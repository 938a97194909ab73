"""The serving epilogue of the rig sampling on the CPU at a tiny size:
`ops/rig.rig_bev_sum`, the plain version of `csrc/rig_bev_epilogue.cu`,
against the per-scale chain it replaces on the serving path (three
`rig_epilogue(..., float32, camera_sum=True)`, the fp32 adds over scales,
the final bf16 cast), and `ops/rig_cuda.rig_bev`'s choice between the
two: the one-launch route for bf16 laterals with no gradient needed, on
the CPU as on the card, the per-scale route for every other call, the
same values from both.

What held here: `rig_bev_sum` equals the chain bit for bit on every case
(the CPU's fp32 camera sum adds in camera order, as the kernel does), so
the tests assert equality, not the one bf16 ulp that another order of
the fp32 sums could flip."""

import types

import pytest
import torch

from vfa_tpu_torch import observability
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import make_calibrations, tiny_config
from vfa_tpu_torch.geometry import make_grid
from vfa_tpu_torch.model.vfanet import VFANet, cast_model, init_weights
from vfa_tpu_torch.ops import rig as trig
from vfa_tpu_torch.ops import rig_cuda
from vfa_tpu_torch.ops.rig_cuda import rig_bev_epilogue

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CASES = [("MultiviewC", "window"), ("MultiviewC", "flat"), ("Wildtrack", "window"),
         ("Wildtrack", "flat")]
IDS = ["mvc-window", "mvc-flat", "wt-window", "wt-flat"]


def _rig(name, layout, dtype=torch.bfloat16):
    tc = tiny_config(get_config(name))
    rig = trig.build_rig(make_calibrations(tc), tc,
                         make_grid(tc.world_size, tc.cube_size[:2], tc.name),
                         trig.pyramid_feat_shapes(tc.resize_size), tile_v=16,
                         band_buckets=3, layout=layout, device="cpu", dtype=dtype)
    return tc, rig


def _tiles(rig, B, seed):
    """Random bf16 tiles of each scale's shape, a bias each: about half
    of tile + bias below 0, so the ReLU clips."""
    gen = torch.Generator().manual_seed(seed)
    tiles, biases = [], []
    for sr in rig.scales:
        N = sr.inv_perm.shape[0]
        rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
        tiles.append(torch.randn((N, B, rows, 256), generator=gen).to(torch.bfloat16))
        biases.append((torch.randn((256,), generator=gen) * 0.5).to(torch.bfloat16))
    return tiles, [sr.inv_perm for sr in rig.scales], biases


def _chain(tiles, inv_perms, biases):
    """The per-scale route's epilogue as `ops.rig.rig_bev` runs it."""
    ortho = 0.0
    for t, ip, b in zip(tiles, inv_perms, biases):
        ortho = ortho + trig.rig_epilogue(t, ip, b, torch.float32, camera_sum=True)
    return ortho.to(torch.bfloat16)


@pytest.mark.parametrize("name,layout", CASES, ids=IDS)
@pytest.mark.parametrize("B", [1, 2])
def test_rig_bev_sum_equals_the_per_scale_chain(name, layout, B):
    _, rig = _rig(name, layout)
    tiles, inv_perms, biases = _tiles(rig, B, 7 + B)
    got = trig.rig_bev_sum(tiles, inv_perms, biases)
    want = _chain(tiles, inv_perms, biases)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (B, inv_perms[0].shape[1], 256)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # the ReLU clipped and the sums are not trivial
    assert 0 < int((got == 0).sum()) < got.numel()


def test_rig_bev_sum_order_and_roundings():
    """One cell by hand, on channel 0 (the other channels hold 0 and give
    relu(0 + 0) = 0): two cameras, two scales, bias 2^-9.
    Scale 0: camera 0 reads 1, rnd(1 + 2^-9) = 1 (a tie to even); camera 1
    reads 2^-9, rnd(2^-9 + 2^-9) = 2^-8; the fp32 sum 1 + 2^-8.
    Scale 1 reads the negated tiles: rnd(-1 + 2^-9) = -1 and 0, both 0
    after the ReLU. The total 1 + 2^-8 rounds to 1 (a tie to even); with
    the bias added unrounded the sum would be 1 + 3 2^-9, which rounds to
    1 + 2^-7."""
    t = torch.zeros((2, 1, 2, 256), dtype=torch.bfloat16)
    t[0, 0, 1, 0], t[1, 0, 0, 0] = 1.0, 2.0 ** -9
    ip = torch.tensor([[1], [0]])
    b = torch.zeros(256, dtype=torch.bfloat16)
    b[0] = 2.0 ** -9
    got = trig.rig_bev_sum([t, -t], [ip, ip], [b, b])
    assert float(got[0, 0, 0]) == 1.0
    assert float(torch.tensor(1.0 + 3 * 2.0 ** -9).to(torch.bfloat16)) == 1.0 + 2.0 ** -7
    assert torch.equal(got[0, 0, 1:], torch.zeros(255, dtype=torch.bfloat16))


def test_rig_bev_epilogue_on_the_cpu_is_the_plain_version():
    """On CPU tensors the wrapper returns `rig_bev_sum` and launches
    nothing; a float32 bias is cast to the tiles' dtype first, as the
    per-scale route casts it."""
    _, rig = _rig("MultiviewC", "window")
    tiles, inv_perms, biases = _tiles(rig, 2, 3)
    n0 = rig_bev_epilogue.launches
    got = rig_bev_epilogue(tiles, inv_perms, [b.float() for b in biases])
    assert rig_bev_epilogue.launches == n0
    assert torch.equal(got, trig.rig_bev_sum(tiles, inv_perms, biases))


@pytest.fixture(scope="module")
def tiny_models():
    """The tiny MultiviewC config, its bf16 window and flat rigs, seeded
    weights and images of 2 scenes."""
    tc = tiny_config(get_config("MultiviewC"))
    rigs = {layout: _rig("MultiviewC", layout)[1] for layout in ("window", "flat")}
    state = init_weights(VFANet(tc), torch.Generator().manual_seed(0)).state_dict()
    images = torch.rand((2, tc.num_cam, *tc.resize_size, 3),
                        generator=torch.Generator().manual_seed(1))
    return tc, rigs, state, images


def _model(tiny_models, dtype=torch.bfloat16, rig_impl="cuda"):
    tc, _, state, _ = tiny_models
    model = VFANet(tc, rig_impl=rig_impl)
    model.load_state_dict(state, strict=True)
    return cast_model(model, dtype).eval()


def _count_epilogue(monkeypatch):
    """Record each call of `rig_cuda.rig_bev_epilogue`, which still runs."""
    calls = []
    real = rig_cuda.rig_bev_epilogue
    monkeypatch.setattr(rig_cuda, "rig_bev_epilogue",
                        lambda *a: calls.append(1) or real(*a))
    return calls


def _bf16_lat(sr, B, seed):
    """A bf16 lat (B, N, fh, fw, 256) and collapse kernel of one scale."""
    gen = torch.Generator().manual_seed(seed)
    lat = torch.rand((B, sr.inv_perm.shape[0], *sr.feat_hw, 256), generator=gen)
    k = torch.randn((256 * sr.nl, 256), generator=gen) * 0.05
    return lat.to(torch.bfloat16), k.to(torch.bfloat16)


@pytest.mark.parametrize("case,want", [
    ("no_grad", True), ("grad_on", False), ("grad_on_frozen", True),
    ("grad_on_frozen_lats_grad", False), ("plain", False), ("mesh", False),
    ("fp32", False), ("cpu", True),
])
def test_serving_epilogue_is_chosen_on_dtype_device_grad_and_mesh(tiny_models, monkeypatch,
                                                                  case, want):
    """`rig_cuda.rig_bev` takes the one-launch route for bf16 laterals and a
    bf16 output with no gradient needed (grad mode off, or neither the
    laterals nor the collapses' parameters need one), on CPU tensors too:
    the `cpu` case calls it directly on CPU tensors with grad mode on and
    nothing that needs a gradient. At model level VFANet with
    rig_impl='plain', or with a mesh (fp32 out, all-reduced before the
    rounding), never reaches the epilogue."""
    _, rigs, _, images = tiny_models
    calls = _count_epilogue(monkeypatch)
    if case == "cpu":
        lats, ks = zip(*(_bf16_lat(sr, 2, 40 + si) for si, sr in enumerate(rigs["window"].scales)))
        bev = rig_cuda.rig_bev(list(lats), rigs["window"].scales, list(ks),
                               [torch.zeros(256, dtype=torch.bfloat16)] * 3, torch.bfloat16)
        assert bev.dtype == torch.bfloat16 and not bev.requires_grad
        assert bool(calls) is want
        return
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    model = _model(tiny_models, dtype, rig_impl="plain" if case == "plain" else "cuda")
    if case == "mesh":
        model.mesh = types.SimpleNamespace(group=lambda axis: None)
    if "frozen" in case:
        model.requires_grad_(False)
    rig = rigs["window"] if dtype == torch.bfloat16 else _rig("MultiviewC", "window",
                                                               torch.float32)[1]
    x = images.to(dtype).requires_grad_(case.endswith("lats_grad"))
    with torch.set_grad_enabled(case != "no_grad"):
        model.bev_features(x, rig)
    assert bool(calls) is want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_sampling_keeps_the_per_scale_route_on_the_cpu(tiny_models, monkeypatch,
                                                      dtype, grad):
    """On CPU tensors, as on the card, the route of `VFANet.sampling` is
    decided by dtype and grad alone: the one-launch epilogue for bf16 with
    no gradient, the per-scale chain (`rig_sample_scale_cuda` once a scale)
    in every other grad mode and dtype."""
    _, rigs, _, images = tiny_models
    calls = _count_epilogue(monkeypatch)
    chain = []
    real = rig_cuda.rig_sample_scale_cuda
    monkeypatch.setattr(rig_cuda, "rig_sample_scale_cuda",
                        lambda *a, **k: chain.append(1) or real(*a, **k))
    model = _model(tiny_models, dtype)
    rig = rigs["window"] if dtype == torch.bfloat16 else _rig("MultiviewC", "window",
                                                               torch.float32)[1]
    with torch.set_grad_enabled(grad):
        out = model(images.to(dtype), rig)
    assert torch.isfinite(out["heatmap"].float()).all()
    serving = dtype == torch.bfloat16 and not grad
    assert (len(calls), len(chain)) == ((1, 0) if serving else (0, 3))


@pytest.mark.parametrize("layout", ["window", "flat"])
def test_serving_route_equals_the_per_scale_route(tiny_models, monkeypatch, layout):
    """The one-launch route on the CPU (tiles from the forward kernels'
    plain versions, then `rig_bev_sum`) gives the BEV features and outputs
    of the per-scale chain, forced through `ops.rig.rig_bev`, bit for bit,
    and records its `sampling.epilogue` span inside `sampling`."""
    _, rigs, _, images = tiny_models
    rig = rigs[layout]
    model = _model(tiny_models)
    x = images.to(torch.bfloat16)
    observability.tracing(True)
    observability.clear_spans()
    try:
        with torch.no_grad():
            got_bev = model.bev_features(x, rig)
            got = model(x, rig)
        records = list(observability._SPANS.records)
    finally:
        observability.tracing(False)
        observability.clear_spans()
    with monkeypatch.context() as m:
        m.setattr(rig_cuda, "rig_bev", lambda *a: trig.rig_bev(
            *a, sample=rig_cuda.rig_sample_scale_cuda))
        with torch.no_grad():
            want = model(x, rig)
            want_bev = model.bev_features(x, rig)
    assert got_bev.dtype == torch.bfloat16 and got_bev.shape == want_bev.shape
    assert torch.equal(got_bev.view(torch.int16), want_bev.view(torch.int16))
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    epilogue = [r for r in records if r.name == "sampling.epilogue"]
    assert len(epilogue) == 2
    assert all(records[r.parent].name == "sampling" for r in epilogue)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_no_grad_forward_equals_the_grad_forward(tiny_models, dtype):
    """The model's outputs under torch.no_grad equal the grad-enabled
    forward's, in eval mode, bit for bit."""
    _, rigs, _, images = tiny_models
    rig = rigs["window"] if dtype == torch.bfloat16 else _rig("MultiviewC", "window",
                                                               torch.float32)[1]
    model = _model(tiny_models, dtype)
    x = images.to(dtype)
    with torch.no_grad():
        served = model(x, rig)
    trained = model(x, rig)
    assert any(v.requires_grad for v in trained.values())
    for k in served:
        assert torch.equal(served[k], trained[k].detach()), k
