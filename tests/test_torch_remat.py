"""The memory options of the port (`VFANet(backbone_remat=, backbone_chunks=,
stem_remat=)`, `ResNetGN(remat=, stem_remat=)`, the counterparts of
`vfa_tpu/model/vfanet.py:62-72, 156-192` and `vfa_tpu/model/resnet.py:
84-145`) on the CPU, in fp32 and in mixed bf16 (fp32 masters cast at use
through `torch.func.functional_call`, `train_lib._forward`).

A recompute in the backward runs the forward's own ops on the forward's
own tensors, so remat and stem_remat give the plain model's outputs and
gradients bit for bit. backbone_chunks runs the backbone over halves of
the B*N images: its outputs are the plain model's bits too (per-image
ops; on one torch thread, `one_torch_thread`, since the CPU GroupNorm on
channels-last input splits its reduction by batch size against the thread
count), and so are
the gradients of every module after the chunks; a feature module's weight
gradient is a sum over the images, here taken as two partial sums added,
so it is held to the same chunks without the recompute bit for bit and to
the plain model at a tolerance, as JAX's own test holds its chunked model
(`tests/test_model.py:131-170`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vfa_tpu.config import TrainConfig, mc_opts
from vfa_tpu.data.synthetic import make_scene, tiny_config
from vfa_tpu.train_lib import create_model

from vfa_tpu_torch import train_lib
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.convert import named_jax_leaves, params_from_jax
from vfa_tpu_torch.data.synthetic import make_calibrations
from vfa_tpu_torch.data.synthetic import tiny_config as t_tiny_config
from vfa_tpu_torch.geometry import make_grid
from vfa_tpu_torch.model import resnet, vfanet
from vfa_tpu_torch.model.vfanet import VFANet, init_weights
from vfa_tpu_torch.ops import rig_cuda, stem
from vfa_tpu_torch.ops.rig import build_rig, pyramid_feat_shapes

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_voxel_bf16 import port_weights_for_jax

OPTIONS = {
    "remat": {"backbone_remat": True},
    "stem_remat": {"stem_remat": True},
    "chunks": {"backbone_chunks": 2},
    "all": {"backbone_remat": True, "stem_remat": True, "backbone_chunks": 2},
}
# a feature module's weight gradient in 2 partial sums against 1 sum, by
# max |diff| / max |plain| of each parameter: fp32 reassociation (measured
# 5.3e-6); under mixed precision each partial sum is a bf16 gradient of
# the cast weight and their sum is rounded again (measured 7.75e-3, one
# bf16 ulp of the largest; the bound is two)
CHUNK_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}


@pytest.fixture(scope="module")
def setup():
    """The tiny MultiviewC config, seeded weights, 2 scenes of 2 cameras
    (B*N = 4 images) and the window rig (the kernels' plain versions)."""
    tc = t_tiny_config(get_config("MultiviewC"))
    scenes = [make_scene(tiny_config(mc_opts), seed=s, num_objects=3) for s in range(2)]
    batch = {"images": torch.from_numpy(np.stack([s.images for s in scenes])),
             "calibs": torch.from_numpy(np.stack([s.calibs for s in scenes])),
             "grid": torch.from_numpy(scenes[0].grid)}
    rig = build_rig(make_calibrations(tc), tc,
                    make_grid(tc.world_size, tc.cube_size[:2], tc.name),
                    pyramid_feat_shapes(tc.resize_size), tile_v=16,
                    band_buckets=3, device="cpu")
    rig16 = build_rig(make_calibrations(tc), tc,
                      make_grid(tc.world_size, tc.cube_size[:2], tc.name),
                      pyramid_feat_shapes(tc.resize_size), tile_v=16,
                      band_buckets=3, device="cpu", dtype=torch.bfloat16)
    state = init_weights(VFANet(tc), torch.Generator().manual_seed(0)).state_dict()
    return tc, batch, {"float32": rig, "bfloat16": rig16}, state, {}


def _step(setup, dtype: str, recompute: bool = True, **options):
    """Outputs (fp32) and parameter gradients of a training-mode forward
    and backward of the seeded model with `options`, loss the mean square
    of every output; and the rig's forward calls. `recompute` False runs
    the same graph with every recomputed region run once, as is."""
    tc, batch, rigs, state, _ = setup
    model = VFANet(tc, **options)
    model.load_state_dict(state, strict=True)
    model.train()
    calls = []
    real = rig_cuda.rig_sample_scale_cuda
    mp = pytest.MonkeyPatch()
    mp.setattr(rig_cuda, "rig_sample_scale_cuda",
               lambda *a, **k: calls.append(1) or real(*a, **k))
    if not recompute:
        direct = lambda module, fn, *args: fn(*args)
        mp.setattr(resnet, "remat", direct)
        mp.setattr(vfanet, "remat", direct)
    try:
        pred = train_lib._forward(model, getattr(torch, dtype),
                                  batch, rigs[dtype])
        pred = {k: v.float() for k, v in pred.items()}
        sum(v.square().mean() for v in pred.values()).backward()
    finally:
        mp.undo()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    return {k: v.detach() for k, v in pred.items()}, grads, len(calls)


def _plain(setup, dtype):
    cache = setup[-1]
    if dtype not in cache:
        cache[dtype] = _step(setup, dtype)
    return cache[dtype]


def _feature_param(name: str) -> bool:
    return name.split(".")[0] in ("base", "lat8", "lat16", "lat32", "bn8", "bn16", "bn32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_gives_the_plain_models_bits(setup, option, dtype):
    """Outputs and every gradient against the plain model, bit for bit
    (chunks: see the module docstring); the rig samples once a scale, its
    kernels outside every recomputed region."""
    want, want_g, want_calls = _plain(setup, dtype)
    got, got_g, calls = _step(setup, dtype, **OPTIONS[option])
    assert calls == want_calls == 3
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert set(got_g) == set(want_g)
    chunked = "backbone_chunks" in OPTIONS[option]
    if chunked:
        _, once_g, _ = _step(setup, dtype, recompute=False, **OPTIONS[option])
    for k in want_g:
        if chunked and _feature_param(k):
            assert torch.equal(got_g[k], once_g[k]), k
            err = (got_g[k] - want_g[k]).abs().max() / want_g[k].abs().max()
            assert err <= CHUNK_GRAD_TOL[dtype], (k, float(err))
        else:
            assert torch.equal(got_g[k], want_g[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_remat_runs_the_fused_stem_backward_once(setup, dtype, monkeypatch):
    """With VFA_FUSED_STEM=1, stem_remat recomputes conv1 and the fused
    tail's forward in the backward, whose hand-written backward (K6, K7 on
    a card) still runs once a step, in the compute dtype; the gradients are
    the plain fused model's bits. With backbone chunks it runs once a
    chunk, as JAX's scan over chunks runs it."""
    monkeypatch.setenv("VFA_FUSED_STEM", "1")
    calls = []
    monkeypatch.setattr(stem, "gn_relu_pool_bwd",
                        lambda *a, _f=stem.gn_relu_pool_bwd: calls.append(a[0].dtype) or _f(*a))
    want, want_g, _ = _step(setup, dtype)
    assert calls == [getattr(torch, dtype)]
    got, got_g, _ = _step(setup, dtype, stem_remat=True, backbone_remat=True)
    assert calls == [getattr(torch, dtype)] * 2
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k in want_g:
        assert torch.equal(got_g[k], want_g[k]), k
    _step(setup, dtype, **OPTIONS["all"])        # 2 chunks: the stem runs per chunk
    assert calls == [getattr(torch, dtype)] * 4


@pytest.mark.parametrize("chunks,sizes", [(1, [4]), (2, [2, 2]), (3, [4]), (4, [1] * 4)])
def test_chunks_run_only_when_they_divide_the_images(setup, chunks, sizes, monkeypatch):
    """As in JAX (`vfa_tpu/model/vfanet.py:164`) the trunk runs in chunks
    only when the chunk count divides B*N (4 here), else in one pass."""
    tc, batch, rigs, state, _ = setup
    seen = []
    monkeypatch.setattr(VFANet, "trunk", lambda self, x, _f=VFANet.trunk:
                        seen.append(x.shape[0]) or _f(self, x))
    model = VFANet(tc, backbone_chunks=chunks)
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        lats = model.eval().laterals(batch["images"])
    assert seen == sizes and [t.shape[0] for t in lats] == [4] * 3


def test_options_keep_the_state_dict():
    """Same keys, shapes and dtypes with every option on: checkpoints and
    `params_from_jax` load into either model (strict)."""
    tc = t_tiny_config(get_config("MultiviewC"))
    plain = VFANet(tc).state_dict()
    opts = VFANet(tc, **OPTIONS["all"]).state_dict()
    assert list(plain) == list(opts)
    assert all(plain[k].shape == opts[k].shape and plain[k].dtype == opts[k].dtype
               for k in plain)
    VFANet(tc, **OPTIONS["all"]).load_state_dict(plain, strict=True)


@pytest.mark.medium
def test_options_match_jax_with_the_same_options():
    """The port with all three options against JAX's `create_model(...,
    backbone_remat=True, stem_remat=True, backbone_chunks=2)` on the same
    weights (the port's seeded init), 2 scenes through the voxel route: outputs at
    `tests/test_model.py:156`'s rtol 2e-3 / atol 1e-4 and the gradients of
    the sum of squared outputs at its rtol 5e-3 / atol 2e-2 (`:168`), the
    rtol taken of each parameter's largest gradient. Elementwise that
    holds between JAX's option and its plain model, not between the two
    frameworks: their plain models' gradients are as far apart (the
    fuse block's, up to 27x the elementwise bound, measured with and
    without the options); against the largest gradient the worst is
    fuse.3.weight at 4.66e-3 (measured; 4.66e-3 between the plain models
    too), and all parameters as one vector are 4.4e-4 apart (rel-L2)."""
    tc = tiny_config(mc_opts)
    scenes = [make_scene(tc, seed=0, num_objects=3)] * 2
    imgs = jnp.stack([s.images for s in scenes])
    calibs = jnp.stack([s.calibs for s in scenes])
    grid = jnp.asarray(scenes[0].grid)
    jmodel = create_model(tc, TrainConfig(pretrained=False), **OPTIONS["all"])
    v = port_weights_for_jax(jmodel, imgs, calibs, grid)

    def loss(params):
        pred = jmodel.apply({**v, "params": params}, imgs, calibs, grid)
        return sum(jnp.sum(x.astype(jnp.float32) ** 2) for x in pred.values()), pred

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    want_g = named_jax_leaves(jax.tree_util.tree_map(np.array, jgrads))

    model = VFANet(t_tiny_config(get_config("MultiviewC")), **OPTIONS["all"])
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.array, v["params"]),
        jax.tree_util.tree_map(np.array, v["batch_stats"])), strict=True)
    got = model.eval()(torch.from_numpy(np.asarray(imgs)), None,
                       torch.from_numpy(np.asarray(calibs)), torch.from_numpy(np.asarray(grid)))
    sum(x.float().square().sum() for x in got.values()).backward()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   rtol=2e-3, atol=1e-4, err_msg=k)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(grads) == set(want_g)
    for k in want_g:
        err = np.abs(grads[k] - want_g[k]).max()
        assert err <= 5e-3 * np.abs(want_g[k]).max() + 2e-2, (k, err)
    l2 = lambda d: np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in d))
    assert l2(grads[k] - want_g[k] for k in want_g) <= 1e-3 * l2(want_g.values())
