"""MVDet in the port (`vfa_tpu_torch/model/mvdet.py`, `geometry.
ground_positions`, `codec.decode_map`) against the benchmark's plain
reference (`benchmark/reference/mvdet.py`, which imports nothing of the
port) on the CPU at a tiny size: 2 cameras, 64x96 images (calibrated at
128x192, maps upsampled to 32x48), an 8x24 grid, seeded weights. Each head
in fp32 and in bf16 against the reference's bf16 twin; the trunk's strides,
dilations and paddings against torchvision's rule written out; each
sampling position against the calibration applied by hand; the decode
against a plain loop; the state dict under upstream's keys; the spans; and
the predict CLI's `--arch mvdet`."""

import dataclasses
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from vfa_tpu_torch import observability, predict
from vfa_tpu_torch.codec import decode_map
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import make_calibrations
from vfa_tpu_torch.geometry import ground_positions, make_grid
from vfa_tpu_torch.model.mvdet import MVDet, init_weights, sample_grid, warp
from vfa_tpu_torch.model.resnet import ResNetGN

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _load_reference():
    """`benchmark/reference/mvdet.py` by its path (it imports only torch)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmark", "reference", "mvdet.py")
    spec = importlib.util.spec_from_file_location("mvdet_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()

CFG = dataclasses.replace(get_config("Wildtrack"), world_size=(32, 96), image_size=(128, 192),
                          resize_size=(64, 96), num_cam=2)
MODEL = {"base": "resnet18", "resnet_layers": [2, 2, 2, 2], "dilation": [False, True, True],
         "img_reduce": 4, "grid_reduce": 4}
DS = {"name": CFG.name, "image_size": list(CFG.image_size), "num_cam": CFG.num_cam}
RUN = {"dataset": DS, "model": MODEL,
       "decode": {"cls_thresh": 0.4, "nms_dist": 20, "topk": 100}}


@pytest.fixture(scope="module")
def case():
    """Seeded weights (the reference's `init_state`), 2 scenes of random
    images, the ring cameras and the grid, and the positions."""
    state = ref.init_state(ref.Reference(DS, MODEL), torch.Generator().manual_seed(22), "cpu")
    calibs = make_calibrations(CFG)
    grid = make_grid(CFG.world_size, CFG.cube_size[:2], CFG.name)
    images = torch.rand(2, 2, 64, 96, 3, generator=torch.Generator().manual_seed(5))
    positions = ground_positions(calibs, grid, CFG.name, CFG.image_size, (32, 48))
    return {"state": state, "calibs": torch.from_numpy(calibs), "grid": torch.from_numpy(grid),
            "images": images, "positions": positions}


def port(state, dtype=torch.float32) -> MVDet:
    model = MVDet(CFG)
    model.load_state_dict(state, strict=True)
    return model.to(dtype).eval()


def reference(state, low=None) -> ref.Reference:
    model = ref.Reference(DS, MODEL, low)
    model.load_state_dict(state)
    return model.eval()


def rel(a, b) -> float:
    return float(torch.linalg.vector_norm((a.double() - b.double()).flatten())
                 / torch.linalg.vector_norm(b.double().flatten()))


def test_the_grid_and_maps_are_the_tiny_sizes(case):
    assert CFG.grid_shape == (8, 24)
    assert MVDet(CFG).upsample_shape == (32, 48)
    assert case["positions"].shape == (2, 8, 24, 2)


@torch.no_grad()
def test_fp32_heads_match_the_reference(case):
    """Both heads within 1e-5 relative L2, 1e-4 of the largest value at
    any point: two fp32 computations whose convolutions sum in other
    orders, the warp's weights here fp32 from fp32 grid coordinates
    (~1e-7 of a pixel, grid_sample's unnormalising) and there fp64 (no
    reordering alone reaches 1e-5 at these depths)."""
    got = port(case["state"])(case["images"], case["positions"])
    want = reference(case["state"])(case["images"], case["calibs"], case["grid"])
    assert set(got) == set(want) == {"heatmap", "img_heatmap"}
    for k in want:
        assert got[k].shape == want[k].shape
        assert rel(got[k], want[k]) < 1e-5, k
        assert float((got[k] - want[k]).abs().max()) < 1e-4 * float(want[k].abs().max()), k


@torch.no_grad()
def test_bf16_heads_are_as_far_as_the_twin(case):
    """In bf16 each head is at most 3 times as far from the fp32 reference
    as the reference's bf16 twin (its convolutions' operands and the
    projection's output rounded, where the program rounds): the program
    rounds also after each norm, ReLU and residual add, which the twin
    leaves in fp32; the fp8 control is many times farther."""
    got = port(case["state"], torch.bfloat16)(case["images"].bfloat16(),
                                             case["positions"])
    want = reference(case["state"])(case["images"], case["calibs"], case["grid"])
    twin = reference(case["state"], "bf16")(case["images"], case["calibs"], case["grid"])
    fp8 = reference(case["state"], "fp8")(case["images"], case["calibs"], case["grid"])
    for k in want:
        assert got[k].dtype == torch.bfloat16
        units = rel(twin[k], want[k])
        assert 1e-4 < units < 5e-2, k
        assert rel(got[k], want[k]) < 3 * units, k
        assert rel(fp8[k], want[k]) > 3 * units, k


def test_trunk_dilation_rule_by_hand():
    """Every convolution of the trunk in module order, (kernel, stride,
    dilation, padding): torchvision's `replace_stride_with_dilation=
    [False, True, True]` on ResNet-18, layer3's blocks at dilations 1
    and 2, layer4's at 2 and 4, the downsamples at stride 1 there."""
    want = [(7, 2, 1, 3)]
    want += [(3, 1, 1, 1)] * 4                                     # layer1
    want += [(3, 2, 1, 1), (3, 1, 1, 1), (1, 2, 1, 0), (3, 1, 1, 1), (3, 1, 1, 1)]
    want += [(3, 1, 1, 1), (3, 1, 1, 1), (1, 1, 1, 0), (3, 1, 2, 2), (3, 1, 2, 2)]
    want += [(3, 1, 2, 2), (3, 1, 2, 2), (1, 1, 1, 0), (3, 1, 4, 4), (3, 1, 4, 4)]
    for model in (MVDet(CFG), ref.Reference(DS, MODEL)):
        got = [(m.kernel_size[0], m.stride[0], m.dilation[0], m.padding[0])
               for seq in (model.base_pt1, model.base_pt2) for m in seq.modules()
               if isinstance(m, torch.nn.Conv2d)]
        assert got == want
        norms = [m for seq in (model.base_pt1, model.base_pt2) for m in seq.modules()
                 if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm))]
        assert len(norms) == 20 and all(isinstance(m, torch.nn.BatchNorm2d) for m in norms)
    out = MVDet(CFG).eval().trunk(torch.rand(1, 64, 96, 3))
    assert out.shape == (1, 512, 8, 12)


def test_vfanet_trunk_keeps_its_modules():
    """The shared stages change nothing of VFANet's ResNet-GN: GroupNorms,
    undilated 3x3 convolutions padded by 1, strides 2 from layer2 on."""
    trunk = ResNetGN()
    convs = [(n, m.stride[0], m.dilation[0], m.padding[0]) for n, m in trunk.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert all(d == 1 for _, _, d, _ in convs)
    assert [s for n, s, _, _ in convs if n.endswith("0.conv1")] == [1, 2, 2, 2]
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in trunk.modules())


def test_positions_are_the_calibration_applied(case):
    """Each cell's position equals its ground point in world coordinates
    (Wildtrack: x 2.5 - 300, y 2.5 - 900, z = 0) through the camera's
    3x4 matrix, divided by depth and scaled from 128x192 to 32x48, worked
    in numpy fp64 point by point."""
    calibs, grid = case["calibs"].numpy().astype(np.float64), case["grid"].numpy()
    got = case["positions"].numpy()
    for n in range(2):
        for r in range(8):
            for c in range(24):
                x, y, _ = grid[r, c].astype(np.float64)
                u = calibs[n] @ np.array([x * 2.5 - 300.0, y * 2.5 - 900.0, 0.0, 1.0])
                want = np.array([u[0] / u[2] * 48 / 192, u[1] / u[2] * 32 / 128])
                np.testing.assert_allclose(got[n, r, c], want, rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(case["positions"].double(), torch.stack(
        [ref.positions(DS, case["calibs"][n], case["grid"], (32, 48)) for n in range(2)]),
        rtol=1e-6, atol=1e-4)


def test_warp_reads_four_taps_and_zero_outside():
    """The port's warp on random maps at positions inside, on the edges and
    outside the map equals the reference's explicit four taps (fp64)."""
    g = torch.Generator().manual_seed(1)
    up = torch.randn(2, 5, 6, 9, generator=g)
    pos = torch.stack([torch.rand(4, 7, generator=g) * 12 - 2,
                       torch.rand(4, 7, generator=g) * 9 - 2], -1).double()
    pos[0, 0], pos[0, 1], pos[0, 2] = torch.tensor([8.0, 5.0]), torch.tensor([0.0, 0.0]), \
        torch.tensor([-0.5, 2.25])
    want = 0.0
    for index, weight in ref.warp_taps(pos, (6, 9)):
        want = want + up.reshape(2, 5, -1)[..., index].double() * weight
    got = warp(up, sample_grid(pos.float(), 6, 9))
    torch.testing.assert_close(got.double(), want.reshape(2, 5, 4, 7), rtol=1e-5, atol=1e-5)


def loop_decode(scores, cells, thresh, dist, topk):
    """Upstream's suppression as a plain loop over the top `topk`."""
    flat = scores.reshape(scores.shape[0], -1).tolist()
    pts = cells.reshape(-1, 2).tolist()
    out = []
    for row in flat:
        order = sorted(range(len(row)), key=lambda i: (-row[i], i))[:topk]
        kept = []
        for i in order:
            if all(math.dist(pts[i], pts[j]) > dist for j in kept):
                kept.append(i)
        out.append([(row[i], pts[i], i in kept and row[i] > thresh) for i in order])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_decode_matches_the_loop_with_ties_and_the_boundary(seed):
    """Scores drawn from few values (many ties), one candidate exactly 20
    units from a higher one (suppressed: upstream keeps only those farther),
    one at 20.1 (kept); against the loop, and the reference's decode."""
    g = torch.Generator().manual_seed(seed)
    L, W = 8, 24
    cells = torch.from_numpy(make_grid(CFG.world_size, (4, 4), CFG.name)[..., :2].copy())
    scores = (torch.randint(0, 12, (3, 1, L, W), generator=g).float() / 10.0)
    scores[:, 0, 2, 3] = 2.0
    scores[:, 0, 7, 3] = 1.9        # 5 cells down a column: 20 units
    scores[:, 0, 2, 8] = 1.8        # 5 cells along a row: 20 units
    got = decode_map(scores, cells, 0.4, 20.0, topk=30)
    want = loop_decode(scores, cells, 0.4, 20.0, 30)
    for b, rows in enumerate(want):
        assert got["conf"][b].tolist() == [r[0] for r in rows]
        assert got["location"][b].tolist() == [r[1] for r in rows]
        assert got["valid"][b].tolist() == [r[2] for r in rows]
        assert rows[1][2] is False and rows[2][2] is False
    cells_off = cells.clone()
    cells_off[7, 3, 0] += 0.1
    got = decode_map(scores, cells_off, 0.4, 20.0, topk=30)
    assert got["valid"][:, 1].all()
    ref_dec = ref.decode({"heatmap": scores}, {**RUN, "dataset": {**DS, "name": "Wildtrack"}})
    for k in ("conf", "location", "valid"):
        assert torch.equal(decode_map(scores, cells, 0.4, 20.0, 100)[k], ref_dec[k]), k


def test_state_dict_loads_strictly_under_upstream_keys(case):
    model = MVDet(CFG)
    keys = set(model.state_dict())
    assert keys == set(case["state"])
    for k in ("base_pt1.0.weight", "base_pt1.1.running_var", "base_pt1.1.num_batches_tracked",
              "base_pt1.4.1.conv2.weight", "base_pt1.5.0.downsample.0.weight",
              "base_pt1.6.0.downsample.1.running_mean", "base_pt1.6.1.bn2.weight",
              "base_pt2.0.1.conv2.weight", "img_classifier.0.bias", "img_classifier.2.weight",
              "map_classifier.0.weight", "map_classifier.2.bias", "map_classifier.4.weight"):
        assert k in keys, k
    assert "img_classifier.2.bias" not in keys and "map_classifier.4.bias" not in keys
    assert model.map_classifier[0].weight.shape == (512, 512 * 2 + 2, 3, 3)
    assert not any(k.startswith(("coord_map", "img_mean")) for k in keys)
    model.load_state_dict(case["state"], strict=True)


def test_init_weights_follows_upstream():
    model = init_weights(MVDet(CFG), torch.Generator().manual_seed(0))
    w = model.base_pt2[0][1].conv2.weight.detach()
    assert abs(float(w.std()) - math.sqrt(2.0 / (512 * 9))) < 0.05 * math.sqrt(2.0 / (512 * 9))
    bound = 1.0 / math.sqrt(model.map_classifier[0].weight[0].numel())
    assert float(model.map_classifier[0].weight.detach().abs().max()) <= bound
    assert float(model.base_pt1[1].running_var.min()) == 1.0


@torch.no_grad()
def test_spans_of_a_serve_forward(case):
    model = port(case["state"])
    cells = case["grid"][..., :2]
    observability.clear_spans()
    was = observability.tracing(True)
    try:
        pred = model(case["images"], case["positions"])
        decode_map(pred["heatmap"], cells, 0.4, 20.0)
        totals = observability.span_totals()
    finally:
        observability.tracing(was)
        observability.clear_spans()
    assert {k: v["calls"] for k, v in totals.items()} == {
        "forward": 1, "backbone": 1, "projection": 1, "heads": 3, "decode": 1}


def test_predict_cli_serves_mvdet(capsys):
    out = predict.main(["--data", "Wildtrack", "--synthetic", "--arch", "mvdet", "--tiny",
                        "--device", "cpu", "--scenes", "2", "--batch", "2"])
    assert len(out["detections"]) == 2 and len(out["ms"]) == 1
    assert out["heatmaps"][0].shape == (2, 1, 7, 22)      # the tiny Wildtrack grid
    assert "detections above conf 0.4" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        predict.main(["--data", "Wildtrack", "--arch", "mvdet", "--device", "cpu"])
