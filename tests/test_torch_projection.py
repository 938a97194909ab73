"""MVDet's projection (`vfa_tpu_torch/ops/projection.py`) and its image
head on the CPU at a tiny size: the wrapper of `csrc/mvdet_project.cu` is
its plain version there, bit for bit, and launches nothing; the plain
version against the kernel's arithmetic written out in fp64 (the
upsample's taps folded into the warp's) at positions inside, on the
edges, outside the map and not finite; the image head's first 1x1
convolution moved before its upsample against the unmoved chain; and
which route `ops.projection.project` takes. The kernel itself is held against the
plain version on the card (`test_torch_kernels_gpu.py`)."""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vfa_tpu_torch import kernels
from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import make_calibrations
from vfa_tpu_torch.geometry import ground_positions, make_grid
from vfa_tpu_torch.model import mvdet
from vfa_tpu_torch.model.mvdet import MVDet, init_weights
from vfa_tpu_torch.ops import projection
from vfa_tpu_torch.ops.projection import (OUTSIDE, project, project_world,
                                          project_world_plain, sample_grid)

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = dataclasses.replace(get_config("Wildtrack"), world_size=(32, 96), image_size=(128, 192),
                          resize_size=(64, 96), num_cam=2)


def channels_last_feats(B, N, C, h8, w8, seed, dtype=torch.float32):
    """Random features (B, N, C, h8, w8) with each pixel's channels
    contiguous, as the trunk leaves them."""
    x = torch.randn(B * N, C, h8, w8, generator=torch.Generator().manual_seed(seed))
    return x.to(dtype).contiguous(memory_format=torch.channels_last).unflatten(0, (B, N))


def edge_positions(h, w, L, W, seed):
    """(L, W, 2) pixel positions on an (h, w) map: random ones from 3
    pixels before the map to 3 after it, then on row 0 the map's corners
    and edges, half a pixel and a whole pixel past them, and positions that
    are not finite."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.stack([torch.rand(L, W, generator=g) * (w + 6) - 3,
                       torch.rand(L, W, generator=g) * (h + 6) - 3], -1)
    special = [(0.0, 0.0), (w - 1, h - 1), (w - 1, 0.0), (0.0, h - 1), (w - 1.5, h - 1.25),
               (w - 0.5, 1.5), (w - 1 + 1e-3, 2.0), (-0.5, 1.0), (-1.0, 2.5), (-1.0001, 1.0),
               (2.0, -1.0), (1.0, h - 0.75), (w + 5, h + 5), (float("nan"), 1.0),
               (1.0, float("inf")), (float("-inf"), float("nan"))]
    for i, (x, y) in enumerate(special):
        pos[i // W, i % W] = torch.tensor([x, y])
    return pos


def axis_taps(u, size, inn):
    """The kernel's taps on one axis (`csrc/mvdet_project.cu::axis_taps`) in
    fp64: grid_sample's two taps floor(u) and floor(u) + 1 inside [0,
    size - 1], each through F.interpolate's two source taps
    (align_corners=False: src = (t + 0.5) in / size - 0.5, clamped at 0;
    i1 = i0 + 1 but at the last row), weights summed by source index."""
    f = math.floor(u)
    out = {}
    for t, wk in ((f, f + 1 - u), (f + 1, u - f)):
        if not 0 <= t <= size - 1:
            continue
        src = max((t + 0.5) * inn / size - 0.5, 0.0)
        i0 = int(src)
        i1 = i0 + (1 if i0 < inn - 1 else 0)
        for i, lam in ((i0, 1 - (src - i0)), (i1, src - i0)):
            out[i] = out.get(i, 0.0) + wk * lam
    return out


def kernel_model(feats, positions, size):
    """The kernel's function in fp64: for every cell, the unnormalised
    coordinate as `sample_grid` and grid_sample make it (fp32 steps), then
    the source pixels' weights of both axes' taps multiplied, summed over
    at most 4 x 4 pixels. -> (B, N*C, L, W) fp64."""
    B, N, C, h8, w8 = feats.shape
    L, W = positions.shape[1:3]
    h, w = size
    grid = sample_grid(positions, h, w).numpy()
    unnorm = lambda g, s: float(np.float32(np.float32(np.float32(g) + np.float32(1)) / 2)
                                * np.float32(s - 1))
    x = feats.double()
    out = torch.zeros(B, N * C, L, W, dtype=torch.float64)
    for n in range(N):
        for r in range(L):
            for c in range(W):
                rows = axis_taps(unnorm(grid[n, r, c, 1], h), h, h8)
                cols = axis_taps(unnorm(grid[n, r, c, 0], w), w, w8)
                assert len(rows) <= 4 and len(cols) <= 4
                for i, wi in rows.items():
                    for j, wj in cols.items():
                        out[:, n * C:(n + 1) * C, r, c] += wi * wj * x[:, n, :, i, j]
    return out


def test_sample_grid_sends_non_finite_positions_outside():
    pos = torch.tensor([[0.0, 0.0], [8.0, 5.0], [float("nan"), 1.0], [1.0, float("-inf")]])
    got = sample_grid(pos, 6, 9)
    assert torch.equal(got[:2], torch.tensor([[-1.0, -1.0], [1.0, 1.0]]))
    assert (got[2:] == OUTSIDE).all()


@pytest.mark.parametrize("fh,fw,h,w", [(4, 6, 12, 18), (5, 7, 13, 29)],
                         ids=["ratio3", "ratio2.6x4.1"])
def test_plain_version_is_the_kernels_arithmetic(fh, fw, h, w):
    """`project_world_plain` (fp32 upsample, grid_sample, one rounding; here
    into fp32) equals the kernel's folded taps in fp64 to fp32 rounding,
    at an integer and a non-integer ratio, on 2 scenes x 2 cameras of
    random positions with the map's corners, edges, points half a pixel
    past them and out of the map; a position that is not finite, or whose
    taps all lie outside, reads exactly 0 (the kernel skips it)."""
    B, N, C, L, W = 2, 2, 8, 5, 7
    feats = channels_last_feats(B, N, C, fh, fw, seed=3)
    pos = torch.stack([edge_positions(h, w, L, W, seed=n) for n in range(N)])
    got = project_world_plain(feats, pos, (h, w), torch.empty(B, N * C + 2, L, W))
    want = kernel_model(feats, pos, (h, w))
    assert float((got[:, :N * C].double() - want).abs().max()) < 1e-5 * float(feats.abs().max())
    zero = torch.zeros(B, C, dtype=torch.float32)
    for n in range(N):
        for i in (12, 13, 14, 15):       # (w + 5, h + 5), then not finite
            assert torch.equal(got[:, n * C:(n + 1) * C, i // W, i % W], zero), i
    assert not torch.equal(got[:, :C, 0, 1], zero)      # (w - 1, h - 1): the last pixel


def test_plain_version_reads_zero_where_not_finite():
    """Pinned: a position with a coordinate that is nan or +-inf gives 0,
    not nan, in every channel of every scene, in bf16 as in fp32."""
    feats = channels_last_feats(1, 1, 4, 3, 5, seed=1)
    pos = torch.tensor([[[[float("nan"), 1.0], [1.0, float("inf")], [float("-inf"), 0.0],
                          [1.0, 1.0]]]])
    for dtype in (torch.float32, torch.bfloat16):
        out = project_world_plain(feats.to(dtype), pos, (6, 10),
                                  torch.full((1, 4, 1, 4), 7.0, dtype=dtype))
        assert torch.equal(out[0, :, 0, :3], torch.zeros(4, 3, dtype=dtype))
        assert torch.isfinite(out.float()).all() and (out[0, :, 0, 3] != 7).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_project_world_on_the_cpu_is_the_plain_version(dtype):
    """On CPU tensors the wrapper returns `project_world_plain`'s output
    bit for bit and launches nothing, in either dtype and layout."""
    B, N, C, L, W = 2, 3, 256, 4, 6
    pos = torch.stack([edge_positions(10, 14, L, W, seed=n) for n in range(N)])
    for feats in (channels_last_feats(B, N, C, 4, 5, seed=2, dtype=dtype),
                  torch.randn(B, N, C, 4, 5).to(dtype)):
        n0 = kernels.launch_counts()["mvdet_project"]
        got = project_world(feats, pos, (10, 14), torch.zeros(B, N * C + 2, L, W, dtype=dtype))
        want = project_world_plain(feats, pos, (10, 14),
                                   torch.zeros(B, N * C + 2, L, W, dtype=dtype))
        assert kernels.launch_counts()["mvdet_project"] == n0
        assert torch.equal(got.view(torch.int16) if dtype == torch.bfloat16 else got,
                           want.view(torch.int16) if dtype == torch.bfloat16 else want)


@pytest.mark.parametrize("fh,fw,h,w", [(8, 12, 32, 48), (5, 7, 13, 29), (6, 9, 16, 20)],
                         ids=["ratio4", "ratio2.6x4.1", "ratio2.7x2.2"])
@torch.no_grad()
def test_image_head_before_the_upsample_equals_the_chain(fh, fw, h, w):
    """The image head with its first 1x1 (bias included) on the /8
    features, then the upsample, ReLU and the second 1x1, equals the
    unmoved chain (upsample, 1x1 with bias, ReLU, 1x1) in fp32: bilinear
    weights sum to 1 on each axis, also on the clamped border rows and
    columns, so the two commute. Held everywhere and on the border alone."""
    model = init_weights(MVDet(CFG), torch.Generator().manual_seed(4)).eval()
    model.upsample_shape = (h, w)
    feats = channels_last_feats(3, 1, 512, fh, fw, seed=6)[:, 0]
    got = model.image_head(feats)
    up = F.interpolate(feats, (h, w), mode="bilinear", align_corners=False)
    want = model.img_classifier(up)
    assert got.shape == want.shape == (3, 2, h, w)
    tol = 2e-6 * float(want.abs().max())
    assert float((got - want).abs().max()) < tol
    for border in (got[..., 0, :] - want[..., 0, :], got[..., -1, :] - want[..., -1, :],
                   got[..., :, 0] - want[..., :, 0], got[..., :, -1] - want[..., :, -1]):
        assert float(border.abs().max()) < tol


@pytest.mark.parametrize("case,want", [
    (("meta", torch.bfloat16, False), True), (("meta", torch.bfloat16, True), False),
    (("meta", torch.float32, False), False), (("meta", torch.float16, False), False),
    (("cpu", torch.bfloat16, None), True), (("cpu", torch.float32, False), False),
], ids=["bf16_cuda", "bf16_cuda_grad", "fp32_cuda", "fp16_cuda", "bf16_cpu", "fp32_cpu"])
def test_kernel_route_only_for_bf16_without_gradient(monkeypatch, case, want):
    """`ops.projection.project` calls the wrapper for bf16 features that
    need no gradient, and the library composition otherwise, whatever the
    device: the same choice on CPU tensors and on another device's (meta
    tensors stand for the card's), where the wrapper alone splits CUDA (the
    kernel) from the CPU (the plain version). `bf16_cpu`'s features require
    a gradient under grad mode off, so none is needed."""
    device, dtype, requires_grad = case
    calls = []
    for name in ("project_world", "project_world_plain"):
        monkeypatch.setattr(projection, name,
                            lambda *a, name=name: calls.append(name) or a[-1])
    feats = torch.zeros(1, 2, 4, 4, 5, dtype=dtype, device=device)
    feats.requires_grad_(requires_grad is not False)
    with torch.set_grad_enabled(requires_grad is not None):
        project(feats, torch.zeros(2, 3, 5, 2, device=device), (10, 14),
                torch.zeros(1, 10, 3, 5, dtype=dtype, device=device))
    assert calls == ["project_world" if want else "project_world_plain"]


@pytest.fixture(scope="module")
def scene():
    model = init_weights(MVDet(CFG), torch.Generator().manual_seed(23)).eval()
    calibs = make_calibrations(CFG)
    grid = make_grid(CFG.world_size, CFG.cube_size[:2], CFG.name)
    images = torch.rand(2, 2, 64, 96, 3, generator=torch.Generator().manual_seed(8))
    pos = ground_positions(calibs, grid, CFG.name, CFG.image_size, model.upsample_shape)
    return model, images, pos


@pytest.mark.parametrize("dtype,grad", [(torch.bfloat16, False), (torch.float32, False),
                                        (torch.bfloat16, True), (torch.float32, True)],
                         ids=["bf16", "fp32", "bf16_grad", "fp32_grad"])
def test_forward_on_the_cpu_launches_nothing(scene, monkeypatch, dtype, grad):
    """On the CPU `MVDet.project` calls the wrapper once for bf16 with no
    gradient and never otherwise, and no launch is counted in any dtype or
    grad mode."""
    model, images, pos = scene
    calls = []
    n0 = kernels.launch_counts()["mvdet_project"]
    net = MVDet(CFG)
    net.load_state_dict(model.state_dict())
    net = net.to(dtype).eval()
    with monkeypatch.context() as m, torch.set_grad_enabled(grad):
        m.setattr(projection, "project_world",
                  lambda *a: calls.append(1) or project_world(*a))
        out = net(images.to(dtype), pos)
    assert out["heatmap"].requires_grad is grad
    assert len(calls) == (dtype == torch.bfloat16 and not grad)
    assert kernels.launch_counts()["mvdet_project"] == n0


@torch.no_grad()
def test_wrapper_route_on_the_cpu_gives_the_plain_routes_outputs(scene, monkeypatch):
    """A bf16 forward on the CPU, which goes through the wrapper, gives the
    outputs of the plain route forced, bit for bit."""
    model, images, pos = scene
    net = MVDet(CFG)
    net.load_state_dict(model.state_dict())
    net = net.to(torch.bfloat16).eval()
    x = images.to(torch.bfloat16)
    calls = []
    monkeypatch.setattr(projection, "project_world",
                        lambda *a: calls.append(1) or project_world(*a))
    got = net(x, pos)
    assert calls == [1]
    monkeypatch.setattr(mvdet, "project", projection.project_world_plain)
    want = net(x, pos)
    assert calls == [1]
    for k in want:
        assert torch.equal(got[k], want[k]), k
