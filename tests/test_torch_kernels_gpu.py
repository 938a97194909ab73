"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Needs a CUDA device and nvcc; skips without a card.
Run on an H100 with:  python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Tolerance: rtol 1e-4 / atol 1e-4 relative to the output scale. Both sides
are fp32 (TF32 off); they sum the K = wh*ww window products and the
nl*C collapse terms in different orders, and the backward kernel adds
overlapping windows with atomics."""

import numpy as np
import pytest
import torch

from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import make_calibrations, tiny_config
from vfa_tpu_torch.geometry import make_grid
from vfa_tpu_torch.ops import rig as trig
from vfa_tpu_torch.ops.rig_cuda import (
    rig_sample_scale_cuda, rig_scale_bwd, rig_tiles_cuda, rig_window_bwd,
    rig_window_fwd,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the window kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def plain_tiles(lat, sr, k):
    ii = trig.pad_features(lat)
    Kr = trig.collapse_per_layer(k, 256, sr.nl, torch.float32)
    return torch.cat([trig.window_tiles(ii, A_b, s_b, Kr, win, sr.tile_v)
                      for A_b, s_b, win in zip(sr.A, sr.starts, sr.window_hw)], 2)


@pytest.mark.parametrize("name,tile_v,buckets",
                         [("MultiviewC", 16, 3), ("MultiviewC", 64, 12),
                          ("Wildtrack", 24, 3)])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_window_kernel_matches_plain(cuda, name, tile_v, buckets, B):
    cfg = tiny_config(get_config(name), factor=4)
    calibs = make_calibrations(cfg)
    grid = make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name)
    rig = trig.build_rig(calibs, cfg, grid, trig.pyramid_feat_shapes(cfg.resize_size),
                         tile_v=tile_v, band_buckets=buckets, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(B)
    for sr in rig.scales:
        fh, fw = sr.feat_hw
        lat = torch.rand((B, calibs.shape[0], fh, fw, 256), generator=g).to(cuda)
        k = (torch.randn((256 * sr.nl, 256), generator=g) * 0.05).to(cuda)
        b = torch.randn((256,), generator=g).to(cuda)
        n0 = rig_window_fwd.launches
        got = rig_tiles_cuda(lat, sr, k)
        torch.cuda.synchronize()
        assert rig_window_fwd.launches == n0 + len(sr.A)
        want = plain_tiles(lat, sr, k)
        # pad rows of the tiles are never gathered: compare through inv_perm
        for cs in (False, True):
            o_k = trig.rig_epilogue(got, sr.inv_perm, b, torch.float32, cs)
            o_p = trig.rig_epilogue(want, sr.inv_perm, b, torch.float32, cs)
            scale = float(o_p.abs().max())
            np.testing.assert_allclose(o_k.cpu().numpy(), o_p.cpu().numpy(),
                                       rtol=1e-4, atol=1e-4 * scale)
        full = rig_sample_scale_cuda(lat, sr, k, b, camera_sum=True)
        np.testing.assert_allclose(
            full.cpu().numpy(),
            trig.rig_sample_scale(lat, sr, k, b, camera_sum=True).cpu().numpy(),
            rtol=1e-4, atol=1e-4 * float(full.abs().max()))


@pytest.mark.parametrize("name,tile_v,buckets",
                         [("MultiviewC", 16, 1), ("MultiviewC", 16, 3),
                          ("MultiviewC", 64, 3), ("Wildtrack", 24, 3)])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_window_bwd_kernel_matches_plain(cuda, name, tile_v, buckets, B):
    """dII and dKr of the backward kernel (all buckets of a scale through
    one dII) against `window_tiles_bwd`, and the autograd function against
    autograd of the plain forward. Tolerance 1e-4 of the plain result's
    max: fp32 both sides, the kernel adds with atomics in another order."""
    cfg = tiny_config(get_config(name), factor=4)
    calibs = make_calibrations(cfg)
    grid = make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name)
    rig = trig.build_rig(calibs, cfg, grid, trig.pyramid_feat_shapes(cfg.resize_size),
                         tile_v=tile_v, band_buckets=buckets, device=cuda)
    gen = torch.Generator(device="cpu").manual_seed(10 + B)
    for sr in rig.scales:
        fh, fw = sr.feat_hw
        N = calibs.shape[0]
        lat = torch.rand((B, N, fh, fw, 256), generator=gen).to(cuda)
        k = (torch.randn((256 * sr.nl, 256), generator=gen) * 0.05).to(cuda)
        rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
        g = torch.randn((N, B, rows, 256), generator=gen).to(cuda)
        ii = trig.pad_features(lat)
        Kr = trig.collapse_per_layer(k, 256, sr.nl, torch.float32)
        n0 = rig_window_bwd.launches
        dII, dKr = rig_scale_bwd(ii, sr, Kr, g)
        torch.cuda.synchronize()
        assert rig_window_bwd.launches == n0 + len(sr.A)
        want_dII, want_dKr, off = None, torch.zeros_like(Kr), 0
        for A_b, s_b, win in zip(sr.A, sr.starts, sr.window_hw):
            T = A_b.shape[1]
            want_dII, d = trig.window_tiles_bwd(
                ii, A_b, s_b, Kr, g[:, :, off * tile_v:(off + T) * tile_v],
                win, tile_v, dII=want_dII)
            want_dKr += d
            off += T
        for got, want in ((dII, want_dII), (dKr, want_dKr)):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-4, atol=1e-4 * float(want.abs().max()))

        # through autograd: the kernels' Function vs autograd of the plain
        # forward, on the tiles (linear in lat and k: no ReLU boundary that
        # a 1e-6 difference of the two forwards could flip)
        grads = []
        for fn in (rig_tiles_cuda, plain_tiles):
            la, ka = lat.clone().requires_grad_(), k.clone().requires_grad_()
            fn(la, sr, ka).backward(g)
            grads.append((la.grad, ka.grad))
        for got, want in zip(*grads):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_window_kernel_rejects_bad_inputs(cuda):
    cfg = tiny_config(get_config("MultiviewC"))
    rig = trig.build_rig(make_calibrations(cfg), cfg,
                         make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
                         trig.pyramid_feat_shapes(cfg.resize_size), tile_v=16,
                         device=cuda)
    sr = rig.scales[0]
    lat = torch.zeros((1, 2, *sr.feat_hw, 256), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        rig_tiles_cuda(lat.half(), sr, torch.zeros((256 * sr.nl, 256), device=cuda))
    with pytest.raises(ValueError, match="C = n_out = 256"):
        rig_tiles_cuda(lat[..., :8], sr, torch.zeros((8 * sr.nl, 256), device=cuda))
    ii = trig.pad_features(lat)
    Kr = torch.zeros((sr.nl, 256, 256), device=cuda)
    rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
    g = torch.zeros((2, 1, rows, 256), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rig_window_bwd(ii, sr.A[0], sr.starts[0], Kr, g.repeat(1, 1, 2, 1)[:, :, ::2],
                       torch.zeros_like(ii), torch.zeros_like(Kr), off_t=0,
                       tile_v=sr.tile_v, window=sr.window_hw[0])
    with pytest.raises(TypeError, match="float32"):
        rig_window_bwd(ii, sr.A[0], sr.starts[0], Kr, g.double(),
                       torch.zeros_like(ii), torch.zeros_like(Kr), off_t=0,
                       tile_v=sr.tile_v, window=sr.window_hw[0])
