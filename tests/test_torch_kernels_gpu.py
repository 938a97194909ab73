"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Needs a CUDA device and nvcc; skips without a card.
Run on an H100 with:  python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Tolerance: rtol 1e-4 / atol 1e-4 relative to the output scale. Both sides
are fp32-accurate (TF32 off in PyTorch; the rig kernels run 3xTF32 on the
tensor cores, see tests/test_torch_rig_tf32.py); they sum the band
products and the nl*C collapse terms in different orders, and the backward
kernels add overlapping bands with atomics. The stem kernels' tolerance is
stated at their tests."""

import numpy as np
import pytest
import torch

from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import make_calibrations, tiny_config
from vfa_tpu_torch.geometry import make_grid
from vfa_tpu_torch.ops import rig as trig
from vfa_tpu_torch.ops import stem as tstem
from vfa_tpu_torch.ops.projection import (ATOL, ULP_SHARE, bf16_ulps, kernel_vs_plain,
                                          project_world, project_world_plain)
from vfa_tpu_torch.ops.rig_cuda import (
    rig_flat_bwd, rig_flat_fwd, rig_sample_scale_cuda, rig_scale_bwd,
    rig_tiles_cuda, rig_window_bwd, rig_window_fwd,
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
                          ("MultiviewC", 64, 3), ("Wildtrack", 24, 3),
                          ("MultiviewC", 24, 3), ("Wildtrack", 16, 3)])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_window_bwd_kernel_matches_plain(cuda, name, tile_v, buckets, B):
    """dII and dKr of the backward kernel (all buckets of a scale through
    one dII) against `window_tiles_bwd`, and the autograd function against
    autograd of the plain forward. Tolerance 1e-4 of the plain result's
    max: fp32 both sides, the kernel adds with atomics in another order.
    MultiviewC at tile_v 24 has nl*tile_v = 120 rows (not a multiple of the
    64-row CTA tile, and tile_v not a multiple of the 16-deep slice);
    Wildtrack at tile_v 16 has nl = 8."""
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


def _plain_scale(lat, sr, k):
    return trig.scale_tiles(trig.scale_features(lat, sr),
                            sr, trig.collapse_per_layer(k, 256, sr.nl, torch.float32))


@pytest.mark.parametrize("tile_v,buckets,fold_prefix",
                         [(16, 1, True), (16, 3, True), (160, 3, True),
                          (16, 1, False), (24, 3, True)],
                         ids=["tv16-b1", "tv16-b3", "tv160-b3", "taps",
                              "tv24-b3"])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_flat_kernels_match_plain(cuda, tile_v, buckets, fold_prefix, B):
    """K4 and K5 on every bucket of a flat rig against `flat_tiles` /
    `flat_tiles_bwd`, and the autograd function against autograd of the
    plain forward (which, for the 16-tap rig, includes the cumsum). The
    tiny rigs hold bands with band % 16 == 8 (checked below for tv16-b3)."""
    cfg = tiny_config(get_config("MultiviewC"), factor=4)
    calibs = make_calibrations(cfg)
    grid = make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name)
    rig = trig.build_rig(calibs, cfg, grid, trig.pyramid_feat_shapes(cfg.resize_size),
                         tile_v=tile_v, band_buckets=buckets, layout="flat",
                         fold_prefix=fold_prefix, device=cuda)
    bands = [a.shape[-1] for sr in rig.scales for a in sr.A]
    if (tile_v, buckets) == (16, 3):
        assert any(b % 16 == 8 for b in bands), bands
    gen = torch.Generator(device="cpu").manual_seed(20 + B)
    N = calibs.shape[0]
    for sr in rig.scales:
        fh, fw = sr.feat_hw
        # the cumsum of a 16-tap rig grows with the image: keep it O(1)
        lat = torch.rand((B, N, fh, fw, 256), generator=gen).to(cuda)
        if not fold_prefix:
            lat = lat / (fh * fw)
        k = (torch.randn((256 * sr.nl, 256), generator=gen) * 0.05).to(cuda)
        rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
        g = torch.randn((N, B, rows, 256), generator=gen).to(cuda)
        f0, b0 = rig_flat_fwd.launches, rig_flat_bwd.launches
        got = rig_tiles_cuda(lat, sr, k)
        torch.cuda.synchronize()
        want = _plain_scale(lat, sr, k)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4 * float(want.abs().max()))
        ii = trig.scale_features(lat, sr)
        Kr = trig.collapse_per_layer(k, 256, sr.nl, torch.float32)
        dII, dKr = rig_scale_bwd(ii, sr, Kr, g)
        torch.cuda.synchronize()
        assert (rig_flat_fwd.launches, rig_flat_bwd.launches) == (
            f0 + len(sr.A), b0 + len(sr.A))
        want_dII, want_dKr, off = None, torch.zeros_like(Kr), 0
        for A_b, s_b in zip(sr.A, sr.starts):
            r = A_b.shape[1] * tile_v
            want_dII, d = trig.flat_tiles_bwd(ii, A_b, s_b, Kr, g[:, :, off:off + r],
                                              tile_v, dII=want_dII)
            want_dKr += d
            off += r
        for a, b in ((dII, want_dII), (dKr, want_dKr)):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=1e-4, atol=1e-4 * float(b.abs().max()))
        grads = []
        for fn in (rig_tiles_cuda, _plain_scale):
            la, ka = lat.clone().requires_grad_(), k.clone().requires_grad_()
            fn(la, sr, ka).backward(g)
            grads.append((la.grad, ka.grad))
        for a, b in zip(*grads):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def _one_tile_case(layout, B, device):
    """A bucket cut to its first tile (T = 1), placed at tile 2 of a 4-tile
    cotangent, with seeded inputs and zeroed accumulators."""
    cfg = tiny_config(get_config("MultiviewC"), factor=4)
    rig = trig.build_rig(make_calibrations(cfg), cfg,
                         make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
                         trig.pyramid_feat_shapes(cfg.resize_size), tile_v=16,
                         band_buckets=3, layout=layout, device=device)
    sr = rig.scales[0]
    bi = len(sr.A) - 1
    A_b, s_b = sr.A[bi][:, :1].contiguous(), sr.starts[bi][:, :1].contiguous()
    gen = torch.Generator(device="cpu").manual_seed(40 + B)
    N = A_b.shape[0]
    lat = torch.rand((B, N, *sr.feat_hw, 256), generator=gen).to(device)
    ii = trig.scale_features(lat, sr)
    Kr = (torch.randn((sr.nl, 256, 256), generator=gen) * 0.05).to(device)
    g = torch.randn((N, B, 4 * sr.tile_v, 256), generator=gen).to(device)
    return sr, bi, ii, A_b, s_b, Kr, g


@pytest.mark.parametrize("layout", ["window", "flat"])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_bwd_kernels_single_tile_bucket(cuda, layout, B):
    """T = 1 at a tile offset: the dKr pass has fewer tiles than depth
    chunks, the other passes a grid of one tile per (n, b)."""
    sr, bi, ii, A_b, s_b, Kr, g = _one_tile_case(layout, B, cuda)
    dII, dKr = torch.zeros_like(ii), torch.zeros_like(Kr)
    g_b = g[:, :, 2 * sr.tile_v:3 * sr.tile_v]
    if layout == "window":
        rig_window_bwd(ii, A_b, s_b, Kr, g, dII, dKr, off_t=2, tile_v=sr.tile_v,
                       window=sr.window_hw[bi])
        want = trig.window_tiles_bwd(ii, A_b, s_b, Kr, g_b, sr.window_hw[bi],
                                     sr.tile_v)
    else:
        rig_flat_bwd(ii, A_b, s_b, Kr, g, dII, dKr, off_t=2, tile_v=sr.tile_v)
        want = trig.flat_tiles_bwd(ii, A_b, s_b, Kr, g_b, sr.tile_v)
    torch.cuda.synchronize()
    for a, b in zip((dII, dKr), want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("layout,name,tile_v",
                         [("window", "MultiviewC", 24), ("window", "Wildtrack", 16),
                          ("flat", "MultiviewC", 16), ("flat", "MultiviewC", 160),
                          ("flat", "Wildtrack", 16)],
                         ids=["window-R120", "window-nl8", "flat-band8",
                              "flat-R800", "flat-nl8"])
@pytest.mark.parametrize("single_tile", [False, True], ids=["bucket", "T1"])
@pytest.mark.parametrize("B", [1, 2])
def test_fwd_kernels_write_in_place(cuda, layout, name, tile_v, single_tile, B):
    """K1 / K4 bucket by bucket into an `out` filled with NaN, at tile
    offset 2 with one tile of room after the bucket: the launch's rows
    within 1e-4 of the plain version's max, every other row still NaN
    (buckets write in place; the collapse's last CTA does not store rows
    past T*tile_v). Cases: R = nl*tile_v = 120 and 800 (no multiple of the
    64-row CTA tile), nl = 8 (Wildtrack: the collapse sums 2048 depths in
    one chain of tensor-core accumulators), flat bands with band % 16 == 8,
    and with `single_tile` each bucket cut to T = 1."""
    cfg = tiny_config(get_config(name), factor=4)
    rig = trig.build_rig(make_calibrations(cfg), cfg,
                         make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
                         trig.pyramid_feat_shapes(cfg.resize_size), tile_v=tile_v,
                         band_buckets=3, layout=layout, device=cuda)
    if layout == "flat":
        assert any(a.shape[-1] % 16 == 8 for sr in rig.scales for a in sr.A)
    gen = torch.Generator(device="cpu").manual_seed(60 + B)
    off_t = 2
    for sr in rig.scales:
        assert sr.nl == (8 if name == "Wildtrack" else 5)
        N = sr.A[0].shape[0]
        lat = torch.rand((B, N, *sr.feat_hw, 256), generator=gen).to(cuda)
        ii = trig.scale_features(lat, sr)
        Kr = (torch.randn((sr.nl, 256, 256), generator=gen) * 0.05).to(cuda)
        for bi, (A_b, s_b) in enumerate(zip(sr.A, sr.starts)):
            if single_tile:
                A_b, s_b = A_b[:, :1].contiguous(), s_b[:, :1].contiguous()
            T = A_b.shape[1]
            lo, hi = off_t * tile_v, (off_t + T) * tile_v
            out = torch.full((N, B, hi + tile_v, 256), float("nan"), device=cuda)
            if layout == "window":
                rig_window_fwd(ii, A_b, s_b, Kr, out, off_t=off_t, tile_v=tile_v,
                               window=sr.window_hw[bi])
                want = trig.window_tiles(ii, A_b, s_b, Kr, sr.window_hw[bi], tile_v)
            else:
                rig_flat_fwd(ii, A_b, s_b, Kr, out, off_t=off_t, tile_v=tile_v)
                want = trig.flat_tiles(ii, A_b, s_b, Kr, tile_v)
            torch.cuda.synchronize()
            np.testing.assert_allclose(out[:, :, lo:hi].cpu().numpy(),
                                       want.cpu().numpy(), rtol=1e-4,
                                       atol=1e-4 * float(want.abs().max()))
            assert torch.isnan(out[:, :, :lo]).all()
            assert torch.isnan(out[:, :, hi:]).all()


@pytest.mark.parametrize("layout", ["window", "flat"])
def test_bwd_kernels_dkr_same_bits_every_run(cuda, layout):
    """dKr is reduced in a fixed order (a workspace and a second stage, no
    atomics): two runs give the same bits. dII is added with atomics and is
    held to rounding only."""
    cfg = tiny_config(get_config("MultiviewC"), factor=4)
    rig = trig.build_rig(make_calibrations(cfg), cfg,
                         make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
                         trig.pyramid_feat_shapes(cfg.resize_size), tile_v=16,
                         band_buckets=3, layout=layout, device=cuda)
    sr = rig.scales[0]
    gen = torch.Generator(device="cpu").manual_seed(50)
    N = sr.A[0].shape[0]
    ii = trig.scale_features(
        torch.rand((2, N, *sr.feat_hw, 256), generator=gen).to(cuda), sr)
    Kr = (torch.randn((sr.nl, 256, 256), generator=gen) * 0.05).to(cuda)
    rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
    g = torch.randn((N, 2, rows, 256), generator=gen).to(cuda)
    first = rig_scale_bwd(ii, sr, Kr, g)
    second = rig_scale_bwd(ii, sr, Kr, g)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1])
    np.testing.assert_allclose(first[0].cpu().numpy(), second[0].cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * float(first[0].abs().max()))


def test_flat_kernel_rejects_bad_inputs(cuda):
    cfg = tiny_config(get_config("MultiviewC"))
    rig = trig.build_rig(make_calibrations(cfg), cfg,
                         make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
                         trig.pyramid_feat_shapes(cfg.resize_size), tile_v=16,
                         layout="flat", device=cuda)
    sr = rig.scales[0]
    lat = torch.zeros((1, 2, *sr.feat_hw, 256), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        rig_tiles_cuda(lat.half(), sr, torch.zeros((256 * sr.nl, 256), device=cuda))
    with pytest.raises(ValueError, match="C = n_out = 256"):
        rig_tiles_cuda(lat[..., :8], sr, torch.zeros((8 * sr.nl, 256), device=cuda))


def _stem_inputs(shape, seed, quantised, device):
    rng = np.random.default_rng(seed)
    M, C, H, W = shape
    x = rng.normal(size=shape).astype(np.float32)
    if quantised:
        x = np.round(x)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, C).astype(np.float32)
    if quantised:
        scale, bias = np.ones(C, np.float32), np.zeros(C, np.float32)
    g = rng.normal(size=(M, C, (H + 1) // 2, (W + 1) // 2)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, scale, bias, g)]


@pytest.mark.parametrize("shape", [(2, 64, 24, 32), (3, 64, 23, 37), (1, 32, 7, 10),
                                   (1, 64, 256, 48), (2, 64, 90, 130), (1, 16, 1, 5),
                                   (1, 64, 100, 640), (2, 32, 61, 260), (2, 32, 61, 261)],
                         ids=str)
def test_stem_kernels_match_plain(cuda, shape):
    """K6 and K7 against their plain versions on the same per-plane
    parameters, and the whole backward against autograd of the unfused
    chain. Tolerance: acc sums H*W terms in another order (1e-4 of the
    max); dx 1e-5 of the max (z is recomputed bit for bit, so no gradient
    moves to another pixel; the moment terms c1, c2 carry acc's rounding)."""
    x, scale, bias, g = _stem_inputs(shape, 3, False, cuda)
    groups = 16
    _, mu, rstd = tstem.group_norm_stats(x, scale, bias, groups, 1e-5)
    params = tstem.plane_params(mu, rstd, scale, bias)
    n0, n1 = tstem.stem_bwd_stats.launches, tstem.stem_bwd_dx.launches
    acc = tstem.stem_bwd_stats(x, g, params)
    torch.cuda.synchronize()
    want = tstem.stem_bwd_stats_plain(x, g, params)
    np.testing.assert_allclose(acc.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    c = torch.randn(mu.shape, generator=torch.Generator().manual_seed(1)).to(cuda) * 0.1
    params2 = tstem.plane_params(mu, rstd, scale, bias, c, -c)
    dx = tstem.stem_bwd_dx(x, g, params2)
    torch.cuda.synchronize()
    assert (tstem.stem_bwd_stats.launches, tstem.stem_bwd_dx.launches) == (n0 + 1, n1 + 1)
    want = tstem.stem_bwd_dx_plain(x, g, params2)
    np.testing.assert_allclose(dx.cpu().numpy(), want.cpu().numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    got = tstem.gn_relu_pool_bwd(x, scale, bias, g, mu, rstd)
    ref = tstem.gn_relu_pool_bwd_plain(x, scale, bias, g, groups)
    np.testing.assert_allclose(got[0].cpu().numpy(), ref[0].cpu().numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref[0].abs().max()))
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-3,
                                   atol=1e-3 * float(b.abs().max()))


@pytest.mark.parametrize("shape", [(2, 64, 16, 16), (1, 64, 33, 47)], ids=str)
def test_stem_kernels_tie_positions_exact(cuda, shape):
    """Integer inputs, scale 1, bias 0: many ReLU zeros and equal maxima.
    The zero pattern of dx must be identical to the plain backward's."""
    x, scale, bias, g = _stem_inputs(shape, 3, True, cuda)
    _, mu, rstd = tstem.group_norm_stats(x, scale, bias, 16, 1e-5)
    got = tstem.gn_relu_pool_bwd(x, scale, bias, g, mu, rstd)[0]
    want = tstem.gn_relu_pool_bwd_plain(x, scale, bias, g)[0]
    assert torch.equal(got == 0, want == 0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    # through the autograd function, as the backbone calls it
    xa = x.clone().requires_grad_()
    tstem.gn_relu_pool(xa, scale, bias).backward(g)
    assert torch.equal(xa.grad == 0, want == 0)
    # the routing itself: with c1 = c2 = 0 the dx kernel gives rstd*scale*dz,
    # zero exactly where dz is; against autograd on the forward's own z
    z = torch.nn.functional.group_norm(x, 16, scale, bias, 1e-5).requires_grad_()
    y = torch.nn.functional.max_pool2d(torch.relu(z), 3, 2, 1)
    (dz_ref,) = torch.autograd.grad(y, z, g)
    dz = tstem.stem_bwd_dx(x, g, tstem.plane_params(mu, rstd, scale, bias))
    assert 0.5 < float((dz_ref == 0).float().mean()) < 1.0
    assert torch.equal(dz == 0, dz_ref == 0)


def test_stem_kernel_rejects_bad_inputs(cuda):
    x, scale, bias, g = _stem_inputs((1, 64, 8, 8), 0, False, cuda)
    _, mu, rstd = tstem.group_norm_stats(x, scale, bias, 16, 1e-5)
    params = tstem.plane_params(mu, rstd, scale, bias)
    with pytest.raises(TypeError, match="float32"):
        tstem.stem_bwd_stats(x.double(), g, params)
    with pytest.raises(ValueError, match="shape"):
        tstem.stem_bwd_dx(x, g[:, :, :3], params)
    with pytest.raises(ValueError, match="contiguous"):
        tstem.stem_bwd_dx(x.transpose(2, 3), g, params)


@pytest.mark.parametrize("shape", [(1, 64, 102, 640), (2, 32, 61, 260), (1, 16, 23, 256)],
                         ids=str)
def test_stem_kernels_paths_and_bits(cuda, shape):
    """Planes of 51, 31 and 12 window rows: strips of 5 with boundaries at
    odd and even window rows and a short last strip. acc has the same bits
    in two runs and stays within 1e-4 of the plain version's max; on planes
    that are not 16-byte aligned (the scalar path) dx and acc have the same
    bits as on the 16-byte path."""
    x, scale, bias, g = _stem_inputs(shape, 4, False, cuda)
    _, mu, rstd = tstem.group_norm_stats(x, scale, bias, 16, 1e-5)
    c = torch.randn(mu.shape, generator=torch.Generator().manual_seed(2)).to(cuda) * 0.1
    params = tstem.plane_params(mu, rstd, scale, bias, c, -c)
    acc = tstem.stem_bwd_stats(x, g, params)
    assert torch.equal(acc, tstem.stem_bwd_stats(x, g, params))
    want = tstem.stem_bwd_stats_plain(x, g, params)
    np.testing.assert_allclose(acc.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    dx = tstem.stem_bwd_dx(x, g, params)
    np.testing.assert_allclose(dx.cpu().numpy(),
                               tstem.stem_bwd_dx_plain(x, g, params).cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * float(dx.abs().max()))
    # the same values one float into a buffer: every plane off 16-byte alignment
    x_off = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    x_off.copy_(x)
    assert x_off.data_ptr() % 16 and x_off.is_contiguous()
    assert torch.equal(tstem.stem_bwd_dx(x_off, g, params), dx)
    assert torch.equal(tstem.stem_bwd_stats(x_off, g, params), acc)


@pytest.mark.parametrize("bias_value", [0.25, -0.25])
@pytest.mark.parametrize("shape", [(1, 16, 9, 12), (1, 16, 10, 11)], ids=str)
def test_stem_kernels_constant_plane(cuda, shape, bias_value):
    """x constant in every plane: every window is tied, and the windows on
    the image's edge also hold padding. With bias > 0 each window's dy goes
    to its first pixel inside the image (never to padding); with bias < 0
    nothing passes the ReLU and dz is 0 everywhere."""
    M, C, H, W = shape
    x = torch.full(shape, 0.7, device=cuda)
    scale = torch.ones(C, device=cuda)
    bias = torch.full((C,), bias_value, device=cuda)
    g = torch.randn((M, C, (H + 1) // 2, (W + 1) // 2),
                    generator=torch.Generator().manual_seed(3)).to(cuda)
    _, mu, rstd = tstem.group_norm_stats(x, scale, bias, 16, 1e-5)
    params = tstem.plane_params(mu, rstd, scale, bias)
    dz = tstem.stem_bwd_dx(x, g, params)
    want = tstem.stem_bwd_dx_plain(x, g, params)
    assert torch.equal(dz == 0, want == 0)
    np.testing.assert_allclose(dz.cpu().numpy(), want.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)
    z = torch.nn.functional.group_norm(x, 16, scale, bias, 1e-5).requires_grad_()
    y = torch.nn.functional.max_pool2d(torch.relu(z), 3, 2, 1)
    (dz_ref,) = torch.autograd.grad(y, z, g)
    assert torch.equal(dz == 0, dz_ref == 0)
    if bias_value < 0:
        assert not dz.any()
    else:   # window (oh, ow)'s first pixel inside the image
        rows = torch.clamp(2 * torch.arange(g.shape[2]) - 1, min=0)
        cols = torch.clamp(2 * torch.arange(g.shape[3]) - 1, min=0)
        hit = torch.zeros((H, W), dtype=torch.bool)
        hit[rows[:, None], cols[None, :]] = True
        assert torch.equal(dz[0, 0].cpu() != 0, hit)
    acc = tstem.stem_bwd_stats(x, g, params)
    ref = tstem.stem_bwd_stats_plain(x, g, params)
    np.testing.assert_allclose(acc.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * max(float(ref.abs().max()), 1e-30))


def _window_bucket(N, B, T, window, Hp, Wp, seed, device, nl=8, tile_v=24):
    """A synthetic window bucket at the 2D configs' widths (nl 8, tile_v 24:
    192-row tiles): dense random A (N, T, nl*tile_v, wh*ww), random window
    origins inside the (Hp, Wp) padded image, features, Kr and the
    cotangent of a (T + 1)-tile buffer."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    wh, ww = window
    A = torch.rand((N, T, nl * tile_v, wh * ww), generator=gen) / (wh * ww)
    starts = torch.stack([torch.randint(0, Hp - wh + 1, (N, T), generator=gen),
                          torch.randint(0, Wp - ww + 1, (N, T), generator=gen)], -1)
    ii = torch.rand((N, B, Hp, Wp, 256), generator=gen)
    Kr = torch.randn((nl, 256, 256), generator=gen) * 0.05
    g = torch.randn((N, B, (T + 1) * tile_v, 256), generator=gen)
    return [t.to(device) for t in (A, starts.to(torch.int32), ii, Kr, g)]


@pytest.mark.parametrize("T", [1, 5], ids=["one_tile", "five_tiles"])
@pytest.mark.parametrize("window", [(8, 16), (16, 16)], ids=["band128", "band256"])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_window_kernels_2d_config_widths(cuda, window, T, B):
    """K1 and K2/K3 at the widths of the full MultiviewX and Wildtrack rigs:
    nl 8 and tile_v 24 (192-row tiles, a 2048-deep collapse chain, dKr
    chains split at DKR_CHAIN twice), 128- and 256-wide windows, a bucket of
    one tile and one of five, at tile offset 1; within 1e-4 of the plain
    versions' max."""
    tile_v = 24
    A, starts, ii, Kr, g = _window_bucket(3, B, T, window, 24, 48, 70 + B, cuda)
    out = torch.full((3, B, (T + 1) * tile_v, 256), float("nan"), device=cuda)
    rig_window_fwd(ii, A, starts, Kr, out, off_t=1, tile_v=tile_v, window=window)
    want = trig.window_tiles(ii, A, starts, Kr, window, tile_v)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out[:, :, tile_v:].cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    assert torch.isnan(out[:, :, :tile_v]).all()
    dII, dKr = torch.zeros_like(ii), torch.zeros_like(Kr)
    rig_window_bwd(ii, A, starts, Kr, g, dII, dKr, off_t=1, tile_v=tile_v,
                   window=window)
    want = trig.window_tiles_bwd(ii, A, starts, Kr, g[:, :, tile_v:], window, tile_v)
    torch.cuda.synchronize()
    for got, ref in zip((dII, dKr), want):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_window_kernels_vox_scratch_past_2_31_elements(cuda, backward):
    """A launch whose (N, B, T, nl*tile_v, C) vox scratch holds more than
    2^31 elements (2 x 16 x 1400 x 192 x 256 = 2.2e9; 8.8 GB): offsets
    past int32 must not wrap. Every scene's rows against the plain
    version, the last scene's alone too (its vox rows lie past 2^31)."""
    N, B, T, tile_v, window = 2, 16, 1400, 24, (1, 16)
    assert N * B * T * 8 * tile_v * 256 > 2 ** 31
    A, starts, ii, Kr, g = _window_bucket(N, B, T, window, 8, 32, 90, cuda)
    if not backward:
        out = torch.empty((N, B, (T + 1) * tile_v, 256), device=cuda)
        rig_window_fwd(ii, A, starts, Kr, out, off_t=1, tile_v=tile_v, window=window)
        got = [out[:, :, tile_v:]]
        del out
        want = [trig.window_tiles(ii, A, starts, Kr, window, tile_v)]
    else:
        dII, dKr = torch.zeros_like(ii), torch.zeros_like(Kr)
        rig_window_bwd(ii, A, starts, Kr, g, dII, dKr, off_t=1, tile_v=tile_v,
                       window=window)
        got = [dII, dKr]
        want = trig.window_tiles_bwd(ii, A, starts, Kr, g[:, :, tile_v:], window,
                                     tile_v)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        tol = 1e-4 * float(b.abs().max())
        assert float((a - b).abs().max()) <= tol
        if a.dim() == 5 or a.dim() == 4:
            assert float((a[-1, -1] - b[-1, -1]).abs().max()) <= tol


# bf16 variants of K1 / K4. Tolerance: max abs err <= 1e-2 of the plain
# result's max and rel-L2 <= 4e-3. Both sides round vox and the tiles to
# bf16 at the same points (`ops/rig._tiles_fwd`); the kernel sums in
# another order, which flips a rounding by about one bf16 ulp (2^-8
# relative) here and there.
BF16_MAX, BF16_L2 = 1e-2, 4e-3


def assert_bf16_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if not want.abs().max() > 0:
        # an empty bucket (a flat rig's 8-pixel bands): exact zeros
        assert not got.abs().max() > 0
        return
    err = float((got - want).abs().max())
    assert err <= BF16_MAX * float(want.abs().max()), err
    rel_l2 = float(torch.linalg.vector_norm(got - want)
                   / torch.linalg.vector_norm(want))
    assert rel_l2 <= BF16_L2, rel_l2


def _bf16_inputs(sr, B, seed, device):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    N = sr.A[0].shape[0]
    lat = torch.rand((B, N, *sr.feat_hw, 256), generator=gen)
    k = torch.randn((256 * sr.nl, 256), generator=gen) * 0.05
    return (lat.to(device=device, dtype=torch.bfloat16),
            k.to(device=device, dtype=torch.bfloat16))


def _bf16_rig(name, tile_v, buckets, layout, device, factor=4):
    cfg = tiny_config(get_config(name), factor=factor)
    return trig.build_rig(make_calibrations(cfg), cfg,
                          make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
                          trig.pyramid_feat_shapes(cfg.resize_size),
                          tile_v=tile_v, band_buckets=buckets, layout=layout,
                          dtype=torch.bfloat16, device=device)


@pytest.mark.parametrize("layout,name,tile_v,buckets",
                         [("window", "MultiviewC", 16, 3),
                          ("window", "MultiviewC", 160, 3),
                          ("window", "Wildtrack", 64, 3),
                          ("flat", "MultiviewC", 16, 3),
                          ("flat", "MultiviewC", 160, 3),
                          ("flat", "Wildtrack", 16, 3)],
                         ids=["window-tv16", "window-R800", "window-nl8",
                              "flat-band8", "flat-R800", "flat-nl8"])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_bf16_fwd_kernels_match_plain(cuda, layout, name, tile_v, buckets, B):
    """The bf16 K1 / K4 on every bucket of bf16 rigs against the plain
    version in bf16, and the whole scale's output (epilogue and camera sum)
    against `rig_sample_scale`. R = nl*tile_v = 800 is no multiple of the
    64-row CTA tile; nl 8 gives a 2048-deep collapse chain; the flat rigs
    hold bands with band % 16 == 8. Both forwards count one launch a scale;
    only the bf16 counts move."""
    from vfa_tpu_torch.ops.rig_cuda import rig_flat_fwd_bf16, rig_window_fwd_bf16

    rig = _bf16_rig(name, tile_v, buckets, layout, cuda)
    if layout == "flat" and tile_v == 16:
        assert any(a.shape[-1] % 16 == 8 for sr in rig.scales for a in sr.A)
    count = rig_window_fwd_bf16 if layout == "window" else rig_flat_fwd_bf16
    for si, sr in enumerate(rig.scales):
        assert all(a.dtype == torch.bfloat16 for a in sr.A)
        lat, k = _bf16_inputs(sr, B, 80 + 10 * B + si, cuda)
        n0 = count.launches
        f32 = (rig_window_fwd.launches, rig_flat_fwd.launches)
        got = rig_tiles_cuda(lat, sr, k)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        # one launch per scale over all its buckets
        assert count.launches == n0 + 1
        assert (rig_window_fwd.launches, rig_flat_fwd.launches) == f32
        want = trig.scale_tiles(trig.scale_features(lat, sr), sr,
                                trig.collapse_per_layer(k, 256, sr.nl, lat.dtype))
        off = 0
        for A_b in sr.A:
            rows = slice(off, off + A_b.shape[1] * sr.tile_v)
            assert_bf16_close(got[:, :, rows], want[:, :, rows])
            off = rows.stop
        b = torch.randn((256,), generator=torch.Generator().manual_seed(si)).to(
            device=cuda, dtype=torch.bfloat16)
        full = rig_sample_scale_cuda(lat, sr, k, b, out_dtype=torch.float32,
                                     camera_sum=True)
        assert_bf16_close(full, trig.rig_sample_scale(
            lat, sr, k, b, out_dtype=torch.float32, camera_sum=True))


@pytest.mark.parametrize("layout", ["window", "flat"])
def test_bf16_fwd_kernels_write_in_place(cuda, layout):
    """Each bucket of a bf16 rig into a NaN-filled bf16 `out` at tile
    offset 2: the launch's rows as the plain version's, every other row
    still NaN."""
    rig = _bf16_rig("MultiviewC", 160 if layout == "flat" else 16, 3, layout, cuda)
    off_t = 2
    for si, sr in enumerate(rig.scales):
        lat, k = _bf16_inputs(sr, 2, 95 + si, cuda)
        ii = trig.scale_features(lat, sr)
        Kr = trig.collapse_per_layer(k, 256, sr.nl, torch.bfloat16)
        for bi, (A_b, s_b) in enumerate(zip(sr.A, sr.starts)):
            T, tile_v = A_b.shape[1], sr.tile_v
            lo, hi = off_t * tile_v, (off_t + T) * tile_v
            out = torch.full((A_b.shape[0], 2, hi + tile_v, 256), float("nan"),
                             dtype=torch.bfloat16, device=cuda)
            if layout == "window":
                rig_window_fwd(ii, A_b, s_b, Kr, out, off_t=off_t, tile_v=tile_v,
                               window=sr.window_hw[bi])
                want = trig.window_tiles(ii, A_b, s_b, Kr, sr.window_hw[bi], tile_v)
            else:
                rig_flat_fwd(ii, A_b, s_b, Kr, out, off_t=off_t, tile_v=tile_v)
                want = trig.flat_tiles(ii, A_b, s_b, Kr, tile_v)
            torch.cuda.synchronize()
            assert_bf16_close(out[:, :, lo:hi], want)
            assert torch.isnan(out[:, :, :lo]).all()
            assert torch.isnan(out[:, :, hi:]).all()


def test_bf16_kernels_refuse_mixed_dtypes_and_backward(cuda):
    """A bf16 forward takes bf16 only (no fp32 / bf16 mixing); so does a
    bf16 backward, but for its dKr accumulator, which must be float32, and
    it takes a tile_v that is a multiple of 8 only."""
    rig = _bf16_rig("MultiviewC", 16, 3, "window", cuda)
    sr = rig.scales[0]
    lat, k = _bf16_inputs(sr, 1, 5, cuda)
    with pytest.raises(TypeError, match="no mixing"):
        rig_tiles_cuda(lat.float(), sr, k.float())
    ii = trig.pad_features(lat)
    Kr = trig.collapse_per_layer(k, 256, sr.nl, torch.bfloat16)
    rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
    out = torch.empty((2, 1, rows, 256), device=cuda)
    with pytest.raises(TypeError, match="no mixing"):
        rig_window_fwd(ii, sr.A[0], sr.starts[0], Kr, out, off_t=0,
                       tile_v=sr.tile_v, window=sr.window_hw[0])
    g = torch.zeros((2, 1, rows, 256), device=cuda, dtype=torch.bfloat16)
    kw = dict(off_t=0, tile_v=sr.tile_v, window=sr.window_hw[0])
    dKr = torch.zeros(Kr.shape, device=cuda)
    with pytest.raises(TypeError, match="no mixing"):
        rig_window_bwd(ii, sr.A[0], sr.starts[0], Kr, g, torch.zeros_like(ii).float(),
                       dKr, **kw)
    with pytest.raises(TypeError, match="dKr accumulator must be float32"):
        rig_window_bwd(ii, sr.A[0], sr.starts[0], Kr, g, torch.zeros_like(ii),
                       torch.zeros_like(Kr), **kw)
    A12 = sr.A[0][:, :, :sr.nl * 12].contiguous()
    with pytest.raises(ValueError, match="multiple of 8"):
        rig_window_bwd(ii, A12, sr.starts[0], Kr, g, torch.zeros_like(ii), dKr,
                       off_t=0, tile_v=12, window=sr.window_hw[0])


def test_bf16_flat_kernels_refuse_what_they_cannot_take(cuda):
    """No fallback on the flat bf16 path: a band that is no multiple of 8
    raises in the forward and the backward, and so does a scale of more
    than MAX_BUCKETS buckets in the one-launch forward."""
    import dataclasses

    from vfa_tpu_torch.ops.rig_cuda import MAX_BUCKETS, rig_flat_fwd_bf16

    sr = _bf16_rig("MultiviewC", 16, 3, "flat", cuda).scales[0]
    lat, k = _bf16_inputs(sr, 1, 6, cuda)
    ii = trig.scale_features(lat, sr)
    Kr = trig.collapse_per_layer(k, 256, sr.nl, torch.bfloat16)
    A_b, s_b = sr.A[-1], sr.starts[-1]
    A4 = A_b[..., :A_b.shape[-1] - 4].contiguous()
    rows = A_b.shape[1] * sr.tile_v
    out = torch.zeros((A_b.shape[0], 1, rows, 256), device=cuda,
                      dtype=torch.bfloat16)
    n0 = rig_flat_fwd_bf16.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        rig_flat_fwd(ii, A4, s_b, Kr, out, off_t=0, tile_v=sr.tile_v)
    with pytest.raises(ValueError, match="multiple of 8"):
        rig_flat_bwd(ii, A4, s_b, Kr, out, torch.zeros_like(ii),
                     torch.zeros(Kr.shape, device=cuda), off_t=0,
                     tile_v=sr.tile_v)
    many = dataclasses.replace(sr, A=(A_b,) * (MAX_BUCKETS + 1),
                               starts=(s_b,) * (MAX_BUCKETS + 1), dii_order=())
    with pytest.raises(ValueError, match=f"at most {MAX_BUCKETS} buckets"):
        rig_tiles_cuda(lat, many, k)
    assert rig_flat_fwd_bf16.launches == n0


def _plain_scale_bwd(ii, sr, Kr, g):
    """(dII, dKr) of all buckets of a scale through the plain backward, one
    dII threaded through them (in ii's dtype)."""
    dII, dKr, off = None, torch.zeros(Kr.shape, device=ii.device), 0
    for bi, (A_b, s_b) in enumerate(zip(sr.A, sr.starts)):
        g_b = g[:, :, off:off + A_b.shape[1] * sr.tile_v]
        if sr.window_hw:
            dII, d = trig.window_tiles_bwd(ii, A_b, s_b, Kr, g_b,
                                           sr.window_hw[bi], sr.tile_v, dII=dII)
        else:
            dII, d = trig.flat_tiles_bwd(ii, A_b, s_b, Kr, g_b, sr.tile_v, dII=dII)
        dKr += d
        off += A_b.shape[1] * sr.tile_v
    return dII, dKr


@pytest.mark.parametrize("layout,name,tile_v,buckets",
                         [("window", "MultiviewC", 16, 3),
                          ("window", "MultiviewC", 160, 3),
                          ("window", "Wildtrack", 64, 3),
                          ("flat", "MultiviewC", 16, 3),
                          ("flat", "MultiviewC", 160, 3),
                          ("flat", "Wildtrack", 16, 3)],
                         ids=["window-tv16", "window-R800", "window-nl8",
                              "flat-band8", "flat-R800", "flat-nl8"])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_bf16_bwd_kernels_match_plain(cuda, layout, name, tile_v, buckets, B):
    """The bf16 K2/K3 / K5 on every bucket of bf16 rigs (one bf16 dII
    threaded through them) against the plain version in bf16. Both keep vox
    and dvox in fp32 and round dII at JAX's points (per window, or per
    layer where JAX's window backward is serial: every bucket at B = 1);
    the kernel carries the fp32 operand as hi + lo bf16. dKr (fp32 sums)
    within 1e-2 of the plain max and rel-L2 4e-3. Both kernels add dII in
    the plain version's order (`ops/rig.window_dii_index`,
    `flat_dii_index`): dII within the same bounds, and the same bits on a
    second run. Then the autograd function's backward runs the kernels.
    Only the bf16 counts move."""
    from vfa_tpu_torch.ops.rig_cuda import rig_flat_bwd_bf16, rig_window_bwd_bf16

    rig = _bf16_rig(name, tile_v, buckets, layout, cuda)
    count = rig_window_bwd_bf16 if layout == "window" else rig_flat_bwd_bf16
    for si, sr in enumerate(rig.scales):
        lat, k = _bf16_inputs(sr, B, 140 + 10 * B + si, cuda)
        ii = trig.scale_features(lat, sr)
        Kr = trig.collapse_per_layer(k, 256, sr.nl, torch.bfloat16)
        rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
        g = torch.randn((ii.shape[0], B, rows, 256),
                        generator=torch.Generator().manual_seed(si)).to(
            device=cuda, dtype=torch.bfloat16)
        n0 = count.launches
        f32 = (rig_window_bwd.launches, rig_flat_bwd.launches)
        dII, dKr = rig_scale_bwd(ii, sr, Kr, g)
        torch.cuda.synchronize()
        assert dII.dtype == torch.bfloat16 and dKr.dtype == torch.bfloat16
        assert count.launches == n0 + len(sr.A)
        assert (rig_window_bwd.launches, rig_flat_bwd.launches) == f32
        want_dII, want_dKr = _plain_scale_bwd(ii, sr, Kr, g)
        assert_bf16_close(dII, want_dII)
        assert torch.equal(rig_scale_bwd(ii, sr, Kr, g)[0], dII)
        n0 += len(sr.A)
        assert_bf16_close(dKr, want_dKr)
        la, ka = lat.clone().requires_grad_(), k.clone().requires_grad_()
        rig_tiles_cuda(la, sr, ka).backward(g)
        assert la.grad.dtype == torch.bfloat16 and torch.isfinite(la.grad.float()).all()
        assert count.launches == n0 + 2 * len(sr.A)


def test_bf16_full_multiviewc_window_rig_every_bucket(cuda):
    """Every bucket of the full bf16 MultiviewC serving rig (the 12-bucket
    policy, tile_v 160, R = 800) at batch 2 through one grouped launch a
    scale against the per-bucket plain tiles."""
    from vfa_tpu_torch.ops.rig_cuda import rig_window_fwd_bf16
    from vfa_tpu_torch.rig_cli import build_cli_rig

    cfg = get_config("MultiviewC")
    rig = build_cli_rig(cfg, make_calibrations(cfg), cuda, dtype=torch.bfloat16)
    for si, sr in enumerate(rig.scales):
        assert sr.tile_v == 160 and sr.A[0].shape[2] == 800
        lat, k = _bf16_inputs(sr, 2, 120 + si, cuda)
        n0 = rig_window_fwd_bf16.launches
        got = rig_tiles_cuda(lat, sr, k)
        assert rig_window_fwd_bf16.launches == n0 + 1
        want = trig.scale_tiles(trig.scale_features(lat, sr), sr,
                                trig.collapse_per_layer(k, 256, sr.nl, lat.dtype))
        torch.cuda.synchronize()
        off = 0
        for A_b in sr.A:
            rows = slice(off, off + A_b.shape[1] * sr.tile_v)
            assert_bf16_close(got[:, :, rows], want[:, :, rows])
            off = rows.stop
        del got, want


@pytest.mark.parametrize("B", [1, 2])
def test_bf16_window_bwd_full_training_rig_every_bucket(cuda, B):
    """K2-bf16 / K3-bf16 on every bucket of the full bf16 MultiviewC
    training rig (8-bucket policy, tile_v 160, R = 800), each bucket into a
    zeroed dII, against the plain bf16 backward: dII and dKr within 1e-2 of
    the plain max and rel-L2 4e-3 (the same rounding points in the same
    order: JAX's serial rounding on scale 0 buckets 6 and 7 at every B and
    on every bucket at B = 1), and dII with the same bits on a second run."""
    from vfa_tpu_torch.rig_cli import build_cli_rig

    cfg = get_config("MultiviewC")
    rig = build_cli_rig(cfg, make_calibrations(cfg), cuda, training=True,
                        dtype=torch.bfloat16)
    serial = []
    for si, sr in enumerate(rig.scales):
        lat, k = _bf16_inputs(sr, B, 160 + si, cuda)
        ii = trig.scale_features(lat, sr)
        Kr = trig.collapse_per_layer(k, 256, sr.nl, torch.bfloat16)
        gen = torch.Generator().manual_seed(170 + si)
        off = 0
        for bi, (A_b, s_b) in enumerate(zip(sr.A, sr.starts)):
            T, R, K = A_b.shape[1:]
            serial.append(trig.window_bwd_serial(B, K, R, 2, 2, 256))
            g = (torch.randn((A_b.shape[0], B, (off + T) * sr.tile_v, 256),
                             generator=gen) * 0.1).to(cuda, torch.bfloat16)
            runs = []
            for _ in range(2):
                dII = torch.zeros_like(ii)
                dKr = torch.zeros(Kr.shape, device=cuda)
                rig_window_bwd(ii, A_b, s_b, Kr, g, dII, dKr, off_t=off,
                               tile_v=sr.tile_v, window=sr.window_hw[bi])
                runs.append((dII, dKr))
            want_dII, want_dKr = trig.window_tiles_bwd(
                ii, A_b, s_b, Kr, g[:, :, off * sr.tile_v:], sr.window_hw[bi],
                sr.tile_v)
            torch.cuda.synchronize()
            assert torch.equal(runs[0][0], runs[1][0])
            assert_bf16_close(runs[0][0], want_dII)
            assert_bf16_close(runs[0][1], want_dKr)
            off += T
            del runs, want_dII, want_dKr, g
    if B == 1:
        assert all(serial)
    else:
        assert serial[6] and serial[7] and sum(serial) == 2, serial


def test_bf16_flat_full_multiviewc_rig_every_scale(cuda):
    """K4-bf16 and K5-bf16 on the full MultiviewC flat rig (8-bucket
    training policy, tile_v 160) cast to bf16, every scale at B = 1 and 2:
    the forward one launch a scale, each bucket's tiles within 1e-2 of the
    plain max and rel-L2 4e-3; the backward's dII and dKr, all buckets
    through one dII, within the same bounds of the plain backward (JAX's
    order and rounding points: one rounding per band add, bucket by bucket,
    tile by tile), and dII with the same bits on a second run. The rig
    holds bands that are 8 (mod 16) and 8-pixel buckets of empty tiles."""
    from vfa_tpu_torch.ops.rig_cuda import rig_flat_bwd_bf16, rig_flat_fwd_bf16
    from vfa_tpu_torch.rig_cli import build_cli_rig

    cfg = get_config("MultiviewC")
    rig = build_cli_rig(cfg, make_calibrations(cfg), cuda, training=True,
                        layout="flat", dtype=torch.bfloat16)
    bands = [a.shape[-1] for sr in rig.scales for a in sr.A]
    assert any(b % 16 == 8 and b > 8 for b in bands) and 8 in bands
    for B in (1, 2):
        for si, sr in enumerate(rig.scales):
            assert sr.tile_v == 160 and sr.A[0].dtype == torch.bfloat16
            lat, k = _bf16_inputs(sr, B, 180 + 10 * B + si, cuda)
            n0 = rig_flat_fwd_bf16.launches
            got = rig_tiles_cuda(lat, sr, k)
            assert rig_flat_fwd_bf16.launches == n0 + 1
            ii = trig.scale_features(lat, sr)
            Kr = trig.collapse_per_layer(k, 256, sr.nl, torch.bfloat16)
            want = trig.scale_tiles(ii, sr, Kr)
            torch.cuda.synchronize()
            off = 0
            for A_b in sr.A:
                rows = slice(off, off + A_b.shape[1] * sr.tile_v)
                assert_bf16_close(got[:, :, rows], want[:, :, rows])
                off = rows.stop
            del got, want
            g = (torch.randn((ii.shape[0], B, off, 256),
                             generator=torch.Generator().manual_seed(190 + si))
                 * 0.1).to(cuda, torch.bfloat16)
            n0 = rig_flat_bwd_bf16.launches
            dII, dKr = rig_scale_bwd(ii, sr, Kr, g)
            again = rig_scale_bwd(ii, sr, Kr, g)[0]
            assert rig_flat_bwd_bf16.launches == n0 + 2 * len(sr.A)
            want_dII, want_dKr = _plain_scale_bwd(ii, sr, Kr, g)
            torch.cuda.synchronize()
            assert torch.equal(again, dII)
            assert_bf16_close(dII, want_dII)
            assert_bf16_close(dKr, want_dKr)
            del dII, dKr, again, want_dII, want_dKr, g


def test_stem_fp32_recompute_equals_forward_full_size(cuda):
    """F3: on fp32 the stem kernels' recomputed z (`recompute_z`, the
    kernels' rounding) equals the z that CUDA's GroupNorm returns, the fused
    stem's forward, on every element of the full stem (14, 64, 360, 640) of
    random input; and the fp32 kernels, routing on it, match their plain
    versions there."""
    gen = torch.Generator().manual_seed(0)
    shape = (14, 64, 360, 640)
    x = torch.randn(shape, generator=gen).to(cuda)
    s = (torch.rand(64, generator=gen) + 0.5).to(cuda)
    b = (torch.rand(64, generator=gen) - 0.5).to(cuda)
    z, mu, rstd = tstem.group_norm_stats(x, s, b, 16, 1e-5)
    params = tstem.plane_params(mu, rstd, s, b)
    assert int((tstem.recompute_z(x, params) != z).sum()) == 0
    del z
    dy = torch.randn((14, 64, 180, 320), generator=gen).to(cuda)
    acc = tstem.stem_bwd_stats(x, dy, params)
    ref = tstem.stem_bwd_stats_plain(x, dy, params)
    np.testing.assert_allclose(acc.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("B", [1, 8])
def test_bf16_window_kernel_2d_widths_and_past_2_31(cuda, B):
    """The bf16 K1 at the widths of the bf16 MultiviewX / Wildtrack rigs
    (nl 8, tile_v 64: 512-row tiles, a 2048-deep collapse chain), 256-wide
    windows; at B = 8 the launch's vox scratch (2 x 8 x 1100 x 512 x 256 =
    2.3e9 elements) passes 2^31, as the full MultiviewX rig's largest bucket
    does at batch 8: the last scene's rows alone too."""
    N, T, tile_v, window = 2, (1100 if B == 8 else 5), 64, (16, 16)
    if B == 8:
        assert N * B * T * 8 * tile_v * 256 > 2 ** 31
    A, starts, ii, Kr, _ = _window_bucket(N, B, T, window, 24, 48, 130 + B, cuda,
                                          tile_v=tile_v)
    A, ii, Kr = (t.to(torch.bfloat16) for t in (A, ii, Kr))
    out = torch.full((N, B, (T + 1) * tile_v, 256), float("nan"),
                     dtype=torch.bfloat16, device=cuda)
    rig_window_fwd(ii, A, starts, Kr, out, off_t=1, tile_v=tile_v, window=window)
    got = out[:, :, tile_v:]
    want = trig.window_tiles(ii, A, starts, Kr, window, tile_v)
    torch.cuda.synchronize()
    assert torch.isnan(out[:, :, :tile_v]).all()
    assert_bf16_close(got, want)
    assert_bf16_close(got[-1, -1], want[-1, -1])


@pytest.mark.parametrize("quantised", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("shape", [(2, 64, 24, 32), (1, 64, 100, 640),
                                   (2, 32, 61, 260), (1, 16, 9, 12),
                                   (1, 16, 7, 4), (1, 32, 33, 132),
                                   (1, 16, 125, 500)], ids=str)
def test_bf16_stem_kernels_match_plain(cuda, shape, quantised):
    """K6 and K7 on bf16 x and dy against their plain versions on the same
    parameters: both round z to bf16 before the ReLU and the comparisons and
    round dz at the same points, so no gradient moves to another pixel
    (the zero patterns of dx are equal); acc sums in another order (1e-4 of
    its max), dx is fp32 arithmetic rounded once to bf16 (1e-2 of the max,
    rel-L2 4e-3: a one-ulp flip where the fp32 values differ in their last
    bits). On integer-valued input with scale 1, bias 0 ties decide; only
    the bf16 counts move. The widths reach the bf16 items' edges (240
    columns, lanes of 8): W = 4, one segment with W % 8 == 4 (132), a
    ragged second segment (260) and third (500, with 63 window rows: strips
    of 30 for the stats kernel, of 6 for the dx kernel, each with a short
    last one), and 640 (segments 240, 240, 160)."""
    x, scale, bias, g = _stem_inputs(shape, 7, quantised, cuda)
    x, scale, bias, g = (t.to(torch.bfloat16) for t in (x, scale, bias, g))
    z, mu, rstd = tstem.group_norm_stats(x, scale, bias, 16, 1e-5)
    params = tstem.plane_params(mu, rstd, scale, bias)
    # the kernels' z is the forward's, bit for bit (CUDA's bf16 GroupNorm
    # normalises with its bf16-rounded statistics)
    assert torch.equal(tstem.recompute_z(x, params), z)
    n = (tstem.stem_bwd_stats_bf16.launches, tstem.stem_bwd_dx_bf16.launches,
         tstem.stem_bwd_stats.launches, tstem.stem_bwd_dx.launches)
    acc = tstem.stem_bwd_stats(x, g, params)
    torch.cuda.synchronize()
    want = tstem.stem_bwd_stats_plain(x, g, params)
    np.testing.assert_allclose(acc.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    c = torch.randn(mu.shape, generator=torch.Generator().manual_seed(1)).to(cuda) * 0.1
    params2 = tstem.plane_params(mu, rstd, scale, bias, c, -c)
    dx = tstem.stem_bwd_dx(x, g, params2)
    torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16
    want = tstem.stem_bwd_dx_plain(x, g, params2)
    assert_bf16_close(dx, want)
    dz = tstem.stem_bwd_dx(x, g, params)
    dz_want = tstem.stem_bwd_dx_plain(x, g, params)
    assert torch.equal(dz == 0, dz_want == 0)
    assert (tstem.stem_bwd_stats_bf16.launches, tstem.stem_bwd_dx_bf16.launches,
            tstem.stem_bwd_stats.launches, tstem.stem_bwd_dx.launches) == (
        n[0] + 1, n[1] + 2, n[2], n[3])
    xa = x.clone().requires_grad_()
    tstem.gn_relu_pool(xa, scale, bias).backward(g)
    assert xa.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(1, 64, 100, 640), (2, 32, 61, 260),
                                   (1, 16, 45, 496)], ids=str)
def test_bf16_stem_kernels_paths_and_bits(cuda, shape):
    """The bf16 acc has the same bits in two runs and stays within 1e-4 of
    the plain version's max; on planes that are 8- but not 16-byte aligned
    (two 8-byte copies a lane instead of one of 16) dx and acc have the
    same bits as on the 16-byte path where W % 8 == 0."""
    x, scale, bias, g = _stem_inputs(shape, 4, False, cuda)
    x, scale, bias, g = (t.to(torch.bfloat16) for t in (x, scale, bias, g))
    _, mu, rstd = tstem.group_norm_stats(x, scale, bias, 16, 1e-5)
    c = torch.randn(mu.shape, generator=torch.Generator().manual_seed(2)).to(cuda) * 0.1
    params = tstem.plane_params(mu, rstd, scale, bias, c, -c)
    acc = tstem.stem_bwd_stats(x, g, params)
    assert torch.equal(acc, tstem.stem_bwd_stats(x, g, params))
    want = tstem.stem_bwd_stats_plain(x, g, params)
    np.testing.assert_allclose(acc.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    dx = tstem.stem_bwd_dx(x, g, params)
    assert_bf16_close(dx, tstem.stem_bwd_dx_plain(x, g, params))
    # the same values four elements into a buffer: 8- but not 16-byte aligned
    x_off = torch.empty(x.numel() + 4, dtype=x.dtype, device=cuda)[4:].view(x.shape)
    x_off.copy_(x)
    assert x_off.data_ptr() % 16 == 8
    assert torch.equal(tstem.stem_bwd_dx(x_off, g, params), dx)
    assert torch.equal(tstem.stem_bwd_stats(x_off, g, params), acc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_stem_stats_refuses_another_scratch_count(cuda, dtype):
    """stem_bwd_stats' scratch is sized by ops/stem.py::ITEM; the kernel
    checks the count it is given against its own STRIP and SEG, so a
    wrapper that disagrees raises instead of reading past, or short of, the
    partial sums (W = 260: one full segment and a ragged one either way)."""
    from vfa_tpu_torch.kernels import LIBRARY

    x, scale, bias, g = _stem_inputs((1, 16, 23, 260), 0, False, cuda)
    x, scale, bias, g = (t.to(dtype) for t in (x, scale, bias, g))
    _, mu, rstd = tstem.group_norm_stats(x, scale, bias, 16, 1e-5)
    params = tstem.plane_params(mu, rstd, scale, bias)
    items = tstem.items_per_plane(dtype, 23, 260)
    assert items == {torch.float32: 3 * 3, torch.bfloat16: 1 * 2}[dtype]
    fn = getattr(LIBRARY.load("stem_bwd"),
                 "stem_bwd_stats_" + ("bf16" if dtype == torch.bfloat16 else "f32"))
    partial = torch.empty((16, items + 1, 2), device=cuda)
    acc = torch.empty((1, 4, 16), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    args = [x.data_ptr(), g.data_ptr(), params.data_ptr(), partial.data_ptr(),
            acc.data_ptr(), 1, 16, 23, 260]
    for wrong in (items - 1, items + 1):
        assert fn(*args, wrong, stream) != 0
    assert fn(*args, items, stream) == 0
    torch.cuda.synchronize()
    want = tstem.stem_bwd_stats_plain(x, g, params)
    np.testing.assert_allclose(acc.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


def test_bf16_stem_kernels_refuse_odd_widths_and_mixing(cuda):
    x, scale, bias, g = _stem_inputs((1, 16, 8, 10), 0, False, cuda)
    x, scale, bias, g = (t.to(torch.bfloat16) for t in (x, scale, bias, g))
    _, mu, rstd = tstem.group_norm_stats(x, scale, bias, 16, 1e-5)
    params = tstem.plane_params(mu, rstd, scale, bias)
    with pytest.raises(ValueError, match="multiple of 4"):
        tstem.stem_bwd_stats(x, g, params)
    x8 = x[..., :8].contiguous()
    with pytest.raises(TypeError, match="dy must be"):
        tstem.stem_bwd_dx(x8, g[..., :4].float().contiguous(), params)


def _unified_slab_scale(dtype, device):
    """Scale 0 of slab 1 of a 2-slab BEV-sharded rig (tiny MultiviewC,
    factor 4, tile_v 16, 3 buckets) on the card, and its bucket 0, which
    the unification gave zero A tiles and origins re-clamped for the
    common window (both checked against the slab's own build)."""
    import types

    from vfa_tpu_torch.parallel_bev import build_bev_sharded_rig

    cfg = tiny_config(get_config("MultiviewC"), factor=4)
    calibs = make_calibrations(cfg)
    grid = make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name)
    shapes = trig.pyramid_feat_shapes(cfg.resize_size)
    srig = build_bev_sharded_rig(calibs, cfg, grid, shapes, num_shards=2,
                                 tile_v=16, dtype=dtype, band_buckets=3)
    rank1 = types.SimpleNamespace(index=lambda axis: 1, group=lambda axis: None)
    sr = srig.slab(rank1, device).scales[0]
    rows = srig.slab_rows
    padded = np.concatenate([grid, np.repeat(grid[-1:], 2 * rows - grid.shape[0], 0)])
    own = trig.build_rig(calibs, cfg, padded[rows:], shapes, tile_v=16, dtype=dtype,
                         band_buckets=3, device="cpu").scales[0]
    T_own = own.A[0].shape[1]
    assert int((sr.A[0].float().abs().amax((2, 3)) == 0).sum()) > 0
    assert bool((sr.starts[0][:, :T_own].cpu() != own.starts[0]).any())
    assert sr.window_hw[0] != own.window_hw[0]
    return sr


@pytest.mark.parametrize("B", [1, 2])
def test_unified_slab_bucket_fp32_kernels_match_plain(cuda, B):
    """K1 and K2 (fp32) on a BEV slab's unified bucket (zero A tiles,
    re-clamped origins, the common window) against their plain versions,
    rtol / atol 1e-4 of the output scale."""
    sr = _unified_slab_scale(torch.float32, cuda)
    A_b, s_b, win = sr.A[0], sr.starts[0], sr.window_hw[0]
    g = torch.Generator(device="cpu").manual_seed(B)
    lat = torch.rand((B, A_b.shape[0], *sr.feat_hw, 256), generator=g).to(cuda)
    k = (torch.randn((256 * sr.nl, 256), generator=g) * 0.05).to(cuda)
    ii = trig.pad_features(lat)
    Kr = trig.collapse_per_layer(k, 256, sr.nl, torch.float32)
    rows = A_b.shape[1] * sr.tile_v
    out = torch.zeros((A_b.shape[0], B, rows, 256), device=cuda)
    rig_window_fwd(ii, A_b, s_b, Kr, out, off_t=0, tile_v=sr.tile_v, window=win)
    want = trig.window_tiles(ii, A_b, s_b, Kr, win, sr.tile_v)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    gr = torch.randn(out.shape, generator=g).to(cuda)
    dII, dKr = torch.zeros_like(ii), torch.zeros_like(Kr)
    rig_window_bwd(ii, A_b, s_b, Kr, gr, dII, dKr, off_t=0, tile_v=sr.tile_v, window=win)
    want_dII, want_dKr = trig.window_tiles_bwd(ii, A_b, s_b, Kr, gr, win, sr.tile_v)
    for got, w in ((dII, want_dII), (dKr, want_dKr)):
        np.testing.assert_allclose(got.cpu().numpy(), w.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.parametrize("B", [1, 2], ids=["B1-K3", "B2-K2"])
def test_unified_slab_bucket_bf16_kernels_match_plain(cuda, B):
    """K1-bf16 (the whole slab scale, one launch) and the bf16 window
    backward on the unified bucket, through the dII order rebuilt for the
    unified buckets (`ScaleRig.dii_order`): K2's once-a-window rounding at
    B = 2, K3's per-layer rounding at B = 1 (JAX runs that bucket
    serially), against the plain versions within 1e-2 of the plain max and
    rel-L2 4e-3, and dII the same bits on a second run."""
    from vfa_tpu_torch.ops.rig_cuda import rig_fwd_scale, rig_window_fwd_bf16, rig_window_bwd_bf16

    sr = _unified_slab_scale(torch.bfloat16, cuda)
    lat, k = _bf16_inputs(sr, B, 300 + B, cuda)
    ii = trig.pad_features(lat)
    Kr = trig.collapse_per_layer(k, 256, sr.nl, torch.bfloat16)
    rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
    out = torch.empty((ii.shape[0], B, rows, 256), dtype=torch.bfloat16, device=cuda)
    n0 = rig_window_fwd_bf16.launches
    rig_fwd_scale(ii, sr, Kr, out)
    assert rig_window_fwd_bf16.launches == n0 + 1
    assert_bf16_close(out, trig.scale_tiles(ii, sr, Kr))
    A_b, s_b, win = sr.A[0], sr.starts[0], sr.window_hw[0]
    T, R, K = A_b.shape[1:]
    assert trig.window_bwd_serial(B, K, R, 2, 2, 256) == (B == 1)
    g = torch.randn((ii.shape[0], B, T * sr.tile_v, 256),
                    generator=torch.Generator().manual_seed(B)).to(cuda, torch.bfloat16)

    def kernel():
        dII = torch.zeros_like(ii)
        dKr = torch.zeros(Kr.shape, dtype=torch.float32, device=cuda)
        rig_window_bwd(ii, A_b, s_b, Kr, g, dII, dKr, off_t=0, tile_v=sr.tile_v,
                       window=win, dii=sr.dii_order[0])
        return dII, dKr

    n0 = rig_window_bwd_bf16.launches
    dII, dKr = kernel()
    assert rig_window_bwd_bf16.launches == n0 + 1
    want_dII, want_dKr = trig.window_tiles_bwd(ii, A_b, s_b, Kr, g, win, sr.tile_v)
    assert_bf16_close(dII, want_dII)
    assert_bf16_close(dKr, want_dKr)
    assert torch.equal(kernel()[0], dII)


@pytest.mark.parametrize("shape", [(1, 256, 90, 160), (7, 256, 23, 40), (2, 45, 640)], ids=str)
def test_bf16_integral_image_on_the_card_equals_the_cpu(cuda, shape):
    """The voxel route's bf16 integral image (`ops/voxel.py::
    IntegralImage`, JAX's blocked bf16 cumsum) and its backward on
    the card bit for bit as on the CPU, which tests/test_torch_voxel_bf16.py
    holds to JAX: every op is one bf16 add of two tensors, rounded once on
    both devices. Full MultiviewC lateral shapes (scale 8 of one camera,
    scale 32 of 7) and a two-level row."""
    from vfa_tpu_torch.ops.voxel import integral_image, sample_voxels

    g = torch.Generator().manual_seed(sum(shape))
    x = torch.rand(shape, generator=g).to(torch.bfloat16)
    dy = torch.randn(shape, generator=g).to(torch.bfloat16)
    leaves = [x.to(cuda).requires_grad_(), x.clone().requires_grad_()]
    (got, want) = (integral_image(t) for t in leaves)
    (dx, dx_cpu) = (torch.autograd.grad(y, t, dy.to(t.device))[0]
                    for y, t in zip((got, want), leaves))
    assert got.dtype == torch.bfloat16 and got.is_cuda == (cuda.type == "cuda")
    assert torch.equal(got.cpu(), want) and torch.equal(dx.cpu(), dx_cpu)
    if shape[-3] == 256:
        boxes = torch.rand((shape[0], 5, 9, 9, 4), generator=g) * 1.8 - 0.9
        boxes = torch.cat([boxes[..., :2], boxes[..., :2] + 0.1 + boxes[..., 2:].abs() * 0.05],
                          -1)
        with torch.no_grad():
            vox = sample_voxels(x.to(cuda), boxes.to(cuda))
            assert torch.equal(vox.cpu(), sample_voxels(x, boxes))


def _voxel_tap_inputs(cuda, cfg, C, B, seed, hw=None):
    """Boxes of camera 0 of `cfg` on the card (B scenes of them), the scale-8
    (or `hw`) map and stacked corner cotangents g (4 * B * P, C)."""
    from vfa_tpu_torch.ops.voxel import voxel_boxes

    calib = torch.from_numpy(make_calibrations(cfg)[:1]).to(cuda)
    grid = torch.from_numpy(make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name)).to(cuda)
    boxes = voxel_boxes(calib, grid, dataset=cfg.name, grid_height=cfg.grid_h,
                        cube_size=cfg.cube_size, image_size=cfg.image_size)
    boxes = boxes.expand(B, *boxes.shape[1:]).clone()
    H, W = hw or (cfg.resize_size[0] // 8, cfg.resize_size[1] // 8)
    g = torch.Generator().manual_seed(seed)
    P = boxes[0, ..., 0].numel()
    grads = torch.randn((4 * B * P, C), generator=g).to(cuda)
    return boxes, (H, W), grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_voxel_tap_bwd_full_multiviewc_matches_plain(cuda, dtype):
    """csrc/voxel_tap_bwd.cu at full MultiviewC, one camera at scale 8
    ((256, 90, 160) under (5, 156, 156) boxes, up to 164 updates a pixel
    from one tap): bit for bit its plain version (`corner_taps_bwd` on the
    card: XLA's order, one tensor add a step), and the same bits on a
    second launch."""
    from vfa_tpu_torch.ops import voxel as tvox

    boxes, (H, W), g = _voxel_tap_inputs(cuda, get_config("MultiviewC"), 256, 1, 0)
    order = tvox.tap_order(boxes, (H, W))
    counter = tvox.voxel_tap_bwd_bf16 if dtype == torch.bfloat16 else tvox.voxel_tap_bwd
    n0 = counter.launches
    got = tvox.voxel_tap_bwd(g, order, (1, 256, H, W), dtype)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1 and got.dtype == dtype
    want = tvox.corner_taps_bwd(g, order, (1, 256, H, W), dtype)
    assert torch.equal(got, want) and float(want.abs().max()) > 0
    assert torch.equal(tvox.voxel_tap_bwd(g, order, (1, 256, H, W), dtype), got)


@pytest.mark.parametrize("C", [3, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_voxel_tap_bwd_channels_and_scenes(cuda, dtype, C):
    """Fewer channels than lanes and more than one pass (256 a pass), two
    scenes, the tiny MultiviewC boxes: the kernel equals its plain version;
    `sample_voxels`' gradient on the card (one launch) equals the CPU's."""
    from vfa_tpu_torch.ops import voxel as tvox

    cfg = tiny_config(get_config("MultiviewC"))
    boxes, (H, W), g = _voxel_tap_inputs(cuda, cfg, C, 2, C)
    order = tvox.tap_order(boxes, (H, W))
    got = tvox.voxel_tap_bwd(g, order, (2, C, H, W), dtype)
    assert torch.equal(got, tvox.corner_taps_bwd(g, order, (2, C, H, W), dtype))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, C, H, W), generator=gen).to(dtype)
    dv = torch.randn((2, *boxes.shape[2:4], C * boxes.shape[1]), generator=gen)
    leaves = [x.to(cuda).requires_grad_(), x.clone().requires_grad_()]
    counter = tvox.voxel_tap_bwd_bf16 if dtype == torch.bfloat16 else tvox.voxel_tap_bwd
    n0 = counter.launches
    dx, dx_cpu = (torch.autograd.grad(tvox.sample_voxels(t, boxes.to(t.device)), t,
                                      dv.to(t.device))[0] for t in leaves)
    assert counter.launches == n0 + 1
    assert torch.equal(dx.cpu(), dx_cpu)


_FULL_SCALES = {}


def _full_scales(name, layout, device):
    """(inv_perm, rows) of each scale of the full-width bf16 serving rig of
    `name` in `layout`, built once a module run (the rig itself is
    dropped)."""
    key = (name, layout)
    if key not in _FULL_SCALES:
        from vfa_tpu_torch.rig_cli import build_cli_rig

        cfg = get_config(name)
        rig = build_cli_rig(cfg, make_calibrations(cfg), device, layout=layout,
                            dtype=torch.bfloat16)
        _FULL_SCALES[key] = [(sr.inv_perm, sum(a.shape[1] for a in sr.A) * sr.tile_v)
                             for sr in rig.scales]
        del rig
        torch.cuda.empty_cache()
    return _FULL_SCALES[key]


def _epilogue_inputs(scales, B, seed, device):
    gen = torch.Generator().manual_seed(seed)
    tiles, biases = [], []
    for ip, rows in scales:
        tiles.append(torch.randn((ip.shape[0], B, rows, 256), generator=gen).to(
            device, torch.bfloat16))
        biases.append((torch.randn((256,), generator=gen) * 0.5).to(device, torch.bfloat16))
    return tiles, [ip for ip, _ in scales], biases


@pytest.mark.parametrize("name,layout", [("MultiviewC", "window"), ("MultiviewC", "flat"),
                                         ("Wildtrack", "window"), ("Wildtrack", "flat")],
                         ids=["mvc-window", "mvc-flat", "wt-window", "wt-flat"])
def test_bev_epilogue_full_width_equals_plain(cuda, name, layout):
    """`csrc/rig_bev_epilogue.cu` on the inv_perms and tile rows of the
    full-width bf16 serving rigs at batch 2, random tiles: one launch, bit
    for bit `rig_bev_sum` (on the card) and the same bits twice; the
    per-scale chain it replaces within one bf16 ulp (its fp32 camera sum
    on the card may add in another order)."""
    from vfa_tpu_torch.ops.rig_cuda import rig_bev_epilogue

    tiles, inv_perms, biases = _epilogue_inputs(_full_scales(name, layout, cuda), 2, 5, cuda)
    n0 = rig_bev_epilogue.launches
    got = rig_bev_epilogue(tiles, inv_perms, biases)
    assert rig_bev_epilogue.launches == n0 + 1
    again = rig_bev_epilogue(tiles, inv_perms, biases)
    want = trig.rig_bev_sum(tiles, inv_perms, biases)
    torch.cuda.synchronize()
    assert got.shape == (2, inv_perms[0].shape[1], 256) and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(again.view(torch.int16), got.view(torch.int16))
    chain = sum(trig.rig_epilogue(t, ip, b, torch.float32, True)
                for t, ip, b in zip(tiles, inv_perms, biases)).to(torch.bfloat16)
    assert int(bf16_ulps(got, chain).max()) <= 1
    assert 0 < int((got == 0).sum()) < got.numel()


def test_bev_epilogue_past_2_31_elements_and_refusals(cuda):
    """One Wildtrack-sized scale at batch 32 (7 x 32 x 43,200 x 256 tile
    elements, past 2^31) and a random permutation: the last scene's rows
    equal the plain version's. The wrapper refuses fp32 tiles, 16-bit
    indices, more than 3 scales and another channel count."""
    from vfa_tpu_torch.ops.rig_cuda import rig_bev_epilogue

    N, B, V2d = 7, 32, 43200
    assert N * B * V2d * 256 > 2 ** 31
    gen = torch.Generator().manual_seed(3)
    ip = torch.stack([torch.randperm(V2d, generator=gen) for _ in range(N)]).to(cuda)
    t = torch.randn((N, B, V2d, 256), device=cuda, dtype=torch.bfloat16,
                    generator=torch.Generator(device=cuda).manual_seed(4))
    b = (torch.randn((256,), generator=gen) * 0.5).to(cuda, torch.bfloat16)
    got = rig_bev_epilogue([t], [ip], [b])
    want = trig.rig_bev_sum([t[:, -2:]], [ip], [b])
    torch.cuda.synchronize()
    assert torch.equal(got[-2:].view(torch.int16), want.view(torch.int16))
    small = [t[:, :1, :64].contiguous()]
    with pytest.raises(TypeError):
        rig_bev_epilogue([small[0].float()], [ip[:, :64]], [b])
    with pytest.raises(ValueError):
        rig_bev_epilogue(small, [ip[:, :64].to(torch.int16)], [b])
    with pytest.raises(ValueError):
        rig_bev_epilogue(small * 4, [ip[:, :64]] * 4, [b] * 4)
    with pytest.raises(ValueError):
        rig_bev_epilogue([small[0][..., :128].contiguous()], [ip[:, :64]], [b[:128]])


def test_serving_forward_bev_matches_the_per_scale_route(cuda, tmp_path, monkeypatch):
    """The full bf16 MultiviewC model on the 12-bucket serving rig at
    batch 2: under no_grad `bev_features` takes the one-launch epilogue
    (1 launch, K1-bf16 once a scale) and gives the per-scale route's BEV
    (taken with gradients on) within one bf16 ulp. Both through the
    backbone's library route (`ops/group_norm.takes_kernel` off), so that
    only the sampling's route differs."""
    from vfa_tpu_torch.kernels import launch_counts
    from vfa_tpu_torch.model.vfanet import VFANet, cast_model, init_weights
    from vfa_tpu_torch.ops import group_norm as gn
    from vfa_tpu_torch.rig_cli import build_cli_rig

    monkeypatch.setattr(gn, "takes_kernel", lambda *a: False)

    cfg = get_config("MultiviewC")
    rig = build_cli_rig(cfg, make_calibrations(cfg), cuda, dtype=torch.bfloat16)
    model = cast_model(init_weights(VFANet(cfg), torch.Generator().manual_seed(0)),
                       torch.bfloat16).to(cuda).eval()
    x = torch.rand((2, 7, *cfg.resize_size, 3), generator=torch.Generator().manual_seed(1))
    x = x.to(cuda, torch.bfloat16)
    n0 = launch_counts()
    with torch.no_grad():
        got = model.bev_features(x, rig)
    n1 = launch_counts()
    assert n1["rig_bev_epilogue"] - n0["rig_bev_epilogue"] == 1
    assert n1["rig_window_fwd_bf16"] - n0["rig_window_fwd_bf16"] == 3
    want = model.bev_features(x, rig)
    assert want.requires_grad
    assert launch_counts()["rig_bev_epilogue"] == n1["rig_bev_epilogue"]
    want = want.detach()
    torch.cuda.synchronize()
    ulps = bf16_ulps(got, want)
    print(f"BEV elements one ulp apart: {int((ulps == 1).sum())} of {ulps.numel()}")
    assert got.shape == (2, *rig.grid_shape, 256) and int(ulps.max()) <= 1


def test_bev_epilogue_launches_once_a_serving_forward_never_in_training(cuda, monkeypatch):
    """`launch_counts()["rig_bev_epilogue"]` moves by 1 a bf16 serving
    forward (eval, no_grad) and by 0 in a mixed-precision training step
    (grad on: the per-scale route, which autograd differentiates), on the
    tiny MultiviewC config's bf16 window rig; the tiles that `rig_bev`'s
    serving route hands the epilogue (`scale_tiles_cuda`) are
    `rig_tiles_cuda`'s."""
    import copy

    from vfa_tpu_torch.config import TrainConfig
    from vfa_tpu_torch.data.synthetic_loader import SyntheticSceneLoader
    from vfa_tpu_torch.kernels import launch_counts
    from vfa_tpu_torch.model.vfanet import VFANet, cast_model, init_weights
    from vfa_tpu_torch.ops import rig_cuda
    from vfa_tpu_torch.train_lib import batch_to_device, make_optimizer, make_train_step

    tc = tiny_config(get_config("MultiviewC"), factor=4)
    rig = _bf16_rig("MultiviewC", 160, 3, "window", cuda)
    # the serving tiles, every scale's forward on one shared vox scratch,
    # are the autograd route's bits
    lats, ks = zip(*(_bf16_inputs(sr, 2, 60 + si, cuda) for si, sr in enumerate(rig.scales)))
    seen = []
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(rig_cuda, "rig_bev_epilogue", lambda tiles, *a: seen.append(tiles))
        rig_cuda.rig_bev(list(lats), rig.scales, list(ks),
                         [torch.zeros(256, dtype=torch.bfloat16, device=cuda)] * 3,
                         torch.bfloat16)
    assert len(seen) == 1
    for got, sr, lat, k in zip(seen[0], rig.scales, lats, ks):
        assert torch.equal(got.view(torch.int16), rig_tiles_cuda(lat, sr, k).view(torch.int16))
    loader = SyntheticSceneLoader(tc, num_frames=2, batch_size=2, max_objects=8, seed=3,
                                  num_objects=3)
    batch = batch_to_device(next(iter(loader)), cuda)
    state = init_weights(VFANet(tc), torch.Generator().manual_seed(0)).state_dict()

    serve = VFANet(tc)
    serve.load_state_dict(state, strict=True)
    serve = cast_model(serve, torch.bfloat16).to(cuda).eval()
    n0 = launch_counts()["rig_bev_epilogue"]
    with torch.no_grad():
        serve(batch["images"].to(torch.bfloat16), rig)
    assert launch_counts()["rig_bev_epilogue"] == n0 + 1

    model = VFANet(tc)
    model.load_state_dict(state, strict=True)
    model = model.to(cuda)
    tcfg = TrainConfig(pretrained=False, compute_dtype="bfloat16")
    step = make_train_step(model, make_optimizer(model, tcfg, 1), tc, tcfg,
                           dim_mean=loader.dim_mean)
    b = copy.copy(batch)
    b["images"] = b["images"].to(torch.bfloat16)
    before = launch_counts()
    losses = step(b, rig)
    torch.cuda.synchronize()
    after = launch_counts()
    assert all(torch.isfinite(v) for v in losses.values())
    assert after["rig_bev_epilogue"] == before["rig_bev_epilogue"]
    assert after["rig_window_fwd_bf16"] == before["rig_window_fwd_bf16"] + 3


# MVDet's projection, `csrc/mvdet_project.cu`, against `project_world_plain` on
# the card: within one bf16 ulp or ATOL of the features' largest magnitude,
# on at most ULP_SHARE of the elements (`ops/projection.py` says why).


def _mvdet_case(B, N, C, fh, fw, h, w, L, W, device, seed):
    """Channels-last bf16 features on the card and (N, L, W, 2) positions:
    random ones around the map with its corners, edges, points past them
    and positions that are not finite (`test_torch_projection.
    edge_positions`)."""
    from test_torch_projection import channels_last_feats, edge_positions

    feats = channels_last_feats(B, N, C, fh, fw, seed, torch.bfloat16).to(device)
    pos = torch.stack([edge_positions(h, w, L, W, seed + n) for n in range(N)]).to(device)
    return feats, pos


def _mvdet_compare(feats, pos, size):
    """The kernel's and the plain version's world features, each into a
    tensor with 2 more channels than the cameras fill (left as they were),
    and `kernel_vs_plain` of the two: the largest distance in bf16 ulps
    and the share of elements off."""
    B, N, C = feats.shape[:3]
    L, W = pos.shape[1:3]
    out = torch.full((B, N * C + 2, L, W), 3.0, dtype=torch.bfloat16, device=feats.device)
    n0 = project_world.launches
    got = project_world(feats, pos, size, out.clone())
    assert project_world.launches == n0 + 1
    want = project_world_plain(feats, pos, size, out)
    torch.cuda.synchronize()
    assert (got[:, N * C:] == 3.0).all()
    return (got, want, *kernel_vs_plain(got, want, feats))


@pytest.mark.parametrize("C,fh,fw,h,w,L,W", [
    (256, 4, 6, 12, 18, 5, 7),          # integer ratio; 35 cells, not a multiple of 8
    (512, 5, 7, 13, 29, 16, 24),        # non-integer ratios; 384 cells, 6 whole blocks
    (256, 9, 16, 27, 48, 9, 13),        # the cell's ratio 3, 2 blocks, the second partial
], ids=["ratio3-tail", "ratio2.6x4.1-whole", "ratio3-partial"])
def test_mvdet_project_tiny_matches_plain(cuda, C, fh, fw, h, w, L, W):
    """The kernel against the library chain at tiny sizes, 2 scenes x 3
    cameras, into a world tensor with 2 more channels that the kernel must
    not touch: every element within one bf16 ulp or ATOL, at most
    ULP_SHARE of them off; the cells whose taps all lie outside the
    map and those whose position is not finite exactly 0 on both sides,
    camera 2's all such (its blocks take the kernel's zero-fill path)."""
    feats, pos = _mvdet_case(2, 3, C, fh, fw, h, w, L, W, cuda, seed=C + L)
    pos[2, :, ::2] = float(w + 1)       # camera 2: every cell out of the map or not
    pos[2, :, 1::2] = float("nan")      # finite, so its blocks write zeros only
    got, want, worst, share = _mvdet_compare(feats, pos, (h, w))
    assert worst <= 1 and share <= ULP_SHARE, (worst, share)
    for i in (12, 13, 14, 15):          # (w + 5, h + 5), then not finite
        assert not got[:, :3 * C, i // W, i % W].any(), i
        assert not want[:, :3 * C, i // W, i % W].any(), i
    assert not got[:, 2 * C:3 * C].any()        # every cell written, as 0


def test_mvdet_project_cell_shapes_match_plain(cuda):
    """The benchmark cell's shapes: 32 scenes x 7 cameras of 512 x 90 x 160
    features to 120 x 360 cells on maps of 270 x 480, at the positions of
    Wildtrack's synthetic cameras, with the first row of camera 0 replaced
    by edge and non-finite positions: within one bf16 ulp or ATOL, at
    most ULP_SHARE off; camera 0's cells out of view 0 on both
    sides."""
    from test_torch_projection import edge_positions
    from vfa_tpu_torch.geometry import ground_positions

    cfg = get_config("Wildtrack")
    size = tuple(int(s / 4) for s in cfg.image_size)
    grid = make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name)
    pos = ground_positions(make_calibrations(cfg), grid, cfg.name, cfg.image_size, size)
    pos[0, 0] = edge_positions(*size, 1, 360, seed=9)[0]
    feats = torch.randn(32 * 7, 512, 90, 160, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(7))
    feats = feats.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    got, want, worst, share = _mvdet_compare(feats.unflatten(0, (32, 7)), pos.to(cuda), size)
    assert worst <= 1 and share <= ULP_SHARE, (worst, share)
    outside = (want[:, :512] == 0).all(0).all(0)        # camera 0's cells out of view
    assert 0 < int(outside.sum()) < 120 * 360
    assert not got[:, :512, outside].any()


def test_mvdet_forward_launches_once_and_refusals(cuda):
    """A tiny MVDet on the card: a bf16 forward with no gradient needed
    launches the kernel once and gives the plain route's world features
    within one bf16 ulp or ATOL; fp32 and a bf16 forward with
    gradients launch nothing. The wrapper refuses fp32 features and
    features whose channels are not contiguous, the kernel 128 channels."""
    import dataclasses

    from vfa_tpu_torch.geometry import ground_positions
    from vfa_tpu_torch.kernels import launch_counts
    from vfa_tpu_torch.model.mvdet import MVDet, init_weights

    cfg = dataclasses.replace(get_config("Wildtrack"), world_size=(32, 96),
                              image_size=(128, 192), resize_size=(64, 96), num_cam=2)
    model = init_weights(MVDet(cfg), torch.Generator().manual_seed(23)).to(cuda).eval()
    grid = make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name)
    pos = ground_positions(make_calibrations(cfg), grid, cfg.name, cfg.image_size,
                           model.upsample_shape).to(cuda)
    images = torch.rand(2, 2, 64, 96, 3, generator=torch.Generator().manual_seed(8)).to(cuda)
    for name, dtype, grad in (("bf16", torch.bfloat16, False), ("fp32", torch.float32, False),
                              ("bf16_grad", torch.bfloat16, True)):
        net = MVDet(cfg).to(cuda)
        net.load_state_dict(model.state_dict())
        net = net.to(dtype).eval()
        n0 = launch_counts()["mvdet_project"]
        with torch.set_grad_enabled(grad):
            net(images.to(dtype), pos)
        torch.cuda.synchronize()
        assert launch_counts()["mvdet_project"] - n0 == (name == "bf16"), name
    with torch.no_grad():
        feats = net.trunk(images.to(torch.bfloat16).flatten(0, 1)).unflatten(0, (2, 2))
        kernel = net.project(feats, pos)[0]
    plain = net.project(feats.clone().requires_grad_(), pos)[0].detach()
    assert kernel_vs_plain(kernel, plain, feats)[0] <= 1
    feats = torch.randn(1, 1, 256, 4, 6, device=cuda).to(torch.bfloat16)
    pos = torch.zeros(1, 3, 5, 2, device=cuda)
    out = torch.empty(1, 258, 3, 5, device=cuda, dtype=torch.bfloat16)
    last = feats.flatten(0, 1).contiguous(memory_format=torch.channels_last).unflatten(0, (1, 1))
    with pytest.raises(TypeError):
        project_world(last.float(), pos, (8, 12), out.float())
    with pytest.raises(ValueError):
        project_world(feats, pos, (8, 12), out)
    with pytest.raises(RuntimeError):          # the kernel refuses 128 channels
        project_world(last[:, :, :128], pos, (8, 12), out)


# VFANet's backbone norms, `csrc/gn_nhwc.cu`, against the library chain
# (`ops/group_norm.py::group_norm_act_plain`) on the card: fed ATen's bf16
# statistics the apply pass gives the chain's bits; with its own, whose fp32
# sums run in another order, the chain's bits except in the (image, group)s
# whose bf16 statistic differs from ATen's, and there the bits of the
# apply pass's plain version (`apply_plain`) fed the kernel's statistics.

GN_SHAPES = [  # (M, C, H, W, epilogue, special)
    (2, 64, 360, 640, "relu_pool", None),       # the stem: 4 channels a group
    (3, 64, 25, 33, "relu_pool", "zeros"),      # odd sizes; z = -0 where x < 0
    (2, 64, 180, 320, "relu", None),            # layer1
    (2, 64, 180, 320, "add_relu", "zeros"),
    (2, 128, 90, 160, "none", None),            # layer2: 8 channels a group
    (2, 128, 90, 160, "add_relu", None),
    (2, 256, 45, 80, "relu", "zeros"),          # layer3: 16
    (2, 256, 45, 80, "add_relu", None),
    (2, 512, 23, 40, "none", None),             # layer4: 32, at 23 x 40
    (2, 512, 23, 40, "relu", None),
    (2, 512, 23, 40, "add_relu", "zeros"),
    (2, 64, 30, 40, "relu_pool", "nan"),        # NaN through the norm, ReLU, add and pool
    (2, 128, 30, 40, "add_relu", "nan"),
    (3, 512, 23, 40, "relu", "nan"),
]
GN_IDS = [f"{m}x{c}x{h}x{w}-{a}" + (f"-{s}" if s else "") for m, c, h, w, a, s in GN_SHAPES]


def _gn_case(M, C, H, W, act, special, device, seed=0):
    """Channels-last bf16 x with a mean per channel, bf16 scale and bias
    (with `zeros`, every fifth channel's scale 0 and bias -0, so that z is
    -0 where x < 0), an identity for add_relu, and with `nan` a NaN in the
    first and last image's first and last pixel."""
    g = torch.Generator(device=device).manual_seed(seed + C + H)
    x = torch.empty((M, C, H, W), device=device, dtype=torch.bfloat16,
                    memory_format=torch.channels_last)
    off = torch.randn((1, C, 1, 1), device=device, generator=g) * 3
    for m in range(M):
        x[m] = torch.randn((C, H, W), device=device, generator=g) * 2 + off[0]
    w = torch.randn(C, device=device, generator=g).to(torch.bfloat16)
    b = (torch.randn(C, device=device, generator=g) * 0.5).to(torch.bfloat16)
    if special == "zeros":
        w[::5], b[::5] = 0.0, -0.0
    ident = None
    if act == "add_relu":
        ident = torch.randn((M, C, H, W), device=device, generator=g).to(torch.bfloat16)
        ident = ident.contiguous(memory_format=torch.channels_last)
    if special == "nan":
        x[0, 0, 0, 0] = float("nan")
        x[M - 1, C - 1, H - 1, W - 1] = float("nan")
    return x, w, b, ident


def _aten_stats(x, G):
    """ATen's bf16 mean and rstd of x as (M, G, 2) fp32, and the fp32 ones
    of its fp32 path (`ops/group_norm.py::aten_stats`)."""
    from vfa_tpu_torch.ops.group_norm import aten_stats

    return aten_stats(x, G)


def _bits(t):
    return t.contiguous().view(torch.int16)


@pytest.mark.parametrize("M,C,H,W,act,special", GN_SHAPES, ids=GN_IDS)
def test_gn_nhwc_apply_fed_atens_statistics_gives_the_chains_bits(cuda, M, C, H, W, act,
                                                                  special):
    """The apply pass fed ATen's own bf16 statistics: the library chain's
    output bit for bit (NaN, -0 and the pool's first maximum included),
    channels-last; one launch."""
    from vfa_tpu_torch.ops import group_norm as gn

    x, w, b, ident = _gn_case(M, C, H, W, act, special, cuda)
    aten, _ = _aten_stats(x, 16)
    n0 = gn.gn_nhwc_apply.launches
    got = gn.gn_nhwc_apply(x, aten, w, b, act, ident)
    assert gn.gn_nhwc_apply.launches == n0 + 1
    want = gn.group_norm_act_plain(x, w, b, 16, 1e-5, act, ident)
    torch.cuda.synchronize()
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.shape == want.shape and torch.equal(_bits(got), _bits(want))
    if special == "nan":
        assert torch.isnan(got[0].float()).any() and torch.isnan(got[M - 1].float()).any()


def _check_stats(got, ref, aten):
    """The kernel's fp32 statistics within `STATS_TOL` of ATen's fp32 ones
    (NaN where ATen's are); where the kernel's and ATen's bf16 statistics
    differ, they are neighbours and ATen's fp32 value lies within
    `STATS_TOL` of the boundary between them (`ops/group_norm.py::
    stats_vs_aten`).
    Returns the (image, group)s whose bf16 statistics differ, and the
    largest scaled distances."""
    from vfa_tpu_torch.ops.group_norm import STATS_TOL, stats_vs_aten

    d_mean, d_rstd, off, sound = stats_vs_aten(got, ref, aten)
    assert d_mean <= STATS_TOL and d_rstd <= STATS_TOL, (d_mean, d_rstd)
    assert sound
    return off, d_mean, d_rstd


@pytest.mark.parametrize("M,C,H,W,act,special", GN_SHAPES, ids=GN_IDS)
def test_gn_nhwc_statistics_and_route_against_the_chain(cuda, M, C, H, W, act, special):
    """The kernel pair (`group_norm_nhwc`): its statistics against ATen's
    (`_check_stats`); its output the chain's bits in every (image, group)
    whose bf16 statistics are ATen's, and everywhere the bits of
    `apply_plain` fed the kernel's statistics; one statistics and one
    apply launch."""
    from vfa_tpu_torch.ops import group_norm as gn

    x, w, b, ident = _gn_case(M, C, H, W, act, special, cuda)
    aten, ref = _aten_stats(x, 16)
    stats = gn.gn_nhwc_stats(x, 16, 1e-5)
    n0 = (gn.gn_nhwc_stats.launches, gn.gn_nhwc_apply.launches)
    got = gn.group_norm_nhwc(x, w, b, 16, 1e-5, act, ident)
    assert (gn.gn_nhwc_stats.launches, gn.gn_nhwc_apply.launches) == (n0[0] + 1, n0[1] + 1)
    again = gn.gn_nhwc_stats(x, 16, 1e-5)                          # the same bits twice
    assert torch.equal(again.view(torch.int32), stats.view(torch.int32))
    groups_off, d_mean, d_rstd = _check_stats(stats, ref, aten)
    want = gn.group_norm_act_plain(x, w, b, 16, 1e-5, act, ident)
    plain = gn.apply_plain(x, stats, w, b, act, ident)
    torch.cuda.synchronize()
    print(f"statistics: mean {d_mean:.2e}, rstd {d_rstd:.2e} of STATS_TOL's scale; "
          f"{int(groups_off.sum())} of {groups_off.numel()} (image, group)s round apart")
    assert torch.equal(_bits(got), _bits(plain))
    cpg = C // 16
    same_groups = ~groups_off.repeat_interleave(cpg, 1)[:, :, None, None].expand_as(got)
    assert torch.equal(_bits(got)[same_groups], _bits(want)[same_groups])


def test_gn_nhwc_past_2_31_elements(cuda):
    """The stem at batch 32 x 7 cameras: conv1's output (224, 64, 360,
    640), 3.3e9 elements, past int32 offsets. Fed ATen's statistics the
    apply pass gives the chain's bits; the kernel's statistics against
    ATen's as above, and where an image's bf16 statistics differ, that
    image against `apply_plain` fed them."""
    from vfa_tpu_torch.ops import group_norm as gn

    M, C, H, W = 224, 64, 360, 640
    x, w, b, _ = _gn_case(M, C, H, W, "relu_pool", None, cuda)
    assert x.numel() > 2 ** 31
    aten, ref = _aten_stats(x, 16)
    want = gn.group_norm_act_plain(x, w, b, 16, 1e-5, "relu_pool")
    fed = gn.gn_nhwc_apply(x, aten, w, b, "relu_pool")
    torch.cuda.synchronize()
    assert torch.equal(_bits(fed), _bits(want))
    del fed
    stats = gn.gn_nhwc_stats(x, 16, 1e-5)
    groups_off, _, _ = _check_stats(stats, ref, aten)
    got = gn.gn_nhwc_apply(x, stats, w, b, "relu_pool")
    torch.cuda.synchronize()
    for m in range(M):
        if groups_off[m].any():
            plain = gn.apply_plain(x[m:m + 1], stats[m:m + 1], w, b, "relu_pool")
            assert torch.equal(_bits(got[m:m + 1]), _bits(plain)), m
        else:
            assert torch.equal(_bits(got[m]), _bits(want[m])), m


def test_gn_nhwc_refusals(cuda):
    """The wrapper refuses fp32 (TypeError), an identity without add_relu
    and none with it, and the apply pass an x that is not channels-last
    (ValueError); the kernel a channel count it does not take
    (RuntimeError)."""
    from vfa_tpu_torch.ops import group_norm as gn

    x, w, b, ident = _gn_case(2, 64, 8, 10, "add_relu", None, cuda)
    with pytest.raises(TypeError):
        gn.group_norm_nhwc(x.float(), w.float(), b.float(), 16, 1e-5, "relu")
    with pytest.raises(RuntimeError):          # 48 / 8 does not divide 256
        gn.group_norm_nhwc(x[:, :48], w[:48], b[:48], 16, 1e-5, "relu")
    with pytest.raises(ValueError):
        gn.group_norm_nhwc(x, w, b, 16, 1e-5, "relu", ident)
    with pytest.raises(ValueError):
        gn.group_norm_nhwc(x, w, b, 16, 1e-5, "add_relu")
    stats = gn.gn_nhwc_stats(x, 16, 1e-5)
    with pytest.raises(ValueError):
        gn.gn_nhwc_apply(x.contiguous(), stats, w, b, "relu")


@pytest.mark.parametrize("groups", [512, 256, 64])
def test_gn_nhwc_2048_channels(cuda, groups):
    """The widest channel count the kernels take, 2048 (one thread a pixel),
    in 4, 8 and 32 channels a group: with 4 (512 groups) a block of the
    statistics' first kernel leaves more groups than it has threads. The
    statistics against ATen's; the output `apply_plain`'s fed them."""
    from vfa_tpu_torch.ops import group_norm as gn

    M, C, H, W = 2, 2048, 9, 11
    g = torch.Generator(device=cuda).manual_seed(groups)
    x = torch.randn((M, C, H, W), device=cuda, generator=g) * 2 + 1
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = torch.randn(C, device=cuda, generator=g).to(torch.bfloat16)
    b = torch.randn(C, device=cuda, generator=g).to(torch.bfloat16)
    aten, ref = _aten_stats(x, groups)
    stats = gn.gn_nhwc_stats(x, groups, 1e-5)
    _check_stats(stats, ref, aten)
    got = gn.group_norm_nhwc(x, w, b, groups, 1e-5, "relu")
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(gn.apply_plain(x, stats, w, b, "relu")))


# What the caching allocator may count above the same requests: it hands a
# cached block out whole where the rest would be at most 1 MiB (kSmallSize
# of c10's CUDACachingAllocator), so each block live at the peak may carry
# up to that much, by the order blocks were freed before. Measured on an
# H100, the kernels' route's allocated peak above the library route's, the
# requested peaks equal: 0.69 MB in the forward below; 1.86 and 2.10 MB in
# the serving cells at batch 32.
ALLOC_SLACK = 2 * 2 ** 20


def _serving_vfanet(cfg, device, seed=0):
    from vfa_tpu_torch.model.vfanet import VFANet, cast_model, init_weights

    net = init_weights(VFANet(cfg), torch.Generator().manual_seed(seed))
    return cast_model(net, torch.bfloat16).to(device).eval()


def test_serving_forward_through_the_gn_kernels_against_the_library_route(cuda, monkeypatch):
    """The full bf16 MultiviewC model on the 12-bucket serving rig at
    batch 2 (14 images of 720 x 1280): 20 statistics and 20 apply launches
    a forward. Fed ATen's statistics, the kernels give every output of the
    library chain run through the same channels-last convolutions bit for
    bit. Against the library route (`takes_kernel` off: the parent's path,
    NCHW), every output within one bf16 ulp on at least FORWARD_ULP_SHARE
    of its elements; the kernel route's peak no higher in the bytes the
    tensors request, and in allocated bytes within ALLOC_SLACK."""
    from vfa_tpu_torch.kernels import launch_counts
    from vfa_tpu_torch.ops import group_norm as gn
    from vfa_tpu_torch.rig_cli import build_cli_rig

    cfg = get_config("MultiviewC")
    rig = build_cli_rig(cfg, make_calibrations(cfg), cuda, dtype=torch.bfloat16)
    model = _serving_vfanet(cfg, cuda)
    x = torch.rand((2, 7, *cfg.resize_size, 3), generator=torch.Generator().manual_seed(1))
    x = x.to(cuda, torch.bfloat16)

    def forward():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_stats()
        with torch.no_grad():
            out = model(x, rig)
        torch.cuda.synchronize()
        now = torch.cuda.memory_stats()
        return out, {k: now[f"{k}_bytes.all.peak"] - base[f"{k}_bytes.all.current"]
                     for k in ("requested", "allocated")}

    def fed_aten_stats(x, w, b, G, eps, act="none", identity=None):
        M, C, H, W = x.shape
        _, mu, rs = torch.native_group_norm(x.contiguous(), w, b, M, C, H * W, G, eps)
        stats = torch.stack([mu.float(), rs.float()], -1).view(M, G, 2)
        last = lambda t: t.contiguous(memory_format=torch.channels_last)
        return gn.gn_nhwc_apply(last(x), stats, w, b, act,
                                last(identity) if identity is not None else None)

    def chain_channels_last(x, w, b, G, eps, act="none", identity=None):
        out = gn.group_norm_act_plain(x, w, b, G, eps, act, identity)
        return out.contiguous(memory_format=torch.channels_last)

    n0 = launch_counts()
    got, peak = forward()
    n1 = launch_counts()
    assert n1["gn_nhwc_apply"] - n0["gn_nhwc_apply"] == 20
    assert n1["gn_nhwc_stats"] - n0["gn_nhwc_stats"] == 20
    with monkeypatch.context() as m:
        m.setattr(gn, "group_norm_nhwc", fed_aten_stats)
        fed, _ = forward()
    with monkeypatch.context() as m:
        m.setattr(gn, "group_norm_nhwc", chain_channels_last)
        chain, _ = forward()
    for k in chain:
        assert torch.equal(_bits(fed[k]), _bits(chain[k])), k
    with monkeypatch.context() as m:
        m.setattr(gn, "takes_kernel", lambda *a: False)
        want, want_peak = forward()
    assert launch_counts()["gn_nhwc_apply"] == n1["gn_nhwc_apply"] + 20
    print(f"serving forward peak above its inputs: kernels {peak}, library {want_peak}")
    assert peak["requested"] <= want_peak["requested"]
    assert peak["allocated"] <= want_peak["allocated"] + ALLOC_SLACK
    for k in want:
        ulps = bf16_ulps(got[k].to(torch.bfloat16), want[k].to(torch.bfloat16))
        share = float((ulps <= 1).float().mean())
        print(f"{k}: {share:.5f} of {ulps.numel()} within one bf16 ulp, max {int(ulps.max())}")
        assert share >= gn.FORWARD_ULP_SHARE, (k, share)


def test_gn_launches_serving_20_training_0_mvdet_0(cuda):
    """`launch_counts()`: 20 statistics and 20 apply launches a bf16 serving
    forward of the tiny MultiviewC VFANet (eval, no_grad), none in fp32,
    none in a mixed-precision training step, none in a bf16 MVDet
    forward."""
    import dataclasses

    from vfa_tpu_torch.config import TrainConfig
    from vfa_tpu_torch.data.synthetic_loader import SyntheticSceneLoader
    from vfa_tpu_torch.geometry import ground_positions
    from vfa_tpu_torch.kernels import launch_counts
    from vfa_tpu_torch.model.mvdet import MVDet, init_weights as mvdet_init
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights
    from vfa_tpu_torch.train_lib import batch_to_device, make_optimizer, make_train_step

    names = ("gn_nhwc_stats", "gn_nhwc_apply")

    def delta(fn):
        n0 = launch_counts()
        fn()
        torch.cuda.synchronize()
        n1 = launch_counts()
        return tuple(n1[n] - n0[n] for n in names)

    tc = tiny_config(get_config("MultiviewC"), factor=4)
    rig = _bf16_rig("MultiviewC", 160, 3, "window", cuda)
    loader = SyntheticSceneLoader(tc, num_frames=2, batch_size=2, max_objects=8, seed=3,
                                  num_objects=3)
    batch = batch_to_device(next(iter(loader)), cuda)
    serve = _serving_vfanet(tc, cuda)
    with torch.no_grad():
        assert delta(lambda: serve(batch["images"].to(torch.bfloat16), rig)) == (20, 20)
    fp32 = init_weights(VFANet(tc), torch.Generator().manual_seed(0)).to(cuda).eval()
    with torch.no_grad():      # the backbone and the laterals: no rig in fp32 here
        assert delta(lambda: fp32.laterals(batch["images"])) == (0, 0)
    model = init_weights(VFANet(tc), torch.Generator().manual_seed(0)).to(cuda)
    tcfg = TrainConfig(pretrained=False, compute_dtype="bfloat16")
    step = make_train_step(model, make_optimizer(model, tcfg, 1), tc, tcfg,
                           dim_mean=loader.dim_mean)
    b16 = dict(batch)
    b16["images"] = batch["images"].to(torch.bfloat16)
    assert delta(lambda: step(b16, rig)) == (0, 0)
    cfg = dataclasses.replace(get_config("Wildtrack"), world_size=(32, 96),
                              image_size=(128, 192), resize_size=(64, 96), num_cam=2)
    mv = mvdet_init(MVDet(cfg), torch.Generator().manual_seed(23)).to(cuda)
    mv = mv.to(torch.bfloat16).eval()
    grid = make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name)
    pos = ground_positions(make_calibrations(cfg), grid, cfg.name, cfg.image_size,
                           mv.upsample_shape).to(cuda)
    images = torch.rand(2, 2, 64, 96, 3, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        assert delta(lambda: mv(images, pos)) == (0, 0)
