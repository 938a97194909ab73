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
