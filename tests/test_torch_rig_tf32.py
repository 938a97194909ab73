"""The arithmetic of the rig kernels' tensor-core passes, on the CPU.

`csrc/rig_mma.cuh` computes every product of the rig forward and backward
as 3xTF32: operands split into TF32 hi and lo parts, three TF32 products
summed in fp32. No kernel runs here; `ops.rig.tf32_split` and
`matmul_3xtf32` are the same arithmetic in plain PyTorch, and these tests
pin what it promises: the split loses at most 2^-21 of a value, the
forward's two products (vox, then the collapse as one product of depth
nl*C) and each of the four products of `window_tiles_bwd` /
`flat_tiles_bwd` redone with it agree with the fp32 result within 1e-5 of
its max (both sides round ~1e-7 per term, over bands of up to a few hundred
pixels), and one TF32 product alone does not reach the kernels' 1e-4
tolerance."""

import numpy as np
import pytest
import torch

from vfa_tpu_torch.config import get_config
from vfa_tpu_torch.data.synthetic import make_calibrations, tiny_config
from vfa_tpu_torch.geometry import make_grid
from vfa_tpu_torch.ops import rig as trig

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RIGS = {"window": dict(layout="window"),
        "flat": dict(layout="flat"),
        "flat-taps": dict(layout="flat", fold_prefix=False, band_buckets=1)}


def _rig(kind):
    cfg = tiny_config(get_config("MultiviewC"))
    return trig.build_rig(
        make_calibrations(cfg), cfg,
        make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
        trig.pyramid_feat_shapes(cfg.resize_size), tile_v=16, device="cpu",
        **RIGS[kind])


def _bucket_inputs(sr, bi, B, rng):
    """ii, A_b, pix, Kr, g_b of bucket bi of a scale, inputs from numpy."""
    fh, fw = sr.feat_hw
    A_b, s_b = sr.A[bi], sr.starts[bi]
    N, T = A_b.shape[:2]
    lat = rng.uniform(size=(B, N, fh, fw, 256)).astype(np.float32)
    if not sr.on_raw:
        lat /= fh * fw       # the 2D cumsum stays O(1)
    ii = trig.scale_features(torch.from_numpy(lat), sr)
    k = rng.normal(size=(256 * sr.nl, 256)).astype(np.float32) * 0.05
    Kr = trig.collapse_per_layer(torch.from_numpy(k), 256, sr.nl, torch.float32)
    g_b = torch.from_numpy(
        rng.normal(size=(N, B, T * sr.tile_v, 256)).astype(np.float32))
    if sr.window_hw:
        pix = trig._window_pixels(s_b, N, T, ii.shape[2], ii.shape[3],
                                  sr.window_hw[bi])
    else:
        pix = trig._band_pixels(s_b, N, T, ii.shape[2], A_b.shape[-1])
    return ii, A_b, pix, Kr, g_b


def _bands(ii, A_b, pix):
    """The bucket's bands (N, T, K, B*C), as `ops.rig._band_vox` reads them."""
    N, B, C = ii.shape[0], ii.shape[1], ii.shape[-1]
    T, _, K = A_b.shape[1:]
    flat = ii.reshape(N, B, -1, C).permute(0, 2, 1, 3).reshape(-1, B * C)
    return flat.index_select(0, pix.reshape(-1)).reshape(N, T, K, B * C)


def _forward_products(ii, A_b, pix, Kr, tile_v, mm):
    """The two products of the forward kernels through the matrix product
    `mm`: vox = A @ band, then the collapse as `rig_collapse_mma` computes
    it, one product of depth nl*C whose row (t, v) is vox[t][l*tile_v + v][c]
    at depth l*C + c, against Kr seen as (nl*C, n_out). The collapse takes
    `mm`'s own vox, as the kernel does. Returns (vox (N, T, R, B*C), tiles
    (N, B, T*tile_v, n_out))."""
    N, B, C = ii.shape[0], ii.shape[1], ii.shape[-1]
    T = A_b.shape[1]
    nl, _, n_out = Kr.shape
    vox = mm(A_b, _bands(ii, A_b, pix))
    rows = (vox.reshape(N, T, nl, tile_v, B, C).permute(0, 4, 1, 3, 2, 5)
            .reshape(N, B, T * tile_v, nl * C))
    return vox, mm(rows, Kr.reshape(nl * C, n_out))


def _four_products(ii, A_b, pix, Kr, g_b, tile_v, mm):
    """The four products of `ops.rig._tiles_bwd` through the matrix product
    `mm`: (vox, dKr, dvox, dband). dKr, dvox and dband take the fp32 vox and
    dvox as operands, so each product is held against its own fp32 twin."""
    N, B, C = ii.shape[0], ii.shape[1], ii.shape[-1]
    T, R, K = A_b.shape[1:]
    nl, _, n_out = Kr.shape
    bands = _bands(ii, A_b, pix)
    vox = mm(A_b, bands)                                      # (N, T, R, B*C)
    vox32 = torch.matmul(A_b, bands).reshape(N, T, nl, tile_v, B, C)
    g = g_b.reshape(N, B, T, tile_v, n_out)
    # dKr[l] = vox_l^T @ g over the depth (n, b, t, v)
    vox_l = vox32.permute(2, 5, 0, 4, 1, 3).reshape(nl, C, -1)
    dKr = mm(vox_l, g.reshape(-1, n_out))                                      # (nl, C, n_out)
    dvox = mm(g.reshape(-1, n_out), Kr.transpose(1, 2)[:, None])
    dvox32 = torch.einsum("nbtvo,lco->ntlvbc", g, Kr).reshape(N, T, R, B * C)
    dband = mm(A_b.transpose(-1, -2), dvox32)                 # (N, T, K, B*C)
    return vox, dKr, dvox, dband


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _tf32(products):
    return lambda a, b: trig.matmul_3xtf32(a, b, products)


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_split_keeps_21_bits(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=20000) * 10.0 ** rng.uniform(-20, 20, size=20000)
    x = torch.from_numpy(x.astype(np.float32))
    hi, lo = trig.tf32_split(x)
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # hi is x to nearest at 10 mantissa bits, lo the remainder likewise
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11
    err = (x.double() - hi.double() - lo.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -21


def test_tf32_split_rounds_ties_away_and_keeps_tf32_values():
    one_ulp = 2.0 ** -10                      # TF32 spacing in [1, 2)
    x = torch.tensor([1.0, 1.0 + one_ulp, 1.0 + one_ulp / 2, -1.0 - one_ulp / 2,
                      1.0 + one_ulp / 4, 0.0, 2.0 ** -126])
    hi, lo = trig.tf32_split(x)
    want = torch.tensor([1.0, 1.0 + one_ulp, 1.0 + one_ulp, -1.0 - one_ulp, 1.0,
                         0.0, 2.0 ** -126])
    assert torch.equal(hi, want)
    assert torch.equal(hi + lo, x)


@pytest.mark.parametrize("products,bound", [(1, 2e-3), (3, 2e-6), (4, 2e-6)])
def test_matmul_3xtf32_against_float64(products, bound):
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.normal(size=(48, 640)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(640, 40)).astype(np.float32))
    ref = a.double() @ b.double()
    err = float((trig.matmul_3xtf32(a, b, products).double() - ref).abs().max()
                / ref.abs().max())
    assert err < bound
    if products == 1:
        assert err > 1e-5      # one product is visibly worse than three


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("kind", list(RIGS))
def test_backward_products_3xtf32_match_fp32(kind, B, seed):
    """Every bucket of every scale: the plain-matmul products equal
    `window_tiles_bwd` / `flat_tiles_bwd` (which guards this file's own
    reading of them), and the 3xTF32 products agree within 1e-5 of the
    max."""
    rig = _rig(kind)
    rng = np.random.default_rng(100 * seed + B)
    worst = 0.0
    for sr in rig.scales:
        assert sr.on_raw == (kind != "flat-taps")
        for bi in range(len(sr.A)):
            ii, A_b, pix, Kr, g_b = _bucket_inputs(sr, bi, B, rng)
            plain = _four_products(ii, A_b, pix, Kr, g_b, sr.tile_v, torch.matmul)
            dII, dKr = trig._tiles_bwd(ii, A_b, pix, Kr, g_b, sr.tile_v, None)
            assert _rel(plain[1], dKr) < 1e-5
            N, T, K = pix.shape
            dflat = torch.zeros((ii[:, 0].numel() // 256, B * 256))
            dflat.index_add_(0, pix.reshape(-1), plain[3].reshape(N * T * K, -1))
            got = dflat.reshape(N, -1, B, 256).permute(0, 2, 1, 3).reshape(ii.shape)
            assert _rel(got, dII) < 1e-5
            three = _four_products(ii, A_b, pix, Kr, g_b, sr.tile_v, _tf32(3))
            for name, a, b in zip(("vox", "dKr", "dvox", "dband"), three, plain):
                err = _rel(a, b)
                worst = max(worst, err)
                assert err < 1e-5, (name, err)
    assert worst > 0.0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("kind", list(RIGS))
def test_forward_products_3xtf32_match_fp32(kind, B, seed):
    """Every bucket of every scale: the forward kernels' two products read
    with plain matmul equal `window_tiles` / `flat_tiles` (which guards this
    file's reading of them: the collapse as one product of depth nl*C), and
    redone in 3xTF32, vox feeding the collapse as in the kernel, they agree
    with `_tiles_fwd` within 1e-5 of its max."""
    rig = _rig(kind)
    rng = np.random.default_rng(100 * seed + B + 50)
    worst = 0.0
    for sr in rig.scales:
        assert sr.on_raw == (kind != "flat-taps")
        for bi in range(len(sr.A)):
            ii, A_b, pix, Kr, _ = _bucket_inputs(sr, bi, B, rng)
            want = trig._tiles_fwd(ii, A_b, pix, Kr, sr.tile_v)
            if sr.window_hw:
                ref = trig.window_tiles(ii, A_b, sr.starts[bi], Kr,
                                        sr.window_hw[bi], sr.tile_v)
            else:
                ref = trig.flat_tiles(ii, A_b, sr.starts[bi], Kr, sr.tile_v)
            assert torch.equal(ref, want)
            vox32, plain = _forward_products(ii, A_b, pix, Kr, sr.tile_v,
                                             torch.matmul)
            assert torch.equal(vox32, trig._band_vox(ii, A_b, pix))
            assert _rel(plain, want) < 1e-6
            vox, three = _forward_products(ii, A_b, pix, Kr, sr.tile_v, _tf32(3))
            for name, a, b in (("vox", vox, vox32), ("tiles", three, want)):
                err = _rel(a, b)
                worst = max(worst, err)
                assert err < 1e-5, (name, err)
    assert worst > 0.0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("B", [1, 2])
def test_single_tf32_product_misses_kernel_tolerance(B, seed):
    """On the 16-tap rig (cumsum'd features: large values that cancel) one
    TF32 product is off by more than the kernels' 1e-4 of the max: the
    reason a single product is not offered."""
    rig = _rig("flat-taps")
    rng = np.random.default_rng(100 * seed + B)
    worst = {}
    for sr in rig.scales:
        for bi in range(len(sr.A)):
            args = _bucket_inputs(sr, bi, B, rng)
            plain = _four_products(*args, sr.tile_v, torch.matmul)
            one = _four_products(*args, sr.tile_v, _tf32(1))
            for name, a, b in zip(("vox", "dKr", "dvox", "dband"), one, plain):
                worst[name] = max(worst.get(name, 0.0), _rel(a, b))
    assert max(worst.values()) > 1e-4, worst
