"""The design of the bf16 stem backward kernels (`csrc/stem_bwd.cu`,
`bf_walk`: stem_bwd_stats_bf16 and stem_bwd_dx_bf16), modelled in torch on
the CPU, where the kernels cannot run, and held against the plain versions
and the JAX package at tiny sizes.

The model follows the kernels step for step: warp items of a strip of
window rows (the dx kernel's BF_DX_STRIP, the stats kernel's
ITEM[bfloat16]) and 240 columns (lanes 1 .. 30 own 8 columns each; lanes 0 and
31 load the 8 columns on either side), one 32-bit key a pixel (z rounded to
bf16 above, a payload that falls in row-major order within every window
below), each window's first maximum as the integer maximum of its row
maxima, and each pixel's dz from the windows whose winner's payload is its
own, added as bf16 pairs in the kernels' order. Its dz must equal
`_dz_plain`'s bit for bit (and so JAX's `_recompute_dz`), every owned pixel
written by exactly one item; its acc must equal `stem_bwd_stats_plain`'s and
JAX's `_pallas_bwd` to fp32 sum order."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vfa_tpu.ops.stem import _pallas_bwd

from vfa_tpu_torch.ops import stem

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

PAY, RW, ROW2 = 0x4000, 256, 512      # the kernels' BF_PAY, BF_RW, 2 * BF_RW
LANES, OWNERS = 32, 30
SOURCE = (Path(stem.__file__).parents[1] / "csrc" / "stem_bwd.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


STATS_STRIP, SEG = stem.ITEM[torch.bfloat16]
DX_STRIP = _const("BF_DX_STRIP")

# (M, C, H, W): one item; odd H with three dx strips, W % 8 == 4 with a
# ragged second segment; three segments (the last 16 columns) and a one-row
# last dx strip; W % 8 == 4 in one segment; W = 4; three stats strips
SHAPES = [(2, 16, 12, 16), (1, 16, 35, 260), (1, 16, 34, 496), (2, 16, 9, 12),
          (1, 16, 20, 4), (1, 16, 130, 12)]


def _inputs(shape, seed, integers):
    rng = np.random.default_rng(seed)
    M, C, H, W = shape
    x = rng.normal(size=shape)
    scale, bias = rng.uniform(0.5, 1.5, C), rng.normal(size=C) * 0.3
    if integers:
        x, scale, bias = np.round(2 * x), np.ones(C), np.zeros(C)
    dy = rng.normal(size=(M, C, (H + 1) // 2, (W + 1) // 2))
    x, scale, bias, dy = (torch.from_numpy(a).float().to(torch.bfloat16)
                          for a in (x, scale, bias, dy))
    _, mu, rstd = stem.group_norm_stats(x, scale, bias, 16, 1e-5)
    return x, scale, bias, dy, mu, rstd


def _rnd(t):
    return t.to(torch.bfloat16).float()


def _model(x, dy, params, strip):
    """dz (M, C, H, W) fp32 holding bf16 values, and acc (M, 4, C), as the
    bf16 kernels compute them, item by item, `strip` window rows an item."""
    M, C, H, W = x.shape
    OH, OW = dy.shape[-2:]
    z = stem.recompute_z(x, params)                        # bf16, as the kernels round it
    bits = z.view(torch.int16).long() & 0xFFFF
    dyf = dy.float()
    p = lambda i: params[:, :, i, None]
    dz_all = torch.full((M, C, H, W), float("nan"))
    s_dz = torch.zeros((M, C))
    s_dzx = torch.zeros((M, C))
    k = torch.arange(RW)                                   # ring columns
    q = torch.arange(4, 4 * LANES)                         # windows of lanes 1 .. 31
    for s in range(-(-OH // strip)):
        oh0, oh1 = s * strip, min(s * strip + strip, OH)
        for seg in range(-(-W // SEG)):
            c0 = seg * SEG - 8                             # lane 0's first column
            cols = c0 + k
            inside = (cols >= 0) & (cols < W)
            colsc = cols.clamp(0, W - 1)

            def row_max(h, r):
                """Each window's greatest key in pixel row h, payloads of
                frame row r; 0 outside the image."""
                if not 0 <= h < H:
                    return torch.zeros((M, C, q.numel()), dtype=torch.long)
                # outside the columns the ring holds zeros: z of x = 0
                zb = torch.where(inside, bits[:, :, h, colsc],
                                 _zero_key_bits(params)[..., None])
                key = (zb << 16) | (PAY - r * RW - k)
                key = torch.where(key >= 2 ** 31, key - 2 ** 32, key)  # int32
                if seg == 0:
                    key[..., 7] = 0                       # column -1: the padding
                return torch.maximum(torch.maximum(key[..., 2 * q - 1], key[..., 2 * q]),
                                     key[..., 2 * q + 1])

            def winners(oh, top):
                vk = torch.maximum(torch.maximum(top + ROW2, row_max(2 * oh, 1)),
                                   row_max(2 * oh + 1, 2))
                ow = c0 // 2 + q
                g = torch.zeros((M, C, q.numel()))
                if oh < OH:
                    ok = (ow >= 0) & (ow < OW)
                    g = torch.where(ok, dyf[:, :, oh, ow.clamp(0, OW - 1)], 0.0)
                g = torch.where(vk >= 2 ** 16, g, 0.0)    # the window passes the ReLU
                return vk & 0xFFFF, g

            def pick(pp, wp, g, a):
                return _rnd(a + torch.where(wp == pp, g, 0.0))

            own = k[8:8 + 8 * OWNERS]                     # lanes 1 .. 30
            wq = own // 2 - 4          # in q: the window centred on the word's even column
            top = row_max(2 * oh0 - 1, 2)
            prev = None
            for oh in range(oh0, oh1 + 1):
                wp, g = winners(oh, top)
                rows = []
                if oh > oh0 and 2 * oh - 1 < H:
                    pwp, pg = prev
                    pp = PAY - own
                    v = pick(pp, pwp[..., wq] + ROW2, pg[..., wq],
                             pick(pp, wp[..., wq], g[..., wq], 0.0))
                    u = pick(pp, pwp[..., wq + 1] + ROW2, pg[..., wq + 1],
                             pick(pp, wp[..., wq + 1], g[..., wq + 1], 0.0))
                    rows.append((2 * oh - 1, _rnd(v + u)))
                if oh < oh1 and 2 * oh < H:
                    pp = PAY - RW - own
                    rows.append((2 * oh, pick(pp, wp[..., wq + 1], g[..., wq + 1],
                                              pick(pp, wp[..., wq], g[..., wq], 0.0))))
                for h, dz in rows:
                    c = c0 + own
                    keep = c < W
                    dz, c = dz[..., keep], c[keep]
                    assert dz_all[:, :, h, c].isnan().all(), "a pixel written twice"
                    dz_all[:, :, h, c] = dz
                    xv = x[:, :, h, c].float()
                    s_dz += dz.sum(-1)
                    s_dzx += (dz * (xv - p(0))).sum(-1)
                top = row_max(2 * oh + 1, 2)
                prev = (wp, g)
    assert not dz_all.isnan().any(), "a pixel no item wrote"
    s_dzx = s_dzx * params[:, :, 1]
    scale = params[:, :, 2]
    return dz_all, torch.stack([s_dz * scale, s_dzx * scale, s_dzx, s_dz], dim=1)


def _zero_key_bits(params):
    """The bf16 bits of z at x = 0 (the ring's zero fill), per plane."""
    z0 = stem.recompute_z(torch.zeros(params.shape[:2] + (1, 1), dtype=torch.bfloat16),
                          params)
    return z0[..., 0, 0].view(torch.int16).long() & 0xFFFF


def test_item_constants_match_the_kernel_source():
    """ops/stem.py::ITEM sizes stem_bwd_stats' scratch; the kernels take
    their own constants from csrc/stem_bwd.cu (and refuse a scratch of
    another count on the card)."""
    assert stem.ITEM[torch.float32] == (_const("STRIP"), _const("SEG"))
    assert stem.ITEM[torch.bfloat16] == (_const("BF_STATS_STRIP"), 8 * _const("BF_OWNERS"))
    assert "constexpr int BF_SEG = 8 * BF_OWNERS;" in SOURCE
    assert stem.items_per_plane(torch.bfloat16, 360, 640) == 6 * 3
    assert stem.items_per_plane(torch.float32, 360, 640) == 36 * 5


@pytest.mark.parametrize("integers", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_model_dz_equals_plain_bit_for_bit(shape, integers):
    """The kernels' dz (routing by payload, bf16 pair sums in their order,
    item ownership with the recomputed boundary window row and the halo
    lanes) against `_dz_plain`, bit for bit; on integer-valued input ties
    decide almost every window."""
    x, scale, bias, dy, mu, rstd = _inputs(shape, 3, integers)
    params = stem.plane_params(mu, rstd, scale, bias)
    got, _ = _model(x, dy, params, DX_STRIP)
    want = stem._dz_plain(x, dy, params)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((want != 0).any())


@pytest.mark.parametrize("integers", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_model_acc_matches_plain(shape, integers):
    """The stats kernel's sums (dz and dz*(x - mean) per item, times rstd)
    against `stem_bwd_stats_plain`: fp32 sum order only, 1e-6 of the max."""
    x, scale, bias, dy, mu, rstd = _inputs(shape, 5, integers)
    params = stem.plane_params(mu, rstd, scale, bias)
    _, acc = _model(x, dy, params, STATS_STRIP)
    want = stem.stem_bwd_stats_plain(x, dy, params)
    np.testing.assert_allclose(acc.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("integers", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("shape", [(1, 16, 34, 496)], ids=str)
def test_model_acc_matches_jax(shape, integers):
    """dscale and dbias (acc's dz*xhat and dz summed over images) of the
    model against JAX's `_pallas_bwd` in interpret mode on the same bf16
    inputs and statistics, to fp32 sum order (1e-6 of the max)."""
    x, scale, bias, dy, mu, rstd = _inputs(shape, 7, integers)
    params = stem.plane_params(mu, rstd, scale, bias)
    _, acc = _model(x, dy, params, STATS_STRIP)
    nhwc = lambda t: jnp.asarray(t.permute(0, 2, 3, 1).float().numpy(), jnp.bfloat16)
    as_j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    _, dscale, dbias = _pallas_bwd(nhwc(x), as_j(scale), as_j(bias),
                                   jnp.asarray(mu.numpy()), jnp.asarray(rstd.numpy()),
                                   nhwc(dy), 16, 1e-5, interpret=True)
    for got, want in ((acc[:, 2].sum(0), dscale), (acc[:, 3].sum(0), dbias)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), want,
                                   rtol=0, atol=1e-6 * np.abs(want).max())
