"""Fused stem tail: GroupNorm(16) + ReLU + 3x3/stride-2 max-pool (port of
`vfa_tpu/ops/stem.py`), NCHW.

The stem's norm + activation + pool right after conv1 run on the largest
activation of the network ((B*N, 64, 360, 640) at full MultiviewC width).
`gn_relu_pool` computes exactly what the unfused chain computes (its
forward IS that chain: `F.group_norm`, `relu`, `max_pool2d(3, 2, 1)`), but
keeps only (x, scale, bias) and the GroupNorm's per-(image, group) mean and
rstd for the backward, instead of the normalized and the rectified
activations and the pool's indices. The backward runs two hand-written
kernels (`csrc/stem_bwd.cu`) that rebuild relu(z) and the pool's
first-maximum routing from x:

    stem_bwd_stats: one pass over (x, dy) -> per (image, channel) the sums
                    sum dxhat, sum dxhat*xhat, sum dz*xhat, sum dz
    (here: the per-(image, group) means c1, c2 and dscale, dbias)
    stem_bwd_dx:    one pass over (x, dy, c1, c2) -> dx

Max-pool ties (common: ReLU plateaus at 0) send the gradient to the FIRST
maximum of a window in row-major order, as `max_pool2d`'s backward and the
JAX package do. Which pixel is a maximum, and whether it passes the ReLU,
is decided on the recomputed z, so z must come out bit for bit as in the
forward: the statistics are the forward's own (the JAX package recomputes
them, but there the same expression yields the same bits; a second
reduction in another order does not, and a group mean that is 0 in one and
1e-9 in the other flips every x == 0 pixel of the group), and the kernels
evaluate z = a*x + b, a = rstd*scale, b = -a*mean + bias with the roundings
of `native_group_norm`'s CUDA kernel (`recompute_z`). On bf16 (x, dy and dx bf16, the
statistics, the sums and the arithmetic fp32: the bf16 instances of the
JAX kernels) z is rounded to bf16 as the forward stored it, before the ReLU
and every comparison, and a pixel's gradient rounds where JAX's
`_recompute_dz` rounds it (`_dz_plain`).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. `gn_relu_pool_bwd_plain` is autograd of the
unfused chain, the reference of the whole backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vfa_tpu_torch.kernels import LaunchCount


def _chain(x, scale, bias, num_groups, eps):
    """The unfused stem tail, op for op."""
    return F.max_pool2d(
        torch.relu(F.group_norm(x, num_groups, scale, bias, eps)), 3, 2, 1)


def group_norm_stats(x, scale, bias, num_groups: int, eps: float):
    """(group_norm(x), mean, rstd) as `F.group_norm` computes them (it
    dispatches to the same `native_group_norm`); mean, rstd are (M, G), the
    statistics z was normalised with. On a CUDA tensor those are the ones
    the call returns (in x's dtype: the kernel rounds them before use); on
    a bf16 CPU tensor the kernel normalises with fp32 statistics and
    returns them rounded, so the fp32 ones are taken here
    (`tools/probe_gn_stats.py` shows both)."""
    M, C, H, W = x.shape
    z, mu, rstd = torch.native_group_norm(x.contiguous(), scale, bias, M, C,
                                          H * W, num_groups, eps)
    if x.device.type == "cpu" and x.dtype != torch.float32:
        _, mu, rstd = torch.native_group_norm(
            x.float().contiguous(), scale.float(), bias.float(), M, C, H * W,
            num_groups, eps)
    return z, mu, rstd


def plane_params(mu, rstd, scale, bias, c1=None, c2=None) -> torch.Tensor:
    """The per-(image, channel) scalars both kernels read, (M, C, 8) fp32:
    mean, rstd, scale, bias, c1, c2 (zeros when not given), 0, 0. mu, rstd,
    c1, c2 are (M, G)."""
    M, G = mu.shape
    C = scale.shape[0]
    per_c = lambda t: t.float().repeat_interleave(C // G, dim=1)   # (M, C)
    zero = torch.zeros((M, C), dtype=torch.float32, device=mu.device)
    return torch.stack([
        per_c(mu), per_c(rstd), scale.float().expand(M, C),
        bias.float().expand(M, C),
        per_c(c1) if c1 is not None else zero,
        per_c(c2) if c2 is not None else zero, zero, zero], dim=2).contiguous()


def _fma(a, b, c):
    """a*b + c rounded once to fp32, as a fused multiply-add rounds it. The
    product of two floats is exact in float64 and their sum s with c is
    rounded there, so s + e == a*b + c with e from Knuth's two-sum; s
    rounded to fp32 is the fused result unless s lies halfway between two
    floats and e is not 0, where it moves one float toward e."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    f = s.float()
    d = s - f.double()
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=f.device)
    nxt = torch.nextafter(f, torch.where(d > 0, inf, -inf))
    tie = (d != 0) & ((nxt.double() - f.double()).abs() == 2 * d.abs())
    return torch.where(tie & (e * d > 0), nxt, f)


def recompute_z(x, params) -> torch.Tensor:
    """z = a*x + b in x's dtype, a = rstd*scale, b = -a*mean + bias, rounded
    as `native_group_norm` on x's device and dtype rounds it, and the
    kernels with it: a one product, z one fused multiply-add, then to x's
    dtype; b one fused multiply-add, but on an fp32 CUDA tensor a product
    and an add, each rounded (`tools/probe_gn_stats.py --candidates`)."""
    p = lambda i: params[:, :, i, None, None]
    a = p(1) * p(2)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        b = -a * p(0) + p(3)
    else:
        b = _fma(-a, p(0), p(3))
    return _fma(a, x.float(), b).to(x.dtype)


def _dz_plain(x, dy, params):
    """Cotangent of z = a*x + b through relu and the pool, fp32: z rounded
    as the kernels (and the forward's GroupNorm on the card) round it, then
    to x's dtype, as the forward stored it; each pool window's dy goes to its
    first maximum in row-major order, if that passes the ReLU (found, as JAX
    does, as the first maximum along W, then along H). A pixel's gradient
    sums the windows that chose it as JAX's `_recompute_dz` does, rounded to
    x's dtype where it rounds `da` on bf16: first the two window rows that
    meet on an odd row (per window column), then the two window columns that
    meet on an odd column."""
    rnd = lambda t: t.to(x.dtype).float()
    act = torch.relu(recompute_z(x, params).float())
    H, W = x.shape[-2:]
    OH, OW = dy.shape[-2:]
    # window (l, q) covers rows 2l .. 2l+2 and columns 2q .. 2q+2 of `ap`
    ap = F.pad(act, (1, 2 * OW - W, 1, 2 * OH - H), value=float("-inf"))

    def first_max(v0, v1, v2):
        m = torch.maximum(torch.maximum(v0, v1), v2)
        return m, torch.where(v0 >= m, 0, torch.where(v1 >= m, 1, 2))

    pw, col = first_max(ap[..., 0:2 * OW:2], ap[..., 1:2 * OW:2],
                        ap[..., 2::2])                    # (.., 2OH+1, OW)
    mx, row = first_max(pw[..., 0:2 * OH:2, :], pw[..., 1:2 * OH:2, :],
                        pw[..., 2::2, :])                 # (.., OH, OW)
    g = torch.where(mx > 0, dy.float(), 0.0)
    pick = lambda sel, v, i: torch.where(sel == i, v, 0.0)
    dpw = torch.zeros_like(pw)
    dpw[..., 1::2, :] = pick(row, g, 1)
    dpw[..., 0::2, :] = rnd(F.pad(pick(row, g, 0), (0, 0, 0, 1))
                            + F.pad(pick(row, g, 2), (0, 0, 1, 0)))
    da = torch.zeros_like(ap)
    da[..., 1::2] = pick(col, dpw, 1)
    da[..., 0::2] = rnd(F.pad(pick(col, dpw, 0), (0, 1))
                        + F.pad(pick(col, dpw, 2), (1, 0)))
    return da[..., 1:H + 1, 1:W + 1]


def _xhat(x, params):
    return (x.float() - params[:, :, 0, None, None]) * params[:, :, 1, None, None]


def stem_bwd_stats_plain(x, dy, params) -> torch.Tensor:
    """Plain PyTorch version of `stem_bwd_stats`: acc (M, 4, C) fp32."""
    dz = _dz_plain(x, dy, params)
    s_dz = dz.sum((2, 3))
    s_dzx = (dz * _xhat(x, params)).sum((2, 3))
    scale = params[:, :, 2]
    return torch.stack([s_dz * scale, s_dzx * scale, s_dzx, s_dz], dim=1)


def stem_bwd_dx_plain(x, dy, params) -> torch.Tensor:
    """Plain PyTorch version of `stem_bwd_dx`: dx (M, C, H, W), computed in
    fp32 and rounded once to x's dtype."""
    dz = _dz_plain(x, dy, params)
    p = lambda i: params[:, :, i, None, None]
    return (p(1) * (dz * p(2) - p(4) - _xhat(x, params) * p(5))).to(x.dtype)


def _check_launch(what, x, dy, params):
    """One device, contiguous, the shapes of one stem tail; x and dy both
    float32 or both bfloat16 (then W a multiple of 4), params float32."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    M, C, H, W = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dtype == torch.bfloat16 and W % 4:
        raise ValueError(f"{what}: the bf16 kernels take a width that is a "
                         f"multiple of 4, got {W}")
    want = {"x": (x, (M, C, H, W), x.dtype),
            "dy": (dy, (M, C, (H - 1) // 2 + 1, (W - 1) // 2 + 1), x.dtype),
            "params": (params, (M, C, 8), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype} (x is {x.dtype}), "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if M * C > 65535:
        raise ValueError(f"{what}: at most 65535 (image, channel) planes, "
                         f"got {M * C}")


# stem_bwd_stats (`csrc/stem_bwd.cu`) gives one warp to each item of one
# plane: (pool-window rows, columns) an item, the kernel's (STRIP, SEG) for
# fp32 and (BF_STATS_STRIP, BF_SEG) for bf16. Its scratch holds a pair of
# sums per item, and the kernel refuses a scratch of another count.
ITEM = {torch.float32: (5, 128), torch.bfloat16: (30, 240)}


def items_per_plane(dtype, H: int, W: int) -> int:
    """Warp items of one (image, channel) plane of an (H, W) stem tail."""
    strip, seg = ITEM[dtype]
    return -(-((H - 1) // 2 + 1) // strip) * -(-W // seg)


def _launch(fn, x, dy, params, *outs, extra=()):
    """Launch the variant of kernel `fn` for x's dtype."""
    from vfa_tpu_torch.kernels import launch

    suffix = "bf16" if x.dtype == torch.bfloat16 else "f32"
    launch("stem_bwd", f"{fn}_{suffix}", x.device, x.data_ptr(), dy.data_ptr(),
           params.data_ptr(), *(t.data_ptr() for t in outs), *x.shape, *extra)


def stem_bwd_stats(x: torch.Tensor, dy: torch.Tensor,
                   params: torch.Tensor) -> torch.Tensor:
    """Pass 1 of the backward: acc (M, 4, C) fp32 with, per (image,
    channel), sum dz*scale, sum dz*scale*xhat, sum dz*xhat, sum dz.

    x (M, C, H, W), dy (M, C, ceil(H/2), ceil(W/2)), both float32 or both
    bfloat16, params from `plane_params` (c1, c2 are not read).
    `stem_bwd_stats.launches` counts fp32 kernel launches,
    `stem_bwd_stats_bf16.launches` bf16 ones."""
    if x.device.type == "cpu":
        return stem_bwd_stats_plain(x, dy, params)
    _check_launch("stem_bwd_stats", x, dy, params)
    M, C, H, W = x.shape
    # per-item sums between the kernel's two stages
    items = items_per_plane(x.dtype, H, W)
    partial = torch.empty((M * C, items, 2),
                          dtype=torch.float32, device=x.device)
    acc = torch.empty((M, 4, C), dtype=torch.float32, device=x.device)
    _launch("stem_bwd_stats", x, dy, params, partial, acc, extra=(items,))
    (stem_bwd_stats_bf16 if x.dtype == torch.bfloat16 else stem_bwd_stats).launches += 1
    return acc


stem_bwd_stats.launches = 0


def stem_bwd_dx(x: torch.Tensor, dy: torch.Tensor,
                params: torch.Tensor) -> torch.Tensor:
    """Pass 2 of the backward: dx = rstd * (dz*scale - c1 - xhat*c2),
    computed in fp32 and written in x's dtype, with c1, c2 in `params`.
    `stem_bwd_dx.launches` counts fp32 kernel launches,
    `stem_bwd_dx_bf16.launches` bf16 ones."""
    if x.device.type == "cpu":
        return stem_bwd_dx_plain(x, dy, params)
    _check_launch("stem_bwd_dx", x, dy, params)
    dx = torch.empty_like(x)
    _launch("stem_bwd_dx", x, dy, params, dx)
    (stem_bwd_dx_bf16 if x.dtype == torch.bfloat16 else stem_bwd_dx).launches += 1
    return dx


stem_bwd_dx.launches = 0
stem_bwd_stats_bf16 = LaunchCount()
stem_bwd_dx_bf16 = LaunchCount()


def gn_relu_pool_bwd(x, scale, bias, dy, mu, rstd):
    """(dx, dscale, dbias) through the two kernels (their plain versions on
    the CPU), with the small reductions between them in torch. mu, rstd
    (M, G) are the forward's GroupNorm statistics."""
    M, C, H, W = x.shape
    G = mu.shape[1]
    gs = C // G
    x, dy = x.contiguous(), dy.contiguous()
    acc = stem_bwd_stats(x, dy, plane_params(mu, rstd, scale, bias))
    n = H * W * gs
    c1 = acc[:, 0].reshape(M, G, gs).sum(2) / n
    c2 = acc[:, 1].reshape(M, G, gs).sum(2) / n
    dx = stem_bwd_dx(x, dy, plane_params(mu, rstd, scale, bias, c1, c2))
    return (dx, acc[:, 2].sum(0).to(scale.dtype),
            acc[:, 3].sum(0).to(bias.dtype))


def gn_relu_pool_bwd_plain(x, scale, bias, dy, num_groups: int = 16,
                           eps: float = 1e-5):
    """Reference backward: autograd of the unfused chain."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
        y = _chain(*leaves, num_groups, eps)
        return torch.autograd.grad(y, leaves, dy)


class GnReluPool(torch.autograd.Function):
    """The chain's forward; only x, scale, bias and the (M, G) statistics
    are kept for the backward, which recomputes everything else from x."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps):
        z, mu, rstd = group_norm_stats(x, scale, bias, num_groups, eps)
        ctx.save_for_backward(x, scale, bias, mu, rstd)
        return F.max_pool2d(torch.relu_(z), 3, 2, 1)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        # read once: under torch.utils.checkpoint (stem_remat) each saved
        # tensor is recomputed and may be unpacked only once
        x, scale, bias, mu, rstd = ctx.saved_tensors
        dx, dscale, dbias = gn_relu_pool_bwd(x, scale, bias, dy, mu, rstd)
        return dx, dscale, dbias, None, None


def gn_relu_pool(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 num_groups: int = 16, eps: float = 1e-5) -> torch.Tensor:
    """max_pool(relu(group_norm(x))) for x (M, C, H, W) -> (M, C, ceil(H/2),
    ceil(W/2)), differentiable in x, scale and bias."""
    if x.shape[1] % num_groups:
        raise ValueError(f"{x.shape[1]} channels do not split into "
                         f"{num_groups} groups")
    return GnReluPool.apply(x, scale, bias, num_groups, eps)
