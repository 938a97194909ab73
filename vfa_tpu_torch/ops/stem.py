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
of `native_group_norm`'s CUDA kernel.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. `gn_relu_pool_bwd_plain` is autograd of the
unfused chain, the reference of the whole backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable


def _chain(x, scale, bias, num_groups, eps):
    """The unfused stem tail, op for op."""
    return F.max_pool2d(
        torch.relu(F.group_norm(x, num_groups, scale, bias, eps)), 3, 2, 1)


def group_norm_stats(x, scale, bias, num_groups: int, eps: float):
    """(group_norm(x), mean, rstd) as `F.group_norm` computes them (it
    dispatches to the same `native_group_norm`); mean, rstd are (M, G)."""
    M, C, H, W = x.shape
    return torch.native_group_norm(x.contiguous(), scale, bias, M, C, H * W,
                                   num_groups, eps)


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
    """a*b + c rounded once, as a fused multiply-add rounds it: the product
    of two floats is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _dz_plain(x, dy, params):
    """Cotangent of z = a*x + b through relu and the pool, by autograd of
    those two ops alone; z rounded as the kernels (and the forward's
    GroupNorm on the card) round it."""
    p = lambda i: params[:, :, i, None, None]
    a = p(1) * p(2)
    z = _fma(a, x.float(), _fma(-a, p(0), p(3))).requires_grad_()
    with torch.enable_grad():
        y = F.max_pool2d(torch.relu(z), 3, 2, 1)
        (dz,) = torch.autograd.grad(y, z, dy.float())
    return dz


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
    """Plain PyTorch version of `stem_bwd_dx`: dx (M, C, H, W) fp32."""
    dz = _dz_plain(x, dy, params)
    p = lambda i: params[:, :, i, None, None]
    return p(1) * (dz * p(2) - p(4) - _xhat(x, params) * p(5))


def _check_launch(what, x, dy, params):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    M, C, H, W = x.shape
    want = {"x": (x, (M, C, H, W)),
            "dy": (dy, (M, C, (H - 1) // 2 + 1, (W - 1) // 2 + 1)),
            "params": (params, (M, C, 8))}
    for name, (t, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32 (the bf16 variants "
                            f"come with bf16 training, ROADMAP.md Queue 1 item 9), "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if M * C > 65535:
        raise ValueError(f"{what}: at most 65535 (image, channel) planes, "
                         f"got {M * C}")


# Both kernels (`csrc/stem_bwd.cu`) give one warp to each item of one plane,
# STRIP pool-window rows and 128 columns; must equal the kernel's STRIP.
STRIP = 5


def _launch(fn, x, dy, params, *outs):
    from vfa_tpu_torch.kernels import launch

    launch("stem_bwd", fn, x.device, x.data_ptr(), dy.data_ptr(),
           params.data_ptr(), *(t.data_ptr() for t in outs), *x.shape)


def stem_bwd_stats(x: torch.Tensor, dy: torch.Tensor,
                   params: torch.Tensor) -> torch.Tensor:
    """Pass 1 of the backward: acc (M, 4, C) fp32 with, per (image,
    channel), sum dz*scale, sum dz*scale*xhat, sum dz*xhat, sum dz.

    x (M, C, H, W), dy (M, C, ceil(H/2), ceil(W/2)), params from
    `plane_params` (c1, c2 are not read). `stem_bwd_stats.launches` counts kernel launches."""
    if x.device.type == "cpu":
        return stem_bwd_stats_plain(x, dy, params)
    _check_launch("stem_bwd_stats", x, dy, params)
    M, C, H, W = x.shape
    # per-item sums between the kernel's two stages
    items = -(-((H - 1) // 2 + 1) // STRIP) * -(-W // 128)
    partial = torch.empty((M * C, items, 2),
                          dtype=torch.float32, device=x.device)
    acc = torch.empty((M, 4, C), dtype=torch.float32, device=x.device)
    _launch("stem_bwd_stats_f32", x, dy, params, partial, acc)
    stem_bwd_stats.launches += 1
    return acc


stem_bwd_stats.launches = 0


def stem_bwd_dx(x: torch.Tensor, dy: torch.Tensor,
                params: torch.Tensor) -> torch.Tensor:
    """Pass 2 of the backward: dx = rstd * (dz*scale - c1 - xhat*c2), fp32,
    with c1, c2 in `params`. `stem_bwd_dx.launches` counts kernel
    launches."""
    if x.device.type == "cpu":
        return stem_bwd_dx_plain(x, dy, params)
    _check_launch("stem_bwd_dx", x, dy, params)
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _launch("stem_bwd_dx_f32", x, dy, params, dx)
    stem_bwd_dx.launches += 1
    return dx


stem_bwd_dx.launches = 0


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
    return (dx.to(x.dtype), acc[:, 2].sum(0).to(scale.dtype),
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
        dx, dscale, dbias = gn_relu_pool_bwd(*ctx.saved_tensors[:3], dy,
                                             *ctx.saved_tensors[3:])
        return dx, dscale, dbias, None, None


def gn_relu_pool(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 num_groups: int = 16, eps: float = 1e-5) -> torch.Tensor:
    """max_pool(relu(group_norm(x))) for x (M, C, H, W) -> (M, C, ceil(H/2),
    ceil(W/2)), differentiable in x, scale and bias."""
    if x.shape[1] % num_groups:
        raise ValueError(f"{x.shape[1]} channels do not split into "
                         f"{num_groups} groups")
    return GnReluPool.apply(x, scale, bias, num_groups, eps)
