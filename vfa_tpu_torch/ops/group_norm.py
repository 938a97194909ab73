"""The backbone's norms, each with what follows it: the norm alone (a
downsample's), then a ReLU (a block's first), the residual add and a ReLU
(a block's second), or a ReLU and the stem's 3x3 / stride-2 / pad-1
max-pool.

`norm_act` chooses for one norm. A `nn.GroupNorm` on a bf16 CUDA tensor
that needs no gradient takes `group_norm_nhwc`: one call of
`csrc/gn_nhwc.cu` on the channels-last tensor, the statistics (counted in
`gn_nhwc_stats.launches`) and the apply pass with its epilogue
(`gn_nhwc_apply.launches`), whose output is channels-last too, so that
cuDNN convolves the next layer without converting it. `gn_nhwc_stats` and
`gn_nhwc_apply` run each pass alone through the same entry (`gn_nhwc`;
the tests feed the apply pass ATen's statistics). Every other call, a
BatchNorm's (MVDet's trunk), a training step's, fp32 and a CPU tensor's,
takes `group_norm_act_plain`, the library chain the kernels replace: the
norm module, then `torch.relu`, the add and `F.max_pool2d`. The fused stem's switch
(`fused_stem`) chooses that chain's backward only (`ops/stem.py`).

The kernels round as the chain does on a bf16 CUDA tensor: the statistics
rounded to bf16, a = rstd * scale one product, b = -a * mean + bias and
z = a * x + b one fused multiply-add each, z rounded once to bf16, then
the epilogue in the chain's order (`apply_plain`, the apply pass's plain
version). So fed the library's statistics the apply pass gives the
chain's bits, and with its own, which sum in another order, the chain's
bits except where a statistic lies next to a bf16 rounding boundary (or
is a mean near 0, whose bf16 ulp is finer than the sums' difference).

On a CPU tensor `group_norm_nhwc` runs the plain chain; on a CUDA tensor it
launches both passes or raises. No autograd: serving only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vfa_tpu_torch.ops import needs_grad
from vfa_tpu_torch.ops.stem import plane_params, recompute_z

ACTS = ("none", "relu", "add_relu", "relu_pool")
MODES = {act: i for i, act in enumerate(ACTS)}
THREADS = 256     # the kernels' block: C / 8 threads a pixel must divide it
STATS_BLOCK = THREADS * 32   # 16-byte vectors a block of the statistics' first kernel

# How close VFANet's bf16 serving forward through the kernels comes to the
# library route's, the parent's (`tests/test_torch_kernels_gpu.py`). Two
# causes part them, and neither is an error: cuDNN picks other convolution
# algorithms for channels-last activations than for NCHW ones (the library
# chain run through channels-last convolutions already parts from the NCHW
# route; fed ATen's statistics, the kernels give that chain's bits), and the
# kernels' statistics sum in another order than native_group_norm's, so a
# group whose fp32 mean or rstd lies next to a bf16 rounding boundary rounds
# to the neighbouring bf16. Twenty norms of seeded random weights and the
# heads then carry a few ulps on, and values near 0 change sign. Measured on
# an H100 at batch 2 of MultiviewC: 64-96 % of each output within one bf16
# ulp (the size head's 64 % the least); the least share held to is this.
FORWARD_ULP_SHARE = 0.5


def group_norm_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         num_groups: int, eps: float, act: str = "none",
                         identity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(group_norm(x)) by the library, op for op: `F.group_norm`, then
    nothing, `torch.relu`, `torch.relu(. + identity)` or
    `F.max_pool2d(torch.relu(.), 3, 2, 1)`."""
    return _epilogue(F.group_norm(x, num_groups, weight, bias, eps), act, identity)


def _epilogue(y, act, identity):
    if act == "relu":
        return torch.relu(y)
    if act == "add_relu":
        return torch.relu(y + identity)
    if act == "relu_pool":
        return F.max_pool2d(torch.relu(y), 3, 2, 1)
    if act != "none":
        raise ValueError(f"unknown epilogue {act!r}, expected one of {ACTS}")
    return y


def apply_plain(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, act: str = "none",
                identity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The apply pass's arithmetic in PyTorch: x (M, C, H, W) normalised
    with stats (M, G, 2) (mean, rstd), rounded to x's dtype first, and the
    kernel's roundings (`ops/stem.py::recompute_z`), then the epilogue as
    the library runs it. x's device does not change the arithmetic."""
    mu, rstd = (stats[..., i].to(x.dtype) for i in (0, 1))
    z = recompute_z(x, plane_params(mu, rstd, weight, bias))
    return _epilogue(z, act, identity)


def _check_channels_last(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous(memory_format=torch.channels_last) or t.data_ptr() % 16:
            raise ValueError("gn_nhwc: x and the identity must be channels-last and 16-byte "
                             f"aligned, got strides {t.stride()}")


def stats_blocks(C: int, H: int, W: int) -> int:
    """Blocks an image in the statistics' first kernel (`csrc/gn_nhwc.cu::
    stats_blocks`), each leaving (n, mean, M2) a group."""
    return -(-(H * W * C // 8) // STATS_BLOCK)


def gn_nhwc(x: torch.Tensor, num_groups: int, eps: float = 0.0,
            weight: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
            act: Optional[str] = None, identity: Optional[torch.Tensor] = None,
            stats: Optional[torch.Tensor] = None):
    """One call of `csrc/gn_nhwc.cu` on x (M, C, H, W) bf16 channels-last
    on the card: the statistics pass (counted in `gn_nhwc_stats.launches`)
    unless `stats` (M, G, 2) fp32 (mean, rstd) is given, then, unless `act`
    is None, the apply pass with that epilogue (`gn_nhwc_apply.launches`),
    its output channels-last. Returns (output or None, stats): the
    statistics unrounded, each (image, group)'s mean and rsqrt(biased var +
    eps)."""
    from vfa_tpu_torch.kernels import launch

    _check_channels_last(x, *([identity] if identity is not None else []))
    M, C, H, W = x.shape
    P = stats_blocks(C, H, W)
    part = None
    if stats is None:   # one block: the statistics, then the partials
        scratch = torch.empty(M * num_groups * (3 * P + 2), dtype=torch.float32,
                              device=x.device)
        n = M * num_groups * 2
        stats, part = scratch[:n].view(M, num_groups, 2), scratch[n:]
    elif tuple(stats.shape) != (M, num_groups, 2) or stats.dtype != torch.float32:
        raise ValueError(f"gn_nhwc: stats must be ({M}, {num_groups}, 2) fp32, got "
                         f"{tuple(stats.shape)} {stats.dtype}")
    else:
        stats = stats.contiguous()
    out = _output(x, act) if act is not None else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    launch("gn_nhwc", "gn_nhwc_bf16", x.device, x.data_ptr(), ptr(identity), ptr(out),
           ptr(part), stats.data_ptr(), ptr(weight), ptr(bias), M, H, W, C, num_groups, P,
           MODES.get(act, 0), ctypes.c_double(eps))
    gn_nhwc_stats.launches += part is not None
    gn_nhwc_apply.launches += out is not None
    return out, stats


def gn_nhwc_stats(x: torch.Tensor, num_groups: int, eps: float) -> torch.Tensor:
    """The statistics pass alone: `gn_nhwc`'s (M, G, 2) fp32 statistics."""
    return gn_nhwc(x, num_groups, eps)[1]


gn_nhwc_stats.launches = 0


def gn_nhwc_apply(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, act: str = "none",
                  identity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The apply pass alone, fed `stats` (M, G, 2) fp32: `apply_plain`'s
    contract on the card, channels-last in and out."""
    return gn_nhwc(x, stats.shape[1], 0.0, weight, bias, act, identity, stats)[0]


gn_nhwc_apply.launches = 0


def _output(x: torch.Tensor, act: str) -> torch.Tensor:
    M, C, H, W = x.shape
    if act == "relu_pool":
        H, W = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    return torch.empty((M, C, H, W), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


def _check_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                act: str, identity: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel cannot see: ValueError for a device, an
    epilogue or a shape, TypeError for a dtype. The kernel refuses a
    channel count or group size it does not take (RuntimeError)."""
    what = "gn_nhwc"
    if not x.is_cuda:
        raise ValueError(f"{what}: unsupported device {x.device}")
    if act not in MODES:
        raise ValueError(f"{what}: unknown epilogue {act!r}, expected one of {ACTS}")
    if (act == "add_relu") != (identity is not None):
        raise ValueError(f"{what}: an identity goes with add_relu, and only with it")
    bf16 = torch.bfloat16
    if (x.dtype != bf16 or weight.dtype != bf16 or bias.dtype != bf16
            or (identity is not None and identity.dtype != bf16)):
        raise TypeError(f"{what}: the kernels take bfloat16 x, weight, bias and identity, got "
                        f"{x.dtype}, {weight.dtype}, {bias.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (M, C, H, W), got {tuple(x.shape)}")
    C = x.shape[1]
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"{what}: weight and bias must be ({C},)")
    if identity is not None and identity.shape != x.shape:
        raise ValueError(f"{what}: identity {tuple(identity.shape)}, x {tuple(x.shape)}")
    device = x.device
    if (weight.device != device or bias.device != device
            or (identity is not None and identity.device != device)):
        raise ValueError(f"{what}: weight, bias and identity must be on {device}")


def kernel_takes(C: int, num_groups: int) -> bool:
    """Whether the kernels take C channels in num_groups groups (C a
    multiple of 8 with C / 8 dividing THREADS; 4 or a multiple of 8 channels
    a group)."""
    if C % 8 or C % num_groups or THREADS % (C // 8):
        return False
    cpg = C // num_groups
    return cpg == 4 or cpg % 8 == 0


def group_norm_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float, act: str = "none",
                    identity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`group_norm_act_plain`'s contract. On bf16 CUDA tensors both passes
    in one `gn_nhwc` call on x and the identity made channels-last (a copy
    only where they are not), the output channels-last; on CPU tensors the
    plain chain."""
    if x.device.type == "cpu":
        return group_norm_act_plain(x, weight, bias, num_groups, eps, act, identity)
    _check_nhwc(x, weight, bias, act, identity)
    last = lambda t: t.contiguous(memory_format=torch.channels_last)
    return gn_nhwc(last(x), num_groups, eps, weight.contiguous(), bias.contiguous(), act,
                   last(identity) if identity is not None else None)[0]


# The kernel's fp32 mean and rstd against ATen's (`aten_stats`: its fp32
# path, the order of its own bf16 one): sums of up to 921,600 values in two
# orders; the mean within STATS_TOL of |mean| + std, the rstd within
# STATS_TOL of itself. A bf16 ulp is 2^-8: 256 times wider.
STATS_TOL = 2.0 ** -16


def aten_stats(x: torch.Tensor, num_groups: int, eps: float = 1e-5):
    """`native_group_norm`'s statistics of x (M, C, H, W), an image at a
    time: its bf16 mean and rstd as (M, G, 2) fp32, and those of its fp32
    path (the values before the rounding), (M, G, 2)."""
    M, C, H, W = x.shape
    G = num_groups
    ones = torch.ones(C, device=x.device)
    aten, ref = [], []
    for m in range(M):
        xm = x[m:m + 1].contiguous()
        _, mu, rs = torch.native_group_norm(xm, ones.to(x.dtype), None, 1, C, H * W, G, eps)
        aten.append(torch.stack([mu.view(G).float(), rs.view(G).float()], -1))
        _, mu, rs = torch.native_group_norm(xm.float(), ones, None, 1, C, H * W, G, eps)
        ref.append(torch.stack([mu.view(G), rs.view(G)], -1))
    return torch.stack(aten), torch.stack(ref)


def stats_vs_aten(got: torch.Tensor, ref: torch.Tensor, aten: torch.Tensor):
    """The kernel's fp32 statistics `got` against ATen's (`aten_stats`: fp32
    `ref`, bf16 `aten`). Returns (d_mean, d_rstd, off, sound): the largest
    distances on STATS_TOL's scale; the (image, group)s whose bf16
    statistics differ from ATen's; and whether NaN lies where ATen's does
    and, where they differ, both bf16 statistics are roundings of values
    within STATS_TOL of ATen's fp32 one on that scale: a sum in another
    order, not an error. That is one ulp across a rounding boundary, or
    more for a mean near 0, whose ulp is finer than the scale. ATen's bf16
    path sums in an order of its own too, so its bf16 value need not be
    the rounding of `ref`."""
    nan = torch.isnan(ref)
    sound = torch.equal(torch.isnan(got), nan)
    g, r = got.masked_fill(nan, 1), ref.masked_fill(nan, 1)
    scale = torch.stack([r[..., 0].abs() + 1 / r[..., 1], r[..., 1]], -1)
    d = (g - r).abs() / scale
    d_mean, d_rstd = float(d[..., 0].max()), float(d[..., 1].max())
    kb, ab = got.to(torch.bfloat16), aten.to(torch.bfloat16)
    off = (kb.view(torch.int16) != ab.view(torch.int16)) & ~nan
    if off.any():
        tol = STATS_TOL * scale[off]
        lo, hi = ((r[off] + s * tol).to(torch.bfloat16).float() for s in (-1, 1))
        within = lambda v: (lo <= v) & (v <= hi)
        sound = sound and bool((within(kb[off].float()) & within(ab[off].float())).all())
    return d_mean, d_rstd, off.any(-1), sound


def on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def takes_kernel(norm: nn.Module, x: torch.Tensor, *more: torch.Tensor) -> bool:
    """The route's rule: a GroupNorm with an affine bf16 scale and bias of
    a shape the kernels take, on a bf16 CUDA tensor (`on_card`), and no
    gradient needed by x, the norm's parameters or `more`."""
    return (isinstance(norm, nn.GroupNorm) and norm.affine and on_card(x)
            and x.dtype == torch.bfloat16 and norm.weight.dtype == torch.bfloat16
            and x.dim() == 4 and kernel_takes(norm.num_channels, norm.num_groups)
            and not needs_grad(x, norm.weight, norm.bias, *more))


def norm_act(norm: nn.Module, x: torch.Tensor, act: str = "none",
             identity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(norm(x)), for act "none", "relu" or "add_relu" (relu(norm(x) +
    identity)): `group_norm_nhwc` where `takes_kernel`, else the chain
    with the norm module."""
    more = (identity,) if identity is not None else ()
    if takes_kernel(norm, x, *more):
        return group_norm_nhwc(x, norm.weight, norm.bias, norm.num_groups, norm.eps, act,
                               identity)
    y = norm(x)
    # the caller hands over its only reference: x goes before the epilogue
    # allocates, as in the chain written out (a serving peak set in a block)
    del x
    return _epilogue(y, act, identity)


def norm_relu_pool(norm: nn.Module, x: torch.Tensor, fused_stem: bool = False) -> torch.Tensor:
    """max_pool(relu(norm(x)), 3, 2, 1): `group_norm_nhwc` where
    `takes_kernel`; else, with `fused_stem`, `ops/stem.py::gn_relu_pool`
    (the chain's forward, the hand-written backward); else the chain."""
    if takes_kernel(norm, x):
        return group_norm_nhwc(x, norm.weight, norm.bias, norm.num_groups, norm.eps,
                               "relu_pool")
    if fused_stem:
        from vfa_tpu_torch.ops.stem import gn_relu_pool

        return gn_relu_pool(x, norm.weight, norm.bias, norm.num_groups, norm.eps)
    y = norm(x)
    del x               # as in `norm_act`: neither x nor the norm's output
    y = torch.relu(y)   # outlives the op that reads it
    return F.max_pool2d(y, 3, 2, 1)
