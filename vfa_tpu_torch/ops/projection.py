"""MVDet's projection: every camera's /8 features warped onto the ground
plane's grid, into the world features that the map head reads.

`project_world_plain` is the library composition: a camera at a time, the
features upsampled in fp32 (`F.interpolate`, bilinear, align_corners=False)
to the map size, sampled at the cells' positions (`warp`: `F.grid_sample`,
bilinear, align_corners=True, zeros outside the map) and rounded once into
the output's dtype. `project_world` wraps `csrc/mvdet_project.cu`, which
does the same from the bf16 features in one launch for every scene and
camera, without the upsampled map: the upsample's taps folded into the
warp's, at most 3 x 3 source pixels a cell (the map is at least the
features' size), summed in fp32 and rounded once. It replaces no TPU
kernel (the JAX package has no MVDet).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. No autograd: serving only. `project`
chooses between the wrapper and the library composition.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from vfa_tpu_torch.ops import needs_grad

# Where a cell whose position is not finite samples, in grid_sample's
# coordinates: every tap lies outside any map of 2 pixels or more.
OUTSIDE = -4.0

# How close the kernel comes to `project_world_plain` (`kernel_vs_plain`).
# Both sum fp32 products of the same bf16 features and round once to bf16:
# the kernel folds the upsample's taps into the warp's and sums up to 9
# source pixels with precomputed weights, the library chain sums 4 upsampled
# values each made of 4 pixels (cuDNN's sampler). So the fp32 sums differ in
# their last bits: an element may round to the next bf16 (at most one ulp,
# on at most ULP_SHARE of the elements), and where the sum nearly cancels,
# the difference may be several ulps of a tiny value but stays within ATOL
# of the features' largest magnitude (9 products, each within 3 fp32
# roundings: 2^-20 has 20 times the room; measured on an H100 at the
# benchmark cell's shapes, 4.4e-5 of the elements one ulp apart, the rest
# within 2.4e-7 where |features| <= 5.5; at tiny sizes, where a quarter of
# the cells sit on the map's edges, 8.4e-4).
ULP_SHARE = 2e-3
ATOL = 2.0 ** -20


def sample_grid(positions: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel positions (..., 2) on an (h, w) map as `F.grid_sample`'s
    coordinates under align_corners=True (pixel i at 2i / (size - 1) - 1),
    in fp32 from fp64; a position with a coordinate that is not finite
    there goes to OUTSIDE, so that it reads 0 on every tap."""
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], dtype=torch.float64,
                         device=positions.device)
    grid = (positions.double() * scale - 1.0).float()
    return grid.masked_fill(~torch.isfinite(grid).all(-1, keepdim=True), OUTSIDE)


def warp(up: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """up (B, C, h, w) fp32 sampled at `grid` (L, W, 2) for every scene:
    bilinear, a tap outside the map reads 0 -> (B, C, L, W) fp32."""
    return F.grid_sample(up, grid.expand(up.shape[0], *grid.shape), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def project_world_plain(feats: torch.Tensor, positions: torch.Tensor, size,
                        out: torch.Tensor) -> torch.Tensor:
    """feats (B, N, C, h8, w8), positions (N, L, W, 2) pixel positions on
    maps of `size` (h, w) -> out[:, :N*C] (out (B, >= N*C, L, W)): camera
    n's warped features in channels n*C to (n+1)*C, in out's dtype. A
    camera at a time: upsampled in fp32, warped, rounded once."""
    C, N = feats.shape[2], feats.shape[1]
    h, w = size
    grid = sample_grid(positions, h, w)
    for n in range(N):
        up = F.interpolate(feats[:, n].float(), (h, w), mode="bilinear", align_corners=False)
        out[:, n * C:(n + 1) * C] = warp(up, grid[n])
    return out


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps between two bf16 tensors, elementwise."""
    def ordered(t):
        u = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(u < 0, -(u & 0x7FFF), u)

    return (ordered(a) - ordered(b)).abs()


def kernel_vs_plain(got: torch.Tensor, want: torch.Tensor,
                    feats: torch.Tensor) -> Tuple[int, float]:
    """The kernel's and the plain version's bf16 world features (B, >= N*C,
    L, W) from feats (B, N, C, h8, w8): over the cameras' N*C channels, the
    largest distance in bf16 ulps among the elements more than ATOL times
    the features' largest magnitude apart, and those elements' share. A
    camera at a time, so that the temporaries stay a camera's size."""
    B, N, C = feats.shape[:3]
    atol = ATOL * float(feats.abs().max())
    worst, off = 0, 0
    for n in range(N):
        a, b = got[:, n * C:(n + 1) * C], want[:, n * C:(n + 1) * C]
        ulps = bf16_ulps(a, b).masked_fill_((a.float() - b.float()).abs() <= atol, 0)
        worst, off = max(worst, int(ulps.max())), off + int((ulps > 0).sum())
    return worst, off / (B * N * C * got.shape[2] * got.shape[3])


def project_world(feats: torch.Tensor, positions: torch.Tensor, size,
                  out: torch.Tensor) -> torch.Tensor:
    """`project_world_plain`'s contract. On bf16 CUDA tensors one launch of
    `csrc/mvdet_project.cu` for every scene and camera (counted in
    `project_world.launches`): feats with each pixel's channels contiguous
    (the trunk's channels-last output) and 16-byte aligned, positions fp32
    contiguous, out bf16 contiguous; the kernel itself refuses (RuntimeError)
    a C that is not a multiple of the channels it takes a pass (256) and a
    map smaller than the features or under 2 pixels a side. On CPU tensors
    the plain version; nothing else is taken, and nothing is copied."""
    if feats.device.type == "cpu":
        return project_world_plain(feats, positions, size, out)
    what = "mvdet_project"
    if feats.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {feats.device}")
    for name, t in (("positions", positions), ("out", out)):
        if t.device != feats.device:
            raise ValueError(f"{what}: {name} on {t.device}, feats on {feats.device}")
    if feats.dtype != torch.bfloat16 or out.dtype != torch.bfloat16:
        raise TypeError(f"{what}: the kernel takes bfloat16 features and output, got "
                        f"{feats.dtype} and {out.dtype}")
    if positions.dtype != torch.float32:
        raise TypeError(f"{what}: positions must be float32, got {positions.dtype}")
    B, N, C, h8, w8 = feats.shape
    L, W = positions.shape[1:3]
    h, w = size
    if (tuple(positions.shape) != (N, L, W, 2) or out.dim() != 4 or out.shape[0] != B
            or out.shape[1] < N * C or tuple(out.shape[2:]) != (L, W)):
        raise ValueError(f"{what}: inconsistent shapes: feats {tuple(feats.shape)}, "
                         f"positions {tuple(positions.shape)}, out {tuple(out.shape)}")
    sb, sn, sc, sh, sw = feats.stride()
    if sc != 1 or any(s % 8 for s in (sb, sn, sh, sw)) or feats.data_ptr() % 16:
        raise ValueError(f"{what}: feats must hold each pixel's channels contiguous (channels "
                         f"last), 16-byte aligned, got strides {feats.stride()}")
    if (h8 - 1) * sh + (w8 - 1) * sw + C >= 2 ** 31:
        raise ValueError(f"{what}: a camera's feature image spans 2^31 elements or more")
    if not positions.is_contiguous() or not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError(f"{what}: positions and out must be contiguous, out 16-byte aligned")
    from vfa_tpu_torch.kernels import launch

    L_ = ctypes.c_longlong
    launch(what, "mvdet_project_bf16", feats.device, feats.data_ptr(), positions.data_ptr(),
           out.data_ptr(), L_(sb), L_(sn), L_(sh), L_(sw), B, N, C, h8, w8, h, w, L, W,
           out.shape[1], ctypes.c_double(2.0 / (w - 1)), ctypes.c_double(2.0 / (h - 1)))
    project_world.launches += 1
    return out


project_world.launches = 0


def project(feats: torch.Tensor, positions: torch.Tensor, size,
            out: torch.Tensor) -> torch.Tensor:
    """`project_world_plain`'s contract: `project_world` for bf16 features
    that need no gradient, else the library composition, which autograd
    differentiates."""
    if feats.dtype == torch.bfloat16 and not needs_grad(feats):
        return project_world(feats, positions, size, out)
    return project_world_plain(feats, positions, size, out)
