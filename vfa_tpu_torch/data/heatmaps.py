"""Ground-truth BEV heatmap precompute: plain and rotated gaussian kernels
(port of `vfa_tpu/data/heatmaps.py`, numpy + scipy).

Reference: `vfa/data/GK.py` — `GaussianKernel` stamps object centers then
convolves once with a fixed gaussian (`GK.py:148-204`);
`RotationGaussianKernel` pastes a per-object elliptical gaussian rotated by
the box yaw, using a hand-rolled O(K^2) pure-Python bilinear rotation
(`GK.py:7-146`). Both are reimplemented as vectorized numpy (the rotation is
the same inverse-mapping bilinear resample, two orders of magnitude faster
at dataset build time), cached to .npy exactly like the reference.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.stats import multivariate_normal


def _bilinear_rotate(arr: np.ndarray, angle_deg: float) -> np.ndarray:
    """Rotate a (H, W) array about its center, bilinear, zeros outside.

    Matches `GK.py:68-124` (`bi_rotate`, clockwise mode): output (i, j) maps
    through center/flip -> rotation -> uncenter to source coordinates, then
    floor + bilinear. The reference's boundary skips are reproduced as masks.
    """
    H, W = arr.shape
    a = np.deg2rad(angle_deg)
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    # matrix1: p = [i, j, 1] -> [i - 0.5H, -(j) + 0.5W ... ] following the
    # reference chain: m1 = [[1,0],[0,-1]] with offset (-.5H, .5W) applied as
    # row-vector multiplies; composed here explicitly.
    x = ii - 0.5 * H          # row coordinate centered
    y = -jj + 0.5 * W         # col coordinate centered & flipped
    ca, sa = np.cos(a), np.sin(a)
    # matrix2 (clockwise): [x, y] @ [[ca, -sa], [sa, ca]]
    xr = x * ca + y * sa
    yr = -x * sa + y * ca
    # matrix3: uncenter and unflip
    src_i = xr + 0.5 * H
    src_j = -(yr - 0.5 * W)

    i0 = np.floor(src_i).astype(np.int64)
    j0 = np.floor(src_j).astype(np.int64)
    u = src_i - i0
    v = src_j - j0

    out = np.zeros_like(arr)
    # reference skip conditions (`GK.py:113`): leave zero
    invalid = (j0 >= W) | (i0 >= H) | (i0 < 1) | (j0 < 1) | (ii + 1 >= H) | (jj + 1 >= W)
    # reference nearest fallback at the far edge (`GK.py:116-117`)
    edge = (~invalid) & ((i0 + 1 >= H) | (j0 + 1 >= W))
    inner = (~invalid) & (~edge)

    i0c = np.clip(i0, 0, H - 1)
    j0c = np.clip(j0, 0, W - 1)
    i1c = np.clip(i0 + 1, 0, H - 1)
    j1c = np.clip(j0 + 1, 0, W - 1)

    out[edge] = arr[i0c[edge], j0c[edge]]
    out[inner] = (
        (1 - u[inner]) * (1 - v[inner]) * arr[i0c[inner], j0c[inner]]
        + (1 - u[inner]) * v[inner] * arr[i0c[inner], j1c[inner]]
        + u[inner] * (1 - v[inner]) * arr[i1c[inner], j0c[inner]]
        + u[inner] * v[inner] * arr[i1c[inner], j1c[inner]]
    )
    return out


def rotated_gaussian_stamp(
    heatmap: np.ndarray,
    box_cx: float,
    box_cy: float,
    box_l: float,
    box_w: float,
    angle_deg: float,
    alpha: float = 0.01,
    kernel_ratio: int = 8,
) -> np.ndarray:
    """Paste one rotated elliptical gaussian (`GK.py:18-66`): kernel sized by
    the box extent, rotated by yaw, max-combined into the heatmap, with the
    exact center pinned to 1."""
    std_w = box_w * alpha
    std_l = box_l * alpha
    ks = int(np.ceil(np.maximum(std_w, std_l)) * kernel_ratio)
    xx, yy = np.meshgrid(
        np.arange(-(ks // 2), ks // 2 + 1, dtype=heatmap.dtype),
        np.arange(-(ks // 2), ks // 2 + 1, dtype=heatmap.dtype),
    )
    kernel = np.exp(-(xx ** 2) / (2.0 * std_l ** 2) - (yy ** 2) / (2.0 * std_w ** 2))
    kernel = _bilinear_rotate(kernel, angle_deg)

    gc = np.unravel_index(np.argmax(kernel), kernel.shape)
    g_l, g_t = int(gc[1]), int(gc[0])
    g_r = kernel.shape[1] - g_l
    g_b = kernel.shape[0] - g_t

    pad = ks // 2
    padded = np.pad(heatmap, pad, mode="constant")
    cx = int(box_cx + pad)
    cy = int(box_cy + pad)
    padded[cy - g_t:cy + g_b, cx - g_l:cx + g_r] = np.maximum(
        padded[cy - g_t:cy + g_b, cx - g_l:cx + g_r], kernel
    )
    heatmap = padded[pad:-pad, pad:-pad]
    heatmap[int(box_cy), int(box_cx)] = 1.0
    return heatmap


def gaussian_map_kernel(grid_reduce: int = 4, kernel_half: int = 8) -> np.ndarray:
    """The fixed smoothing kernel of `GaussianKernel` (`GK.py:155-163`):
    a (2*kernel_half+1)^2 normal pdf with sigma^2 = 8/grid_reduce,
    peak-normalized."""
    sigma2 = 8.0 / grid_reduce
    x, y = np.meshgrid(np.arange(-kernel_half, kernel_half + 1),
                       np.arange(-kernel_half, kernel_half + 1))
    pos = np.stack([x, y], axis=2)
    k = multivariate_normal.pdf(pos, [0, 0], np.identity(2) * sigma2)
    return (k / k.max()).astype(np.float32)


def smooth_occupancy_maps(occupancy: np.ndarray, grid_reduce: int = 4) -> np.ndarray:
    """Convolve binary occupancy maps (F, H, W) with the gaussian kernel and
    re-pin object centers to exactly 1 (`GK.py:169-182`)."""
    from scipy.signal import fftconvolve

    k = gaussian_map_kernel(grid_reduce)
    centers = occupancy == 1.0
    out = np.empty_like(occupancy, dtype=np.float32)
    for f in range(occupancy.shape[0]):
        out[f] = fftconvolve(occupancy[f].astype(np.float32), k, mode="same")
    out[centers] = 1.0
    return out


class HeatmapCache:
    """Build-or-load .npy heatmap caches (mirrors the GK/RGK dump/load
    protocol, `GK.py:126-146,184-204`)."""

    def __init__(self, save_path: str):
        self.save_path = save_path
        self.items = []

    def exists(self) -> bool:
        return os.path.exists(self.save_path)

    def add(self, heatmap: np.ndarray):
        self.items.append(heatmap)

    def load(self) -> np.ndarray:
        return np.load(self.save_path)

    def dump(self, maps: np.ndarray | None = None) -> np.ndarray:
        arr = maps if maps is not None else np.stack(self.items, axis=0)
        os.makedirs(os.path.dirname(self.save_path) or ".", exist_ok=True)
        np.save(self.save_path, arr)
        return arr
