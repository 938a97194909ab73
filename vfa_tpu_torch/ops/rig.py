"""Compiled camera rig, window and flat layouts (port of
`vfa_tpu/ops/rig.py`).

Calibrations are rig constants on every supported dataset, so voxel
sampling is a static linear map vox = A @ features. Sampling is, per
(camera, tile of `tile_v` BEV cells):

    band = the tile's pixels of the features             # (K, C)
    vox  = A_tile @ band                                 # (nl*tile_v, C)
    out  = sum_l vox[l] @ Kr[l]                          # collapse -> n_out

Two band layouts. Window: cells are Hilbert-ordered by projected box
center and a band is one compact 2D image window lat[ry : ry + wh,
rx : rx + ww]. Flat: cells are ordered by mean tap position and a band is
`band_b` contiguous rows of the features flattened to (fh*fw, C), i.e.
whole image rows; with `fold_prefix=False` A holds the 16 integral-image
taps instead and applies to 2D-cumsum'd features.

The host builder below is numpy and reproduces the JAX build byte for byte
(same A, starts, inv_perm, window_hw), including its TPU-derived constants:
`default_tile_v`, the band caps, and the 8/16 alignments.
`rig_sample_scale` is the plain PyTorch version of the hand-written
kernels (`ops/rig_cuda.py`) plus the shared epilogue; `window_tiles_bwd`
and `flat_tiles_bwd` are the plain versions of the backward kernels.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from vfa_tpu_torch.config import DatasetConfig
from vfa_tpu_torch.ops.voxel import (
    EPSILON, MAXIMUM_AREA_RATIO, cube_corner_offsets, z_layer_offsets,
)


@dataclasses.dataclass
class ScaleRig:
    """Static sampling structure for one feature scale, all cameras.

    A[b]: (N, T_b, nl*tile_v, band_b) soft box weights; row = l*tile_v + v
    (layer-major). inv_perm: (N, V2d) int64, BEV cell -> row of the scale's
    concatenated tiles. on_raw: A has the 2D prefix sum folded in and
    applies to raw features; False keeps the 16-tap integral-image form
    (applies to cumsum'd features, flat layout only).

    Window layout (window_hw[b] == (wh_b, ww_b)): band_b = wh_b*ww_b and
    starts[b] is (N, T_b, 2) int32 (row, col) window origins inside the
    image padded to (fh up to a multiple of 8, fw up to 16).
    Flat layout (window_hw == ()): starts[b] is (N, T_b) int32 band starts
    in the features flattened to (fh*fw, C); starts and band_b are
    multiples of 8, and the features are padded by max band_b zero rows."""

    A: tuple
    starts: tuple
    inv_perm: torch.Tensor
    feat_hw: Tuple[int, int]
    nl: int
    tile_v: int
    on_raw: bool = True
    window_hw: tuple = ()   # per bucket (wh_b, ww_b); () = flat layout


@dataclasses.dataclass
class CameraRig:
    scales: List[ScaleRig]
    grid_shape: Tuple[int, int]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def default_tile_v(nl: int, dtype=torch.float32, layout: str = "window") -> int:
    """BEV cells per tile, as the JAX package picks it for its kernel route
    (`vfa_tpu/ops/rig.py:81`). The values come from the TPU kernels' VMEM
    budget; they are kept so the rig matches the JAX build exactly."""
    if layout != "window":
        return 160
    fp32 = dtype.itemsize >= 4
    if nl > 5:
        return 24 if fp32 else 64
    return 64 if fp32 else 160


def pyramid_feat_shapes(resize_size) -> List[Tuple[int, int]]:
    """Feature-map (h, w) at strides 8/16/32 for the ResNet-GN backbone
    (each downsampling stage computes ceil(x/2))."""
    def c(x):
        return (x + 1) // 2

    h, w = resize_size
    h8, w8 = c(c(c(h))), c(c(c(w)))
    h16, w16 = c(h8), c(w8)
    h32, w32 = c(h16), c(w16)
    return [(h8, w8), (h16, w16), (h32, w32)]


def _np_norm_boxes(calib, cfg: DatasetConfig, grid, feat_hw, crange):
    """Per-voxel projected box in normalized [-1, 1] image coords.

    Returns (l, t, r, b, area, visible), each (nl, V2d): the box bounds
    (float64), its area in feature pixels + EPSILON, and the visibility
    mask of `ops/voxel.py`."""
    fh, fw = feat_hw
    z_off = z_layer_offsets(cfg.grid_h, cfg.cube_size[2]).astype(np.float64)
    c_off = cube_corner_offsets(cfg.cube_size).astype(np.float64)
    corners = (grid.astype(np.float64)[None, :, :, None, :]
               + z_off[:, None, None, None, :] + c_off)
    if cfg.name == "MultiviewX":
        corners = corners / 40.0
    elif cfg.name == "Wildtrack":
        corners = corners * np.array([2.5, 2.5, 2.5]) + np.array([-300.0, -900.0, 0.0])
    calib = np.asarray(calib, np.float64)
    h = corners @ calib[:, :3].T + calib[:, 3]
    img = h[..., :2] / h[..., 2:3]
    ih, iw = cfg.image_size
    norm = np.clip(2.0 * img / np.array([iw, ih]) - 1.0, crange[0], crange[1])
    nl = norm.shape[0]
    V2d = norm.shape[1] * norm.shape[2]
    norm = norm.reshape(nl, V2d, 8, 2)
    l, t = norm[..., 0].min(-1), norm[..., 1].min(-1)
    r, b = norm[..., 0].max(-1), norm[..., 1].max(-1)
    area = (r - l) * (b - t) * (fh * fw) + EPSILON
    visible = (area > EPSILON) & (area < fh * fw * MAXIMUM_AREA_RATIO)
    return l, t, r, b, area, visible


def _np_box_profiles(calib, cfg: DatasetConfig, grid, feat_hw, crange):
    """Per-voxel fractional box bounds in pixel coords + 1/area scale.

    Returns (xl, xr, yt, yb) each (nl, V2d) float64 (grid_sample
    align_corners=False convention) and scale (nl, V2d) = visible/area."""
    fh, fw = feat_hw
    l, t, r, b, area, visible = _np_norm_boxes(calib, cfg, grid, feat_hw, crange)
    scale = visible / area
    unx = lambda v: ((v + 1.0) * fw - 1.0) * 0.5
    uny = lambda v: ((v + 1.0) * fh - 1.0) * 0.5
    return unx(l), unx(r), uny(t), uny(b), scale


def _np_taps(calib, cfg: DatasetConfig, grid, feat_hw, crange):
    """The 16 merged bilinear / integral-image taps per voxel: idx
    (nl, V2d, 16) int64 flat pixel indices and w (nl, V2d, 16) float64
    weights (4 box corners with signs +, +, -, -, 4 bilinear taps each,
    scaled by visible/area)."""
    fh, fw = feat_hw
    l, t, r, b, area, visible = _np_norm_boxes(calib, cfg, grid, feat_hw, crange)
    pts_x = np.stack([l, r, r, l], axis=2)                # (nl, V2d, 4)
    pts_y = np.stack([t, b, t, b], axis=2)
    signs = np.array([1.0, 1.0, -1.0, -1.0])
    x = ((pts_x + 1.0) * fw - 1.0) * 0.5
    y = ((pts_y + 1.0) * fh - 1.0) * 0.5
    x0, y0 = np.floor(x), np.floor(y)
    wx1, wy1 = x - x0, y - y0
    tap_idx, tap_w = [], []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        wxt = wx1 if dx else 1.0 - wx1
        wyt = wy1 if dy else 1.0 - wy1
        inb = (xi >= 0) & (xi <= fw - 1) & (yi >= 0) & (yi <= fh - 1)
        xi_c = np.clip(xi, 0, fw - 1).astype(np.int64)
        yi_c = np.clip(yi, 0, fh - 1).astype(np.int64)
        tap_idx.append(yi_c * fw + xi_c)
        tap_w.append(wxt * wyt * inb * signs)
    idx = np.concatenate(tap_idx, axis=-1)
    w = np.concatenate(tap_w, axis=-1)
    return idx, w * (visible / area)[..., None]


def _axis_params(lo, hi, size):
    """Step-function params of the prefix-sample difference along one axis:
    (t0_lo, f_lo, in0_lo, in1_lo, t0_hi, f_hi, in0_hi, in1_hi, span_start,
    span_len)."""
    t0l = np.floor(lo)
    fl = lo - t0l
    t0h = np.floor(hi)
    fh_ = hi - t0h
    in0l = (t0l >= 0) & (t0l <= size - 1)
    in1l = (t0l + 1 >= 0) & (t0l + 1 <= size - 1)
    in0h = (t0h >= 0) & (t0h <= size - 1)
    in1h = (t0h + 1 >= 0) & (t0h + 1 <= size - 1)
    i0 = np.maximum(0, t0l).astype(np.int64)
    # zeros-padding deficit: an upper tap outside the image extends the
    # support to pixel 0 (the reference's grid_sample zeros padding)
    deficit = (~in1h & in0h) | (~in1l & in0l)
    i0 = np.where(deficit, 0, i0)
    i1 = np.minimum(size - 1, t0h + 1).astype(np.int64)
    n = np.maximum(i1 - i0 + 1, 0)
    return (t0l, fl, in0l, in1l, t0h, fh_, in0h, in1h, i0, n)


def _axis_value(i, t0l, fl, in0l, in1l, t0h, fh_, in0h, in1h):
    """d(i) = c_hi(i) - c_lo(i) evaluated elementwise."""
    c_lo = (1.0 - fl) * in0l * (i <= t0l) + fl * in1l * (i <= t0l + 1)
    c_hi = (1.0 - fh_) * in0h * (i <= t0h) + fh_ * in1h * (i <= t0h + 1)
    return c_hi - c_lo


def _raster_triplets(calib, cfg, grid, feat_hw, crange):
    """Rasterize every visible voxel box: (iy, ix, val, layer, cell) entry
    arrays, the prefix-folded A value at pixel (iy, ix) of voxel
    (layer, cell)."""
    fh, fw = feat_hw
    xl, xr, yt, yb, scale = _np_box_profiles(calib, cfg, grid, feat_hw, crange)
    nl, V2d = scale.shape

    px = _axis_params(xl.ravel(), xr.ravel(), fw)
    py = _axis_params(yt.ravel(), yb.ravel(), fh)
    nx, ny = px[9], py[9]
    vis = scale.ravel() > 0
    sel = np.nonzero(vis & (nx > 0) & (ny > 0))[0]

    nx_s, ny_s = nx[sel], ny[sel]
    total = nx_s * ny_s
    n_entries = int(total.sum())
    vox = np.repeat(np.arange(len(sel)), total)
    offs = np.concatenate([[0], np.cumsum(total)[:-1]])
    k = np.arange(n_entries) - np.repeat(offs, total)
    a = k // nx_s[vox]
    b = k % nx_s[vox]

    gsel = sel[vox]
    iy = py[8][gsel] + a
    ix = px[8][gsel] + b
    dyv = _axis_value(iy, *[p[gsel] for p in py[:8]])
    dxv = _axis_value(ix, *[p[gsel] for p in px[:8]])
    val = dyv * dxv * scale.ravel()[gsel]
    return iy, ix, val, gsel // V2d, gsel % V2d


def _dp_bucket_edges(wh, ww, nb, pad_h, pad_w, band_cap=None):
    """Bucket split points over the per-camera area-sorted tile index that
    minimize total padded A bytes (buckets allocate at the cross-camera
    max dims). O(nb * T^2)."""
    num_cam, T = wh.shape
    ru = lambda v, m: (v + m - 1) // m * m
    wh_all = wh.max(axis=0)
    ww_all = ww.max(axis=0)

    cost = np.zeros((T + 1, T + 1))
    for i in range(T):
        mh = int(wh_all[i])
        mw = int(ww_all[i])
        for j in range(i + 1, T + 1):
            if j > i + 1:
                mh = max(mh, int(wh_all[j - 1]))
                mw = max(mw, int(ww_all[j - 1]))
            band = ru(mh, pad_h) * ru(mw, pad_w)
            if band_cap is not None and band > band_cap:
                cost[i, j] = np.inf
            else:
                cost[i, j] = (j - i) * num_cam * band

    INF = float("inf")
    dp = np.full((nb + 1, T + 1), INF)
    back = np.zeros((nb + 1, T + 1), np.int64)
    dp[0, 0] = 0.0
    for b in range(1, nb + 1):
        for j in range(b, T + 1):
            ks = np.arange(b - 1, j)
            vals = dp[b - 1, ks] + cost[ks, j]
            k = int(ks[np.argmin(vals)])
            dp[b, j] = vals.min()
            back[b, j] = k
    if not np.isfinite(dp[1:, T]).any():
        raise ValueError(
            f"no bucketing fits the band cap {band_cap}: a single tile's "
            "window exceeds it; reduce tile_v")
    b_best = int(np.argmin(dp[1:, T])) + 1
    edges = [T]
    b, j = b_best, T
    while b > 0:
        j = int(back[b, j])
        edges.append(j)
        b -= 1
    return sorted(set(edges))


def _hilbert(y: np.ndarray, x: np.ndarray, bits: int = 11) -> np.ndarray:
    """Hilbert-curve index of (y, x) on a 2^bits grid (vectorized xy2d)."""
    x = x.astype(np.int64).copy()
    y = y.astype(np.int64).copy()
    d = np.zeros_like(x)
    s = np.int64(1) << (bits - 1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        flip = (ry == 0) & (rx == 1)
        x2 = np.where(flip, s - 1 - x, x)
        y2 = np.where(flip, s - 1 - y, y)
        swap = ry == 0
        x, y = np.where(swap, y2, x2), np.where(swap, x2, y2)
        s >>= 1
    return d


def _build_scale_window(calibs, cfg, grid, feat_hw, crange, tile_v,
                        band_buckets, dtype=torch.float32):
    """Window-layout build for one feature scale.

    Returns (A_buckets fp32 list, starts list of (N, T_b, 2) int32,
    window_hw list of (wh_b, ww_b), inv_perm (N, V2d) int32, nl)."""
    fh, fw = feat_hw
    num_cam = calibs.shape[0]
    V2d = grid.shape[0] * grid.shape[1]
    v2d_pad = _round_up(V2d, tile_v)
    n_tiles = v2d_pad // tile_v
    nb = max(1, min(band_buckets, n_tiles))

    per_cam = []
    nl = None
    for cam in range(num_cam):
        xl, xr, yt, yb, scale = _np_box_profiles(
            calibs[cam], cfg, grid, feat_hw, crange)
        nl = scale.shape[0]
        px = _axis_params(xl.ravel(), xr.ravel(), fw)
        py = _axis_params(yt.ravel(), yb.ravel(), fh)
        vis = (scale.ravel() > 0) & (px[9] > 0) & (py[9] > 0)
        y0, ny = py[8], py[9]
        x0, nx = px[8], px[9]

        # Hilbert order of the mean visible box center (pixel coords)
        v2 = vis.reshape(nl, V2d)
        cnt = v2.sum(0)
        cx = np.clip((xl + xr) * 0.5, 0, fw - 1)
        cy = np.clip((yt + yb) * 0.5, 0, fh - 1)
        mx = (cx * v2).sum(0) / np.maximum(cnt, 1)
        my = (cy * v2).sum(0) / np.maximum(cnt, 1)
        qx = np.clip(mx / fw * 2048, 0, 2047).astype(np.int64)
        qy = np.clip(my / fh * 2048, 0, 2047).astype(np.int64)
        key = np.where(cnt > 0, _hilbert(qy, qx), np.int64(1) << 60)
        order = np.argsort(key, kind="stable")
        pos = np.empty(V2d, np.int64)
        pos[order] = np.arange(V2d)
        t_of_cell = pos // tile_v

        # per-tile bounding window over the rasterized spans
        big = np.iinfo(np.int64).max
        ry = np.full(n_tiles, big)
        y1t = np.full(n_tiles, -1)
        rx = np.full(n_tiles, big)
        x1t = np.full(n_tiles, -1)
        cell_f = np.tile(np.arange(V2d), nl)
        t_flat = t_of_cell[cell_f][vis]
        np.minimum.at(ry, t_flat, y0[vis])
        np.maximum.at(y1t, t_flat, (y0 + ny - 1)[vis])
        np.minimum.at(rx, t_flat, x0[vis])
        np.maximum.at(x1t, t_flat, (x0 + nx - 1)[vis])
        empty = y1t < 0
        ry = np.where(empty, 0, ry)
        rx = np.where(empty, 0, (rx // 8) * 8)   # 8-aligned column start
        wh = np.where(empty, 1, y1t - ry + 1)
        ww = np.where(empty, 8, x1t - rx + 1)
        per_cam.append((order, ry, rx, wh, ww))

    tperms = []
    whs = np.zeros((num_cam, n_tiles), np.int64)
    wws = np.zeros((num_cam, n_tiles), np.int64)
    for cam in range(num_cam):
        _, ry, rx, wh, ww = per_cam[cam]
        tperm = np.argsort(wh * ww, kind="stable")
        tperms.append(tperm)
        whs[cam] = wh[tperm]
        wws[cam] = ww[tperm]
    # the JAX build's band cap (a TPU VMEM budget, `vfa_tpu/ops/rig.py:512`),
    # kept as is so buckets and A match the JAX build exactly
    rows = nl * tile_v
    C = 256
    a_iz = dtype.itemsize
    f_iz = a_iz
    band_cap = int(11.5e6) // (rows * a_iz + C * (f_iz + 4 + 4))
    edges = _dp_bucket_edges(whs, wws, nb, 8, 16, band_cap=band_cap)
    nb = len(edges) - 1
    wh_b = [_round_up(int(whs[:, edges[b]:edges[b + 1]].max()), 8)
            for b in range(nb)]
    ww_b = [_round_up(int(wws[:, edges[b]:edges[b + 1]].max()), 16)
            for b in range(nb)]

    A_buckets = [
        np.zeros((num_cam, edges[b + 1] - edges[b], nl * tile_v,
                  wh_b[b] * ww_b[b]), np.float32)
        for b in range(nb)
    ]
    starts_buckets = [
        np.zeros((num_cam, edges[b + 1] - edges[b], 2), np.int32)
        for b in range(nb)
    ]
    inv_perm = np.zeros((num_cam, V2d), np.int32)
    # windows sit inside the (8, 16)-aligned image: origins are clamped
    # up/left so origin + bucket dims never overruns it
    fh_pad = _round_up(fh, 8)
    fw_pad = _round_up(fw, 16)
    for cam in range(num_cam):
        order, ry, rx, wh, ww = per_cam[cam]
        tperm = tperms[cam]
        pos = _tile_order(order, tperm, tile_v, n_tiles, V2d)
        inv_perm[cam] = pos
        t_of_cell = pos // tile_v
        vi_of_cell = pos % tile_v
        ry2, rx2 = ry[tperm].copy(), rx[tperm].copy()
        for b in range(nb):
            seg = slice(edges[b], edges[b + 1])
            ry2[seg] = np.minimum(ry2[seg], max(fh_pad - wh_b[b], 0))
            rx2[seg] = np.minimum(rx2[seg], max(fw_pad - ww_b[b], 0))
            starts_buckets[b][cam, :, 0] = ry2[seg]
            starts_buckets[b][cam, :, 1] = rx2[seg]

        iy, ix, val, layer, cell = _raster_triplets(
            calibs[cam], cfg, np.asarray(grid), feat_hw, crange)
        t = t_of_cell[cell]
        row = layer * tile_v + vi_of_cell[cell]
        oy = iy - ry2[t]
        ox = ix - rx2[t]
        for b in range(nb):
            in_bucket = (t >= edges[b]) & (t < edges[b + 1])
            ok = (oy >= 0) & (oy < wh_b[b]) & (ox >= 0) & (ox < ww_b[b])
            dropped = in_bucket & ~ok
            if np.abs(val[dropped]).max(initial=0.0) != 0.0:
                raise ValueError("rig entry outside its window")
            m = in_bucket & ok
            col = oy[m] * ww_b[b] + ox[m]
            np.add.at(A_buckets[b][cam], (t[m] - edges[b], row[m], col),
                      val[m])
    # the kernel reads windows unchecked: every one must lie in the
    # padded image
    for b in range(nb):
        s = starts_buckets[b]
        if (s.min(initial=0) < 0 or (s[..., 0] + wh_b[b]).max() > fh_pad
                or (s[..., 1] + ww_b[b]).max() > fw_pad):
            raise ValueError(f"bucket {b}: a window leaves the padded image")
    return A_buckets, starts_buckets, list(zip(wh_b, ww_b)), inv_perm, nl


def _tile_order(order, tperm, tile_v, n_tiles, V2d):
    """Cell positions after the tiles of `order` are reordered by `tperm`
    (pad slots kept, so tile boundaries stay aligned): pos (V2d,) int64,
    BEV cell -> row of the concatenated tiles."""
    padded = np.full(n_tiles * tile_v, -1, np.int64)
    padded[:V2d] = order
    padded2 = np.concatenate([
        padded[t * tile_v:(t + 1) * tile_v] for t in tperm])
    pos = np.empty(V2d, np.int64)
    valid_slots = padded2 >= 0
    pos[padded2[valid_slots]] = np.nonzero(valid_slots)[0]
    return pos


def _build_scale_flat(calibs, cfg, grid, feat_hw, crange, tile_v,
                      band_buckets, fold_prefix, finish):
    """Flat-layout build for one feature scale.

    Returns (A list, starts list of (N, T_b) int32, inv_perm (N, V2d)
    int32, nl). Each A bucket is built on the host in fp32 and handed to
    `finish` (which places it on the device) before the next one is
    allocated, so the host never holds the whole A."""
    fh, fw = feat_hw
    P = fh * fw
    num_cam = calibs.shape[0]
    V2d = grid.shape[0] * grid.shape[1]
    n_tiles = _round_up(V2d, tile_v) // tile_v
    per_cam = [_np_taps(calibs[cam], cfg, grid, feat_hw, crange)
               for cam in range(num_cam)]
    nl = per_cam[0][0].shape[0]

    # sort cells by mean visible tap position; per-tile support span
    orders, tile_starts_all = [], []
    for cam, (idx, w) in enumerate(per_cam):
        m = np.abs(w) > 0
        any_vis = m.any(axis=(0, 2))
        mean_tap = np.where(
            any_vis,
            np.where(m, idx, 0).sum((0, 2)) / np.maximum(m.sum((0, 2)), 1),
            P + 1)
        order = np.argsort(mean_tap, kind="stable")
        orders.append(order)
        pos = np.empty(V2d, np.int64)
        pos[order] = np.arange(V2d)
        t_of_cell = pos // tile_v
        lo = np.full(n_tiles, np.iinfo(np.int64).max)
        hi = np.full(n_tiles, -1)
        if fold_prefix:
            # support = rasterized box extents (includes the rare
            # zeros-padding deficit spans, see _axis_params)
            xl, xr, yt, yb, scl = _np_box_profiles(
                calibs[cam], cfg, grid, feat_hw, crange)
            px = _axis_params(xl.ravel(), xr.ravel(), fw)
            py = _axis_params(yt.ravel(), yb.ravel(), fh)
            vis = (scl.ravel() > 0) & (px[9] > 0) & (py[9] > 0)
            flat_lo = py[8] * fw + px[8]
            flat_hi = (py[8] + py[9] - 1) * fw + (px[8] + px[9] - 1)
            t_flat = t_of_cell[np.tile(np.arange(V2d), nl)][vis]
            np.minimum.at(lo, t_flat, flat_lo[vis])
            np.maximum.at(hi, t_flat, flat_hi[vis])
        else:
            t_flat = np.broadcast_to(t_of_cell[None, :, None], idx.shape)[m]
            np.minimum.at(lo, t_flat, idx[m])
            np.maximum.at(hi, t_flat, idx[m])
        # starts aligned down to 8 (the JAX build's DMA alignment, kept so
        # the rig is the same)
        starts = np.where(hi >= 0, (lo // 8) * 8, 0)
        spans = np.where(hi >= 0, hi - starts + 1, 1)
        tile_starts_all.append((starts, spans))

    # band buckets: per camera, tiles ascending by span; bucket b covers
    # the same sorted-tile range in every camera, padded to the max span
    # within the bucket; DP-optimal edges
    nb = max(1, min(band_buckets, n_tiles))
    tperms = []
    spans_sorted = np.zeros((num_cam, n_tiles), np.int64)
    for cam in range(num_cam):
        tperm = np.argsort(tile_starts_all[cam][1], kind="stable")
        tperms.append(tperm)
        spans_sorted[cam] = tile_starts_all[cam][1][tperm]
    # the JAX build's band cap (a TPU VMEM budget, `vfa_tpu/ops/rig.py:750`),
    # kept as is so buckets and A match the JAX build exactly
    flat_cap = int(12e6) // (nl * tile_v * 4 + 1024)
    flat_cap = max(flat_cap, _round_up(int(spans_sorted.max()), 8))
    edges = _dp_bucket_edges(spans_sorted, np.ones_like(spans_sorted), nb, 8,
                             1, band_cap=flat_cap)
    nb = len(edges) - 1
    if not fold_prefix and nb != 1:
        raise ValueError("band_buckets > 1 requires fold_prefix")
    bands = [_round_up(max(8, int(spans_sorted[:, edges[b]:edges[b + 1]].max())), 8)
             for b in range(nb)]

    starts_buckets = [np.zeros((num_cam, edges[b + 1] - edges[b]), np.int32)
                      for b in range(nb)]
    inv_perm = np.zeros((num_cam, V2d), np.int32)
    entries = []        # per camera (tile, row, col, val) of every A entry
    for cam, (idx, w) in enumerate(per_cam):
        pos = _tile_order(orders[cam], tperms[cam], tile_v, n_tiles, V2d)
        inv_perm[cam] = pos
        # no clamping: the features are padded by max(bands) rows at apply
        # time, so any start <= P - 1 slices safely
        s2 = tile_starts_all[cam][0][tperms[cam]]
        t_of_cell = pos // tile_v
        vi_of_cell = pos % tile_v
        for b in range(nb):
            starts_buckets[b][cam] = s2[edges[b]:edges[b + 1]]
        if fold_prefix:
            # rasterize the camera once; every bucket scatters its share
            iy, ix, val, layer, cell = _raster_triplets(
                calibs[cam], cfg, grid, feat_hw, crange)
            t = t_of_cell[cell]
            row = layer * tile_v + vi_of_cell[cell]
            col = iy * fw + ix - s2[t]
        else:
            # 16-tap integral-image form
            cell = np.broadcast_to(np.arange(V2d)[None, :, None], idx.shape)
            layer = np.broadcast_to(np.arange(nl)[:, None, None], idx.shape)
            keep = np.abs(w) > 0
            t = t_of_cell[cell][keep]
            row = (layer * tile_v + vi_of_cell[cell])[keep]
            col = (idx - s2[t_of_cell][None, :, None])[keep]
            val = w[keep]
        entries.append((t.astype(np.int32), row.astype(np.int32),
                        col.astype(np.int64), val))

    A_buckets = []
    for b in range(nb):
        A_b = np.zeros((num_cam, edges[b + 1] - edges[b], nl * tile_v,
                        bands[b]), np.float32)
        for cam, (t, row, col, val) in enumerate(entries):
            in_bucket = (t >= edges[b]) & (t < edges[b + 1])
            ok = in_bucket & (col >= 0) & (col < bands[b])
            if fold_prefix:
                # bands come from these same raster spans: an entry with
                # weight outside its band would be dropped signal
                dropped = in_bucket & ~ok
                if np.abs(val[dropped]).max(initial=0.0) != 0.0:
                    raise ValueError("rig entry outside its band")
            np.add.at(A_b[cam], (t[ok] - edges[b], row[ok], col[ok]), val[ok])
        A_buckets.append(finish(A_b))
        del A_b
    return A_buckets, starts_buckets, inv_perm, nl


def build_rig(
    calibs: np.ndarray,
    cfg: DatasetConfig,
    grid: np.ndarray,
    feat_shapes: Sequence[Tuple[int, int]],
    tile_v: int = 64,
    dtype=torch.float32,
    crange=(-1.0, 0.95),
    fold_prefix: bool = True,
    band_buckets: int = 1,
    layout: str = "window",
    device="cuda",
) -> CameraRig:
    """Precompute the sampling matrices on the host (numpy) and place them
    on `device`. layout 'window' (2D image windows, Hilbert cell order,
    requires fold_prefix) or 'flat' (contiguous bands of the flattened
    features; fold_prefix=False keeps the 16-tap integral-image form, one
    bucket only)."""
    if layout not in ("flat", "window"):
        raise ValueError(f"unknown rig layout {layout!r}")
    if layout == "window" and not fold_prefix:
        raise ValueError("the window layout requires fold_prefix")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rig dtype must be float32 or bfloat16, got {dtype}")
    calibs, grid = np.asarray(calibs), np.asarray(grid)
    L, W = grid.shape[0], grid.shape[1]
    place = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)
    scales = []
    for fh, fw in feat_shapes:
        if layout == "window":
            A_bk, s_bk, win_hw, inv_perm, nl = _build_scale_window(
                calibs, cfg, grid, (fh, fw), crange, tile_v, band_buckets,
                dtype=dtype)
            A_bk = [place(a) for a in A_bk]
        else:
            A_bk, s_bk, inv_perm, nl = _build_scale_flat(
                calibs, cfg, grid, (fh, fw), crange, tile_v, band_buckets,
                fold_prefix, place)
            win_hw = ()
        scales.append(ScaleRig(
            A=tuple(A_bk),
            starts=tuple(torch.from_numpy(s).to(device) for s in s_bk),
            inv_perm=torch.from_numpy(inv_perm.astype(np.int64)).to(device),
            feat_hw=(fh, fw), nl=nl, tile_v=tile_v, on_raw=fold_prefix,
            window_hw=tuple(win_hw),
        ))
    return CameraRig(scales=scales, grid_shape=(L, W))


def rig_matmul_flops(rig: CameraRig, channels: int = 256, n_out: int = 256) -> int:
    """Forward FLOPs per scene of the rig sampling + collapse, counted at
    the allocated (padded) A dims, i.e. the work the kernel performs."""
    total = 0
    for sr in rig.scales:
        cam_tiles = 0
        for A in sr.A:
            rows, band = A.shape[-2:]
            lead = int(np.prod(A.shape[:-2]))
            total += 2 * lead * rows * band * channels
            cam_tiles += lead
        total += 2 * cam_tiles * sr.tile_v * (sr.nl * channels) * n_out
    return total


def pad_features(lat: torch.Tensor) -> torch.Tensor:
    """(B, N, fh, fw, C) -> (N, B, fh up to 8, fw up to 16, C), contiguous:
    the padded image every window origin of the rig lies inside."""
    B, N, fh, fw, C = lat.shape
    ii = lat.transpose(0, 1)
    ii = torch.nn.functional.pad(
        ii, (0, 0, 0, _round_up(fw, 16) - fw, 0, _round_up(fh, 8) - fh))
    return ii.contiguous()


def pad_features_flat(lat: torch.Tensor, rig: ScaleRig) -> torch.Tensor:
    """(B, N, fh, fw, C) -> (N, B, fh*fw + max_band, C), contiguous: the
    flattened features of a flat rig (2D-cumsum'd first when the rig keeps
    the 16-tap form), padded by max_band zero rows so that a band starting
    near the end never reads past the buffer."""
    B, N, fh, fw, C = lat.shape
    if not rig.on_raw:
        lat = lat.cumsum(3).cumsum(2)
    ii = lat.reshape(B, N, fh * fw, C).transpose(0, 1)
    max_band = max(a.shape[-1] for a in rig.A)
    return torch.nn.functional.pad(ii, (0, 0, 0, max_band)).contiguous()


def collapse_per_layer(collapse_kernel: torch.Tensor, C: int, nl: int,
                       dtype) -> torch.Tensor:
    """Collapse weight regrouped per layer: K[c*nl + l, o] -> Kr[l, c, o]
    (the reference's c-major layout, `vfa/model/vfa_op.py:120`)."""
    n_out = collapse_kernel.shape[-1]
    return (collapse_kernel.reshape(C, nl, n_out).permute(1, 0, 2)
            .to(dtype).contiguous())


def _window_pixels(starts_b: torch.Tensor, N: int, T: int, Hp: int, Wp: int,
                   window) -> torch.Tensor:
    """(N, T, wh*ww) row indices of every window's pixels in the padded
    features flattened to (N*Hp*Wp, B*C)."""
    wh, ww = window
    dev = starts_b.device
    st = starts_b.reshape(N, T, 2).long()
    dy = torch.arange(wh, device=dev).repeat_interleave(ww)
    dx = torch.arange(ww, device=dev).repeat(wh)
    pix = (st[..., :1] + dy) * Wp + st[..., 1:] + dx          # (N, T, K)
    return pix + (torch.arange(N, device=dev) * (Hp * Wp))[:, None, None]


def _band_pixels(starts_b: torch.Tensor, N: int, T: int, rows: int,
                 band: int) -> torch.Tensor:
    """(N, T, band) row indices of every flat band's pixels in the padded
    flat features flattened to (N*rows, B*C)."""
    dev = starts_b.device
    pix = starts_b.reshape(N, T, 1).long() + torch.arange(band, device=dev)
    return pix + (torch.arange(N, device=dev) * rows)[:, None, None]


def _band_vox(ii, A_b, pix):
    """vox = A @ band in fp32 for one bucket: (N, T, R, B*C). ii is
    (N, B, pixels..., C); pix (N, T, K) indexes its pixels flattened over
    (N, pixels...)."""
    N, B, C = ii.shape[0], ii.shape[1], ii.shape[-1]
    T, _, K = A_b.shape[1:]
    flat = ii.reshape(N, B, -1, C).permute(0, 2, 1, 3).reshape(-1, B * C)
    bands = flat.index_select(0, pix.reshape(-1)).reshape(N, T, K, B * C)
    return torch.matmul(A_b.float(), bands.float())


def _tiles_fwd(ii, A_b, pix, Kr, tile_v):
    """The bucket's tiles (N, B, T*tile_v, n_out) in ii's dtype: vox =
    A @ band accumulated in fp32, then sum_l vox_l @ Kr_l in fp32."""
    N, B, C = ii.shape[0], ii.shape[1], ii.shape[-1]
    T = A_b.shape[1]
    nl, _, n_out = Kr.shape
    vox = _band_vox(ii, A_b, pix)
    vox = vox.to(Kr.dtype).reshape(N, T, nl, tile_v, B, C)
    out = torch.einsum("ntlvbc,lco->nbtvo", vox.float(), Kr.float())
    return out.reshape(N, B, T * tile_v, n_out).to(ii.dtype)


def _tiles_bwd(ii, A_b, pix, Kr, g_b, tile_v, dII):
    """(dII, dKr) of `_tiles_fwd`, written out (no autograd), both fp32:
    dII, shaped as ii, is the given accumulator with this bucket's bands
    added (a new zero-filled one if None), dKr (nl, C, n_out) is this
    bucket's contribution."""
    N, B, C = ii.shape[0], ii.shape[1], ii.shape[-1]
    T, R, K = A_b.shape[1:]
    nl, _, n_out = Kr.shape
    vox = _band_vox(ii, A_b, pix).reshape(N, T, nl, tile_v, B, C)
    g = g_b.float().reshape(N, B, T, tile_v, n_out)
    dKr = torch.einsum("ntlvbc,nbtvo->lco", vox, g)
    dvox = torch.einsum("nbtvo,lco->ntlvbc", g, Kr.float())
    dband = torch.matmul(A_b.float().transpose(-1, -2),
                         dvox.reshape(N, T, R, B * C))
    pixels = ii[0, 0].numel() // C
    dflat = torch.zeros((N * pixels, B * C), dtype=torch.float32,
                        device=ii.device)
    dflat.index_add_(0, pix.reshape(-1), dband.reshape(N * T * K, B * C))
    add = dflat.reshape(N, pixels, B, C).permute(0, 2, 1, 3).reshape(ii.shape)
    if dII is None:
        return add.contiguous(), dKr
    dII += add
    return dII, dKr


def window_tiles(ii: torch.Tensor, A_b: torch.Tensor, starts_b: torch.Tensor,
                 Kr: torch.Tensor, window, tile_v: int) -> torch.Tensor:
    """Plain PyTorch version of the window kernel for one bucket.

    ii (N, B, Hp, Wp, C) padded features; A_b (N, T, nl*tile_v, wh*ww);
    starts_b (N, T, 2); Kr (nl, C, n_out). Returns the bucket's tiles
    (N, B, T*tile_v, n_out) in ii's dtype."""
    N, B, Hp, Wp, C = ii.shape
    pix = _window_pixels(starts_b, N, A_b.shape[1], Hp, Wp, window)
    return _tiles_fwd(ii, A_b, pix, Kr, tile_v)


def window_tiles_bwd(ii: torch.Tensor, A_b: torch.Tensor,
                     starts_b: torch.Tensor, Kr: torch.Tensor,
                     g_b: torch.Tensor, window, tile_v: int, dII=None):
    """Plain PyTorch version of the window backward kernel for one bucket.

    Inputs as `window_tiles`, plus g_b (N, B, T*tile_v, n_out), the
    cotangent of the bucket's tiles. Returns (dII, dKr), both fp32: dII
    (N, B, Hp, Wp, C) is the given accumulator with this bucket's windows
    added (a new zero-filled one if None), dKr (nl, C, n_out) is this
    bucket's contribution."""
    N, B, Hp, Wp, C = ii.shape
    pix = _window_pixels(starts_b, N, A_b.shape[1], Hp, Wp, window)
    return _tiles_bwd(ii, A_b, pix, Kr, g_b, tile_v, dII)


def flat_tiles(ii: torch.Tensor, A_b: torch.Tensor, starts_b: torch.Tensor,
               Kr: torch.Tensor, tile_v: int) -> torch.Tensor:
    """Plain PyTorch version of the flat kernel for one bucket.

    ii (N, B, P + max_band, C) padded flat features; A_b
    (N, T, nl*tile_v, band); starts_b (N, T); Kr (nl, C, n_out). Returns
    the bucket's tiles (N, B, T*tile_v, n_out) in ii's dtype."""
    N, B, rows, C = ii.shape
    T, _, band = A_b.shape[1:]
    return _tiles_fwd(ii, A_b, _band_pixels(starts_b, N, T, rows, band), Kr,
                      tile_v)


def flat_tiles_bwd(ii: torch.Tensor, A_b: torch.Tensor, starts_b: torch.Tensor,
                   Kr: torch.Tensor, g_b: torch.Tensor, tile_v: int, dII=None):
    """Plain PyTorch version of the flat backward kernel for one bucket:
    as `window_tiles_bwd`, with dII (N, B, P + max_band, C) (its last
    max_band rows are padding)."""
    N, B, rows, C = ii.shape
    T, _, band = A_b.shape[1:]
    return _tiles_bwd(ii, A_b, _band_pixels(starts_b, N, T, rows, band), Kr,
                      g_b, tile_v, dII)


def tf32_split(x: torch.Tensor):
    """x (fp32) -> (hi, lo), both fp32 values that fit TF32 (10 mantissa
    bits): hi is x rounded to nearest (ties away from zero, by integer
    arithmetic on the bits, as `cvt.rna.tf32.f32` rounds) and lo is x - hi
    rounded the same way. The split of the backward kernels' 3xTF32
    products (`csrc/rig_mma.cuh`)."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor, products: int = 3):
    """a @ b as the tensor-core passes of the backward kernels compute it:
    both operands split by `tf32_split`, a_lo @ b_hi + a_hi @ b_lo +
    a_hi @ b_hi summed in fp32, small terms first. `products` 1 keeps only
    a_hi @ b_hi (one TF32 product), 4 adds a_lo @ b_lo. For tests and logs;
    nothing on the main path calls it."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    terms = [a_lo @ b_lo, a_lo @ b_hi, a_hi @ b_lo, a_hi @ b_hi][4 - products:]
    if products == 1:
        return terms[0]
    return sum(terms[1:], terms[0])


def scale_tiles(ii: torch.Tensor, rig: ScaleRig, Kr: torch.Tensor):
    """All buckets of one scale through the plain versions:
    (N, B, T_total*tile_v, n_out)."""
    if rig.window_hw:
        parts = [window_tiles(ii, A_b, s_b, Kr, win, rig.tile_v)
                 for A_b, s_b, win in zip(rig.A, rig.starts, rig.window_hw)]
    else:
        parts = [flat_tiles(ii, A_b, s_b, Kr, rig.tile_v)
                 for A_b, s_b in zip(rig.A, rig.starts)]
    return torch.cat(parts, dim=2)


def scale_features(lat: torch.Tensor, rig: ScaleRig) -> torch.Tensor:
    """The padded features a scale's kernels read: `pad_features` for the
    window layout, `pad_features_flat` for the flat one."""
    return pad_features(lat) if rig.window_hw else pad_features_flat(lat, rig)


def rig_epilogue(tiles: torch.Tensor, inv_perm: torch.Tensor,
                 collapse_bias: torch.Tensor, out_dtype, camera_sum: bool):
    """tiles (N, B, rows, n_out) -> BEV order by inv_perm, + bias, ReLU;
    then the fp32 camera sum (B, V2d, n_out) or (B, N, V2d, n_out)."""
    N, B, _, n_out = tiles.shape
    idx = inv_perm[:, None, :, None].expand(N, B, inv_perm.shape[1], n_out)
    out = torch.gather(tiles, 2, idx)                         # (N, B, V2d, n_out)
    out = torch.relu(out + collapse_bias.to(out.dtype))
    if camera_sum:
        return out.to(out_dtype).sum(0)
    return out.transpose(0, 1).to(out_dtype)


def rig_sample_scale(lat, rig: ScaleRig, collapse_kernel, collapse_bias,
                     out_dtype=None, camera_sum=False):
    """One scale, all cameras, batched scenes (plain PyTorch).

    lat (B, N, fh, fw, C); collapse_kernel (C*nl, n_out) c-major. Returns
    relu(collapse(vox)) in BEV order: (B, N, V2d, n_out), or the camera sum
    (B, V2d, n_out) when camera_sum."""
    C = lat.shape[-1]
    out_dtype = out_dtype or lat.dtype
    ii = scale_features(lat, rig)
    Kr = collapse_per_layer(collapse_kernel, C, rig.nl, lat.dtype)
    return rig_epilogue(scale_tiles(ii, rig, Kr), rig.inv_perm, collapse_bias,
                        out_dtype, camera_sum)
