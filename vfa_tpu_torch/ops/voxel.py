"""Voxelized feature aggregation, the reference voxel route (port of
`vfa_tpu/ops/voxel.py`).

Reference: `vfa/model/vfa_op.py:46-173`. Per (camera, scale): lift the
ground grid to `nl` z-layers, add the 8 cube corner offsets, convert
world-grid -> world coords, project through the 3x4 calibration, normalize
to [-1, crange_hi], take the per-voxel axis-aligned box over the 8 projected
corners, mask by visible area, and mean-pool the features inside each box
through 4 bilinear reads of their integral image. The compiled rig
(`ops/rig.py`) is the same linear map built once on the host; this module
computes it from the calibrations on every call (VFANet's `rig=None`
route) and is the rig's reference.

The torch functions take optional leading batch dims where the JAX ones
are vmapped over cameras: `voxel_boxes` on calibs (*lead, 3, 4),
`sample_voxels` on features (*lead, C, fh, fw) with boxes (*lead, ...).
On bf16 features the integral image is JAX's, bit for bit: XLA's blocked
cumsum (`blocked_cumsum`), not `torch.cumsum`, which rounds elsewhere.
The backward is JAX's in both dtypes, bit for bit: the corner reads'
gradient is added into the integral image in XLA's order (`CornerTaps`,
on a card by the hand-written kernel `csrc/voxel_tap_bwd.cu`, which
replaces no Pallas kernel: the JAX module has none, its gathers'
transpose is XLA's scatter-add), then scanned back as XLA scans it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vfa_tpu_torch.geometry import (bilinear_taps, grid_sample_bilinear, project,
                                    worldgrid_to_worldcoord)
from vfa_tpu_torch.kernels import LaunchCount
from vfa_tpu_torch.utils import device_constant

EPSILON = 1e-6
MAXIMUM_AREA_RATIO = 0.3


def cube_corner_offsets(cube_size) -> np.ndarray:
    """8 corner offsets of one voxel cube, shape (8, 3)
    (`vfa/model/vfa_op.py:127-133`)."""
    l, w, h = cube_size
    x = np.array([-l / 2, l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2])
    y = np.array([-w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2, w / 2])
    z = np.array([0, 0, 0, 0, h, h, h, h])
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def z_layer_offsets(grid_height: int, cube_h: int) -> np.ndarray:
    """(nl, 3) z offsets of the voxel layers (`vfa/model/vfa_op.py:50-52`)."""
    z = np.arange(0, grid_height, cube_h, dtype=np.float32)
    out = np.zeros((len(z), 3), dtype=np.float32)
    out[:, 2] = z
    return out


def voxel_boxes(calib: torch.Tensor, grid: torch.Tensor, *, dataset: str,
                grid_height: int, cube_size, image_size,
                crange=(-1.0, 0.95)) -> torch.Tensor:
    """Per-voxel projected boxes, normalized to [-1, crange_hi].

    calib (*lead, 3, 4) = K @ [R|t]; grid (L, W, 3) world-grid ground
    plane from `make_grid`; image_size (H, W) the projection is normalized
    by (`vfa/model/vfa_op.py:75-76`). Returns (*lead, nl, L, W, 4) boxes
    (l, t, r, b)."""
    dev, dt = grid.device, grid.dtype
    z_off = device_constant(z_layer_offsets(grid_height, cube_size[2]), dev, dt)
    c_off = device_constant(cube_corner_offsets(cube_size), dev, dt)
    corners = grid[None, :, :, None, :] + z_off[:, None, None, None, :] + c_off
    corners = worldgrid_to_worldcoord(corners, dataset)          # (nl, L, W, 8, 3)
    img_xy = project(corners, calib[..., None, None, None, None, :, :])
    ih, iw = image_size
    nx = (2.0 * img_xy[..., 0] / iw - 1.0).clamp(crange[0], crange[1])
    ny = (2.0 * img_xy[..., 1] / ih - 1.0).clamp(crange[0], crange[1])
    return torch.stack([nx.amin(-1), ny.amin(-1), nx.amax(-1), ny.amax(-1)],
                       dim=-1)


def box_area_visibility(boxes: torch.Tensor, feat_hw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Area (normalized units * fH*fW, the reference's convention) and the
    visibility mask EPS < area < 0.3*fH*fW (`vfa/model/vfa_op.py:104-106`)."""
    fh, fw = feat_hw
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    area = area * (fh * fw) + EPSILON
    visible = (area > EPSILON) & (area < fh * fw * MAXIMUM_AREA_RATIO)
    return area, visible


def integral_image(feature: torch.Tensor) -> torch.Tensor:
    """Double cumsum over (W, H) of (..., C, fH, fW)
    (`vfa/model/vfa_op.py:172-173`), `IntegralImage`: on bf16 JAX's bf16
    cumsum bit for bit, on fp32 `torch.cumsum`; the backward is JAX's
    transpose in both."""
    return IntegralImage.apply(feature)


# JAX lowers `jnp.cumsum` to a reduce-window, which XLA rewrites into a
# tree of windows of this length (its `ReduceWindowRewriter`; the CPU
# compiler's optimised HLO of a 640-long bf16 cumsum holds f32[..., 40, 16]
# windows), rounding every add to bf16.
SCAN_BLOCK = 16


def blocked_cumsum(x: torch.Tensor, dim: int, reverse: bool = False) -> torch.Tensor:
    """XLA's bf16 cumsum along `dim`, bit for bit: the axis padded with
    zeros to blocks of SCAN_BLOCK; inside a block a sequential scan from
    the block's start, each add rounded to x's dtype; the block totals
    scanned the same way (recursively) and each block's exclusive prefix
    added to it once. `reverse` is the suffix sum, JAX's transpose of
    cumsum (its backward): inside a block output i is x_i + x_i+1 + ... in
    that order, each add rounded (not the forward scan of the flipped
    block), the totals the first column, the exclusive suffix added once.
    Every op is one bf16 add of two tensors, which rounds the exact sum
    once, on the CPU and on a card alike."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    nb = -(-n // SCAN_BLOCK)
    x = F.pad(x, (0, nb * SCAN_BLOCK - n)).reshape(*x.shape[:-1], nb, SCAN_BLOCK)
    out = x.clone()
    if reverse:
        for k in range(1, SCAN_BLOCK):
            out[..., :SCAN_BLOCK - k] += x[..., k:]
    else:
        for k in range(1, SCAN_BLOCK):
            out[..., k] += out[..., k - 1]
    if nb > 1:
        totals = blocked_cumsum(out[..., 0 if reverse else -1], -1, reverse)
        carry = torch.zeros_like(totals)
        if reverse:
            carry[..., :-1] = totals[..., 1:]
        else:
            carry[..., 1:] = totals[..., :-1]
        out += carry[..., None]
    return out.reshape(*out.shape[:-2], nb * SCAN_BLOCK)[..., :n].movedim(-1, dim)


class IntegralImage(torch.autograd.Function):
    """The integral image (`vfa_tpu/ops/voxel.py:107-109`). The forward is
    `blocked_cumsum` over -1 then -2 on bf16, as JAX computes it there, and
    `torch.cumsum` on fp32 (XLA's fp32 scan rounds elsewhere, within the
    fp32 tests' 1e-4; the port keeps torch's). The backward is JAX's transpose
    in every dtype: the reverse `blocked_cumsum` over -2 then -1 (XLA
    lowers the fp32 cumsum to the same blocked windows, each add in fp32)."""

    @staticmethod
    def forward(ctx, feature):
        if feature.dtype == torch.bfloat16:
            return blocked_cumsum(blocked_cumsum(feature, -1), -2)
        return torch.cumsum(torch.cumsum(feature, dim=-1), dim=-2)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return blocked_cumsum(blocked_cumsum(grad, -2, reverse=True), -1,
                              reverse=True)


# The transpose of the four corner reads, as XLA adds it (the CPU
# compiler's optimised HLO of `jax.vjp` of `vfa_tpu.ops.voxel.sample_voxels`,
# JAX 0.9.0, bf16 and fp32 features, live boxes and cotangent, at (3, 5, 7)
# under (2, 3, 4) boxes and at full MultiviewC (256, 90, 160) under
# (5, 156, 156) boxes vmapped over 2 scenes; and `jax.vjp` run op by op):
#
# - The cotangent of the corner reads: gs = (g * visible) / area in fp32
#   (`broadcast_divide_fusion`), +gs for lt and rb, -gs for rt and lb (a
#   negate before the products). Autograd of `sample_voxels`' last lines
#   computes the same bits.
# - Each of a corner's 4 bilinear taps (`vfa_tpu/geometry.py:117`, one
#   `jnp.take`) transposes to its own scatter-add into a zeroed fp32
#   operand laid out pixel-major, f32[(scene,) H*W, C]. Its update of
#   point p is the fp32 product (+-gs)_p * w_p (w the tap's bilinear
#   weight, as the forward computes it) rounded to ii's dtype, times the
#   tap's in-image mask. The scatter visits the updates in point order
#   ((nl, L, W) row-major; XLA's CPU scatter is a loop over the updates in
#   index order, the scenes of a vmap in parallel, each scene's pixels its
#   own), and rounds each add to ii's dtype (bf16: the combiner adds in fp32
#   and converts to bf16 and back), from 0.
# - The 16 scatters (4 corners x 4 taps) are joined in one chain, each add
#   rounded to ii's dtype, in the reverse of their use: lb, rt, rb, lt, and
#   inside a corner tap (x1, y1), (x0, y1), (x1, y0), (x0, y0). JAX
#   accumulates the cotangents as it walks the forward backwards.
# - The sum, transposed to (C, H, W), is the cotangent of the integral
#   image: `IntegralImage.backward` scans it back (reverse blocked scans
#   over H, then W).
#
# bf16 and fp32 differ only in the rounding, so one code path serves both
# (`CHAIN_LENGTH` chain positions, `TapOrder`), and both equal `jax.vjp` of
# JAX's op, run op by op, bit for bit. Under `jax.jit` XLA changes two
# things: it contracts ((x + 1) * W - 1) of the tap coordinates into one
# fused multiply-add, and on fp32 its algebraic simplifier rewrites
# add(A, scatter(0, u)) into scatter(A, u) for every other tap of the chain
# (A + u1 + u2 ...). JAX's jitted gradient is then 3.7e-3 rel-L2 from its
# own op-by-op one on bf16 (97.4 % of the elements equal) and 4.3e-5 on
# fp32, on the full MultiviewC boxes over (32, 90, 160); at the tiny
# MultiviewC boxes 0 and 9.8e-6 (tests/voxel_order_report.py).
CHAIN_LENGTH = 16


def corner_coords(boxes: torch.Tensor):
    """The (x, y) points of boxes (..., 4) = (l, t, r, b) at the corners
    lt, rb, rt, lb, each (..., 2). By slicing and stacking: an index list
    would be a host tensor copied to the device, and waited for, at every
    call."""
    l, t, r, b = boxes.unbind(-1)
    return (boxes[..., 0:2], boxes[..., 2:4], torch.stack([r, t], dim=-1),
            torch.stack([l, b], dim=-1))


class TapOrder(NamedTuple):
    """The order index of the corner reads' transpose over B scenes of
    (H, W) pixels and P points: entry e is one update, at `rows[e]` of the
    stacked cotangents (4 * B * P, C) (corner, scene, point) with weight
    `w[e]` (the bilinear weight times the in-image mask). The entries of
    chain position j, scene b, pixel q are e in [ptr[k], ptr[k + 1]), k =
    (j * B + b) * H * W + q, in XLA's order (point order)."""
    ptr: torch.Tensor      # (CHAIN_LENGTH * B * H * W + 1,) int32
    rows: torch.Tensor     # (CHAIN_LENGTH * B * P,) int32
    w: torch.Tensor        # (CHAIN_LENGTH * B * P,) the boxes' dtype


def tap_order(boxes: torch.Tensor, feat_hw) -> TapOrder:
    """The `TapOrder` of boxes (B, nl, L, W, 4) on an (H, W) feature map,
    built on the boxes' device with no host sync: one stable sort of the
    entries' keys (chain position, scene, pixel), whose input is in point
    order."""
    H, W = feat_hw
    B, P = boxes.shape[0], boxes[0, ..., 0].numel()
    dev = boxes.device
    bx = boxes.reshape(B, P, 4)
    taps = [bilinear_taps(c, H, W) for c in corner_coords(bx)]
    scene = torch.arange(B, device=dev)[:, None]
    point = torch.arange(B * P, device=dev).reshape(B, P)
    keys, rows, ws = [], [], []
    for j in range(CHAIN_LENGTH):
        corner, tap = divmod(CHAIN_LENGTH - 1 - j, 4)
        idx, inb, w = taps[corner][tap]
        keys.append((j * B + scene) * (H * W) + idx)
        rows.append(corner * B * P + point)
        ws.append(w * inb)
    keys = torch.stack(keys).reshape(-1)
    order = torch.sort(keys, stable=True).indices
    n = CHAIN_LENGTH * B * H * W
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(keys, minlength=n), 0)
    return TapOrder(ptr.int(), torch.stack(rows).reshape(-1)[order].int(),
                    torch.stack(ws).reshape(-1)[order])


def corner_taps_bwd(g: torch.Tensor, order: TapOrder, shape, dtype) -> torch.Tensor:
    """The plain version of `voxel_tap_bwd`: the cotangent of the integral
    image (B, C, H, W) in `dtype` from the stacked cotangents g (4 * B * P,
    C) of the corners lt, rb, rt, lb (fp32: vox is fp32 on bf16 features
    too), in XLA's order. Every chain position's scatter runs from 0 at
    once: step k adds the k-th update of every (position, scene, pixel)
    that has one, no two of them on one row, as one add of two tensors in
    `dtype`; then the chain joins the 16 sums, each add rounded. As many
    steps as the most updates a pixel takes from one tap (one host sync
    for that count)."""
    B, C, H, W = shape
    n = CHAIN_LENGTH * B * H * W
    counts = order.ptr[1:] - order.ptr[:-1]
    entries = order.rows.numel()
    key = torch.repeat_interleave(torch.arange(n, device=g.device), counts,
                                  output_size=entries)
    rank = torch.arange(entries, device=g.device) - order.ptr[:-1].long()[key]
    by_rank = torch.sort(rank, stable=True).indices
    acc = torch.zeros((n, C), dtype=dtype, device=g.device)
    start = 0
    for size in torch.bincount(rank).tolist():
        e = by_rank[start:start + size]
        start += size
        k = key[e]
        acc[k] = acc[k] + (g[order.rows[e].long()] * order.w[e, None]).to(dtype)
    acc = acc.reshape(CHAIN_LENGTH, B, H * W, C)
    out = acc[0]
    for j in range(1, CHAIN_LENGTH):
        out = out + acc[j]
    return out.transpose(1, 2).reshape(B, C, H, W)


def _check_launch(g, order, out):
    """One device, contiguous, the dtypes the kernel takes."""
    if g.device.type != "cuda":
        raise ValueError(f"voxel_tap_bwd: unsupported device {g.device}")
    if out.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"voxel_tap_bwd: the integral image must be float32 or "
                        f"bfloat16, got {out.dtype}")
    B, C, H, W = out.shape
    want = {"g": (g, torch.float32, (g.shape[0], C)),
            "ptr": (order.ptr, torch.int32, (CHAIN_LENGTH * B * H * W + 1,)),
            "rows": (order.rows, torch.int32, (g.shape[0] * 4,)),
            "w": (order.w, torch.float32, (g.shape[0] * 4,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != g.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"voxel_tap_bwd: {name} is {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}, expected {dtype} {shape} on {g.device}")
        if not t.is_contiguous():
            raise ValueError(f"voxel_tap_bwd: {name} must be contiguous")


def voxel_tap_bwd(g: torch.Tensor, order: TapOrder, shape, dtype) -> torch.Tensor:
    """The cotangent of the integral image (B, C, H, W) in `dtype` (float32
    or bfloat16) from the stacked corner cotangents g (4 * B * P, C) fp32,
    in XLA's order (`corner_taps_bwd`). On a CPU tensor the plain version;
    on a CUDA tensor the kernel `csrc/voxel_tap_bwd.cu` or an error.
    `voxel_tap_bwd.launches` counts fp32 kernel launches,
    `voxel_tap_bwd_bf16.launches` bf16 ones."""
    if g.device.type == "cpu":
        return corner_taps_bwd(g, order, shape, dtype)
    from vfa_tpu_torch.kernels import launch

    out = torch.empty(shape, dtype=dtype, device=g.device)
    _check_launch(g, order, out)
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    B, C, H, W = shape
    launch("voxel_tap_bwd", f"voxel_tap_bwd_{suffix}", g.device, g.data_ptr(),
           order.ptr.data_ptr(), order.rows.data_ptr(), order.w.data_ptr(),
           out.data_ptr(), B, H * W, C)
    (voxel_tap_bwd_bf16 if dtype == torch.bfloat16 else voxel_tap_bwd).launches += 1
    return out


voxel_tap_bwd.launches = 0
voxel_tap_bwd_bf16 = LaunchCount()


class CornerTaps(torch.autograd.Function):
    """The four corner reads lt, rb, rt, lb of the integral image ii
    (*lead, C, H, W) at boxes (*lead, nl, L, W, 4), each (*lead, nl, L, W,
    C): the forward is `grid_sample_bilinear`'s, the backward adds their
    cotangents into ii's in XLA's order (`tap_order`, `voxel_tap_bwd`).
    The boxes take no gradient (they come from the calibrations, which no
    route trains)."""

    @staticmethod
    def forward(ctx, ii, boxes):
        ctx.save_for_backward(boxes)
        ctx.ii_meta = (ii.shape, ii.dtype)
        return tuple(grid_sample_bilinear(ii, c) for c in corner_coords(boxes))

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        if ctx.needs_input_grad[1]:
            raise NotImplementedError("CornerTaps: no gradient for the boxes")
        (boxes,), (shape, dtype) = ctx.saved_tensors, ctx.ii_meta
        C, H, W = shape[-3:]
        boxes = boxes.reshape(-1, *boxes.shape[-4:])
        B = boxes.shape[0]
        g = torch.stack(grads).reshape(4 * B * boxes[0, ..., 0].numel(), C)
        out = voxel_tap_bwd(g, tap_order(boxes, (H, W)), (B, C, H, W), dtype)
        return out.reshape(shape), None


def sample_voxels(feature: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Mean-pooled voxel features of one camera at one scale.

    feature (*lead, C, fH, fW); boxes (*lead, nl, L, W, 4) from
    `voxel_boxes`. Returns (*lead, L, W, C*nl), channel-major then layer
    (the reference's flatten order, `vfa/model/vfa_op.py:120`), so the
    collapse Linear maps 1:1 from the reference checkpoint. On bf16
    features vox is fp32, as in JAX: the bf16 taps of the integral image
    meet fp32 bilinear weights."""
    C = feature.shape[-3]
    nl, L, W = boxes.shape[-4:-1]
    lead = feature.shape[:-3]
    area, visible = box_area_visibility(boxes, feature.shape[-2:])
    lt, rb, rt, lb = CornerTaps.apply(integral_image(feature), boxes)
    vox = (lt + rb - rt - lb) / area[..., None]               # (*lead, nl, L, W, C)
    vox = vox * visible[..., None].to(vox.dtype)
    return vox.movedim(-4, -1).reshape(*lead, L, W, C * nl)


def voxel_taps(boxes: torch.Tensor, feat_hw):
    """Gather taps of one camera's boxes (nl, L, W, 4): the 4 integral-image
    corner reads x 4 bilinear taps of each voxel as 16 flat pixel indices
    and merged weights (sign * bilinear weight / area * visible); taps
    outside the image get weight 0 (zeros padding).

    Returns idx (nl*L*W, 16) int32 into fH*fW and w (nl*L*W, 16) float32."""
    fh, fw = feat_hw
    area, visible = box_area_visibility(boxes, feat_hw)
    V = boxes.shape[0] * boxes.shape[1] * boxes.shape[2]
    boxes = boxes.reshape(V, 4)
    # corner points (V, 4, 2) in (x, y), signs (+ + - -) for lt rb rt lb
    pts = torch.stack([boxes[:, [0, 1]], boxes[:, [2, 3]], boxes[:, [2, 1]],
                       boxes[:, [0, 3]]], dim=1)
    signs = torch.tensor([1.0, 1.0, -1.0, -1.0], device=boxes.device)
    x = ((pts[..., 0] + 1.0) * fw - 1.0) * 0.5
    y = ((pts[..., 1] + 1.0) * fh - 1.0) * 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    tap_idx, tap_w = [], []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        wxt = wx1 if dx else 1.0 - wx1
        wyt = wy1 if dy else 1.0 - wy1
        inb = (xi >= 0) & (xi <= fw - 1) & (yi >= 0) & (yi <= fh - 1)
        xc = xi.clamp(0, fw - 1).to(torch.int32)
        yc = yi.clamp(0, fh - 1).to(torch.int32)
        tap_idx.append(yc * fw + xc)
        tap_w.append(wxt * wyt * inb * signs)
    idx = torch.cat(tap_idx, dim=-1)
    w = torch.cat(tap_w, dim=-1)
    scale = (visible.to(w.dtype) / area).reshape(V, 1)
    return idx, w * scale


def sample_voxels_taps(feature: torch.Tensor, idx: torch.Tensor,
                       w: torch.Tensor, nl: int, L: int, W: int) -> torch.Tensor:
    """`sample_voxels` from `voxel_taps`' taps: vox[v, c] = sum_t
    w[v, t] * II[c, idx[v, t]]. feature (C, fH, fW); returns (L, W, C*nl)."""
    C = feature.shape[0]
    ii = integral_image(feature).reshape(C, -1)
    taps = ii[:, idx.reshape(-1).long()].reshape(C, -1, 16)
    vox = torch.einsum("cvt,vt->vc", taps, w)                  # (V, C)
    return vox.reshape(nl, L * W, C).permute(1, 2, 0).reshape(L, W, C * nl)
