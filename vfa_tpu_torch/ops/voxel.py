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
No hand kernel: the JAX module has no Pallas call.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vfa_tpu_torch.geometry import grid_sample_bilinear, project, worldgrid_to_worldcoord
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
    (`vfa/model/vfa_op.py:172-173`). On bf16 it is JAX's bf16 cumsum bit
    for bit (`BlockedIntegralImage`), forward and backward; on fp32 it is
    `torch.cumsum`."""
    if feature.dtype == torch.bfloat16:
        return BlockedIntegralImage.apply(feature)
    return torch.cumsum(torch.cumsum(feature, dim=-1), dim=-2)


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


class BlockedIntegralImage(torch.autograd.Function):
    """The bf16 integral image as JAX computes it (`vfa_tpu/ops/voxel.py:
    107-109` on bf16 features): `blocked_cumsum` over -1 then -2; the
    backward is JAX's transpose, the reverse scans over -2 then -1."""

    @staticmethod
    def forward(ctx, feature):
        return blocked_cumsum(blocked_cumsum(feature, -1), -2)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return blocked_cumsum(blocked_cumsum(grad, -2, reverse=True), -1,
                              reverse=True)


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
    ii = integral_image(feature)
    # corners by slicing and stacking: an index list would be a host tensor
    # copied to the device, and waited for, at every call
    l, t, r, b = boxes.unbind(-1)
    lt = grid_sample_bilinear(ii, boxes[..., 0:2])
    rb = grid_sample_bilinear(ii, boxes[..., 2:4])
    rt = grid_sample_bilinear(ii, torch.stack([r, t], dim=-1))
    lb = grid_sample_bilinear(ii, torch.stack([l, b], dim=-1))
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
