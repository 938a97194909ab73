"""Geometry (port of `vfa_tpu/geometry.py`): the BEV grid on the host,
world-grid -> world-coord conversion (numpy or torch), pinhole projection
and a torch-`grid_sample`-compatible bilinear sampler on torch tensors;
and MVDet's ground-plane sampling positions (`ground_positions`).

  - `vfa/utils.py:16-37`  make_grid (Wildtrack axis swap)
  - `vfa/utils.py:50-59`  project (3x4 calib, homogeneous divide)
  - `vfa/model/vfa_op.py:23-44` worldgrid->worldcoord converters
  - torch ``F.grid_sample(mode='bilinear', padding_mode='zeros',
    align_corners=False)`` as used at `vfa/model/vfa_op.py:112-115`.
"""

from __future__ import annotations

import numpy as np
import torch


def make_grid(world_size, cube_LW, dataset: str, grid_offset=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Ground-plane grid of world-grid coordinates, shape (L, W, 3)."""
    if dataset == "Wildtrack":
        length, width = world_size[::-1]
    else:
        length, width = world_size
    xoff, yoff, zoff = grid_offset
    xcoords = np.arange(0.0, width, cube_LW[0], dtype=np.float32) + xoff
    ycoords = np.arange(0.0, length, cube_LW[1], dtype=np.float32) + yoff
    if dataset == "Wildtrack":
        xx, yy = np.meshgrid(xcoords, ycoords, indexing="ij")
    else:
        yy, xx = np.meshgrid(ycoords, xcoords, indexing="ij")
    zz = np.full_like(xx, zoff)
    return np.stack([xx, yy, zz], axis=-1)


def worldgrid_to_worldcoord(grid, dataset: str):
    """World-grid coords (..., 3) -> world coords, numpy or torch.
    MultiviewC: identity; MultiviewX: /40; Wildtrack: x*2.5-300,
    y*2.5-900, z*2.5."""
    if dataset == "MultiviewC":
        return grid
    if dataset == "MultiviewX":
        return grid / 40.0
    if dataset == "Wildtrack" and isinstance(grid, torch.Tensor):
        # per axis with Python scalars: no host constant copied to the device
        return torch.stack([grid[..., 0] * 2.5 + -300.0,
                            grid[..., 1] * 2.5 + -900.0,
                            grid[..., 2] * 2.5 + 0.0], dim=-1)
    if dataset == "Wildtrack":
        scale = np.asarray([2.5, 2.5, 2.5], dtype=grid.dtype)
        shift = np.asarray([-300.0, -900.0, 0.0], dtype=grid.dtype)
        return grid * scale + shift
    raise ValueError(f"unknown dataset {dataset}")


def project(points: torch.Tensor, calib: torch.Tensor) -> torch.Tensor:
    """Pinhole projection: points (..., 3) world coords, calib (..., 3, 4)
    = K @ [R|t] broadcastable against the points' leading dims. Returns
    (..., 2) pixel coords: h = calib[:, :3] @ p + calib[:, 3]; h[:2] / h[2],
    with the length-3 contraction as a multiply and a sum, as in JAX."""
    h = (calib[..., :3] * points[..., None, :]).sum(-1) + calib[..., 3]
    return h[..., :2] / h[..., 2:3]


def ground_positions(calibs, grid, dataset: str, image_size, map_size) -> torch.Tensor:
    """MVDet's perspective transform as sampling positions: where each BEV
    cell's ground point falls in each camera's feature map of `map_size`
    (h, w), the camera's image of `image_size` (H, W) scaled by w / W and
    h / H. calibs (N, 3, 4) = K @ [R|t] at `image_size`; grid (L, W, 3)
    world-grid coordinates, of which the height is not read (the ground,
    z = 0). Returns (N, L, W, 2) fp32 (x, y) pixel indices of the map,
    worked out in fp64: the homography of `kornia.warp_perspective` as
    upstream builds it (`persp_trans_detector.py`: the image zoom, the
    world-grid transform, the map zoom), applied point by point."""
    g = torch.as_tensor(np.asarray(grid), dtype=torch.float64)
    g = torch.cat([g[..., :2], torch.zeros_like(g[..., :1])], -1)
    pts = worldgrid_to_worldcoord(g, dataset)
    c = torch.as_tensor(np.asarray(calibs), dtype=torch.float64)[:, None, None]
    xy = project(pts, c)
    scale = torch.tensor([map_size[1] / image_size[1], map_size[0] / image_size[0]],
                         dtype=torch.float64)
    return (xy * scale).float()


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """Normalized coord in [-1, 1] -> pixel index, align_corners=False:
    ix = ((x + 1) * size - 1) / 2."""
    return ((coord + 1.0) * size - 1.0) * 0.5


def bilinear_taps(coords: torch.Tensor, H: int, W: int):
    """The four bilinear taps of normalized `coords` (..., 2) in (x, y)
    order on an (H, W) image, in the order `grid_sample_bilinear` adds
    them, (x0, y0), (x1, y0), (x0, y1), (x1, y1): per tap the flat pixel
    index y * W + x (clamped into the image), whether the tap lies inside
    the image, and its weight, each (...)."""
    x = _unnormalize(coords[..., 0], W)
    y = _unnormalize(coords[..., 1], H)
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    out = []
    for xi, yi, w in ((x0, y0, wx0 * wy0), (x1, y0, wx1 * wy0),
                      (x0, y1, wx0 * wy1), (x1, y1, wx1 * wy1)):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        out.append((idx, inb, w))
    return out


def grid_sample_bilinear(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of `image` (*lead, C, H, W) at normalized `coords`
    (*lead, *pts, 2) in (x, y) order, as torch ``F.grid_sample`` with its
    defaults (bilinear, zeros padding, align_corners=False): each of the
    four taps is masked on its own when it falls outside the image.
    Returns (*lead, *pts, C)."""
    C, H, W = image.shape[-3:]
    lead = image.shape[:-3]
    pts = coords.shape[len(lead):-1]
    flat = image.reshape(*lead, C, H * W)
    out = None
    for idx, inb, w in bilinear_taps(coords, H, W):
        idx = idx.reshape(*lead, 1, -1).expand(*lead, C, -1)
        vals = torch.gather(flat, -1, idx).movedim(-2, -1)     # (*lead, P, C)
        vals = vals.reshape(*lead, *pts, C) * inb[..., None].to(image.dtype)
        out = vals * w[..., None] if out is None else out + vals * w[..., None]
    return out


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Rodrigues rotation-vector -> 3x3 rotation matrix."""
    rvec = np.asarray(rvec, dtype=np.float64).reshape(3)
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) * np.cos(theta) + (1 - np.cos(theta)) * np.outer(k, k) + np.sin(theta) * K
