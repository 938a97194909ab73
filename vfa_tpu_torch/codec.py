"""Detection target codec (port of `vfa_tpu/codec.py`).

Reference: `vfa/data/encoder.py:24-333`, `vfa/data/smooth_label.py:4-9`.

Encode: each object's center picks a grid cell (Wildtrack's index order is
swapped), and the cell gets fractional location offsets, log(dim /
class_mean) dimension offsets and a 360-bin Circular-Smooth-Label rotation
target. Batched over scenes on the objects' device, no loop over cells;
two objects on one cell resolve last-writer-wins through an `owner` mask,
so every cell is written once and the result does not depend on the order
in which a device applies a scatter. The dense targets index the grid as
the JAX package's `.at[row, col].set(..., mode="drop")` does: a row in
[-L, 0) wraps to row + L (columns likewise with W), and only indices
outside [-L, L) x [-W, W) are dropped. `object_cells` clips instead, as
its JAX twin does (the sparse rotation loss reads it).

Decode: sigmoid -> 5x5 maxpool-equality NMS -> top-k -> threshold ->
invert the offset / dimension / CSL encodings. Fixed-shape (B, K) outputs
with a `valid` mask, batched over scenes, all on the model's device.
MVDet's score map decodes by its own test loop instead (`decode_map`):
raw scores, greedy suppression by distance on the ground plane.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vfa_tpu_torch import observability
from vfa_tpu_torch.config import DatasetConfig
from vfa_tpu_torch.utils import Obj2D, Obj3D, device_constant


def gaussian_csl_labels(angles_deg: torch.Tensor, num_class: int = 360,
                        sigma: float = 6.0) -> torch.Tensor:
    """Circular smooth labels for integer angles in degrees (truncated
    toward zero, may be negative): a gaussian centered on the angle bin,
    wrapped over `num_class` bins (`vfa/data/smooth_label.py:4-9`).
    Returns (..., num_class)."""
    label = torch.trunc(angles_deg).to(torch.int64)
    half = num_class // 2
    dev = angles_deg.device
    x = torch.arange(-half, num_class - half, dtype=torch.float32, device=dev)
    y = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    bins = torch.arange(num_class, device=dev)
    idx = torch.remainder(bins - (label[..., None] - half), num_class)
    return y[idx]


def _normalized_locations(location: torch.Tensor, world_size, grid_shape):
    """location (..., >=2) -> continuous grid coords, reference formula
    `encoder.py:155`: loc / world_size * grid_shape."""
    ws = device_constant(world_size, location.device)
    gs = device_constant(grid_shape, location.device)
    return location[..., :2] / ws * gs


def object_cells(objects: Dict[str, torch.Tensor], cfg: DatasetConfig):
    """Grid cell (row, col) of each padded object and its `owner` mask.

    objects: 'location' (..., M, 3), 'valid' (..., M). `owner` marks objects
    that are valid, land inside the grid, and are not followed by a later
    valid object on the same cell: exactly the cells where a
    last-writer-wins scatter leaves that object's targets. Rows and cols
    are clipped into the grid."""
    L, W = cfg.grid_shape
    row, col = _grid_indices(objects, cfg)
    inside = (row >= 0) & (row < L) & (col >= 0) & (col < W)
    owner = _last_writers(row * W + col, (objects["valid"] > 0) & inside)
    return row.clamp(0, L - 1), col.clamp(0, W - 1), owner


def _grid_indices(objects, cfg: DatasetConfig):
    """Unclipped (row, col) of each object's cell; Wildtrack swaps them."""
    loc = _normalized_locations(objects["location"], cfg.world_size,
                                cfg.grid_shape)
    cx = torch.floor(loc[..., 0]).to(torch.int64)
    cy = torch.floor(loc[..., 1]).to(torch.int64)
    return (cx, cy) if cfg.name == "Wildtrack" else (cy, cx)


def _last_writers(key: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., M) mask of the valid objects that no later valid object with
    the same key follows."""
    M = key.shape[-1]
    later = torch.ones((M, M), dtype=torch.bool, device=key.device).triu(1)
    same_later = ((key[..., None, :] == key[..., :, None])
                  & valid[..., None, :] & later)
    return valid & ~same_later.any(-1)


def encode_frame(objects: Dict[str, torch.Tensor], heatmap: torch.Tensor,
                 cfg: DatasetConfig, dim_mean=None, angle_range: int = 360,
                 angle_radius: float = 6.0,
                 dense_rotation: bool = True) -> Dict[str, torch.Tensor]:
    """Encode padded gt objects into dense targets, batched over scenes.

    objects: 'location' (B, M, 3), 'valid' (B, M) and, in 3D mode,
    'dimension' (B, M, 3), 'rotation' (B, M) (see `utils.pad_objects`);
    heatmap (B, L, W). One frame may be given without the leading B and is
    encoded as a batch of one. Returns mask (B, 1, L, W), heatmap
    (B, 1, L, W), loc_offset (B, L, W, 2) and, in 3D mode, dim_offset
    (B, L, W, 3) and (with dense_rotation) rotation (B, L, W, angle_range).
    Objects that are padded or fall outside [-L, L) x [-W, W) are dropped,
    a negative index wraps (module docstring); an empty frame encodes to
    all-zero targets."""
    if objects["location"].dim() == 2:
        objects = {k: v[None] for k, v in objects.items()}
        heatmap = heatmap[None]
    L, W = cfg.grid_shape
    location = objects["location"].float()
    B, M = location.shape[:2]
    dev = location.device
    # JAX's scatter index rule: a row in [-L, 0) wraps to row + L, one in
    # [0, L) stays, any other is dropped (columns likewise with W)
    row, col = _grid_indices(objects, cfg)
    kept = (row >= -L) & (row < L) & (col >= -W) & (col < W)
    row, col = row.remainder(L), col.remainder(W)
    owner = _last_writers(row * W + col, (objects["valid"] > 0) & kept)
    # every owner writes its own cell; all others go to one spare slot
    flat = (torch.arange(B, device=dev)[:, None] * L + row) * W + col
    flat = torch.where(owner, flat, torch.full_like(flat, B * L * W)).reshape(-1)

    def scatter(values: torch.Tensor) -> torch.Tensor:
        """values (B, M, D) -> (B, L, W, D), zeros off the owners' cells."""
        D = values.shape[-1]
        buf = torch.zeros((B * L * W + 1, D), dtype=torch.float32, device=dev)
        buf[flat] = values.reshape(B * M, D).float()
        return buf[:-1].reshape(B, L, W, D)

    loc = _normalized_locations(location, cfg.world_size, cfg.grid_shape)
    out = {
        "mask": scatter(torch.ones((B, M, 1), device=dev)).permute(0, 3, 1, 2),
        "heatmap": heatmap.float()[:, None],
        "loc_offset": scatter(loc - torch.floor(loc)),
    }
    if cfg.mode == "3D":
        if dim_mean is None:
            raise ValueError("3D encode needs dim_mean")
        mean = device_constant(dim_mean, dev)
        valid = objects["valid"] > 0
        dim_off = torch.log(objects["dimension"].float() / mean)
        out["dim_offset"] = scatter(
            torch.where(valid[..., None], dim_off, torch.zeros_like(dim_off)))
        # dense_rotation=False skips the (L, W, angle_range) CSL map: the
        # train step evaluates the angle loss at the object cells instead
        # (losses.csl_angle_focal_loss_cells)
        if dense_rotation:
            out["rotation"] = scatter(gaussian_csl_labels(
                torch.rad2deg(objects["rotation"].float()), angle_range,
                angle_radius))
    return out


def nms_heatmap(heatmap: torch.Tensor) -> torch.Tensor:
    """5x5 maxpool-equality NMS (`encoder.py:48,230-232`); heatmap (..., L, W)."""
    shape = heatmap.shape
    x = heatmap.reshape(-1, 1, *shape[-2:])
    pooled = F.max_pool2d(x, 5, stride=1, padding=2)
    return torch.where(pooled == x, x, torch.zeros_like(x)).reshape(shape)


@torch.no_grad()
@observability.traced("decode")
def decode_frame(pred: Dict[str, torch.Tensor], cfg: DatasetConfig,
                 cls_thresh: float, topk: int = 100,
                 dim_mean: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
    """Decode a batch of predictions (heatmap (B, 1, L, W), ...) into
    (B, K) detection arrays: conf, location (B, K, 3), valid; in 3D mode
    also dimension (B, K, 3) and rotation (B, K) in radians."""
    heatmap = pred["heatmap"]
    Bn, L, W = heatmap.shape[0], heatmap.shape[2], heatmap.shape[3]
    dev = heatmap.device
    conf_map = nms_heatmap(torch.sigmoid(heatmap))[:, 0].reshape(Bn, -1)

    grid_y, grid_x = torch.meshgrid(
        torch.arange(L, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    grid_size = (np.asarray(cfg.world_size, np.float64)
                 / np.asarray(cfg.cube_size[:2], np.float64))
    world_size = np.asarray(cfg.world_size, np.float64)

    tytx = torch.sigmoid(pred["loc_offset"])                  # (B, L, W, 2)
    cy = ((grid_y + tytx[..., 0]) / float(grid_size[0]) * float(world_size[0])).reshape(Bn, -1)
    cx = ((grid_x + tytx[..., 1]) / float(grid_size[1]) * float(world_size[1])).reshape(Bn, -1)

    # the k largest, equal values in index order, as `jax.lax.top_k`
    # (torch.topk leaves the order of ties open): a trained model's
    # sigmoid saturates at 1.0, so ties above the threshold happen
    k = min(topk, conf_map.shape[1])
    conf, idx = torch.sort(conf_map, dim=1, descending=True, stable=True)
    conf, idx = conf[:, :k], idx[:, :k]
    valid = conf > cls_thresh
    cy = torch.gather(cy, 1, idx)
    cx = torch.gather(cx, 1, idx)
    zeros = torch.zeros_like(cy)

    if cfg.mode == "3D":
        if dim_mean is None:
            raise ValueError("3D decode needs dim_mean")
        thtwtl = pred["dim_offset"].reshape(Bn, -1, 3)
        dims = torch.exp(torch.gather(thtwtl, 1, idx[..., None].expand(-1, -1, 3)))
        dims = dims * device_constant(dim_mean, dev)
        rot = pred["rotation"]
        orient = torch.argmax(rot.reshape(Bn, -1, rot.shape[-1]), dim=-1)
        rot_deg = torch.gather(orient, 1, idx).to(torch.float32)
        return {
            "conf": conf,
            "location": torch.stack([cx, cy, zeros], dim=-1),
            "dimension": dims,
            "rotation": torch.deg2rad(rot_deg),
            "valid": valid,
        }
    if cfg.name == "Wildtrack":
        location = torch.stack([cy, cx, zeros], dim=-1)
    else:
        location = torch.stack([cx, cy, zeros], dim=-1)
    return {"conf": conf, "location": location, "valid": valid}


@torch.no_grad()
@observability.traced("decode")
def decode_map(scores: torch.Tensor, cells: torch.Tensor, cls_thresh: float,
               nms_dist: float, topk: int = 100) -> Dict[str, torch.Tensor]:
    """MVDet's post-processing of a batch of raw score maps (B, 1, L, W)
    (no sigmoid) on their device, with no host sync: the `topk` highest
    scores of each scene, equal scores in cell order; greedy suppression
    among them, highest first, of every candidate at most `nms_dist` from
    one kept before it, by the cells' ground positions `cells` (L, W, 2),
    world-grid units; valid where kept and the score is above
    `cls_thresh`. Upstream suppresses among the cells above the threshold
    only, which suppress one another here alike (a cell under it ranks
    after all of them). Returns conf (B, K), location (B, K, 2) and valid
    (B, K)."""
    B = scores.shape[0]
    flat = scores.float().reshape(B, -1)
    k = min(topk, flat.shape[1])
    conf, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    conf, idx = conf[:, :k], idx[:, :k]
    loc = cells.reshape(-1, 2).float()[idx]                                # (B, K, 2)
    d2 = ((loc[:, :, None] - loc[:, None]) ** 2).sum(-1)
    # close[b, j, i]: candidate j ranks before i and lies within the distance
    close = (d2 <= nms_dist ** 2) & torch.ones(k, k, dtype=torch.bool,
                                               device=flat.device).triu(1)
    keep = torch.ones(B, k, dtype=torch.bool, device=flat.device)
    for i in range(1, k):
        keep[:, i] = ~(keep & close[:, :, i]).any(1)
    return {"conf": conf, "location": loc, "valid": keep & (conf > cls_thresh)}


class ObjectEncoder:
    """Holds the dataset constants and turns decoded arrays into python
    Obj3D/Obj2D lists (`encoder.py:24-49,307-333`)."""

    def __init__(self, cfg: DatasetConfig, dim_mean=None, topk: int = 100):
        self.cfg = cfg
        self.topk = topk
        self.dim_mean = None if dim_mean is None else np.asarray(dim_mean, np.float32)
        self.label_name = "Cow" if cfg.name == "MultiviewC" else "Person"

    def decode(self, pred, cls_thresh: float):
        return decode_frame(pred, self.cfg, cls_thresh, topk=self.topk,
                            dim_mean=self.dim_mean)

    def batch_decode(self, pred, cls_thresh: float):
        """One list of Obj3D/Obj2D per scene of the batch."""
        d = {k: v.cpu().numpy() for k, v in self.decode(pred, cls_thresh).items()}
        scenes = []
        for s in range(d["conf"].shape[0]):
            objects = []
            for i in np.nonzero(d["valid"][s])[0]:
                if self.cfg.mode == "3D":
                    objects.append(Obj3D(
                        classname=self.label_name, conf=d["conf"][s, i],
                        location=d["location"][s, i],
                        dimension=d["dimension"][s, i],
                        rotation=d["rotation"][s, i]))
                else:
                    objects.append(Obj2D(
                        classname=self.label_name, conf=d["conf"][s, i],
                        location=d["location"][s, i]))
            scenes.append(objects)
        return scenes
