"""Synthetic multiview scenes (port of `vfa_tpu/data/synthetic.py`).

Cameras sit on a ring around the world grid looking at its center, with
intrinsics matching each dataset's image size. Everything is numpy from a
seed, so the same seed gives the same arrays as the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from vfa_tpu_torch.config import DatasetConfig
from vfa_tpu_torch.geometry import make_grid, worldgrid_to_worldcoord
from vfa_tpu_torch.utils import Obj2D, Obj3D


def _look_at_extrinsic(cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World->camera [R|t], +z from cam_pos toward target, x right, y down."""
    z = target - cam_pos
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 0.0, -1.0])
    x = np.cross(z, up)
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)
    t = -R @ cam_pos
    return np.hstack([R, t[:, None]]).astype(np.float64)


def make_camera_params(cfg: DatasetConfig, num_cam: int | None = None):
    """[(K (3, 3), [R|t] (3, 4))] per camera, float64: intrinsics matching
    the dataset's image size, extrinsics on a ring looking at the grid's
    center (what `make_calibrations` multiplies)."""
    num_cam = num_cam or cfg.num_cam
    grid = make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name)
    corners = np.stack([grid[0, 0], grid[-1, -1]])
    wc = np.asarray(worldgrid_to_worldcoord(corners.astype(np.float32), cfg.name))
    center = wc.mean(axis=0)
    extent = np.abs(wc[1] - wc[0]).max()

    ih, iw = cfg.image_size
    f = 0.9 * iw
    K = np.array([[f, 0, iw / 2.0], [0, f, ih / 2.0], [0, 0, 1.0]])

    params = []
    for i in range(num_cam):
        ang = 2.0 * np.pi * i / num_cam
        pos = center + np.array(
            [1.1 * extent * np.cos(ang), 1.1 * extent * np.sin(ang), 0.45 * extent]
        )
        params.append((K, _look_at_extrinsic(pos, center)))
    return params


def make_calibrations(cfg: DatasetConfig, num_cam: int | None = None) -> np.ndarray:
    """(N, 3, 4) camera matrices K @ [R|t] in world-coord units."""
    return np.stack([K @ Rt for K, Rt in make_camera_params(cfg, num_cam)]
                    ).astype(np.float32)


def make_objects(cfg: DatasetConfig, num_objects: int, rng: np.random.Generator):
    """Random gt objects in world-grid units, away from grid borders."""
    ws = np.asarray(cfg.world_size, np.float64)
    objs = []
    for _ in range(num_objects):
        xy = rng.uniform(0.1, 0.9, size=2) * ws
        if cfg.mode == "3D":
            dim = rng.uniform([120, 100, 220], [170, 140, 290])
            rot = rng.uniform(-np.pi, np.pi)
            objs.append(Obj3D(
                classname="Cow", dimension=dim, location=np.array([xy[0], xy[1], 0.0]),
                rotation=rot, conf=None,
            ))
        else:
            objs.append(Obj2D(
                classname="Person", location=np.array([xy[0], xy[1], 0.0]), conf=None,
            ))
    return objs


def make_gt_heatmap(cfg: DatasetConfig, objects, sigma: float = 2.0) -> np.ndarray:
    """Gaussian-bump gt heatmap on the BEV grid."""
    L, W = cfg.grid_shape
    hm = np.zeros((L, W), np.float32)
    ws = np.asarray(cfg.world_size, np.float64)
    gs = np.asarray(cfg.grid_shape, np.float64)
    yy, xx = np.mgrid[0:L, 0:W]
    for o in objects:
        cx, cy = np.asarray(o.location)[:2] / ws * gs
        r, c = (cx, cy) if cfg.name == "Wildtrack" else (cy, cx)
        hm = np.maximum(hm, np.exp(-((yy - r) ** 2 + (xx - c) ** 2) / (2 * sigma ** 2)))
        ri, ci = int(r), int(c)
        if 0 <= ri < L and 0 <= ci < W:
            hm[ri, ci] = 1.0
    return hm


@dataclasses.dataclass
class SyntheticScene:
    images: np.ndarray    # (N, H, W, 3) float32 in [0, 1]
    calibs: np.ndarray    # (N, 3, 4)
    grid: np.ndarray      # (L, W, 3)
    objects: list
    heatmap: np.ndarray   # (L, W)


def make_scene(
    cfg: DatasetConfig,
    seed: int = 0,
    num_objects: int = 8,
    num_cam: int | None = None,
    image_hw: Tuple[int, int] | None = None,
) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    num_cam = num_cam or cfg.num_cam
    ih, iw = image_hw or cfg.resize_size
    images = rng.uniform(0, 1, size=(num_cam, ih, iw, 3)).astype(np.float32)
    calibs = make_calibrations(cfg, num_cam)
    grid = make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name)
    objects = make_objects(cfg, num_objects, rng)
    heatmap = make_gt_heatmap(cfg, objects)
    return SyntheticScene(images, calibs, grid, objects, heatmap)


def tiny_config(cfg: DatasetConfig, factor: int = 16) -> DatasetConfig:
    """Shrink a dataset config for fast CPU tests (same voxel semantics)."""
    ws = tuple(
        max(4 * cfg.cube_size[i], (s // factor) // cfg.cube_size[i] * cfg.cube_size[i])
        for i, s in enumerate(cfg.world_size)
    )
    return dataclasses.replace(
        cfg,
        world_size=ws,
        image_size=(cfg.image_size[0] // 8, cfg.image_size[1] // 8),
        resize_size=(cfg.resize_size[0] // 8, cfg.resize_size[1] // 8),
        num_cam=2,
        num_frame=4,
    )
