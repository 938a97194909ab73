"""Inputs of a cell, made from its seed: the cameras, the BEV grid, the
scenes' objects and ground-truth heatmaps (numpy, on the host) and the
images (uint8, on the card, one call).

A frozen copy of the synthetic-scene generator of the upstream VFA port
(cameras on a ring around the world grid looking at its centre, pinhole
intrinsics at the dataset's image size, random objects away from the grid's
borders, a Gaussian bump heatmap), so that the yardstick does not move
when the program's own generator does. Every function takes the
configuration's `dataset` group (`configs/<config>.json`).
"""

from __future__ import annotations

import numpy as np
import torch


def grid_shape(ds) -> tuple:
    """(L, W) of the BEV grid. Wildtrack swaps the world axes."""
    length, width = ds["world_size"][::-1] if ds["name"] == "Wildtrack" else ds["world_size"]
    n_x = width // ds["cube_size"][0]
    n_y = length // ds["cube_size"][1]
    return (n_x, n_y) if ds["name"] == "Wildtrack" else (n_y, n_x)


def num_layers(ds) -> int:
    return len(range(0, ds["grid_h"], ds["cube_size"][2]))


def make_grid(ds) -> np.ndarray:
    """(L, W, 3) world-grid coordinates of the ground plane."""
    if ds["name"] == "Wildtrack":
        length, width = ds["world_size"][::-1]
    else:
        length, width = ds["world_size"]
    xs = np.arange(0.0, width, ds["cube_size"][0], dtype=np.float32)
    ys = np.arange(0.0, length, ds["cube_size"][1], dtype=np.float32)
    if ds["name"] == "Wildtrack":
        xx, yy = np.meshgrid(xs, ys, indexing="ij")
    else:
        yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([xx, yy, np.zeros_like(xx)], axis=-1)


def world_coords(points, dataset: str):
    """World-grid coordinates (..., 3) to world coordinates (numpy or torch)."""
    if dataset == "MultiviewC":
        return points
    if dataset == "MultiviewX":
        return points / 40.0
    if dataset == "Wildtrack":
        if isinstance(points, torch.Tensor):
            shift = torch.tensor([-300.0, -900.0, 0.0], dtype=points.dtype,
                                 device=points.device)
        else:
            shift = np.asarray([-300.0, -900.0, 0.0], dtype=points.dtype)
        return points * 2.5 + shift
    raise ValueError(f"unknown dataset {dataset}")


def _look_at(cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    z = target - cam_pos
    z = z / np.linalg.norm(z)
    x = np.cross(z, np.array([0.0, 0.0, -1.0]))
    x = x / np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z], axis=0)
    return np.hstack([R, (-R @ cam_pos)[:, None]])


def make_calibrations(ds) -> np.ndarray:
    """(N, 3, 4) float32 camera matrices K @ [R|t] of a ring of N cameras
    around the grid's centre, raised to 0.45 of its extent."""
    grid = make_grid(ds)
    wc = world_coords(np.stack([grid[0, 0], grid[-1, -1]]).astype(np.float32), ds["name"])
    center, extent = wc.mean(axis=0), np.abs(wc[1] - wc[0]).max()
    ih, iw = ds["image_size"]
    f = 0.9 * iw
    K = np.array([[f, 0, iw / 2.0], [0, f, ih / 2.0], [0, 0, 1.0]])
    out = []
    n = ds["num_cam"]
    for i in range(n):
        ang = 2.0 * np.pi * i / n
        pos = center + np.array([1.1 * extent * np.cos(ang),
                                 1.1 * extent * np.sin(ang), 0.45 * extent])
        out.append(K @ _look_at(pos, center))
    return np.stack(out).astype(np.float32)


def make_objects(ds, count: int, rng: np.random.Generator) -> list:
    """`count` objects as dicts: location (3,) in world-grid units and, in
    3D mode, dimension (3,) and rotation (radians)."""
    ws = np.asarray(ds["world_size"], np.float64)
    objs = []
    for _ in range(count):
        xy = rng.uniform(0.1, 0.9, size=2) * ws
        o = {"location": np.array([xy[0], xy[1], 0.0])}
        if ds["mode"] == "3D":
            o["dimension"] = rng.uniform([120, 100, 220], [170, 140, 290])
            o["rotation"] = rng.uniform(-np.pi, np.pi)
        objs.append(o)
    return objs


def object_rc(ds, location) -> tuple:
    """Continuous (row, col) of a location on the BEV grid."""
    cx, cy = np.asarray(location)[:2] / np.asarray(ds["world_size"], np.float64) \
        * np.asarray(grid_shape(ds), np.float64)
    return (cx, cy) if ds["name"] == "Wildtrack" else (cy, cx)


def make_heatmap(ds, objects, sigma: float = 2.0) -> np.ndarray:
    """(L, W) float32 Gaussian bumps, 1 at each object's cell."""
    L, W = grid_shape(ds)
    hm = np.zeros((L, W), np.float32)
    yy, xx = np.mgrid[0:L, 0:W]
    for o in objects:
        r, c = object_rc(ds, o["location"])
        hm = np.maximum(hm, np.exp(-((yy - r) ** 2 + (xx - c) ** 2) / (2 * sigma ** 2)))
        if 0 <= int(r) < L and 0 <= int(c) < W:
            hm[int(r), int(c)] = 1.0
    return hm


def pad_objects(ds, objects, max_objects: int) -> dict:
    """Fixed-shape arrays of a scene's objects: location (M, 3), valid
    (M,) and, in 3D mode, dimension (M, 3), rotation (M,)."""
    M = max_objects
    out = {"location": np.zeros((M, 3), np.float32), "valid": np.zeros((M,), np.float32)}
    if ds["mode"] == "3D":
        out["dimension"] = np.zeros((M, 3), np.float32)
        out["rotation"] = np.zeros((M,), np.float32)
    for i, o in enumerate(objects[:M]):
        out["location"][i] = o["location"]
        out["valid"][i] = 1.0
        if ds["mode"] == "3D":
            out["dimension"][i] = o["dimension"]
            out["rotation"][i] = o["rotation"]
    return out


def sub_seeds(seed: int, count: int) -> list:
    """`count` independent 63-bit seeds drawn from `seed` (any whole number)."""
    words = np.random.SeedSequence(abs(int(seed))).generate_state(2 * count, np.uint32)
    return [int(words[2 * i]) << 31 ^ int(words[2 * i + 1]) for i in range(count)]


class Scenes:
    """A pool of `count` scenes of one configuration made from `seed`:
    `images` (count, N, H, W, 3) uint8 on `device` (one call of a seeded
    generator there), `targets` the stacked ground truth (heatmap (count,
    L, W), the padded objects) as host arrays, `calibs` (N, 3, 4) and
    `grid` (L, W, 3)."""

    def __init__(self, ds, seed: int, count: int, device, objects: int = 6,
                 max_objects: int = 16):
        img_seed, obj_seed = sub_seeds(seed, 2)
        H, W = ds["resize_size"]
        g = torch.Generator(device=device).manual_seed(img_seed)
        self.images = torch.randint(0, 256, (count, ds["num_cam"], H, W, 3),
                                    dtype=torch.uint8, generator=g, device=device)
        self.calibs = make_calibrations(ds)
        self.grid = make_grid(ds)
        rngs = [np.random.default_rng([obj_seed, k]) for k in range(count)]
        objs = [make_objects(ds, objects, r) for r in rngs]
        padded = [pad_objects(ds, o, max_objects) for o in objs]
        self.targets = {"heatmap": np.stack([make_heatmap(ds, o) for o in objs])}
        for key in padded[0]:
            self.targets[key] = np.stack([p[key] for p in padded])

    def __len__(self) -> int:
        return self.images.shape[0]

    def floats(self, idx, dtype=torch.float32) -> torch.Tensor:
        """Scenes `idx` (a list or slice) as [0, 1] images in `dtype`, on
        the images' device: x * (1/255) in fp32, then the cast."""
        return (self.images[idx].to(torch.float32) * (1.0 / 255.0)).to(dtype)

    def batch(self, idx, device) -> dict:
        """The ground truth of scenes `idx` as tensors on `device`."""
        return {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(device)
                for k, v in self.targets.items()}
