"""3D box wireframe helpers (port of `vfa_tpu/visualization/bbox.py`;
reference `vfa/visualization/bbox.py`). numpy only."""

from __future__ import annotations

import numpy as np

from vfa_tpu_torch.utils import to_numpy

# wireframe edges of the 8-corner box (bottom ring, top ring, verticals)
BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def compute_3d_box_corners(location, dimension, rotation) -> np.ndarray:
    """(8, 3) world-space corners of a z-up box.

    location: bottom-center (x, y, z); dimension: (h, w, l); rotation: yaw.
    Matches `bbox.py:23-51` conventions: l along x, w along y, h up.
    """
    x, y, z = to_numpy(location).reshape(-1)[:3]
    h, w, l = to_numpy(dimension).reshape(-1)[:3]
    rot = float(rotation)
    cx = np.array([-l / 2, l / 2, l / 2, -l / 2] * 2)
    cy = np.array([-w / 2, -w / 2, w / 2, w / 2] * 2)
    cz = np.array([0.0] * 4 + [h] * 4)
    c, s = np.cos(rot), np.sin(rot)
    rx = cx * c - cy * s
    ry = cx * s + cy * c
    return np.stack([rx + x, ry + y, cz + z], axis=-1)


def project_points(points: np.ndarray, calib: np.ndarray) -> np.ndarray:
    """(N, 3) world points -> (N, 2) pixels through a (3, 4) calib."""
    pts = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    h = pts @ np.asarray(calib).T
    return h[:, :2] / h[:, 2:3]
