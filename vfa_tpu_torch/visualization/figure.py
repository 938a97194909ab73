"""Matplotlib figures: BEV heatmaps, projected boxes, ground points (port
of `vfa_tpu/visualization/figure.py`).

Reference: `vfa/visualization/figure.py` (pred-vs-gt heatmaps `:16-44`,
projected 3D wireframes per camera `:46-83`, ground scatter `:85-149`).
matplotlib is imported lazily with the Agg backend, so headless runs work
and a machine without matplotlib imports this module; `matplotlib_available`
says whether a figure can be drawn. Inputs are numpy arrays (or tensors,
moved to the host).
"""

from __future__ import annotations

import numpy as np

from vfa_tpu_torch.config import DatasetConfig
from vfa_tpu_torch.geometry import worldgrid_to_worldcoord
from vfa_tpu_torch.utils import grid_rot180, to_numpy
from vfa_tpu_torch.visualization.bbox import (
    BOX_EDGES, compute_3d_box_corners, project_points,
)


def matplotlib_available() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def heatmap_figure(pred_heatmap, gt_heatmap=None):
    """Pred (and optionally gt) BEV heatmap, rotated 180 deg for display like
    the reference (`figure.py:16-44`)."""
    plt = _plt()
    ncols = 2 if gt_heatmap is not None else 1
    fig, axes = plt.subplots(1, ncols, figsize=(6 * ncols, 5), squeeze=False)
    axes[0][0].imshow(grid_rot180(to_numpy(pred_heatmap)))
    axes[0][0].set_title("pred heatmap")
    axes[0][0].axis("off")
    if gt_heatmap is not None:
        axes[0][1].imshow(grid_rot180(to_numpy(gt_heatmap)))
        axes[0][1].set_title("gt heatmap")
        axes[0][1].axis("off")
    return fig


def draw_boxes_on_camera(ax, image, calib, objects, cfg: DatasetConfig,
                         color="lime"):
    """Project 3D boxes (3D mode) or ground points (2D mode) into one view."""
    image = to_numpy(image)
    ax.imshow(np.clip(image, 0, 1))
    ax.axis("off")
    ih, iw = cfg.image_size
    rh = image.shape[0] / ih
    rw = image.shape[1] / iw
    calib = to_numpy(calib)
    for o in objects or []:
        loc_grid = to_numpy(o.location).reshape(-1)[:3].astype(np.float64)
        loc = np.asarray(worldgrid_to_worldcoord(
            loc_grid.astype(np.float32), cfg.name))
        if hasattr(o, "dimension") and o.dimension is not None:
            corners = compute_3d_box_corners(loc, o.dimension, o.rotation)
            px = project_points(corners, calib)
            px = px * np.array([rw, rh])
            for a, b in BOX_EDGES:
                ax.plot([px[a, 0], px[b, 0]], [px[a, 1], px[b, 1]],
                        color=color, linewidth=1)
        else:
            px = project_points(loc[None], calib) * np.array([rw, rh])
            ax.scatter(px[:, 0], px[:, 1], s=12, c=color, marker="x")


def prediction_figure(images, calibs, pred_heatmap, detections,
                      gt_objects, cfg: DatasetConfig):
    """One-page overview: BEV heatmap + every camera with gt (green) and
    predicted (red) boxes/points (`vfa/trainer.py:68-87` writes the same
    content to TensorBoard every vis_iter)."""
    plt = _plt()
    n = len(images)
    ncols = 3
    nrows = int(np.ceil((n + 1) / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(5 * ncols, 3.2 * nrows))
    axes = np.atleast_2d(axes)
    axes.flat[0].imshow(grid_rot180(to_numpy(pred_heatmap)))
    axes.flat[0].set_title("BEV heatmap")
    axes.flat[0].axis("off")
    for cam in range(n):
        ax = axes.flat[cam + 1]
        draw_boxes_on_camera(ax, images[cam], calibs[cam], gt_objects, cfg,
                             color="lime")
        draw_boxes_on_camera(ax, images[cam], calibs[cam], detections, cfg,
                             color="red")
        ax.set_title(f"C{cam + 1}")
    for k in range(n + 1, nrows * ncols):
        axes.flat[k].axis("off")
    fig.tight_layout()
    return fig


def save_prediction_figure(path, images, calibs, pred_heatmap, detections,
                           gt_objects, cfg: DatasetConfig):
    fig = prediction_figure(images, calibs, pred_heatmap, detections,
                            gt_objects, cfg)
    fig.savefig(path, dpi=110)
    _plt().close(fig)
