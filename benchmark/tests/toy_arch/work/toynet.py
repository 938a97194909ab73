"""The toy architecture's work: its two convolutions' FLOPs a scene."""

from __future__ import annotations

from scene import grid_shape
from work import bound_s, conv_flops  # noqa: F401


def forward_flops(cfg: dict, device="cpu") -> int:
    ds, c = cfg["dataset"], cfg["model"]["channels"]
    L, W = grid_shape(ds)
    return ds["num_cam"] * conv_flops(3, c, 1, *ds["resize_size"]) + conv_flops(c, 1, 3, L, W)
