"""The work of an MVDet configuration, counted from its shapes, as the
per-layer metrics read it (`ctx["work"]` in a cell whose configuration
names the architecture "mvdet"). Whatever implements a layer does not
change these counts.

Operations are 2 FLOPs a multiply-add of the model's convolutions: the
dilated trunk's on each camera's image, the image head's on each camera's
upsampled map and the map head's on the grid. The upsampling, the warp and
the decode count 0. The projection's least bytes: the trunk's /8 features
read once and the world features (every camera's warped map and the
coordinate map) written once, in the configuration's dtype.
"""

from __future__ import annotations

import torch

from scene import grid_shape
from work import bound_s, conv_flops  # noqa: F401  (the metrics read both here)

FEATURES = 512


def _half(n: int) -> int:
    return (n + 1) // 2


def trunk_shape(resize_size) -> tuple:
    """(h, w) of the /8 features: the stem's stride 2, the max-pool's and
    stage 2's; stages 3 and 4 dilate instead."""
    h, w = resize_size
    for _ in range(3):
        h, w = _half(h), _half(w)
    return h, w


def trunk_flops(cfg: dict) -> int:
    """FLOPs of the trunk on one scene: every camera's image through the
    7x7 stem, each block's two 3x3 convolutions and the 1x1 downsamples
    (stages 3 and 4 at /8: their dilation adds none)."""
    ds, m = cfg["dataset"], cfg["model"]
    h, w = _half(ds["resize_size"][0]), _half(ds["resize_size"][1])
    total = conv_flops(3, 64, 7, h, w)
    h, w = _half(h), _half(w)                                  # max-pool
    cin = 64
    for stage, (cout, n) in enumerate(zip((64, 128, 256, 512), m["resnet_layers"])):
        if stage == 1:
            h, w = _half(h), _half(w)                          # stage 2's stride
        if cin != cout:
            total += conv_flops(cin, cout, 1, h, w)            # downsample
        for b in range(n):
            total += conv_flops(cin if b == 0 else cout, cout, 3, h, w)
            total += conv_flops(cout, cout, 3, h, w)
        cin = cout
    return ds["num_cam"] * total


def map_shape(cfg: dict) -> tuple:
    """(h, w) of the upsampled maps: the calibration's image over img_reduce."""
    return tuple(int(s / cfg["model"]["img_reduce"]) for s in cfg["dataset"]["image_size"])


def head_flops(cfg: dict) -> int:
    """FLOPs of both classifiers on one scene."""
    ds = cfg["dataset"]
    h, w = map_shape(cfg)
    L, W = grid_shape(ds)
    img = ds["num_cam"] * (conv_flops(FEATURES, 64, 1, h, w) + conv_flops(64, 2, 1, h, w))
    cin = FEATURES * ds["num_cam"] + 2
    return img + (conv_flops(cin, 512, 3, L, W) + conv_flops(512, 512, 3, L, W)
                  + conv_flops(512, 1, 3, L, W))


def forward_flops(cfg: dict, device="cpu") -> int:
    """FLOPs of the model's forward on one scene."""
    return trunk_flops(cfg) + head_flops(cfg)


def projection_bytes(cfg: dict) -> int:
    """The projection's least bytes on one scene (module docstring)."""
    ds = cfg["dataset"]
    size = torch.empty((), dtype=getattr(torch, cfg["dtype"])).element_size()
    h, w = trunk_shape(ds["resize_size"])
    L, W = grid_shape(ds)
    return size * (ds["num_cam"] * FEATURES * h * w + (ds["num_cam"] * FEATURES + 2) * L * W)
