"""The work of a VFANet configuration, counted from its shapes: the model's
own operations and the sampling layer's least bytes, as the per-layer
metrics read them (`ctx["work"]` in a cell whose configuration names the
architecture "vfanet"). Whatever implements a layer (padded rig products,
a library call) does not change these counts.

Operations are 2 FLOPs a multiply-add of the model's convolutions and
linear layers: the backbone's, the laterals', fuse's and the heads'
convolutions, and the collapse Linear(256 * nl -> 256) over the (BEV cell,
camera) pairs that the calibrations make visible at each scale (a pair none
of whose voxels is visible collapses zeros). The sampling's gathers count
0. A training step counts 3 times the forward.
"""

from __future__ import annotations

import functools

import torch

from reference.vfanet import feature_shapes, voxel_geometry
from scene import grid_shape, make_calibrations, make_grid, num_layers
from work import bound_s, conv_flops  # noqa: F401  (the metrics read both here)

CH = 256          # lateral / BEV channels


def backbone_flops(resize_size, layers) -> int:
    """FLOPs of the ResNet-GN trunk on one image: the 7x7 stem, each block's
    two 3x3 convolutions and the 1x1 downsamples."""
    h, w = resize_size
    h, w = (h + 1) // 2, (w + 1) // 2
    total = conv_flops(3, 64, 7, h, w)
    h, w = (h + 1) // 2, (w + 1) // 2                   # max-pool
    cin = 64
    for stage, (cout, n) in enumerate(zip((64, 128, 256, 512), layers)):
        for b in range(n):
            if b == 0 and stage > 0:
                h, w = (h + 1) // 2, (w + 1) // 2
                total += conv_flops(cin, cout, 1, h, w)  # downsample
            total += conv_flops(cin if b == 0 else cout, cout, 3, h, w)
            total += conv_flops(cout, cout, 3, h, w)
        cin = cout
    return total


@functools.lru_cache(maxsize=None)
def _visible_pairs(key, device: str) -> tuple:
    """Visible (cell, camera) pairs at each scale, for a configuration
    given as a frozen key of its dataset group."""
    ds = dict(key)
    calibs = torch.as_tensor(make_calibrations(ds), device=device)
    grid = torch.as_tensor(make_grid(ds), device=device)
    nl = num_layers(ds)
    out = []
    for hw in feature_shapes(ds["resize_size"]):
        pairs = 0
        for n in range(calibs.shape[0]):
            vis = voxel_geometry(ds, calibs[n], grid, hw)[2].reshape(nl, -1)
            pairs += int(vis.any(0).sum())
        out.append(pairs)
    return tuple(out)


def visible_pairs(ds: dict, device="cpu") -> list:
    """Visible (cell, camera) pairs of each scale, worked out on `device`."""
    key = tuple((k, tuple(v) if isinstance(v, list) else v) for k, v in sorted(ds.items()))
    return list(_visible_pairs(key, str(device)))


def collapse_flops(ds: dict, device="cpu") -> int:
    """FLOPs of the collapse over one scene's visible pairs, all scales."""
    return sum(visible_pairs(ds, device)) * 2 * CH * num_layers(ds) * CH


def forward_flops(cfg: dict, device="cpu") -> int:
    """FLOPs of the model's forward on one scene."""
    ds, m = cfg["dataset"], cfg["model"]
    L, W = grid_shape(ds)
    total = ds["num_cam"] * backbone_flops(ds["resize_size"], m["resnet_layers"])
    for (h, w), cin in zip(feature_shapes(ds["resize_size"]), (128, 256, 512)):
        total += ds["num_cam"] * conv_flops(cin, CH, 1, h, w)
    total += collapse_flops(ds, device)
    total += 2 * conv_flops(CH, CH, 3, L, W)                       # fuse
    total += conv_flops(CH, 1, 3, L, W)                            # map_classifier
    total += conv_flops(CH, CH, 3, L, W) + conv_flops(CH, 2, 3, L, W)      # tytx
    if ds["mode"] == "3D":
        total += conv_flops(CH, CH, 3, L, W) + conv_flops(CH, 3, 3, L, W)  # thtwtl
        total += conv_flops(CH, m["angle_bins"], 3, L, W)                  # orient
    return total


def sampling_bytes(cfg: dict, batch: int, backward: bool) -> int:
    """The least bytes the sampling layer moves in one call of `batch`
    scenes, in the configuration's dtype: the laterals read once, the BEV
    features written once and the collapse weights read once; the backward
    also reads the BEV gradient and writes the laterals' and the weights'
    gradients once."""
    ds = cfg["dataset"]
    size = torch.empty((), dtype=getattr(torch, cfg["dtype"])).element_size()
    L, W = grid_shape(ds)
    lat = batch * ds["num_cam"] * CH * sum(h * w for h, w in feature_shapes(ds["resize_size"]))
    bev = batch * L * W * CH
    weights = 3 * (CH * num_layers(ds) * CH + CH)
    n = (2 * lat + bev + 2 * weights) if backward else (lat + bev + weights)
    return n * size


def sampling_flops(cfg: dict, batch: int, backward: bool, device="cpu") -> int:
    """The collapse's FLOPs in one call: the forward's, or the backward's
    two products (the input's and the weights' gradients)."""
    return batch * collapse_flops(cfg["dataset"], device) * (2 if backward else 1)
