"""Shared CLI policy for the compiled camera rig (port of
`vfa_tpu/rig_cli.py`): the bucket counts, the `--rig_layout` flag and the
one place where a CLI builds its rig."""

from __future__ import annotations

import time

import numpy as np
import torch

from vfa_tpu_torch.config import DatasetConfig
from vfa_tpu_torch.geometry import make_grid
from vfa_tpu_torch.ops.rig import (
    CameraRig, build_rig, default_tile_v, pyramid_feat_shapes,
)

# copied from the JAX package's policy (`vfa_tpu/rig_cli.py:29-30`) so both
# packages sample through the same rig
INFERENCE_BUCKETS = 12
TRAIN_BUCKETS = 8


def add_rig_layout_arg(parser) -> None:
    parser.add_argument(
        "--rig_layout", type=str, default="window", choices=["window", "flat"],
        help="rig band layout (window: compact 2D image windows; flat: "
             "contiguous bands of the flattened features)")


def build_cli_rig(cfg: DatasetConfig, calibs: np.ndarray, device,
                  buckets: int = None, training: bool = False,
                  layout: str = "window") -> CameraRig:
    """The fp32 rig a CLI run samples through, built on the host and placed
    on `device`. `calibs` is one scene's (N, 3, 4) projection stack, valid
    for the whole run because calibrations are rig constants per dataset.
    `buckets` defaults to the training or inference policy."""
    if buckets is None:
        buckets = TRAIN_BUCKETS if training else INFERENCE_BUCKETS
    t0 = time.perf_counter()
    tile_v = default_tile_v(cfg.num_layers, torch.float32, layout)
    rig = build_rig(np.asarray(calibs), cfg,
                    make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
                    pyramid_feat_shapes(cfg.resize_size), tile_v=tile_v,
                    dtype=torch.float32, band_buckets=buckets,
                    layout=layout, device=device)
    a_bytes = sum(a.numel() * a.element_size() for s in rig.scales for a in s.A)
    print(f"compiled rig: {buckets} buckets, tile_v {tile_v}, fp32, {layout} "
          f"layout, A {a_bytes / 1e9:.3f} GB, built in "
          f"{time.perf_counter() - t0:.1f} s")
    return rig
