"""Shared CLI policy for the compiled camera rig (port of
`vfa_tpu/rig_cli.py`): the bucket counts and the one place where a CLI
builds its rig."""

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


def build_cli_rig(cfg: DatasetConfig, calibs: np.ndarray, device,
                  buckets: int = None, training: bool = False) -> CameraRig:
    """The fp32 window rig a CLI run samples through, built on the host and
    placed on `device`. `calibs` is one scene's (N, 3, 4) projection stack,
    valid for the whole run because calibrations are rig constants per
    dataset. `buckets` defaults to the training or inference policy."""
    if buckets is None:
        buckets = TRAIN_BUCKETS if training else INFERENCE_BUCKETS
    t0 = time.perf_counter()
    tile_v = default_tile_v(cfg.num_layers, torch.float32)
    rig = build_rig(np.asarray(calibs), cfg,
                    make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
                    pyramid_feat_shapes(cfg.resize_size), tile_v=tile_v,
                    dtype=torch.float32, band_buckets=buckets,
                    layout="window", device=device)
    print(f"compiled rig: {buckets} buckets, tile_v {tile_v}, fp32, built in "
          f"{time.perf_counter() - t0:.1f} s")
    return rig
