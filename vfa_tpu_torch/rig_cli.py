"""Shared CLI policy for the compiled camera rig (port of
`vfa_tpu/rig_cli.py`): the bucket counts, the `--rig_layout` flag, the rig
disk cache and the one place where a CLI builds its rig."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from vfa_tpu_torch.config import DatasetConfig
from vfa_tpu_torch.geometry import make_grid
from vfa_tpu_torch.ops.rig import (
    CameraRig, build_rig, default_tile_v, pyramid_feat_shapes, rig_cache_path,
)

# copied from the JAX package's policy (`vfa_tpu/rig_cli.py:29-30`) so both
# packages sample through the same rig
INFERENCE_BUCKETS = 12
TRAIN_BUCKETS = 8
# where the port's CLIs and bench cache their rigs (the JAX CLIs use
# ~/.cache/vfa_tpu_rig; the two keys differ, so the directories do too)
RIG_CACHE_DIR = "~/.cache/vfa_tpu_torch_rig"


def add_rig_layout_arg(parser) -> None:
    parser.add_argument(
        "--rig_layout", type=str, default="window", choices=["window", "flat"],
        help="rig band layout (window: compact 2D image windows; flat: "
             "contiguous bands of the flattened features)")


def build_cli_rig(cfg: DatasetConfig, calibs: np.ndarray, device,
                  buckets: int = None, training: bool = False,
                  layout: str = "window", cache_dir: str = None,
                  dtype=torch.float32) -> CameraRig:
    """The rig a CLI run samples through, built on the host (or loaded from
    `cache_dir`, see `ops.rig.build_rig`) and placed on `device`. `calibs`
    is one scene's (N, 3, 4) projection stack, valid for the whole run
    because calibrations are rig constants per dataset. `buckets` defaults
    to the training or inference policy. `dtype` is the feature compute
    dtype: tile_v and A's dtype both follow it, as in
    `vfa_tpu/rig_cli.py:74-105`, and the cache key carries it."""
    if buckets is None:
        buckets = TRAIN_BUCKETS if training else INFERENCE_BUCKETS
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rig dtype must be float32 or bfloat16, got {dtype}")
    t0 = time.perf_counter()
    tile_v = default_tile_v(cfg.num_layers, dtype, layout)
    grid = make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name)
    shapes = pyramid_feat_shapes(cfg.resize_size)
    keyed = dict(tile_v=tile_v, dtype=dtype, crange=(-1.0, 0.95),
                 fold_prefix=True, band_buckets=buckets, layout=layout)
    hit = False
    if cache_dir is not None:
        cache_dir = os.path.expanduser(cache_dir)
        hit = os.path.exists(rig_cache_path(cache_dir, np.asarray(calibs), cfg,
                                            grid, shapes, **keyed))
    rig = build_rig(np.asarray(calibs), cfg, grid, shapes, device=device,
                    cache_dir=cache_dir, **keyed)
    a_bytes = sum(a.numel() * a.element_size() for s in rig.scales for a in s.A)
    how = "cache hit" if hit else "built"
    name = "bf16" if dtype == torch.bfloat16 else "fp32"
    print(f"compiled rig: {buckets} buckets, tile_v {tile_v}, {name}, {layout} "
          f"layout, A {a_bytes / 1e9:.3f} GB, {how} in "
          f"{time.perf_counter() - t0:.1f} s")
    return rig
