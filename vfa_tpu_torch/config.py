"""Dataset and training configuration (port of `vfa_tpu/config.py`).

The three per-dataset configs and `TrainConfig` keep the reference's field names
(`vfa/config.py:5-90`); all are frozen dataclasses.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """Static per-dataset geometry + recipe constants."""

    name: str
    mode: str                       # '3D' or '2D'
    root: str                       # dataset root on disk
    world_size: Tuple[int, int]     # (rows, cols) of the world grid, dataset units
    image_size: Tuple[int, int]     # (H, W) used for projection normalization
    resize_size: Tuple[int, int]    # (H, W) images are resized to before the CNN
    ann: str                        # annotation subdirectory
    calib: str                      # calibration subdirectory
    grid_h: int                     # height of the voxel grid (dataset units)
    cube_size: Tuple[int, int, int]  # (L, W, H) of one voxel cube
    loss_weight: Tuple[float, ...]  # per-loss weights (4 for 3D, 2 for 2D)
    grid_scale: float               # worldgrid -> worldcoord divisor
    num_cam: int
    num_frame: int

    @property
    def grid_shape(self) -> Tuple[int, int]:
        """(L, W) of the BEV grid; matches `geometry.make_grid`.
        Wildtrack swaps the world_size axes (`vfa/utils.py:16-37`)."""
        if self.name == "Wildtrack":
            length, width = self.world_size[::-1]
        else:
            length, width = self.world_size
        n_x = width // self.cube_size[0]
        n_y = length // self.cube_size[1]
        if self.name == "Wildtrack":
            return (n_x, n_y)
        return (n_y, n_x)

    @property
    def num_layers(self) -> int:
        """Number of z layers of the voxel grid (`vfa/model/vfa_op.py:50-52`)."""
        return len(range(0, self.grid_h, self.cube_size[2]))

    @property
    def reduced_grid_size(self) -> Tuple[int, int]:
        """Grid size of the precomputed gt heatmaps."""
        return (
            self.world_size[0] // self.cube_size[0],
            self.world_size[1] // self.cube_size[1],
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-recipe flags (reference `train.py:21-138` defaults)."""

    epochs: int = 40
    batch_size: int = 1
    lr: float = 0.02
    weight_decay: float = 5e-4
    momentum: float = 0.5
    angle_range: int = 360
    pretrained: bool = True
    heatmap: str = "GK"          # 'GK' or 'RGK' gt heatmap flavor
    seed: int = 1
    savedir: str = "experiments"
    print_iter: int = 1
    vis_iter: int = 50
    cls_thresh: float = 0.8
    topk: int = 50
    base: str = "resnet18"
    # Reference quirk: OneCycleLR is configured with steps_per_epoch*epochs
    # total steps but stepped once per epoch (`train.py:257-258,274`), so the
    # LR trajectory only traverses the first `epochs` steps of the cycle.
    # True replicates that behavior; False steps per iteration as configured.
    scheduler_step_per_epoch: bool = True
    # Reference quirk: torch OneCycleLR defaults to cycle_momentum=True and
    # overwrites SGD's configured momentum (0.5) with a 0.95->0.85->0.95
    # cosine cycle every scheduler step (`train.py:256-258`). True replicates
    # that (the `momentum` field is then inert, as in the reference); False
    # uses the constant `momentum` value.
    cycle_momentum: bool = True
    # Numerics: 'float32', or 'bfloat16' (accepted here, refused by the
    # train step until the bf16 kernels are ported).
    compute_dtype: str = "float32"


MC_OPTS = DatasetConfig(
    name="MultiviewC",
    mode="3D",
    root="data/MultiviewC",
    world_size=(3900, 3900),
    image_size=(720, 1280),
    resize_size=(720, 1280),
    ann="annotations",
    calib="calibrations",
    grid_h=160,
    cube_size=(25, 25, 32),
    loss_weight=(1.0, 1.0, 1.0, 1.0),
    grid_scale=1.0,
    num_cam=7,
    num_frame=560,
)

MX_OPTS = DatasetConfig(
    name="MultiviewX",
    mode="2D",
    root="data/MultiviewX",
    world_size=(640, 1000),
    image_size=(1080, 1920),
    resize_size=(720, 1280),
    ann="annotations_positions",
    calib="calibrations",
    grid_h=64,
    cube_size=(4, 4, 8),
    loss_weight=(5.0, 1.0),
    grid_scale=40.0,
    num_cam=6,
    num_frame=400,
)

WT_OPTS = DatasetConfig(
    name="Wildtrack",
    mode="2D",
    root="data/Wildtrack",
    world_size=(480, 1440),
    image_size=(1080, 1920),
    resize_size=(720, 1280),
    ann="annotations_positions",
    calib="calibrations",
    grid_h=32,
    cube_size=(4, 4, 4),
    loss_weight=(5.0, 1.0),
    grid_scale=1.0,
    num_cam=7,
    num_frame=2000,
)

mc_opts = MC_OPTS
mx_opts = MX_OPTS
wt_opts = WT_OPTS

CONFIGS = {"MultiviewC": mc_opts, "MultiviewX": mx_opts, "Wildtrack": wt_opts}


def get_config(name: str) -> DatasetConfig:
    if name not in CONFIGS:
        raise ValueError(
            f"Dataset error, expect `MultiviewC`, `MultiviewX`, `Wildtrack`, got {name}."
        )
    return CONFIGS[name]
