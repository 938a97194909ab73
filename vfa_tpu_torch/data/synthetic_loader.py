"""Synthetic scene loader (port of `vfa_tpu/data/synthetic_loader.py`):
batches of procedurally generated scenes, so the train CLI runs with no
dataset on disk. Same seeds (`seed * 10_000 + i`) and batch keys as the
JAX package; arrays are numpy, the caller moves them to its device."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from vfa_tpu_torch.config import DatasetConfig
from vfa_tpu_torch.data.synthetic import make_scene
from vfa_tpu_torch.utils import pad_objects

_DIM_MEAN = np.array([145.0, 120.0, 255.0], np.float32)


class SyntheticSceneLoader:
    def __init__(self, cfg: DatasetConfig, num_frames: int = 16,
                 batch_size: int = 1, max_objects: int = 128, seed: int = 0,
                 num_objects: int = 6, augment=None,
                 process_id: int = 0, process_count: int = 1):
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_objects = max_objects
        self.augment = augment
        self._aug_rng = np.random.default_rng(seed + 777)
        self.dim_mean = _DIM_MEAN if cfg.mode == "3D" else None
        # multi-process: each process generates only its strided frame shard
        self.scenes = [
            make_scene(cfg, seed=seed * 10_000 + i, num_objects=num_objects)
            for i in range(process_id, num_frames, process_count)
        ]

    def __len__(self):
        return (len(self.scenes) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(0, len(self.scenes), self.batch_size):
            chunk = self.scenes[i:i + self.batch_size]
            objs = [pad_objects(s.objects, self.max_objects, self.cfg.mode)
                    for s in chunk]
            batch = {
                "index": np.arange(i, i + len(chunk)),
                "frame": np.arange(i, i + len(chunk)),
                "images": np.stack([
                    self.augment(s.images, self._aug_rng)
                    if self.augment is not None else s.images
                    for s in chunk]),
                "calibs": np.stack([s.calibs for s in chunk]),
                "grid": chunk[0].grid,
                "heatmap": np.stack([s.heatmap for s in chunk]),
                "location": np.stack([o["location"] for o in objs]),
                "valid": np.stack([o["valid"] for o in objs]),
                "objects": [s.objects for s in chunk],
            }
            if self.cfg.mode == "3D":
                batch["dimension"] = np.stack([o["dimension"] for o in objs])
                batch["rotation"] = np.stack([o["rotation"] for o in objs])
            yield batch
