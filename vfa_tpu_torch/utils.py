"""Small shared utilities (port of `vfa_tpu/utils.py`)."""

from __future__ import annotations

from collections import defaultdict, namedtuple

import numpy as np

# for MultiviewC-style 3D detection (`vfa/utils.py:10-11`)
Obj3D = namedtuple("Obj3D", ["classname", "dimension", "location", "rotation", "conf"])
# for MultiviewX / Wildtrack 2D detection (`vfa/utils.py:13-14`)
Obj2D = namedtuple("Obj2D", ["classname", "location", "conf"])


class MetricDict(defaultdict):
    """Running means of scalar metrics (`vfa/utils.py:61-73`)."""

    def __init__(self):
        super().__init__(float)
        self.count = defaultdict(int)

    def __add__(self, other):
        for key, value in other.items():
            self[key] += value
            self.count[key] += 1
        return self

    @property
    def mean(self):
        return {key: self[key] / self.count[key] for key in self.keys()}


def pad_objects(objects, max_objects: int, mode: str):
    """Pad a list of Obj3D/Obj2D into fixed-shape arrays.

    Returns dict of np arrays: location (M,3), valid (M,), and for 3D mode
    dimension (M,3), rotation (M,). Invalid rows are zeros with valid=0.
    """
    objects = list(objects)[:max_objects]
    loc = np.zeros((max_objects, 3), np.float32)
    valid = np.zeros((max_objects,), np.float32)
    for i, o in enumerate(objects):
        loc[i] = np.asarray(o.location, np.float32).reshape(3)
        valid[i] = 1.0
    out = {"location": loc, "valid": valid}
    if mode == "3D":
        dim = np.zeros((max_objects, 3), np.float32)
        rot = np.zeros((max_objects,), np.float32)
        for i, o in enumerate(objects):
            dim[i] = np.asarray(o.dimension, np.float32).reshape(3)
            rot[i] = float(o.rotation)
        out["dimension"] = dim
        out["rotation"] = rot
    return out
