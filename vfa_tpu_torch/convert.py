"""JAX parameter trees -> the port's state dict (inverse of
`vfa_tpu/convert.py::convert_state_dict`).

Takes the flax `params` and `batch_stats` trees as nested dicts of numpy
arrays (no JAX needed) and returns a state dict that
`VFANet.load_state_dict(..., strict=True)` accepts:
  conv   flax (kh, kw, I, O) -> torch (O, I, kh, kw)
  linear flax (I, O)         -> torch (O, I)
  GroupNorm / BatchNorm scale/bias -> weight/bias
  batch_stats mean/var -> running_mean/var (+ num_batches_tracked = 0)
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _module_name(scope: str) -> str:
    """flax scope -> torch module path: 'layer2_1' -> 'layer2.1',
    'downsample_0' -> 'downsample.0', 'fuse_3' -> 'fuse.3',
    'map_classifier_0' -> 'map_classifier.0'; 'lat8' stays."""
    return re.sub(r"_(\d+)$", r".\1", scope)


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def params_from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params):
        m = re.fullmatch(r"vfa(8|16|32)_collapse_(kernel|bias)", path[0])
        if m:
            s, leaf = m.groups()
            sd[f"vfa{s}.collapse.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                torch.from_numpy(np.ascontiguousarray(v.T if leaf == "kernel" else v)))
            continue
        mod = ".".join(_module_name(p) for p in path[:-1])
        leaf = path[-1]
        if leaf == "kernel" and v.ndim == 4:
            sd[f"{mod}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.transpose(v, (3, 2, 0, 1))))
        elif leaf in ("kernel", "scale"):
            sd[f"{mod}.weight"] = torch.from_numpy(np.ascontiguousarray(v))
        elif leaf == "bias":
            sd[f"{mod}.bias"] = torch.from_numpy(np.ascontiguousarray(v))
        else:
            raise KeyError(f"unmapped JAX param {'/'.join(path)}")
    for path, v in _flatten(batch_stats):
        mod = ".".join(_module_name(p) for p in path[:-1])
        names = {"mean": "running_mean", "var": "running_var"}
        if path[-1] not in names:
            raise KeyError(f"unmapped JAX batch stat {'/'.join(path)}")
        sd[f"{mod}.{names[path[-1]]}"] = torch.from_numpy(np.ascontiguousarray(v))
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def named_jax_leaves(params: Mapping, batch_stats: Mapping = None) -> Dict[str, np.ndarray]:
    """A JAX params (and batch_stats) tree laid out under the port's names
    and layouts, as numpy arrays: what the model's `named_parameters()` and
    BatchNorm running buffers are compared with after a train step."""
    return {k: v.numpy() for k, v in
            params_from_jax(params, batch_stats or {}).items()
            if not k.endswith("num_batches_tracked")}
