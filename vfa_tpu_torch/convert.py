"""Weights into the port's model (port of `vfa_tpu/convert.py`).

The port's VFANet keeps the reference `.pth` key names, so a reference
checkpoint needs no layout change: `convert_state_dict` checks a reference
`model_state_dict` key by key under the JAX package's mapping rules
(`vfa_tpu/convert.py:80-141`: the same keys skipped, the same keys
accepted, unknown keys refused when strict, every shape checked) and
returns the model's state dict with those tensors in place, ready for
`load_state_dict(strict=True)`. `load_reference_checkpoint` does that for a
`.pth` file. `load_torchvision_resnet_params` is the reference's partial
load of torchvision ImageNet weights into the backbone
(`vfa_tpu/convert.py:153-185`); it takes a state dict (no download
anywhere), and `torchvision_resnet_path` names where a local copy is
looked for.

`params_from_jax` goes the other way from the JAX package's trees: it takes
the flax `params` and `batch_stats` trees as nested dicts of numpy arrays
(no JAX needed) and returns a state dict that
`VFANet.load_state_dict(..., strict=True)` accepts:
  conv   flax (kh, kw, I, O) -> torch (O, I, kh, kw)
  linear flax (I, O)         -> torch (O, I)
  GroupNorm / BatchNorm scale/bias -> weight/bias
  batch_stats mean/var -> running_mean/var (+ num_batches_tracked = 0)
"""

from __future__ import annotations

import os
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


# the reference modules the JAX mapping accepts outside the backbone, with
# their kind (`vfa_tpu/convert.py:28-47`): conv | norm (affine) | bn (affine
# and running statistics)
_HEAD_KINDS = {
    "fuse.0": "conv", "fuse.1": "bn", "fuse.3": "conv", "fuse.4": "bn",
    "map_classifier.0": "conv", "tytx_pred.0": "conv", "tytx_pred.1": "norm",
    "tytx_pred.3": "conv", "orient_pred.0": "conv", "thtwtl_pred.0": "conv",
    "thtwtl_pred.1": "norm", "thtwtl_pred.3": "conv", "lat8": "conv",
    "lat16": "conv", "lat32": "conv", "bn8": "norm", "bn16": "norm",
    "bn32": "norm",
}
# reference buffers with no counterpart (`vfa_tpu/convert.py:49-51`)
_SKIP = re.compile(
    r"(num_batches_tracked|z_corners|corners_offset|^mean$|^std$)"
)
TORCHVISION_FILES = {"resnet18": "resnet18-5c106cde.pth",
                     "resnet34": "resnet34-333f7ec4.pth"}


def _accepted(key: str) -> bool:
    """Whether the JAX mapping places `key`."""
    if key.startswith("base."):
        leaf = key.rsplit(".", 1)[1]
        return leaf in ("weight", "bias")
    if re.fullmatch(r"vfa(8|16|32)\.collapse\.(weight|bias)", key):
        return True
    if "." not in key:
        return False
    mod, leaf = key.rsplit(".", 1)
    kind = _HEAD_KINDS.get(mod)
    if kind is None:
        return False
    if leaf in ("weight", "bias"):
        return True
    return kind == "bn" and leaf in ("running_mean", "running_var")


def _tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def convert_state_dict(state_dict: Mapping, model_state: Mapping,
                       strict: bool = True) -> Dict[str, torch.Tensor]:
    """A reference VFA `model_state_dict` placed into a copy of the port
    model's `model_state` by name. Keys the JAX mapping skips are skipped;
    a key it does not map raises KeyError when `strict`, and every placed
    tensor must have the model's shape (it takes the model's dtype)."""
    out = {k: v.detach().clone() for k, v in model_state.items()}
    for key, val in state_dict.items():
        if _SKIP.search(key):
            continue
        v = _tensor(val)
        if not _accepted(key):
            if strict:
                raise KeyError(f"unmapped torch key: {key}")
            continue
        if key not in out:
            raise KeyError(f"missing param {key}")
        if tuple(out[key].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {key}: {tuple(out[key].shape)} "
                             f"vs {tuple(v.shape)}")
        out[key] = v.to(out[key].dtype).clone()
    return out


def load_reference_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference `.pth` (torch.save of {'model_state_dict': ...})
    into `model`, strictly. A reference checkpoint also stores its training
    args, so it is not a weights-only file."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    model.load_state_dict(convert_state_dict(sd, model.state_dict()), strict=True)
    return model


def load_torchvision_resnet_params(model: torch.nn.Module,
                                   state_dict: Mapping) -> torch.nn.Module:
    """Partial-load torchvision ImageNet weights into the model's backbone,
    like the reference (`resnet.py:151-180`): conv kernels map over; BN
    weight/bias land in the same-named GroupNorm affine; running stats and
    the fc head are dropped, and keys the backbone lacks (or whose shape
    differs) are skipped."""
    own = model.state_dict()
    new = {}
    for key, val in state_dict.items():
        if "num_batches_tracked" in key or "running_" in key or key.startswith("fc."):
            continue
        if key.rsplit(".", 1)[-1] not in ("weight", "bias"):
            continue
        name = f"base.{key}"
        v = _tensor(val)
        if name not in own or tuple(own[name].shape) != tuple(v.shape):
            continue
        new[name] = v.to(own[name].dtype)
    own.update(new)
    model.load_state_dict(own, strict=True)
    return model


def torchvision_resnet_path(base: str = "resnet18") -> str:
    """Where a local copy of torchvision's ImageNet weights for `base` is
    looked for: the file name torchvision downloads, under torch's hub
    cache (`torch.hub.get_dir()/checkpoints`). Nothing is downloaded."""
    return os.path.join(torch.hub.get_dir(), "checkpoints", TORCHVISION_FILES[base])


def load_torchvision_resnet_file(model: torch.nn.Module, base: str = "resnet18") -> str:
    """Read torchvision's weights for `base` from
    `torchvision_resnet_path(base)` and partial-load them into the model;
    returns the path. A missing file raises FileNotFoundError."""
    path = torchvision_resnet_path(base)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {base} ImageNet weights at {path}")
    load_torchvision_resnet_params(
        model, torch.load(path, map_location="cpu", weights_only=True))
    return path
