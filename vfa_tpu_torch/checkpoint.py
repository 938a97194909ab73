"""Checkpoints with the reference's resume semantics (port of
`vfa_tpu/checkpoint.py`).

The reference saves `{epoch, model_state_dict, optimizer_state_dict,
scheduler_state_dict, args}` every 5 epochs (`train.py:168-198`), and its
checkpoints are self-describing (`evaluate.py:57-72` rebuilds the model
from the stored args). Here one `torch.save` per checkpoint,
`<savedir>/epoch_<NNNN>/state.pt`, holds the model's state dict (the fp32
master parameters and the BatchNorm statistics), the optimizer's (the SGD
momentum buffers), the OneCycle position (the optimizer steps taken), the
epoch and the meta (the dataset and train configs, as `_meta` of the JAX
package writes them, and `extra`, e.g. `dim_mean`); `meta.json` beside it
holds the same meta for readers without torch, and the file also keeps
the train loader's and the jitter's numpy generator states. Everything in the file is
tensors and plain containers, so it loads with `weights_only=True`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

from vfa_tpu_torch.config import DatasetConfig, TrainConfig

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def _meta(cfg: DatasetConfig, tcfg: TrainConfig, epoch: int, extra=None) -> dict:
    return {
        "dataset": dataclasses.asdict(cfg),
        "train": dataclasses.asdict(tcfg),
        "epoch": epoch,
        "extra": extra or {},
    }


def save_checkpoint(savedir: str, model: torch.nn.Module, optimizer,
                    cfg: DatasetConfig, tcfg: TrainConfig, epoch: int,
                    extra: Optional[dict] = None, rng: Optional[dict] = None) -> str:
    """Write `<savedir>/epoch_<epoch:04d>/` and return its path. `optimizer`
    is the train step's `ScheduledSGD` (its `count` is the OneCycle
    position) or None; `rng` maps names to numpy generator states
    (`Generator.bit_generator.state`), which a resumed run restores so that
    its shuffles and jitter draws continue the uninterrupted run's."""
    path = os.path.abspath(os.path.join(savedir, f"epoch_{epoch:04d}"))
    os.makedirs(path, exist_ok=True)
    meta = _meta(cfg, tcfg, epoch, extra)
    state = {
        "model": model.state_dict(),
        "optimizer": None if optimizer is None else optimizer.state_dict(),
        "step": None if optimizer is None else int(optimizer.count),
        "epoch": epoch,
        "rng": rng or {},
        # through JSON, so the file holds plain lists, numbers and strings
        "meta": json.loads(json.dumps(meta, default=str)),
    }
    tmp = os.path.join(path, f".{STATE_FILE}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return path


def _tupleize(d: dict, cls):
    """JSON turns tuples into lists; restore field types."""
    fields = {f.name: f.type for f in dataclasses.fields(cls)}
    out = {}
    for k, v in d.items():
        if k not in fields:
            continue
        out[k] = tuple(v) if isinstance(v, list) else v
    return cls(**out)


def load_meta(path: str) -> Tuple[DatasetConfig, TrainConfig, int, dict]:
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    cfg = _tupleize(meta["dataset"], DatasetConfig)
    tcfg = _tupleize(meta["train"], TrainConfig)
    return cfg, tcfg, meta["epoch"], meta.get("extra", {})


def load_state(path: str) -> dict:
    """The checkpoint's saved dict, tensors on the CPU (wherever they were
    saved from)."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str, model: torch.nn.Module, optimizer=None) -> int:
    """Load the checkpoint at `path` into `model` (strictly, by name) and,
    when given, into `optimizer` (momentum buffers and `count`, the
    OneCycle position); returns the saved epoch."""
    state = load_state(path)
    model.load_state_dict(state["model"], strict=True)
    if optimizer is not None:
        if state["optimizer"] is None:
            raise ValueError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(state["optimizer"])
        optimizer.count = int(state["step"])
    return int(state["epoch"])


def latest_checkpoint(savedir: str) -> Optional[str]:
    if not os.path.isdir(savedir):
        return None
    cands = sorted(
        d for d in os.listdir(savedir)
        if d.startswith("epoch_") and os.path.isdir(os.path.join(savedir, d))
    )
    return os.path.join(savedir, cands[-1]) if cands else None
