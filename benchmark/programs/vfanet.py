"""The adapter of the port's VFANet (`vfa_tpu_torch.model.vfanet`), the
architecture `"vfanet"` (`program.py` names the functions every adapter
gives). It builds the port's model from a state dict the benchmark made,
the port's compiled rig through its own set-up (`rig_cli.build_cli_rig`)
with the benchmark's cache directory, and returns the calls that a cell's
traffic times.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch


def dataset_config(ds: dict):
    """The port's DatasetConfig of a configuration's `dataset` group."""
    from vfa_tpu_torch.config import DatasetConfig

    return DatasetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in ds.items()})


def _model(cfg: dict, state: dict, device):
    """The port's VFANet at its defaults (no memory option, the stem
    unfused), loaded strictly from `state`."""
    from vfa_tpu_torch.model.vfanet import VFANet

    m = cfg["model"]
    # the port takes VFA_FUSED_STEM from the environment over its default
    os.environ["VFA_FUSED_STEM"] = "0"
    model = VFANet(dataset_config(cfg["dataset"]), base=m["base"],
                   angle_range=m["angle_bins"], rig_impl="cuda")
    model.load_state_dict(state, strict=True)
    return model.to(device)


def prepare(cfg: dict, calibs, device, train: bool, cache_dir: str):
    """The port's rig for this configuration (train: the training bucket
    policy), built on the host or loaded from `cache_dir`; its log line
    goes to stderr."""
    from vfa_tpu_torch.rig_cli import build_cli_rig

    rig = cfg["rig"]
    with contextlib.redirect_stdout(sys.stderr):
        return build_cli_rig(dataset_config(cfg["dataset"]), calibs, device,
                             buckets=rig["train_buckets" if train else "serve_buckets"],
                             training=train, layout=rig["layout"], cache_dir=cache_dir,
                             dtype=getattr(torch, cfg["dtype"]))


def server(cfg: dict, state: dict, rig, device, calibs, grid):
    """serve(images) -> (predictions, detections), both on the device: the
    port's model cast to the configuration's dtype (every floating
    parameter and buffer, `cast_model`) in eval mode, then the port's
    decode of the fp32 predictions."""
    from vfa_tpu_torch.codec import decode_frame
    from vfa_tpu_torch.model.vfanet import cast_model

    model = cast_model(_model(cfg, state, device), getattr(torch, cfg["dtype"])).eval()
    dcfg = dataset_config(cfg["dataset"])
    dec = cfg["decode"]
    dim_mean = cfg["model"]["dim_mean"] if dcfg.mode == "3D" else None

    @torch.no_grad()
    def serve(images):
        pred = model(images, rig, calibs, grid)
        det = decode_frame({k: v.float() for k, v in pred.items()}, dcfg,
                           cls_thresh=dec["cls_thresh"], topk=dec["topk"], dim_mean=dim_mean)
        return pred, det

    serve.model = model
    return serve


def trainer(cfg: dict, state: dict, device):
    """(step, model, optimizer): the port's training step
    (`train_lib.make_train_step`) over a model with fp32 master parameters
    and the port's SGD under OneCycle; the configuration's dtype is the
    compute dtype (bfloat16: mixed precision)."""
    from vfa_tpu_torch.config import TrainConfig
    from vfa_tpu_torch.train_lib import make_optimizer, make_train_step

    model = _model(cfg, state, device)
    dcfg = dataset_config(cfg["dataset"])
    t = cfg["train"]
    tcfg = TrainConfig(epochs=t["epochs"], lr=t["lr"], weight_decay=t["weight_decay"],
                       angle_range=cfg["model"]["angle_bins"], pretrained=False,
                       compute_dtype=cfg["dtype"])
    opt = make_optimizer(model, tcfg, t["steps_per_epoch"])
    dim_mean = cfg["model"]["dim_mean"] if dcfg.mode == "3D" else None
    step = make_train_step(model, opt, dcfg, tcfg, dim_mean=dim_mean)
    return step, model, opt


def clock_points(model) -> dict:
    """The modules the layer clock stamps (`devtrace.LayerClock`): the
    backbone `base`, its first convolution (whose weight's gradient is the
    backbone backward's last), the laterals' norms and `fuse`, the first
    module after the rig sampling."""
    return {"backbone": model.base, "backbone_first": model.base.conv1,
            "laterals": [getattr(model, f"bn{s}") for s in (8, 16, 32)],
            "bev_head": model.fuse}
