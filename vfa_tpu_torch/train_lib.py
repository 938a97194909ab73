"""Training library (port of `vfa_tpu/train_lib.py`): schedules, the SGD
update, target encoding and the train / eval steps.

Reference recipe (`train.py:256-258`): SGD lr=0.02 momentum=0.5 wd=5e-4
with OneCycleLR. The reference configures OneCycleLR with
steps_per_epoch*epochs total steps but calls scheduler.step() once per
EPOCH, so training only traverses the first `epochs` steps of the cycle;
`TrainConfig.scheduler_step_per_epoch=True` (default) replicates that,
False steps per iteration as the configuration implies.

The steps are plain functions over an `nn.Module`, an optimizer and a dict
batch of tensors on the model's device. Losses are computed in fp32.
bf16 compute (fp32 master parameters, bf16 at use) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch import nn

from vfa_tpu_torch.codec import encode_frame, gaussian_csl_labels, object_cells
from vfa_tpu_torch.config import DatasetConfig, TrainConfig
from vfa_tpu_torch.losses import compute_loss2d, compute_loss3d

OBJECT_KEYS = ("location", "valid", "dimension", "rotation")


def _cos(a: float, b: float, pct: float) -> float:
    return b + (a - b) / 2.0 * (1.0 + math.cos(math.pi * pct))


def _onecycle(total: int, first: float, peak: float, last: float,
              ) -> Callable[[int], float]:
    """torch OneCycleLR's two cosine phases (pct_start 0.3) over `total`
    steps: first -> peak up to step 0.3*total - 1, then peak -> last."""
    up = 0.3 * total - 1.0          # last index of the warmup phase
    down = (total - 1.0) - up

    def clip01(x: float) -> float:
        return min(max(x, 0.0), 1.0)

    def schedule(count: int) -> float:
        s = float(count)
        if s <= up:
            return _cos(first, peak, clip01(s / up))
        return _cos(peak, last, clip01((s - up) / down))

    return schedule


def onecycle_schedule(tcfg: TrainConfig, steps_per_epoch: int):
    """torch OneCycleLR's learning-rate curve with its defaults (cos
    anneal, div_factor 25, final_div_factor 1e4) over
    steps_per_epoch*epochs steps, with torch's own milestones."""
    initial = tcfg.lr / 25.0
    return _onecycle(steps_per_epoch * tcfg.epochs, initial, tcfg.lr,
                     initial / 1e4)


def momentum_schedule(tcfg: TrainConfig, steps_per_epoch: int,
                      base_momentum: float = 0.85, max_momentum: float = 0.95):
    """torch OneCycleLR's momentum cycle: 0.95 down to 0.85 during warmup
    and back. The reference passes momentum=0.5 to SGD, but OneCycleLR
    (cycle_momentum=True by default) overrides it every scheduler step;
    replicated when tcfg.cycle_momentum, else the constant tcfg.momentum."""
    if not tcfg.cycle_momentum:
        return lambda count: float(tcfg.momentum)
    return _onecycle(steps_per_epoch * tcfg.epochs, max_momentum,
                     base_momentum, max_momentum)


def sched_step(tcfg: TrainConfig, steps_per_epoch: int, count: int) -> int:
    """Scheduler step of optimizer step `count`: the epoch index + 1 under
    the per-epoch quirk (the scheduler is stepped once before each epoch),
    else the iteration count."""
    if tcfg.scheduler_step_per_epoch:
        return count // steps_per_epoch + 1
    return count


def current_lr(tcfg: TrainConfig, steps_per_epoch: int, step: int) -> float:
    return onecycle_schedule(tcfg, steps_per_epoch)(
        sched_step(tcfg, steps_per_epoch, step))


class ScheduledSGD(torch.optim.SGD):
    """torch SGD with weight decay whose lr and momentum follow the
    OneCycle schedules: g = grad + wd*p; buf = m(t)*buf + g; p -= lr(t)*buf.
    `count` is the number of steps taken."""

    def __init__(self, params, tcfg: TrainConfig, steps_per_epoch: int):
        super().__init__(params, lr=tcfg.lr, momentum=0.9,
                         weight_decay=tcfg.weight_decay)
        self.tcfg = tcfg
        self.steps_per_epoch = steps_per_epoch
        self.count = 0
        self._lr = onecycle_schedule(tcfg, steps_per_epoch)
        self._momentum = momentum_schedule(tcfg, steps_per_epoch)

    def step(self, closure=None):
        t = sched_step(self.tcfg, self.steps_per_epoch, self.count)
        for group in self.param_groups:
            group["lr"] = self._lr(t)
            group["momentum"] = self._momentum(t)
        out = super().step(closure)
        self.count += 1
        return out


def make_optimizer(model: nn.Module, tcfg: TrainConfig,
                   steps_per_epoch: int) -> ScheduledSGD:
    return ScheduledSGD(model.parameters(), tcfg, steps_per_epoch)


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A loader's numpy batch as tensors on `device` (python-object and
    bookkeeping entries dropped)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if k not in ("objects", "index", "frame")}


def encode_targets(batch: Dict[str, torch.Tensor], cfg: DatasetConfig,
                   dim_mean, angle_range: int, dense_rotation: bool = True):
    """Dense targets (B, ...) of a batch's padded objects."""
    objects = {k: batch[k] for k in OBJECT_KEYS if k in batch}
    return encode_frame(objects, batch["heatmap"], cfg,
                        dim_mean=dim_mean if cfg.mode == "3D" else None,
                        angle_range=angle_range, dense_rotation=dense_rotation)


def gather_rotation_cells(pred_rotation: torch.Tensor, batch, cfg: DatasetConfig,
                          angle_range: int):
    """(pred_cells, gt_cells, owner) for the sparse CSL angle loss: the
    rotation head's logits (B, L, W, A) gathered at the <= M object cells
    (the only cells where the dense loss is nonzero), in fp32, and the
    matching CSL targets built directly."""
    rows, cols, owner = object_cells(
        {k: batch[k] for k in ("location", "valid")}, cfg)
    b = torch.arange(pred_rotation.shape[0], device=pred_rotation.device)[:, None]
    pred_cells = pred_rotation[b, rows, cols]
    gt_cells = gaussian_csl_labels(torch.rad2deg(batch["rotation"].float()),
                                   angle_range)
    return pred_cells.float(), gt_cells, owner


def _angle_range(model: nn.Module) -> int:
    return model.orient_pred[0].out_channels if model.cfg.mode == "3D" else 360


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    cfg: DatasetConfig, tcfg: TrainConfig, dim_mean=None):
    """Returns step(batch, rig) -> loss_dict (detached scalars on the
    device): forward in training mode, target encoding, loss, backward and
    one optimizer update.

    batch: images (B, N, H, W, 3), heatmap (B, L, W), location (B, M, 3),
    valid (B, M) and, in 3D mode, dimension (B, M, 3), rotation (B, M)."""
    if tcfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype {tcfg.compute_dtype!r}: bf16 training (fp32 "
            "master parameters, bf16 variants of the window kernels) is not "
            "ported yet; see ROADMAP.md Queue 1 item 9 (bf16)")
    angle_range = _angle_range(model)

    def train_step(batch: Dict[str, torch.Tensor], rig) -> Dict[str, torch.Tensor]:
        model.train()
        pred = model(batch["images"], rig)
        # the rotation loss is evaluated at the object cells, so the dense
        # (B, L, W, angle) CSL target is never built
        rotation_cells = None
        if cfg.mode == "3D":
            rotation_cells = gather_rotation_cells(
                pred.pop("rotation"), batch, cfg, angle_range)
        pred = {k: v.float() for k, v in pred.items()}
        gt = encode_targets(batch, cfg, dim_mean, angle_range,
                            dense_rotation=False)
        if cfg.mode == "3D":
            loss, loss_dict = compute_loss3d(pred, gt, cfg.loss_weight,
                                             rotation_cells=rotation_cells)
        else:
            loss, loss_dict = compute_loss2d(pred, gt, cfg.loss_weight)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in loss_dict.items()}

    return train_step


def make_eval_step(model: nn.Module, cfg: DatasetConfig, dim_mean=None):
    """Returns step(batch, rig) -> (loss_dict, pred): the loss under running
    BatchNorm statistics with dense rotation targets, no update."""
    angle_range = _angle_range(model)

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor], rig):
        model.eval()
        pred = {k: v.float() for k, v in model(batch["images"], rig).items()}
        gt = encode_targets(batch, cfg, dim_mean, angle_range)
        if cfg.mode == "3D":
            _, loss_dict = compute_loss3d(pred, gt, cfg.loss_weight)
        else:
            _, loss_dict = compute_loss2d(pred, gt, cfg.loss_weight)
        return loss_dict, pred

    return eval_step
