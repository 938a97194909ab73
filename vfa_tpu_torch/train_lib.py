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
`compute_dtype` 'bfloat16' is mixed precision, as
`vfa_tpu/train_lib.py:241-335`: the parameters and the SGD momentum stay
fp32 masters in the model and the optimizer, and each step casts the
parameters to bf16 at use, differentiably (`torch.func.functional_call`),
so their gradients arrive in fp32; the BatchNorms cast their fp32 running
statistics at use and write the update back in fp32
(`model/vfanet.py::BatchNorm2dBiased`); the images go in as bf16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from vfa_tpu_torch import observability
from vfa_tpu_torch.codec import encode_frame, gaussian_csl_labels, object_cells
from vfa_tpu_torch.config import DatasetConfig, TrainConfig
from vfa_tpu_torch.losses import compute_loss2d, compute_loss3d
from vfa_tpu_torch.observability import check_finite, nan_debugging, span

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


@observability.traced("stage")
def stage_images(images: np.ndarray, device, dtype=None,
                 jitter=None) -> torch.Tensor:
    """A uint8-staged (B, N, H, W, 3) host batch on `device` as [0, 1]
    images in `dtype` (default fp32): the copy moves the uint8 bytes, and
    the normalization (`x * (1/255)` in fp32, as the JAX CLI's staging
    step) and, when `jitter` = (factors, order) is given (one row per
    camera image, `data.augment.sample_jitter_params`), the train-split
    ColorJitter run on the device. The copy is from pageable memory: one
    through pinned memory without waiting did not measure faster from
    disk (CHANGES.md, the on-disk path's entry)."""
    x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    f = x.to(torch.float32) * (1.0 / 255.0)
    if jitter is not None:
        from vfa_tpu_torch.data.augment import device_color_jitter

        f = device_color_jitter(f.reshape(-1, *f.shape[2:]), *jitter).reshape(f.shape)
    return f.to(dtype or torch.float32)


def batch_to_device(batch: Dict, device, image_dtype=None,
                    jitter=None) -> Dict[str, torch.Tensor]:
    """A loader's numpy batch as tensors on `device` (python-object and
    bookkeeping entries dropped). Float images are cast to `image_dtype`
    on the host first when it is given (bf16 halves the copy); uint8
    images go through `stage_images` (with `jitter`, if given)."""
    out = {}
    for k, v in batch.items():
        if k in ("objects", "index", "frame"):
            continue
        if k == "images" and np.asarray(v).dtype == np.uint8:
            out[k] = stage_images(v, device, image_dtype, jitter)
            continue
        t = torch.as_tensor(v)
        if k == "images" and image_dtype is not None:
            t = t.to(image_dtype)
        out[k] = t.to(device)
    return out


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


def _compute_dtype(name: str) -> torch.dtype:
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {name!r}")
    return getattr(torch, name)


def _forward(model: nn.Module, dtype: torch.dtype, batch, rig):
    """The model on the batch, its parameters and images cast to `dtype`
    at use (a no-op cast in fp32); the cast is differentiable, so the fp32
    masters receive the gradients."""
    args = (batch["images"].to(dtype), rig, batch.get("calibs"), batch.get("grid"))
    if dtype == torch.float32:
        return model(*args)
    with span("cast"):
        params = {name: p.to(dtype) for name, p in model.named_parameters()}
    return torch.func.functional_call(model, params, args)


def _mesh_sums(mesh):
    """(count_sum, report) of a step on `mesh`: the losses' counts summed
    over its data axis, and the loss dict summed over it (each rank holds
    its share of the global loss), or (None, identity) without one."""
    if mesh is None or mesh.group("data") is None:
        return None, lambda d: d
    from vfa_tpu_torch import parallel

    group = mesh.group("data")
    count_sum = lambda n: parallel.sum_nograd(n, group)

    def report(loss_dict):
        keys = sorted(loss_dict)
        total = parallel.sum_nograd(torch.stack([loss_dict[k].detach() for k in keys]), group)
        return dict(zip(keys, total.unbind()))

    return count_sum, report


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    cfg: DatasetConfig, tcfg: TrainConfig, dim_mean=None,
                    mesh=None):
    """Returns step(batch, rig) -> loss_dict (detached scalars on the
    device): forward in training mode, target encoding, loss, backward and
    one optimizer update. rig=None samples through the voxel route.

    batch: images (B, N, H, W, 3), heatmap (B, L, W), location (B, M, 3),
    valid (B, M), in 3D mode dimension (B, M, 3), rotation (B, M), and for
    the voxel route calibs (B, N, 3, 4), grid (L, W, 3). With
    `tcfg.compute_dtype` 'bfloat16' the step is mixed precision (module
    docstring) and the rig must be a bf16 one. Under
    `observability.enable_nan_debugging()` the loss and the gradients are
    checked before the update (FloatingPointError naming the step).

    On a `parallel.Mesh` (`mesh`, also set as `model.mesh`) the batch is
    this rank's part (`parallel.make_global_batch`), the loss is this
    rank's share of the global batch's, the gradients are summed as
    `parallel.reduce_gradients` says before the update, and the returned
    losses are the global batch's."""
    dtype = _compute_dtype(tcfg.compute_dtype)
    angle_range = _angle_range(model)
    count_sum, report = _mesh_sums(mesh)

    @observability.traced("train_step")
    def train_step(batch: Dict[str, torch.Tensor], rig) -> Dict[str, torch.Tensor]:
        model.train()
        pred = _forward(model, dtype, batch, rig)
        with span("targets"):
            # the rotation loss is evaluated at the object cells, so the
            # dense (B, L, W, angle) CSL target is never built
            rotation_cells = None
            if cfg.mode == "3D":
                rotation_cells = gather_rotation_cells(
                    pred.pop("rotation"), batch, cfg, angle_range)
            pred = {k: v.float() for k, v in pred.items()}
            gt = encode_targets(batch, cfg, dim_mean, angle_range,
                                dense_rotation=False)
        with span("loss"):
            if cfg.mode == "3D":
                loss, loss_dict = compute_loss3d(pred, gt, cfg.loss_weight,
                                                 rotation_cells=rotation_cells,
                                                 count_sum=count_sum)
            else:
                loss, loss_dict = compute_loss2d(pred, gt, cfg.loss_weight,
                                                 count_sum=count_sum)
        with span("optimizer"):
            optimizer.zero_grad(set_to_none=True)
        with span("backward"):
            loss.backward()
            if mesh is not None:
                from vfa_tpu_torch.parallel import reduce_gradients

                reduce_gradients(model, mesh)
            if nan_debugging():
                check_finite(optimizer.count, loss,
                             ((n, p.grad) for n, p in model.named_parameters()))
        with span("optimizer"):
            optimizer.step()
        return report({k: v.detach() for k, v in loss_dict.items()})

    return train_step


def make_eval_step(model: nn.Module, cfg: DatasetConfig, dim_mean=None,
                   compute_dtype: str = "float32", mesh=None):
    """Returns step(batch, rig) -> (loss_dict, pred): the loss under running
    BatchNorm statistics with dense rotation targets, no update.
    compute_dtype 'bfloat16' casts the parameters, the running statistics
    and the images at use, as the mixed-precision train step does. On a
    mesh the losses are the global batch's, as the train step's."""
    dtype = _compute_dtype(compute_dtype)
    angle_range = _angle_range(model)
    count_sum, report = _mesh_sums(mesh)

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor], rig):
        model.eval()
        pred = _forward(model, dtype, batch, rig)
        pred = {k: v.float() for k, v in pred.items()}
        gt = encode_targets(batch, cfg, dim_mean, angle_range)
        if cfg.mode == "3D":
            _, loss_dict = compute_loss3d(pred, gt, cfg.loss_weight,
                                          count_sum=count_sum)
        else:
            _, loss_dict = compute_loss2d(pred, gt, cfg.loss_weight,
                                          count_sum=count_sum)
        return report(loss_dict), pred

    return eval_step
