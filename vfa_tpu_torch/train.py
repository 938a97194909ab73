"""Training CLI of the port (mirrors the root `train.py`).

Loads a dataset from disk (`--root`, the MultiviewC / MultiviewX /
Wildtrack layouts of `data.adapters`) or generates synthetic scenes
(`--synthetic`), builds the compiled camera rig once on the host, or loads
it from the rig cache (window layout by default, `--rig_layout flat` for
the flat one; 8 buckets, in the compute dtype), trains VFANet with SGD +
OneCycle through the hand-written rig kernels of that layout (forward and
backward; `--no_rig`: through the reference voxel route instead), runs the
validation loss after each epoch, logs train / val / opt scalars to
`<savedir>/<run>/metrics.jsonl` (and TensorBoard when it imports), saves
a checkpoint every 5 epochs and at the last one (`checkpoint.py`), and
reports the time per step. `--resume <run>` continues `<savedir>/<run>`
from its latest checkpoint.

On disk, the train loader stages uint8 batches (4x fewer host-to-device
bytes) and the train-split ColorJitter runs on the device
(`data.augment.device_color_jitter`, factors drawn on the host from
`--seed`); the synthetic route jitters on the host, as the JAX CLI does.
With VFA_FUSED_STEM=1 in the environment (as in the JAX package) the
stem's GroupNorm + ReLU + max-pool run through `ops.stem.gn_relu_pool` and
its hand-written backward kernels. `--dtype bfloat16` trains in mixed
precision, as the JAX CLI does: fp32 master parameters and momentum, bf16
compute (`train_lib`), bf16 images, a bf16 rig and the bf16 variants of
the kernels.

    python -m vfa_tpu_torch.train --data MultiviewC --root data/MultiviewC -e 40 -b 2 --pretrained 0
    python -m vfa_tpu_torch.train --data MultiviewC --root data/MultiviewC -e 2 --resume <run>
    python -m vfa_tpu_torch.train --data MultiviewC --synthetic -e 1 -b 2 --pretrained 0 --no_augment
    VFA_FUSED_STEM=1 python -m vfa_tpu_torch.train --data MultiviewC --synthetic -e 1 -b 2 --pretrained 0 --no_augment --rig_layout flat
    python -m vfa_tpu_torch.train --data MultiviewC --synthetic --tiny -e 1 --pretrained 0 --device cpu --dtype bfloat16
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from datetime import datetime

import numpy as np
import torch

from vfa_tpu_torch.rig_cli import add_rig_layout_arg

CHECKPOINT_EVERY = 5          # epochs, as the reference (`train.py:284-286`)
AUGMENT_SEED_OFFSET = 777     # the jitter's generator: seed + 777, as JAX


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True,
                   choices=["MultiviewC", "MultiviewX", "Wildtrack"])
    p.add_argument("--root", type=str, default=None,
                   help="dataset root on disk (default: the config's)")
    p.add_argument("--mode", type=str, default=None, choices=["2D", "3D"])
    p.add_argument("--world_size", type=int, nargs=2, default=None)
    p.add_argument("--image_size", type=int, nargs=2, default=None)
    p.add_argument("--resize_size", type=int, nargs=2, default=None)
    p.add_argument("-e", "--epochs", type=int, default=40)
    p.add_argument("-b", "--batch_size", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--momentum", type=float, default=0.5)
    p.add_argument("--grid_h", type=int, default=None)
    p.add_argument("--cube_size", type=int, nargs=3, default=None)
    p.add_argument("--angle_range", type=int, default=360)
    p.add_argument("--pretrained", type=int, default=1,
                   help="1: torchvision ImageNet backbone weights, read from "
                        "a local file (convert.torchvision_resnet_path; "
                        "training goes on from random weights, saying so, "
                        "when it is absent); 0: seeded random weights")
    p.add_argument("--heatmap", type=str, default="GK", choices=["GK", "RGK"],
                   help="MultiviewC gt heatmap flavor")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--savedir", type=str, default="experiments")
    p.add_argument("--resume", type=str, default=None,
                   help="run name under --savedir to continue from its "
                        "latest checkpoint")
    p.add_argument("--loss_weight", type=float, nargs="*", default=None)
    p.add_argument("--print_iter", type=int, default=1)
    p.add_argument("--vis_iter", type=int, default=50,
                   help="decode and write pred-vs-gt figures (heatmaps, "
                        "every camera's boxes) every N train iterations, and "
                        "the val heatmap once an epoch, to TensorBoard (0 "
                        "disables; needs matplotlib, else it says so once "
                        "and trains on); the reference trainer's vis_iter")
    p.add_argument("--cls_thresh", type=float, default=0.8,
                   help="confidence threshold of the figures' detections")
    p.add_argument("--topk", type=int, default=50)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="training compute dtype (bfloat16: mixed precision, "
                        "fp32 master parameters)")
    p.add_argument("--fix_scheduler", action="store_true",
                   help="step OneCycle per iteration instead of replicating "
                        "the reference's per-epoch quirk")
    p.add_argument("--no_cycle_momentum", action="store_true",
                   help="use the constant --momentum instead of replicating "
                        "OneCycleLR's 0.95<->0.85 momentum cycle")
    p.add_argument("--no_augment", action="store_true",
                   help="disable the train-split ColorJitter augmentation "
                        "(brightness/contrast/hue 0.2, the reference's)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on procedurally generated scenes")
    p.add_argument("--synthetic_frames", type=int, default=16)
    p.add_argument("--tiny", action="store_true",
                   help="the shrunken test configuration")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="capture a torch.profiler trace of the step with "
                        "this global index (0 disables) into <run>/profile, "
                        "the port's spans on; their totals print at the end")
    p.add_argument("--debug_nans", action="store_true",
                   help="check the loss and the gradients after every step "
                        "and fail on a NaN or Inf (one host sync a step)")
    p.add_argument("--no_rig", action="store_true",
                   help="sample through the reference voxel route from the "
                        "calibrations instead of a compiled rig")
    p.add_argument("--rig_buckets", type=int, default=None,
                   help="max window buckets of the rig (default: the "
                        "training policy of rig_cli, 8)")
    p.add_argument("--rig_impl", default="cuda", choices=["cuda", "plain"],
                   help="cuda: the hand-written rig kernels; plain: "
                        "their plain PyTorch versions under autograd")
    add_rig_layout_arg(p)
    # multi-process (`parallel.py`): one process per card, or two ranks
    # sharing one card through gloo; data parallel over a (data, cam) mesh
    p.add_argument("--multihost", action="store_true",
                   help="init torch.distributed and shard the batch over a "
                        "(data, cam) mesh of all processes: each loads its "
                        "strided frame shard, -b scenes a process")
    p.add_argument("--coordinator", type=str, default="localhost:8476",
                   help="rendezvous address host:port (process 0's host)")
    p.add_argument("--num_processes", type=int,
                   default=int(os.environ.get("VFA_NUM_PROCESSES", "1")))
    p.add_argument("--process_id", type=int,
                   default=int(os.environ.get("VFA_PROCESS_ID", "0")))
    p.add_argument("--mesh_cam", type=int, default=1,
                   help="processes on the mesh 'cam' axis: each samples its "
                        "share of the cameras and the BEV sum is an "
                        "all-reduce over them")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build_config(args):
    """(DatasetConfig, TrainConfig) of the arguments, as the root
    `train.py:114-135` builds them: the geometry overrides and
    --loss_weight replace the dataset's, then --tiny shrinks it."""
    from vfa_tpu_torch.config import TrainConfig, get_config
    from vfa_tpu_torch.data.synthetic import tiny_config

    cfg = get_config(args.data)
    overrides = {}
    for field in ("root", "mode", "grid_h"):
        v = getattr(args, field)
        if v is not None:
            overrides[field] = v
    for field in ("world_size", "image_size", "resize_size", "cube_size"):
        v = getattr(args, field)
        if v is not None:
            overrides[field] = tuple(v)
    if args.loss_weight:
        overrides["loss_weight"] = tuple(args.loss_weight)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if args.tiny:
        cfg = tiny_config(cfg)
    if args.momentum != 0.5 and not args.no_cycle_momentum:
        raise SystemExit(
            "--momentum has no effect while the reference's OneCycleLR "
            "momentum cycle is replicated (it overwrites SGD's momentum "
            "every step). Pass --no_cycle_momentum to train with a constant "
            "momentum.")
    tcfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, momentum=args.momentum,
        angle_range=args.angle_range, pretrained=bool(args.pretrained),
        heatmap=args.heatmap, seed=args.seed, savedir=args.savedir,
        print_iter=args.print_iter, vis_iter=args.vis_iter,
        cls_thresh=args.cls_thresh, topk=args.topk,
        scheduler_step_per_epoch=not args.fix_scheduler,
        cycle_momentum=not args.no_cycle_momentum, compute_dtype=args.dtype)
    return cfg, tcfg


def make_loaders(cfg, args, shard=None):
    """(train, val, dim_mean, device_jitter), as the root `train.py:156-207`.
    device_jitter: the train loader stages raw uint8 images and the
    train-split ColorJitter runs on the device; the synthetic and the
    multi-process routes keep the host jitter, as the JAX CLI does.
    `shard` = {"process_id", "process_count"}: each loader takes its
    strided frame shard (the data axis of a --multihost mesh)."""
    shard = shard or {}
    augment = None
    if not args.no_augment:
        from vfa_tpu_torch.data.augment import ColorJitterAugment

        augment = ColorJitterAugment(brightness=0.2, contrast=0.2, hue=0.2)

    if args.synthetic:
        from vfa_tpu_torch.data.synthetic_loader import SyntheticSceneLoader

        train = SyntheticSceneLoader(cfg, num_frames=args.synthetic_frames,
                                     batch_size=args.batch_size, seed=args.seed,
                                     augment=augment, **shard)
        val = SyntheticSceneLoader(cfg, num_frames=max(2, args.synthetic_frames // 8),
                                   batch_size=args.batch_size, seed=args.seed + 1,
                                   **shard)
        return train, val, train.dim_mean, False

    from vfa_tpu_torch.data.adapters import ADAPTERS
    from vfa_tpu_torch.data.frame_dataset import FrameDataset, SceneLoader
    from vfa_tpu_torch.native.imageio import decoder_backend

    kw = {"heatmap_type": args.heatmap} if cfg.name == "MultiviewC" else {}
    base = ADAPTERS[cfg.name](cfg.root, world_size=cfg.world_size,
                              cube_LWH=cfg.cube_size, **kw)
    train_ds = FrameDataset(base, cfg, split="train")
    val_ds = FrameDataset(base, cfg, split="val")
    device_jitter = augment is not None and not args.multihost
    staged = np.uint8 if device_jitter else np.float32
    train = SceneLoader(train_ds, batch_size=args.batch_size, shuffle=True,
                        seed=args.seed, augment=None if device_jitter else augment,
                        images_dtype=staged, **shard)
    val = SceneLoader(val_ds, batch_size=args.batch_size, shuffle=False,
                      images_dtype=staged, **shard)
    print(f"dataset {cfg.name} at {cfg.root}: {len(train_ds)} train / "
          f"{len(val_ds)} val frames, {base.num_cam} cameras; decoder "
          f"{decoder_backend()}; images staged as "
          f"{np.dtype(staged).name}, ColorJitter "
          f"{'off' if augment is None else 'on the device' if device_jitter else 'on the host'}")
    return train, val, train_ds.dim_mean, device_jitter


def _rng_of(loader):
    """The train loader's and its host jitter's generators (numpy), whose
    states a checkpoint keeps so that a resumed run draws what the
    uninterrupted one would."""
    return {k: getattr(loader, a) for k, a in (("loader", "_rng"), ("augment", "_aug_rng"))
            if hasattr(loader, a)}


class _Figures:
    """The train CLI's figures (`vfa/trainer.py:68-87`, the root
    `train.py:355-418`): every --vis_iter iterations the train heatmap
    beside the gt and the prediction figure (every camera with the gt and
    the decoded boxes), once an epoch the val heatmap, to TensorBoard
    through the metrics writer (the first rank's). Without matplotlib it
    says so once and draws nothing (`ready` False)."""

    def __init__(self, cfg, tcfg, dim_mean, writer):
        from vfa_tpu_torch.codec import ObjectEncoder
        from vfa_tpu_torch.visualization.figure import matplotlib_available

        self.cfg, self.tcfg, self.writer = cfg, tcfg, writer
        self.encoder = ObjectEncoder(cfg, dim_mean=dim_mean, topk=tcfg.topk)
        self.ready = matplotlib_available()
        if not self.ready:
            print("figures not written (--vis_iter): matplotlib is not installed")

    def train(self, batch, pred, step):
        from vfa_tpu_torch.visualization.figure import heatmap_figure, prediction_figure

        if self.writer is None:
            return
        one = {k: v[0:1] for k, v in pred.items()}
        dets = self.encoder.batch_decode(one, self.tcfg.cls_thresh)[0]
        pred_hm = torch.sigmoid(pred["heatmap"][0, 0]).cpu().numpy()
        self.writer.figure("train/heatmap",
                           heatmap_figure(pred_hm, np.asarray(batch["heatmap"][0])), step)
        imgs = np.asarray(batch["images"][0])
        if imgs.dtype == np.uint8:      # uint8-staged loader (device jitter)
            imgs = imgs.astype(np.float32) / 255.0
        self.writer.figure("train/prediction", prediction_figure(
            imgs, np.asarray(batch["calibs"][0]), pred_hm, dets,
            batch["objects"][0], self.cfg), step)

    def val(self, pred, epoch):
        from vfa_tpu_torch.visualization.figure import heatmap_figure

        if self.writer is not None:
            self.writer.figure("val/heatmap", heatmap_figure(
                torch.sigmoid(pred["heatmap"][0, 0]).cpu().numpy()), epoch)


def main(argv=None, rig=None) -> dict:
    """Run the CLI. `rig` is an already built CameraRig for this
    configuration (built here when None). Returns the per-step and
    validation losses, the step times and learning rates, the model, the
    rig and the run directory."""
    args = parse_args(argv)
    from vfa_tpu_torch import observability
    from vfa_tpu_torch.checkpoint import (
        latest_checkpoint, load_state, restore_checkpoint, save_checkpoint,
    )
    from vfa_tpu_torch.data.augment import sample_jitter_params
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights
    from vfa_tpu_torch.rig_cli import RIG_CACHE_DIR, build_cli_rig
    from vfa_tpu_torch.train_lib import (
        batch_to_device, current_lr, make_eval_step, make_optimizer,
        make_train_step,
    )
    from vfa_tpu_torch.utils import MetricDict

    cfg, tcfg = build_config(args)
    mesh = shard = None
    if args.multihost:
        from vfa_tpu_torch import parallel

        device = parallel.init_multihost(args.coordinator, args.num_processes,
                                         args.process_id, args.device)
        mesh = parallel.make_mesh(cam=args.mesh_cam)
        shard = {"process_id": mesh.index("data"),
                 "process_count": mesh.size("data")}
        print(f"multihost: mesh {mesh}; rank {mesh.rank} loads data shard "
              f"{shard['process_id']} of {shard['process_count']}, cameras "
              f"{args.mesh_cam} ways", flush=True)
    else:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is available")
    main_rank = mesh is None or mesh.rank == 0
    observability.enable_nan_debugging(args.debug_nans)

    train_loader, val_loader, dim_mean, device_jitter = make_loaders(cfg, args, shard)
    steps_per_epoch = max(1, len(train_loader))
    image_dtype = None
    if args.dtype == "bfloat16":
        image_dtype = torch.bfloat16
        print("mixed precision: bfloat16 compute, float32 master params")
    aug_rng = np.random.default_rng(tcfg.seed + AUGMENT_SEED_OFFSET)

    def local(batch):
        """This rank's cameras of its scenes (all of them in one process)."""
        return batch if mesh is None else parallel.make_global_batch(batch, mesh)

    def to_device(batch, jitter=False):
        params = None
        if jitter:
            n = batch["images"].shape[0] * batch["images"].shape[1]
            params = sample_jitter_params(aug_rng, n)
        return batch_to_device(batch, device, image_dtype, params)

    if args.no_rig:
        rig = None
    elif rig is None:
        calibs = (train_loader.ds.calibs if hasattr(train_loader, "ds")
                  else train_loader.scenes[0].calibs)
        rig = build_cli_rig(cfg, calibs, device,
                            buckets=args.rig_buckets, training=True,
                            layout=args.rig_layout, cache_dir=RIG_CACHE_DIR,
                            dtype=getattr(torch, args.dtype))
    if rig is not None and mesh is not None:
        rig = parallel.camera_rig(rig, mesh)

    gen = torch.Generator().manual_seed(args.seed)
    model = init_weights(
        VFANet(cfg, base=tcfg.base, angle_range=tcfg.angle_range,
               rig_impl=args.rig_impl), gen)
    if tcfg.pretrained:
        from vfa_tpu_torch.convert import load_torchvision_resnet_file

        try:
            path = load_torchvision_resnet_file(model, tcfg.base)
            print(f"loaded torchvision ImageNet backbone weights from {path}")
        except FileNotFoundError as e:
            print(f"pretrained backbone unavailable ({e}); training from scratch")
    model = model.to(device)
    if mesh is not None:
        model.mesh = mesh
        parallel.replicate(model, mesh)
    print(f"weights seeded from {args.seed}, rig_impl {args.rig_impl}, fused stem "
          f"{'on' if model.base.fused_stem_on() else 'off'}")
    optimizer = make_optimizer(model, tcfg, steps_per_epoch)

    savedir = os.path.join(tcfg.savedir, args.resume or
                           datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
    if main_rank:
        os.makedirs(savedir, exist_ok=True)
    ckpt_dir = os.path.join(savedir, "checkpoints")
    start_epoch = 1
    rngs = {"augment_device": aug_rng, **_rng_of(train_loader)}
    if args.resume:
        # as the JAX CLI: a run without a checkpoint starts at epoch 1
        ckpt = latest_checkpoint(ckpt_dir)
        if ckpt is None:
            print(f"--resume {args.resume}: no checkpoint under {ckpt_dir}; "
                  "starting at epoch 1")
        else:
            start_epoch = restore_checkpoint(ckpt, model, optimizer) + 1
            for name, state in load_state(ckpt)["rng"].items():
                rngs[name].bit_generator.state = state
            print(f"resumed from {ckpt} at epoch {start_epoch} (optimizer "
                  f"step {optimizer.count})")

    train_step = make_train_step(model, optimizer, cfg, tcfg, dim_mean=dim_mean,
                                 mesh=mesh)
    eval_step = make_eval_step(model, cfg, dim_mean=dim_mean,
                               compute_dtype=args.dtype, mesh=mesh)
    # every rank trains; the first writes the metrics, figures and checkpoints
    writer = observability.MetricsWriter(savedir) if main_rank else None
    if writer:
        writer.text("config", json.dumps(
            {"dataset": dataclasses.asdict(cfg), "train": dataclasses.asdict(tcfg)},
            indent=2, default=str))
    figures = _Figures(cfg, tcfg, dim_mean, writer) if tcfg.vis_iter else None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses, val_losses, step_ms, lrs, wait_ms, checkpoints = [], [], [], [], [], []
    step_spans = None
    global_it = 0
    for epoch in range(start_epoch, tcfg.epochs + 1):
        t_epoch = time.time()
        epoch_loss = MetricDict()
        t_wait = time.perf_counter()
        for i, batch in enumerate(train_loader):
            wait_ms.append((time.perf_counter() - t_wait) * 1e3)
            tracing = args.profile_steps and global_it == args.profile_steps
            batch = local(batch)
            t0 = time.perf_counter()
            with observability.profile_trace(
                    os.path.join(savedir, "profile") if tracing and main_rank else None):
                on_device = to_device(batch, jitter=device_jitter)
                loss_dict = train_step(on_device, rig)
                loss_dict = {k: float(v) for k, v in loss_dict.items()}
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if tracing and main_rank:
                step_spans = observability.span_totals()
            lrs.append(optimizer.param_groups[0]["lr"])
            losses.append(loss_dict)
            epoch_loss += loss_dict
            if figures and figures.ready and i % tcfg.vis_iter == 0:
                _, vis_pred = eval_step(on_device, rig)
                figures.train(batch, vis_pred, global_it)
            global_it += 1
            if i % tcfg.print_iter == 0:
                m = epoch_loss.mean
                print(f"[TRAIN] epoch {epoch}/{tcfg.epochs} it {i+1}/{steps_per_epoch} "
                      + " ".join(f"{k}={v:.5f}" for k, v in sorted(m.items())),
                      flush=True)
            t_wait = time.perf_counter()
        val_loss = MetricDict()
        last_pred = None
        for batch in val_loader:
            loss_dict, last_pred = eval_step(to_device(local(batch)), rig)
            val_loss += {k: float(v) for k, v in loss_dict.items()}
        val_losses.append(val_loss.mean)
        lr = current_lr(tcfg, steps_per_epoch, optimizer.count - 1)
        print(f"[VAL] epoch {epoch}: train {epoch_loss.mean.get('loss', 0):.5f} "
              f"val {val_loss.mean.get('loss', 0):.5f} lr {lr:.5f}")
        if writer:
            writer.scalars("train", epoch_loss.mean, epoch)
            writer.scalars("val", val_loss.mean, epoch)
            writer.scalars("opt", {"lr": lr, "epoch_seconds": time.time() - t_epoch}, epoch)
        if figures and figures.ready and last_pred is not None:
            figures.val(last_pred, epoch)
        if main_rank and (epoch % CHECKPOINT_EVERY == 0 or epoch == tcfg.epochs):
            path = save_checkpoint(
                ckpt_dir, model, optimizer, cfg, tcfg, epoch,
                extra={"dim_mean": None if dim_mean is None
                       else np.asarray(dim_mean).tolist()},
                rng={k: g.bit_generator.state for k, g in rngs.items()})
            checkpoints.append(path)
            print(f"saved checkpoint {path}")
    if writer:
        writer.close()
    if device.type == "cuda":
        from vfa_tpu_torch.kernels import launch_counts

        print(f"kernel launches (this process): {json.dumps(launch_counts())}")
    if step_spans is not None:
        print(f"spans of step {args.profile_steps} (ms): {json.dumps(step_spans)}")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if step_ms:
        print(f"steps {len(step_ms)} (batch {args.batch_size}): ms per step "
              + " ".join(f"{t:.2f}" for t in step_ms)
              + f"; p50 {float(np.median(step_ms)):.2f} ms; loader wait p50 "
              f"{float(np.median(wait_ms)):.2f} ms per step")
    return {"losses": losses, "val_losses": val_losses, "ms": step_ms,
            "wait_ms": wait_ms, "lrs": lrs, "model": model, "rig": rig,
            "optimizer": optimizer, "savedir": savedir,
            "checkpoints": checkpoints, "start_epoch": start_epoch,
            "steps_per_epoch": steps_per_epoch}


if __name__ == "__main__":
    main()
