"""Training CLI of the port (the synthetic route of the root `train.py`).

Builds the compiled camera rig once on the host, or loads it from the rig
cache (window layout by default, `--rig_layout flat` for the flat one; 8
buckets, in the compute dtype), trains VFANet with SGD + OneCycle through the hand-written
rig kernels of that layout (forward and backward; `--no_rig`: through the
reference voxel route instead), runs the validation loss after each epoch, and
reports the time per step. With VFA_FUSED_STEM=1 in the environment (as
in the JAX package) the stem's GroupNorm + ReLU + max-pool run through
`ops.stem.gn_relu_pool` and its hand-written backward kernels.
`--dtype bfloat16` trains in mixed precision, as the JAX CLI does: fp32
master parameters and momentum, bf16 compute (`train_lib`), bf16 images,
a bf16 rig and the bf16 variants of the kernels.

    python -m vfa_tpu_torch.train --data MultiviewC --synthetic -e 1 -b 2 --pretrained 0 --no_augment
    VFA_FUSED_STEM=1 python -m vfa_tpu_torch.train --data MultiviewC --synthetic -e 1 -b 2 --pretrained 0 --no_augment --rig_layout flat
    python -m vfa_tpu_torch.train --data MultiviewC --synthetic --tiny -e 1 --pretrained 0 --no_augment --device cpu
    python -m vfa_tpu_torch.train --data MultiviewC --synthetic --tiny -e 1 --pretrained 0 --no_augment --device cpu --dtype bfloat16
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vfa_tpu_torch.rig_cli import add_rig_layout_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True,
                   choices=["MultiviewC", "MultiviewX", "Wildtrack"])
    p.add_argument("-e", "--epochs", type=int, default=40)
    p.add_argument("-b", "--batch_size", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--momentum", type=float, default=0.5)
    p.add_argument("--angle_range", type=int, default=360)
    p.add_argument("--pretrained", type=int, default=1,
                   help="1: ImageNet backbone weights (not ported yet); "
                        "0: seeded random weights")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--resume", type=str, default=None,
                   help="resume from a checkpoint (not ported yet)")
    p.add_argument("--print_iter", type=int, default=1)
    p.add_argument("--vis_iter", type=int, default=0,
                   help="write pred-vs-gt figures every N iterations (not "
                        "ported yet; 0 disables)")
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
                        "(the augmentation is not ported yet, so this flag "
                        "is required)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on procedurally generated scenes (on-disk "
                        "data is not ported yet)")
    p.add_argument("--synthetic_frames", type=int, default=16)
    p.add_argument("--tiny", action="store_true",
                   help="the shrunken test configuration")
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
    p.add_argument("--multihost", action="store_true",
                   help="multi-process data parallelism (not ported yet)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    """Every flag whose path is not ported yet raises, naming its ROADMAP
    item; nothing is silently skipped."""
    unported = [
        (not args.synthetic, "on-disk datasets are not ported yet; pass "
         "--synthetic (ROADMAP.md Queue 1 item 11)"),
        (bool(args.pretrained), "--pretrained 1 (ImageNet backbone weights) "
         "is not ported yet; pass --pretrained 0 (ROADMAP.md Queue 1 item 10)"),
        (not args.no_augment, "the ColorJitter augmentation is not ported "
         "yet; pass --no_augment (ROADMAP.md Queue 1 item 11)"),
        (args.dtype == "bfloat16" and args.no_rig, "--no_rig --dtype "
         "bfloat16 (the reference voxel route in bf16) is not ported yet "
         "(ROADMAP.md Queue 1 item 17)"),
        (args.resume is not None, "--resume and checkpoints are not ported "
         "yet (ROADMAP.md Queue 1 item 10)"),
        (bool(args.vis_iter), "training figures (--vis_iter) are not ported "
         "yet (ROADMAP.md Queue 1 item 14)"),
        (args.multihost, "--multihost is not ported yet (ROADMAP.md Queue 1 "
         "item 15)"),
    ]
    for hit, message in unported:
        if hit:
            raise NotImplementedError(message)


def main(argv=None, rig=None) -> dict:
    """Run the CLI. `rig` is an already built CameraRig for this
    configuration (built here when None). Returns the per-step and
    validation losses, the step times, the model and the rig."""
    args = parse_args(argv)
    _refuse_unported(args)
    from vfa_tpu_torch.config import TrainConfig, get_config
    from vfa_tpu_torch.data.synthetic import tiny_config
    from vfa_tpu_torch.data.synthetic_loader import SyntheticSceneLoader
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights
    from vfa_tpu_torch.rig_cli import RIG_CACHE_DIR, build_cli_rig
    from vfa_tpu_torch.train_lib import (
        batch_to_device, current_lr, make_eval_step, make_optimizer,
        make_train_step,
    )
    from vfa_tpu_torch.utils import MetricDict

    if args.momentum != 0.5 and not args.no_cycle_momentum:
        raise SystemExit(
            "--momentum has no effect while the reference's OneCycleLR "
            "momentum cycle is replicated (it overwrites SGD's momentum "
            "every step). Pass --no_cycle_momentum to train with a constant "
            "momentum.")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    cfg = get_config(args.data)
    if args.tiny:
        cfg = tiny_config(cfg)
    tcfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, momentum=args.momentum,
        angle_range=args.angle_range, pretrained=bool(args.pretrained),
        seed=args.seed, print_iter=args.print_iter, vis_iter=args.vis_iter,
        scheduler_step_per_epoch=not args.fix_scheduler,
        cycle_momentum=not args.no_cycle_momentum, compute_dtype=args.dtype)

    train_loader = SyntheticSceneLoader(
        cfg, num_frames=args.synthetic_frames, batch_size=args.batch_size,
        seed=args.seed)
    val_loader = SyntheticSceneLoader(
        cfg, num_frames=max(2, args.synthetic_frames // 8),
        batch_size=args.batch_size, seed=args.seed + 1)
    steps_per_epoch = max(1, len(train_loader))
    if args.no_rig:
        rig = None
    elif rig is None:
        rig = build_cli_rig(cfg, train_loader.scenes[0].calibs, device,
                            buckets=args.rig_buckets, training=True,
                            layout=args.rig_layout, cache_dir=RIG_CACHE_DIR,
                            dtype=getattr(torch, args.dtype))

    gen = torch.Generator().manual_seed(args.seed)
    model = init_weights(
        VFANet(cfg, base=tcfg.base, angle_range=tcfg.angle_range,
               rig_impl=args.rig_impl), gen).to(device)
    print(f"training from random weights (seed {args.seed}), "
          f"rig_impl {args.rig_impl}, fused stem "
          f"{'on' if model.base.fused_stem_on() else 'off'}")
    image_dtype = None
    if args.dtype == "bfloat16":
        image_dtype = torch.bfloat16
        print("mixed precision: bfloat16 compute, float32 master params")
    optimizer = make_optimizer(model, tcfg, steps_per_epoch)
    train_step = make_train_step(model, optimizer, cfg, tcfg,
                                 dim_mean=train_loader.dim_mean)
    eval_step = make_eval_step(model, cfg, dim_mean=train_loader.dim_mean,
                               compute_dtype=args.dtype)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses, val_losses, step_ms = [], [], []
    for epoch in range(1, tcfg.epochs + 1):
        epoch_loss = MetricDict()
        for i, batch in enumerate(train_loader):
            t0 = time.perf_counter()
            loss_dict = train_step(batch_to_device(batch, device, image_dtype), rig)
            loss_dict = {k: float(v) for k, v in loss_dict.items()}
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss_dict)
            epoch_loss += loss_dict
            if i % tcfg.print_iter == 0:
                m = epoch_loss.mean
                print(f"[TRAIN] epoch {epoch}/{tcfg.epochs} it {i+1}/{steps_per_epoch} "
                      + " ".join(f"{k}={v:.5f}" for k, v in sorted(m.items())),
                      flush=True)
        val_loss = MetricDict()
        for batch in val_loader:
            loss_dict, _ = eval_step(batch_to_device(batch, device, image_dtype), rig)
            val_loss += {k: float(v) for k, v in loss_dict.items()}
        val_losses.append(val_loss.mean)
        lr = current_lr(tcfg, steps_per_epoch, optimizer.count - 1)
        print(f"[VAL] epoch {epoch}: train {epoch_loss.mean.get('loss', 0):.5f} "
              f"val {val_loss.mean.get('loss', 0):.5f} lr {lr:.5f}")
    print(f"steps {len(step_ms)} (batch {args.batch_size}): ms per step "
          + " ".join(f"{t:.2f}" for t in step_ms)
          + f"; p50 {float(np.median(step_ms)):.2f} ms")
    return {"losses": losses, "val_losses": val_losses, "ms": step_ms,
            "model": model, "rig": rig}


if __name__ == "__main__":
    main()
