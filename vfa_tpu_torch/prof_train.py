"""Where one training step of the PyTorch/CUDA port spends its time.

Runs the full-width MultiviewC fp32 train step of `vfa_tpu_torch.train_lib`
(7 x 720x1280 cameras, 8-bucket rig of the given layout, batch 2, random
seeded weights, TF32 off as in chip_smoke.py) on one GPU, warms up, then
traces two steps with torch.profiler and prints the device time by kernel,
the device busy share of the traced wall time, the host wall time per step
and the card's name and power limit.

    python -m vfa_tpu_torch.prof_train
    VFA_FUSED_STEM=1 python -m vfa_tpu_torch.prof_train --rig_layout flat
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

BATCH = 2
ROWS = 30
STEPS = 2


def main(argv=None):
    from vfa_tpu_torch.rig_cli import add_rig_layout_arg

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_rig_layout_arg(parser)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    from vfa_tpu_torch.config import TrainConfig, get_config
    from vfa_tpu_torch.data.synthetic_loader import SyntheticSceneLoader
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights
    from vfa_tpu_torch.rig_cli import build_cli_rig
    from vfa_tpu_torch.train_lib import (
        batch_to_device, make_optimizer, make_train_step,
    )

    dev = torch.device("cuda")
    cfg = get_config("MultiviewC")
    loader = SyntheticSceneLoader(cfg, num_frames=BATCH, batch_size=BATCH, seed=0)
    batch = next(iter(loader))
    rig = build_cli_rig(cfg, loader.scenes[0].calibs, dev, training=True,
                        layout=args.rig_layout)
    model = init_weights(VFANet(cfg), torch.Generator().manual_seed(0)).to(dev)
    # a small peak lr: the trace repeats one batch and must not diverge
    tcfg = TrainConfig(epochs=40, batch_size=BATCH, lr=0.002, pretrained=False)
    step = make_train_step(model, make_optimizer(model, tcfg, 1), cfg, tcfg,
                           dim_mean=loader.dim_mean)

    def one_step():
        loss = step(batch_to_device(batch, dev), rig)["loss"]
        torch.cuda.synchronize()
        return float(loss)

    for _ in range(2):
        one_step()
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_trace = time.perf_counter()
        for _ in range(STEPS):
            t0 = time.perf_counter()
            loss = one_step()
            walls.append((time.perf_counter() - t0) * 1e3)
        t_trace = (time.perf_counter() - t_trace) * 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    total_dev = sum(e.device_time_total for e in events) / 1e3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card.splitlines()[0]}")
    print(f"rig layout {args.rig_layout}, fused stem "
          f"{'on' if model.base.fused_stem_on() else 'off'}")
    print(f"last loss {loss:.5f}; host wall ms per step (batch {BATCH}): "
          + " ".join(f"{w:.2f}" for w in walls))
    print(f"device kernel time {total_dev:.2f} ms over {t_trace:.2f} ms traced "
          f"(busy share {total_dev / t_trace:.3f}; kernels may overlap copies); "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:ROWS]:
        print(f"  {e.device_time_total / 1e3 / STEPS:9.3f} ms/step  "
              f"{e.count // STEPS:5d} calls/step  {e.key[:90]}")


if __name__ == "__main__":
    main()
