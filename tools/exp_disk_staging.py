"""The bench's `--from_disk` loop with the uint8 batch copied to the card
from pageable memory (`train_lib.stage_images`, a copy that waits for the
card's queued work) against through pinned memory without waiting, bf16
MultiviewC, serving (auto batch) and training (batch 8), in one process
and alternating (pinned, pageable, pageable, pinned, ...), every run on
one frame set and one rig per mode.

    python tools/exp_disk_staging.py [--rounds 4] [--iters 16]

Prints the card and its power limit, then one line per run and the medians.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vfa_tpu_torch import bench, train_lib  # noqa: E402
from vfa_tpu_torch.config import get_config  # noqa: E402
from vfa_tpu_torch.data.synthetic import make_calibrations  # noqa: E402
from vfa_tpu_torch.rig_cli import build_cli_rig  # noqa: E402

PAGEABLE = train_lib.stage_images


def pinned(images, device, dtype=None, jitter=None):
    """`stage_images` with the copy through pinned memory, not waiting."""
    x = torch.from_numpy(np.ascontiguousarray(images)).pin_memory()
    f = x.to(device, non_blocking=True).to(torch.float32) * (1.0 / 255.0)
    if jitter is not None:
        from vfa_tpu_torch.data.augment import device_color_jitter

        f = device_color_jitter(f.reshape(-1, *f.shape[2:]), *jitter).reshape(f.shape)
    return f.to(dtype or torch.float32)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--iters", type=int, default=16)
    args = p.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    cfg = get_config("MultiviewC")
    disk = tempfile.mkdtemp(prefix="exp_disk_staging_")
    rigs = {mode: build_cli_rig(cfg, make_calibrations(cfg), "cuda",
                                buckets=buckets, dtype=torch.bfloat16)
            for mode, buckets in (("serving", 12), ("training", 8))}
    argv = {"serving": ["--batch", "0"], "training": ["--train", "--batch", "8"]}
    results = {}
    for r in range(args.rounds):
        for staging in (("pinned", "pageable") if r % 2 == 0 else ("pageable", "pinned")):
            train_lib.stage_images = pinned if staging == "pinned" else PAGEABLE
            for mode in ("serving", "training"):
                with contextlib.redirect_stdout(sys.stderr):
                    res = bench.main(["--data", "MultiviewC", "--dtype", "bfloat16",
                                      "--from_disk", "--disk_dir", disk, "--iters",
                                      str(args.iters), "--warmup", "1"] + argv[mode],
                                     rig=rigs[mode])
                results.setdefault((mode, staging), []).append(res["value"])
                print(f"round {r} {mode} {staging}: {res['value']} scenes/s", flush=True)
    for (mode, staging), v in sorted(results.items()):
        print(f"{mode} {staging}: median {float(np.median(v))} scenes/s over {v}")


if __name__ == "__main__":
    main()
