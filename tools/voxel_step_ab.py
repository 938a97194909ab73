"""The voxel-route training step at batch 1 (rig=None, the bench's runner:
`--train --no-rig --batch 1`) from two checkouts of the repository, in
turns (A, B, B, A), one process a run, on one card: per run the p50 and
every step's ms (host clock around a step that ends in a synchronize),
after 2 warm-up steps, and the kernel launches of the timed steps.

    python tools/voxel_step_ab.py --a <checkout> --b <checkout> \
        [--dtype bfloat16 float32] [--steps 7]

Prints one line a run and, last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from vfa_tpu_torch import bench, kernels

dtype, steps = sys.argv[2], int(sys.argv[3])
args = bench.parse_args(["--train", "--dtype", dtype, "--no-rig", "--batch", "1"])
device = torch.device("cuda")
torch.backends.cudnn.allow_tf32 = bench.CUDNN_TF32
torch.backends.cuda.matmul.allow_tf32 = bench.MATMUL_TF32
run = bench.make_runner(bench.bench_config(args), args, 1, 0, None, device)
for _ in range(2):
    bench.finish(run(), device, True)
before = kernels.launch_counts()
ms = []
for _ in range(steps):
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = run()
    bench.finish(out, device, True)
    ms.append((time.perf_counter() - t0) * 1e3)
after = kernels.launch_counts()
print(json.dumps({"p50_ms": float(np.median(ms)), "ms": ms,
                  "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}))
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (e.g. the parent commit)")
    ap.add_argument("--b", required=True, help="checkout B")
    ap.add_argument("--dtype", nargs="+", default=["bfloat16"])
    ap.add_argument("--steps", type=int, default=7)
    args = ap.parse_args(argv)
    for dtype in args.dtype:
        for tag in ("a", "b", "b", "a"):
            root = os.path.abspath(getattr(args, tag))
            res = subprocess.run([sys.executable, "-c", CHILD, root, dtype, str(args.steps)],
                                 capture_output=True, text=True, timeout=900)
            if res.returncode:
                raise RuntimeError(f"{tag} ({root}) failed:\n{res.stderr[-3000:]}")
            line = json.loads(res.stdout.strip().splitlines()[-1])
            print(f"{dtype} {tag.upper()} {root}: p50 {line['p50_ms']:.1f} ms; steps "
                  + " ".join(f"{t:.1f}" for t in line["ms"])
                  + f"; launches {line['launches']}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}")


if __name__ == "__main__":
    main()
