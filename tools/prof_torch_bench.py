"""Where one steady-state call of the port's bench spends its device time.

Builds the bench's runner (`vfa_tpu_torch.bench.make_runner`: seeded
weights, synthetic scenes staged on the card, the rig built or loaded from
the rig cache) at one batch, warms it up, then traces two calls with
torch.profiler and prints the device time by kernel, the rig kernels'
share, the device busy share of the traced wall time, and the card's name
and power limit. Serving by default; the bench's flags select the rest.

    python tools/prof_torch_bench.py --data MultiviewC --dtype bfloat16 --batch 32
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = 25
CALLS = 2


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from vfa_tpu_torch import bench
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import make_calibrations
    from vfa_tpu_torch.rig_cli import RIG_CACHE_DIR, build_cli_rig

    args = bench.parse_args(argv)
    if not args.batch:
        raise SystemExit("give --batch: the profile runs one batch")
    device = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = bench.CUDNN_TF32
    torch.backends.cuda.matmul.allow_tf32 = bench.MATMUL_TF32
    cfg = get_config(args.data)
    with contextlib.redirect_stdout(sys.stderr):
        rig = build_cli_rig(cfg, make_calibrations(cfg), device,
                            buckets=args.buckets or (8 if args.train else 12),
                            layout=args.layout, cache_dir=RIG_CACHE_DIR,
                            dtype=getattr(torch, args.dtype))
    run = bench.warm_runner(cfg, args, args.batch, 0, rig, device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            out = run()
        bench.finish(out, device, args.train)
        wall = (time.perf_counter() - t0) * 1e3
    # the kernels themselves (device events), as prof_train counts them
    kernels = sorted((e for e in prof.key_averages() if e.device_time_total > 0
                      and e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in kernels) / 1e3
    rig_ms = sum(e.device_time_total for e in kernels
                 if "rig_" in e.key and "_mma" in e.key) / 1e3
    print(f"{args.data} {'training' if args.train else 'serving'}, dtype "
          f"{args.dtype}, batch {args.batch}, {CALLS} calls traced: device time "
          f"{total:.3f} ms in {wall:.3f} ms of wall time (device busy "
          f"{total / wall:.1%}); per call {total / CALLS:.3f} ms, per scene "
          f"{total / CALLS / args.batch:.3f} ms; rig kernels {rig_ms:.3f} ms "
          f"({rig_ms / total:.1%})")
    for e in kernels[:ROWS]:
        ms = e.device_time_total / 1e3
        print(f"  {ms:10.3f} ms {ms / total:6.1%} x{e.count:<5d} {e.key[:110]}")
    print(f"card: {bench.card_line(device)[len('# card: '):]}")


if __name__ == "__main__":
    main()
