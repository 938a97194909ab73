"""Where one serving request of the PyTorch/CUDA port spends its time.

Runs the full-width MultiviewC fp32 path of `vfa_tpu_torch.predict` (7 x
720x1280 cameras, window rig with 12 buckets, batch 2, random seeded
weights, TF32 off as in chip_smoke.py) on one GPU, warms up, then traces
two requests with torch.profiler and prints the device time by kernel, the
device busy share of the traced wall time, the host wall time per request
and the card's name and power limit.

    python tools/prof_torch_predict.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


BATCH = 2
ROWS = 25


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    from vfa_tpu_torch.codec import ObjectEncoder
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import make_scene
    from vfa_tpu_torch.geometry import make_grid
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights
    from vfa_tpu_torch.ops.rig import build_rig, pyramid_feat_shapes

    dev = torch.device("cuda")
    cfg = get_config("MultiviewC")
    scenes = [make_scene(cfg, seed=i, num_objects=6) for i in range(BATCH)]
    rig = build_rig(scenes[0].calibs, cfg,
                    make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
                    pyramid_feat_shapes(cfg.resize_size), tile_v=64,
                    band_buckets=12, device=dev)
    model = init_weights(VFANet(cfg), torch.Generator().manual_seed(0)).to(dev).eval()
    enc = ObjectEncoder(cfg, dim_mean=[145.0, 120.0, 255.0])
    images = np.stack([s.images for s in scenes])

    def request():
        with torch.no_grad():
            pred = model(torch.from_numpy(images).to(dev), rig)
            enc.batch_decode(pred, 0.5)
        torch.cuda.synchronize()

    for _ in range(2):
        request()
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_trace = time.perf_counter()
        for _ in range(2):
            t0 = time.perf_counter()
            request()
            walls.append((time.perf_counter() - t0) * 1e3)
        t_trace = (time.perf_counter() - t_trace) * 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    total_dev = sum(e.device_time_total for e in events) / 1e3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card.splitlines()[0]}")
    print(f"host wall ms per request (batch {BATCH}): "
          + " ".join(f"{w:.2f}" for w in walls))
    print(f"device kernel time {total_dev:.2f} ms over {t_trace:.2f} ms traced "
          f"(busy share {total_dev / t_trace:.3f}; kernels may overlap copies)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:ROWS]:
        print(f"  {e.device_time_total / 1e3 / 2:9.3f} ms/request  "
              f"{e.count // 2:5d} calls/request  {e.key[:90]}")


if __name__ == "__main__":
    main()
