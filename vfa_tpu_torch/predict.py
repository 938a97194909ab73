"""Multi-scene inference CLI of the port (mirrors `predict.py`, without the
figure).

Builds the compiled camera rig once on the host (window layout by default,
`--rig_layout flat` for the flat one; 12 buckets, fp32), runs VFANet
through the hand-written rig kernel of that layout, decodes the
detections, and reports the time per request (one request = one batch of
scenes, timed from host input to decoded detections on the host).

    python -m vfa_tpu_torch.predict --data MultiviewC --synthetic --scenes 4 --batch 2
    python -m vfa_tpu_torch.predict --data MultiviewC --synthetic --rig_layout flat
    python -m vfa_tpu_torch.predict --data MultiviewC --synthetic --tiny --device cpu
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
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic scenes from --seed (on-disk data is not "
                        "ported yet)")
    p.add_argument("--tiny", action="store_true",
                   help="the shrunken test configuration")
    p.add_argument("--scenes", type=int, default=4)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0,
                   help="scene i uses seed + i; weights use seed")
    p.add_argument("--cls_thresh", type=float, default=0.9)
    p.add_argument("--device", default="cuda")
    p.add_argument("--rig_impl", default="cuda", choices=["cuda", "plain"],
                   help="cuda: the hand-written rig kernel; plain: its "
                        "plain PyTorch version")
    add_rig_layout_arg(p)
    return p.parse_args(argv)


def main(argv=None, rig=None) -> dict:
    """Run the CLI; returns the predictions and timings for callers. `rig`
    is an already built CameraRig for this configuration (built here when
    None)."""
    args = parse_args(argv)
    from vfa_tpu_torch.codec import ObjectEncoder
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import make_scene, tiny_config
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights
    from vfa_tpu_torch.rig_cli import build_cli_rig

    if not args.synthetic:
        raise NotImplementedError(
            "on-disk datasets are not ported yet; pass --synthetic")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    cfg = get_config(args.data)
    if args.tiny:
        cfg = tiny_config(cfg)
    dim_mean = np.array([145.0, 120.0, 255.0], np.float32)
    scenes = [make_scene(cfg, seed=args.seed + i, num_objects=6)
              for i in range(args.scenes)]

    if rig is None:
        rig = build_cli_rig(cfg, scenes[0].calibs, device,
                            layout=args.rig_layout)

    gen = torch.Generator().manual_seed(args.seed)
    model = init_weights(VFANet(cfg, rig_impl=args.rig_impl), gen)
    model = model.to(device).eval()
    print(f"WARNING: predicting with random weights (seed {args.seed})")
    encoder = ObjectEncoder(cfg, dim_mean=dim_mean)

    heatmaps, detections, times = [], [], []
    with torch.no_grad():
        for i in range(0, len(scenes), args.batch):
            batch = scenes[i:i + args.batch]
            images = np.stack([s.images for s in batch])
            t0 = time.perf_counter()
            pred = model(torch.from_numpy(images).to(device), rig)
            dets = encoder.batch_decode(pred, args.cls_thresh)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
            heatmaps.append(pred["heatmap"].cpu())
            detections.extend(dets)
            for j, objs in enumerate(dets):
                print(f"scene {i + j}: {len(objs)} detections above conf "
                      f"{args.cls_thresh}")
                for o in objs[:3]:
                    print("  ", {f: np.round(np.asarray(getattr(o, f), np.float64), 2).tolist()
                                 for f in o._fields
                                 if f != "classname" and getattr(o, f) is not None})
    print(f"requests {len(times)} (batch {args.batch}): ms per request "
          + " ".join(f"{t:.2f}" for t in times)
          + f"; p50 {float(np.median(times)):.2f} ms")
    return {"heatmaps": heatmaps, "detections": detections, "ms": times}


if __name__ == "__main__":
    main()
