"""Inference CLI of the port (mirrors `predict.py`).

On disk (`--root`): loads one validation scene (`--index`) of a dataset
through `data.frame_dataset.FrameDataset`, restores a checkpoint of the
train CLI (`--checkpoint`), decodes the detections at `--cls_thresh` and
writes the BEV heatmap with every camera's gt (green) and predicted (red)
boxes to `--out` (`visualization.figure.save_prediction_figure`; where
matplotlib is not installed it says so and writes nothing). With
`--synthetic` it times requests instead: one request = one batch of
synthetic scenes, timed from host input to decoded detections on the
host. Either way it builds the compiled camera rig once on the host, or
loads it from the rig cache (window layout by default, `--rig_layout flat`
for the flat one; 12 buckets or `--rig_buckets`, in the compute dtype),
and runs VFANet through the hand-written rig kernel of that layout
(`--no_rig`: through the reference voxel route instead). `--arch mvdet`
serves MVDet (`model/mvdet.py`) on the synthetic path instead: seeded
weights, the cameras' ground-plane sampling positions made once, and its
own decode (`codec.decode_map`).

    python -m vfa_tpu_torch.predict --data MultiviewC --root data/MultiviewC --checkpoint <run>/checkpoints/epoch_0040 --out prediction.png
    python -m vfa_tpu_torch.predict --data MultiviewC --synthetic --scenes 4 --batch 2
    python -m vfa_tpu_torch.predict --data MultiviewC --synthetic --rig_layout flat
    python -m vfa_tpu_torch.predict --data Wildtrack --synthetic --dtype bfloat16
    python -m vfa_tpu_torch.predict --data MultiviewC --synthetic --tiny --device cpu
    python -m vfa_tpu_torch.predict --data Wildtrack --synthetic --arch mvdet --dtype bfloat16 --batch 32 --scenes 64
"""

from __future__ import annotations

import argparse
import time
from collections import namedtuple

import numpy as np
import torch

from vfa_tpu_torch.rig_cli import add_rig_layout_arg

# Each architecture's decode defaults: VFANet's threshold on its sigmoid
# scores; MVDet's on its raw scores and upstream's suppression distance
# (world-grid units: 0.5 m on Wildtrack).
DECODE = {"vfanet": {"cls_thresh": 0.9}, "mvdet": {"cls_thresh": 0.4, "nms_dist": 20.0}}

MapDetection = namedtuple("MapDetection", "conf location")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True,
                   choices=["MultiviewC", "MultiviewX", "Wildtrack"])
    p.add_argument("--root", type=str, default=None,
                   help="dataset root on disk (default: the config's)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a checkpoint directory of the train CLI "
                        "(<run>/checkpoints/epoch_NNNN); random weights "
                        "from --seed when not given")
    p.add_argument("--index", type=int, default=0,
                   help="the validation scene to predict (on disk)")
    p.add_argument("--out", type=str, default="prediction.png",
                   help="where the figure is written (on disk)")
    p.add_argument("--synthetic", action="store_true",
                   help="time requests on synthetic scenes from --seed "
                        "instead of predicting a scene on disk")
    p.add_argument("--tiny", action="store_true",
                   help="the shrunken test configuration")
    p.add_argument("--scenes", type=int, default=4)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0,
                   help="scene i uses seed + i; weights use seed")
    p.add_argument("--arch", default="vfanet", choices=["vfanet", "mvdet"],
                   help="the model: VFANet, or MVDet (Wildtrack and "
                        "MultiviewX, --synthetic only)")
    p.add_argument("--cls_thresh", type=float, default=None,
                   help="detection threshold (default: the architecture's, "
                        "DECODE)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype; bfloat16 serves as the root bench "
                        "does: model, images and rig in bf16, the "
                        "predictions decoded in fp32")
    p.add_argument("--device", default="cuda")
    p.add_argument("--rig_impl", default="cuda", choices=["cuda", "plain"],
                   help="cuda: the hand-written rig kernel; plain: its "
                        "plain PyTorch version")
    p.add_argument("--no_rig", action="store_true",
                   help="sample through the reference voxel route from the "
                        "calibrations instead of a compiled rig")
    p.add_argument("--rig_buckets", type=int, default=None,
                   help="max window buckets of the rig (default: the "
                        "inference policy of rig_cli, 12)")
    add_rig_layout_arg(p)
    return p.parse_args(argv)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    return device


def _model(cfg, args, device, dtype):
    """VFANet with seeded random weights, or the weights of
    `--checkpoint`, cast to the compute dtype, in eval mode."""
    from vfa_tpu_torch.model.vfanet import VFANet, cast_model, init_weights

    gen = torch.Generator().manual_seed(args.seed)
    model = init_weights(VFANet(cfg, rig_impl=args.rig_impl), gen)
    if args.checkpoint:
        from vfa_tpu_torch.checkpoint import restore_checkpoint

        epoch = restore_checkpoint(args.checkpoint, model)
        print(f"restored {args.checkpoint} (epoch {epoch})")
    else:
        print(f"WARNING: predicting with random weights (seed {args.seed})")
    return cast_model(model.to(device), dtype).eval()


def _print_objects(objs, limit):
    for o in objs[:limit]:
        print("  ", {f: np.round(np.asarray(getattr(o, f), np.float64), 2).tolist()
                     for f in o._fields
                     if f != "classname" and getattr(o, f) is not None})


def main(argv=None, rig=None) -> dict:
    """Run the CLI; returns the heatmaps (sigmoid-free logits, fp32, on
    the host), the detections and the ms per request for callers, and on
    disk the figure's path (None when it was not written). `rig` is an
    already built CameraRig for this configuration (built here when
    None)."""
    args = parse_args(argv)
    if args.cls_thresh is None:
        args.cls_thresh = DECODE[args.arch]["cls_thresh"]
    if args.arch == "mvdet" and not args.synthetic:
        raise SystemExit("--arch mvdet serves synthetic scenes only (--synthetic)")
    if args.synthetic:
        return _synthetic(args, rig)
    return _on_disk(args, rig)


def _rig(args, cfg, calibs, device, dtype, rig):
    from vfa_tpu_torch.rig_cli import RIG_CACHE_DIR, build_cli_rig

    if args.no_rig:
        return None
    if rig is not None:
        return rig
    return build_cli_rig(cfg, calibs, device, buckets=args.rig_buckets,
                         layout=args.rig_layout, cache_dir=RIG_CACHE_DIR,
                         dtype=dtype)


def _on_disk(args, rig) -> dict:
    """One validation scene on disk, as the root `predict.py:64-123`."""
    import dataclasses

    from vfa_tpu_torch.codec import ObjectEncoder
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.adapters import ADAPTERS
    from vfa_tpu_torch.data.frame_dataset import FrameDataset
    from vfa_tpu_torch.data.synthetic import tiny_config
    from vfa_tpu_torch.visualization.figure import (
        matplotlib_available, save_prediction_figure,
    )

    device = _device(args.device)
    dtype = getattr(torch, args.dtype)
    cfg = get_config(args.data)
    if args.root:
        cfg = dataclasses.replace(cfg, root=args.root)
    if args.tiny:
        cfg = tiny_config(cfg)
    base = ADAPTERS[cfg.name](cfg.root, world_size=cfg.world_size,
                              cube_LWH=cfg.cube_size)
    ds = FrameDataset(base, cfg, split="val")
    item = ds[args.index]
    images, calibs, grid = item["images"], item["calibs"], item["grid"]
    dim_mean = (ds.dim_mean if ds.dim_mean is not None
                else np.array([145.0, 120.0, 255.0], np.float32))
    rig = _rig(args, cfg, calibs, device, dtype, rig)
    model = _model(cfg, args, device, dtype)
    encoder = ObjectEncoder(cfg, dim_mean=dim_mean)
    t0 = time.perf_counter()
    with torch.no_grad():
        pred = model(torch.from_numpy(images[None]).to(device).to(dtype), rig,
                     torch.from_numpy(np.asarray(calibs)[None]).to(device),
                     torch.from_numpy(grid).to(device))
        pred = {k: v.float() for k, v in pred.items()}
        dets = encoder.batch_decode(pred, args.cls_thresh)[0]
    ms = (time.perf_counter() - t0) * 1e3
    print(f"frame {item['frame']} (val index {args.index}): {len(dets)} "
          f"detections above conf {args.cls_thresh}, {ms:.2f} ms")
    _print_objects(dets, 10)
    heatmap = pred["heatmap"].cpu()
    figure = None
    if matplotlib_available():
        save_prediction_figure(args.out, images, calibs,
                               torch.sigmoid(heatmap[0, 0]).numpy(), dets,
                               item["objects"], cfg)
        figure = args.out
        print(f"wrote {args.out}")
    else:
        print("figure not written: matplotlib is not installed")
    return {"heatmaps": [heatmap], "detections": [dets], "ms": [ms],
            "figure": figure}


def _synthetic(args, rig) -> dict:
    """Requests of synthetic scenes through `--arch`'s model and decode,
    timed."""
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import make_scene, tiny_config

    device = _device(args.device)
    cfg = get_config(args.data)
    dtype = getattr(torch, args.dtype)
    if args.tiny:
        cfg = tiny_config(cfg)
    scenes = [make_scene(cfg, seed=args.seed + i, num_objects=6)
              for i in range(args.scenes)]
    server = _serve_mvdet if args.arch == "mvdet" else _serve_vfanet
    serve = server(args, cfg, scenes[0], device, dtype, rig)

    heatmaps, detections, times = [], [], []
    with torch.no_grad():
        for i in range(0, len(scenes), args.batch):
            batch = scenes[i:i + args.batch]
            images = np.stack([s.images for s in batch])
            calibs = np.stack([s.calibs for s in batch])
            t0 = time.perf_counter()
            heatmap, dets = serve(torch.from_numpy(images).to(device).to(dtype),
                                  torch.from_numpy(calibs).to(device))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
            heatmaps.append(heatmap.cpu())
            detections.extend(dets)
            for j, objs in enumerate(dets):
                print(f"scene {i + j}: {len(objs)} detections above conf "
                      f"{args.cls_thresh}")
                _print_objects(objs, 3)
    print(f"requests {len(times)} (batch {args.batch}): ms per request "
          + " ".join(f"{t:.2f}" for t in times)
          + f"; p50 {float(np.median(times)):.2f} ms")
    return {"heatmaps": heatmaps, "detections": detections, "ms": times}


def _serve_vfanet(args, cfg, scene, device, dtype, rig):
    """serve(images, calibs) -> (the fp32 heatmap, the detections of each
    scene): VFANet through the rig, then `ObjectEncoder`'s decode."""
    from vfa_tpu_torch.codec import ObjectEncoder

    rig = _rig(args, cfg, scene.calibs, device, dtype, rig)
    grid = torch.from_numpy(scene.grid).to(device)
    model = _model(cfg, args, device, dtype)
    encoder = ObjectEncoder(cfg, dim_mean=np.array([145.0, 120.0, 255.0], np.float32))

    def serve(images, calibs):
        pred = {k: v.float() for k, v in model(images, rig, calibs, grid).items()}
        return pred["heatmap"], encoder.batch_decode(pred, args.cls_thresh)

    return serve


def _serve_mvdet(args, cfg, scene, device, dtype, rig):
    """serve(images, calibs) -> (the fp32 heatmap, the detections of each
    scene): MVDet on seeded weights at the cameras' ground-plane sampling
    positions, made once (the calibrations are the scenes' own), then
    `codec.decode_map` at `DECODE["mvdet"]`'s distance."""
    from vfa_tpu_torch.codec import decode_map
    from vfa_tpu_torch.geometry import ground_positions
    from vfa_tpu_torch.model.mvdet import MVDet, init_weights

    if cfg.mode != "2D":
        raise SystemExit("--arch mvdet: a 2D dataset (Wildtrack, MultiviewX)")
    model = init_weights(MVDet(cfg), torch.Generator().manual_seed(args.seed))
    model = model.to(device=device, dtype=dtype).eval()
    print(f"WARNING: predicting with random weights (seed {args.seed})")
    positions = ground_positions(scene.calibs, scene.grid, cfg.name, cfg.image_size,
                                 model.upsample_shape).to(device)
    cells = torch.from_numpy(np.ascontiguousarray(scene.grid[..., :2])).to(device)
    dec = DECODE["mvdet"]

    def serve(images, calibs):  # every scene shares the first's calibrations
        heatmap = model(images, positions)["heatmap"]
        det = {k: v.cpu() for k, v in decode_map(heatmap, cells, args.cls_thresh,
                                                  dec["nms_dist"]).items()}
        return heatmap.float(), [
            [MapDetection(float(c), loc.tolist())
             for c, loc in zip(det["conf"][j][keep], det["location"][j][keep])]
            for j, keep in enumerate(det["valid"])]

    return serve


if __name__ == "__main__":
    main()
