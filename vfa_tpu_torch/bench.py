"""End-to-end benchmark of the port: steady-state scenes per second on one
card, serving (forward + on-device decode) or training (forward + target
encoding + loss + backward + SGD). Port of the root `bench.py`'s default
path.

    python -m vfa_tpu_torch.bench                         # MultiviewC serving, auto batch
    python -m vfa_tpu_torch.bench --data MultiviewX --train
    python -m vfa_tpu_torch.bench --dtype bfloat16 --data Wildtrack   # bf16 serving
    python -m vfa_tpu_torch.bench --dtype bfloat16 --train            # bf16 training
    python -m vfa_tpu_torch.bench --dtype bfloat16 --from_disk           # the real input path
    python -m vfa_tpu_torch.bench --dtype bfloat16 --from_disk --train --batch 8
    python -m vfa_tpu_torch.bench --dtype bfloat16 --bev_shards 2 --batch 2   # 2 ranks, BEV row slabs
    python -m vfa_tpu_torch.bench --dtype bfloat16 --train --grid2x     # backbone remat forced on
    python -m vfa_tpu_torch.bench --dtype bfloat16 --no-rig --batch 1   # the reference voxel route
    python -m vfa_tpu_torch.bench --tiny --device cpu --batch 1 --iters 2 --warmup 1

Inputs are synthetic scenes (`make_scene(cfg, seed=s, num_objects=6)`)
staged on the device before timing, weights are seeded random
(`init_weights`, seed 0), the rig is built once (or loaded from the rig
cache, `rig_cli.RIG_CACHE_DIR`). Warm-up runs inside the batch fallback;
the timed loop dispatches `--iters` calls and then waits once for the
device and reads one value back. `--batch 0` tries the root bench's
(batch, backbone chunks) attempts (`bench.py:326-337`: serving 32/16/8/4/
2/1 scenes unchunked, training (8, 1), (8, 2), (4, 1), (4, 2), (2, 1),
(1, 1)) and falls back on `torch.cuda.OutOfMemoryError` only; `--chunks N`
overrides an attempt's chunks. `--remat`, `--stem_remat` and `--chunks` are
the model's memory options (`VFANet(backbone_remat=, stem_remat=,
backbone_chunks=)`); `--grid2x --train` forces `--remat` on, as the root
bench does (`bench.py:141-144`).
`--from_disk` feeds the timed loop from an on-disk JPEG frame set instead
(the root `bench.py:364-420`): written once under `--disk_dir`
(`data.disk.ensure_dataset`), decoded by the SceneLoader's threads
(`--image_backend`, `--loader_threads`) into uint8 batches (`drop_last`),
copied to the card and normalized there, with `--train` through the
train-split ColorJitter on the card (`--no_augment` skips it); the metric
name gains `_fromdisk`. `--bev_shards N` runs N ranks (`launch.run_ranks`,
the backend of `parallel.backend_for`: two ranks on one card share it
through gloo), each on its row slab of the BEV plane
(`parallel_bev.build_bev_sharded_rig`, the slabs through the rig cache)
with the halo'd fuse block and heads; it reports the first rank's
scenes/sec and the metric name gains `_bev{N}`. On one card that is the
cost of the path, not a speed-up. There is no batch fallback across ranks
(a rank out of memory would leave the others in a collective): `--batch
0` takes 2 for serving and 1 for training.

Prints ONE JSON line on stdout with `bench.py`'s keys: metric, value
(scenes/sec), unit, vs_baseline (null: the root bench divides by targets
set for a TPU, which are not the port's), tflops_per_sec and mfu (against
the card's dense bf16 peak, for a known card only), and dtype. bfloat16
serves as the root bench does: every floating parameter and buffer of the
model cast to bf16, bf16 images, a rig built in bf16 (its tile_v and A),
fp32 predictions decoded; it trains as the root bench does, in mixed
precision (fp32 master parameters cast at use, `train_lib`), with bf16
images and the bf16 rig. Everything else
(TF32 settings, the card and its power limit, each batch attempt with its
peak memory, host syncs in a warm call, FLOPs) goes to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# dense bf16 tensor-core peak, TFLOP/s (H100 SXM5 data sheet); fp32 runs are
# also reported against it, as the root bench does
PEAK_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4}
# TF32: on for cuDNN convolutions (PyTorch's default; the fp32 convolutions
# lead every step without it), off for matmuls. The rig kernels run 3xTF32
# by their own code, so neither setting touches them.
CUDNN_TF32 = True
MATMUL_TF32 = False
# (batch, backbone chunks) attempts of `--batch 0`, the root bench's
# (`bench.py:326-337`): training tries a batch unchunked, then in 2 chunks
SERVING_ATTEMPTS = ((32, 1), (16, 1), (8, 1), (4, 1), (2, 1), (1, 1))
TRAIN_ATTEMPTS = ((8, 1), (8, 2), (4, 1), (4, 2), (2, 1), (1, 1))
GRID2X_SERVING_ATTEMPTS = ((8, 1), (4, 1), (2, 1), (1, 1))
GRID2X_TRAIN_ATTEMPTS = ((4, 2), (2, 1), (2, 2), (1, 1))
STEPS_PER_EPOCH = 100          # the schedule's length, as `bench.py:217`
MAX_OBJECTS = 16               # objects a training scene is padded to
DIM_MEAN = np.array([145.0, 120.0, 255.0], np.float32)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=0, help="scenes per call (0 = auto)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype (bfloat16: the images and the rig in "
                        "bf16; serving casts the model, training keeps fp32 "
                        "master parameters, as the root bench does)")
    p.add_argument("--data", default="MultiviewC",
                   choices=["MultiviewC", "MultiviewX", "Wildtrack"])
    p.add_argument("--layout", default="window", choices=["window", "flat"],
                   help="rig band layout")
    p.add_argument("--buckets", type=int, default=0,
                   help="rig band buckets (0 = auto: 12 serving, 8 training)")
    p.add_argument("--train", action="store_true",
                   help="time training steps instead of serving calls")
    p.add_argument("--no-rig", dest="no_rig", action="store_true",
                   help="sample through the reference voxel route instead "
                        "of a compiled rig")
    p.add_argument("--grid2x", action="store_true",
                   help="halve the ground cube size (2x BEV resolution)")
    p.add_argument("--rig_impl", default="cuda", choices=["cuda", "plain"],
                   help="cuda: the hand-written rig kernels; plain: their "
                        "plain PyTorch versions")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="the shrunken test configuration")
    p.add_argument("--remat", action="store_true",
                   help="recompute each backbone block in the backward")
    p.add_argument("--stem_remat", action="store_true",
                   help="recompute the stem (conv1 + GN + ReLU + pool) in "
                        "the backward")
    p.add_argument("--chunks", type=int, default=0,
                   help="run the backbone over the B*N images in this many "
                        "recomputed chunks (0 = each attempt's own)")
    p.add_argument("--from_disk", action="store_true",
                   help="feed the timed loop from an on-disk JPEG frame set "
                        "through the SceneLoader (decode, uint8 staging, "
                        "normalization on the card) instead of inputs "
                        "staged on the device; written under --disk_dir on "
                        "first use")
    p.add_argument("--disk_dir", default=os.path.join(tempfile.gettempdir(),
                                                      "vfa_loader_bench"))
    p.add_argument("--no_augment", action="store_true",
                   help="with --train --from_disk: skip the train-split "
                        "ColorJitter on the card")
    p.add_argument("--disk_frames", type=int, default=24)
    p.add_argument("--loader_threads", type=int,
                   default=max(1, min(16, os.cpu_count() or 1)))
    p.add_argument("--image_backend", default="native",
                   choices=["native", "pil"],
                   help="decoder (native falls back to PIL, saying so, "
                        "where native/imageio.cpp cannot be built)")
    p.add_argument("--bev_shards", type=int, default=0,
                   help="shard the BEV plane into this many row slabs, one "
                        "rank each (0 = unsharded)")
    return p.parse_args(argv)


def make_inputs(cfg, bs: int, device, train: bool, dtype=torch.float32):
    """A batch of `bs` synthetic scenes as tensors on `device`: images (in
    `dtype`, `bench.py:252`), calibs, grid and, for training, the gt heatmap
    and the objects padded to MAX_OBJECTS (`bench.py:206-219`)."""
    from vfa_tpu_torch.data.synthetic import make_scene
    from vfa_tpu_torch.utils import pad_objects

    scenes = [make_scene(cfg, seed=s, num_objects=6) for s in range(bs)]
    batch = {"images": np.stack([s.images for s in scenes]),
             "calibs": np.stack([s.calibs for s in scenes]),
             "grid": scenes[0].grid}
    if train:
        objs = [pad_objects(s.objects, MAX_OBJECTS, cfg.mode) for s in scenes]
        batch["heatmap"] = np.stack([s.heatmap for s in scenes])
        for key in objs[0]:
            batch[key] = np.stack([o[key] for o in objs])
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    out["images"] = out["images"].to(dtype)
    return out


def make_runner(cfg, args, bs: int, chunks: int, rig, device):
    """A function that runs one call at batch `bs` and returns its outputs
    on the device: the decoded detections (serving) or the loss dict
    (training), the model with the memory options of `args` and
    `args.chunks or chunks or 1` backbone chunks, as the root bench's
    `model_for` (`bench.py:155-167`). Called with no argument it takes
    the images staged in its closure, else the images it is given (the
    `--from_disk` loop). Model, optimizer and inputs live in its closure
    and nowhere else, so dropping it frees them. A BEV slab rig brings its mesh (`parallel_bev.BevSlab`),
    on which the model and the train step then run."""
    from vfa_tpu_torch.codec import decode_frame
    from vfa_tpu_torch.config import TrainConfig
    from vfa_tpu_torch.model.vfanet import VFANet, cast_model, init_weights
    from vfa_tpu_torch.train_lib import make_optimizer, make_train_step

    dtype = getattr(torch, args.dtype)
    model = init_weights(
        VFANet(cfg, rig_impl=args.rig_impl, backbone_remat=args.remat,
               backbone_chunks=args.chunks or chunks or 1,
               stem_remat=args.stem_remat),
        torch.Generator().manual_seed(0)).to(device)
    model.mesh = mesh = getattr(rig, "mesh", None)
    batch = make_inputs(cfg, bs, device, args.train, dtype)
    dim_mean = DIM_MEAN if cfg.mode == "3D" else None
    if args.train:
        # mixed precision: fp32 masters, cast at use by the step
        tcfg = TrainConfig(pretrained=False, compute_dtype=args.dtype)
        step = make_train_step(model, make_optimizer(model, tcfg, STEPS_PER_EPOCH),
                               cfg, tcfg, dim_mean=dim_mean, mesh=mesh)
        return lambda images=None: step(
            batch if images is None else {**batch, "images": images}, rig)
    model = cast_model(model, dtype).eval()

    @torch.no_grad()
    def serve(images=None):
        images = batch["images"] if images is None else images
        pred = model(images, rig, batch["calibs"], batch["grid"])
        return decode_frame({k: v.float() for k, v in pred.items()}, cfg,
                            cls_thresh=0.7, topk=100, dim_mean=dim_mean)

    return serve


def finish(out, device, train: bool) -> float:
    """Wait for the device once and read one value back."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return float(out["loss"] if train else out["conf"].sum())


def warm_runner(cfg, args, bs, chunks, rig, device):
    """The runner at batch `bs` (and `chunks`, `make_runner`) after its
    first call and the warm-up (both inside the fallback: either can be the
    one that runs out of memory)."""
    run = make_runner(cfg, args, bs, chunks, rig, device)
    finish(run(), device, args.train)
    for _ in range(args.warmup):
        finish(run(), device, args.train)
    return run


def card_line(device) -> str:
    if device.type != "cuda":
        return f"# card: none ({device})"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except FileNotFoundError:
        smi = f"{torch.cuda.get_device_name(device)}, power limit not read (no nvidia-smi)"
    return f"# card: {smi}"


def count_call(run, device, train):
    """(FLOPs, host syncs, output) of one warm call: the FLOPs that
    torch.utils.flop_counter sees (the convolutions and matmuls, forward
    and backward) and every synchronising call the device reports under
    torch.cuda.set_sync_debug_mode('warn')."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with counter:
                out = run()
        finally:
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
    # one warning per synchronizing call ("called a synchronizing CUDA
    # operation"); the mode's own notice that it is a prototype is not one
    syncs = [w for w in caught if "synchronizing cuda operation" in str(w.message).lower()]
    finish(out, device, train)
    return counter.get_total_flops(), syncs, out


def call_flops(counted: int, rig, bs: int, train: bool, device, rig_impl: str) -> int:
    """The FLOPs of one call: the counter's, plus the builder's count of the
    rig products when the CUDA rig kernels ran. They launch through ctypes,
    unseen by the counter; on the CPU (and with rig_impl 'plain') the plain
    rig's matmuls are torch ops that the counter already sees."""
    if rig is not None and device.type == "cuda" and rig_impl == "cuda":
        from vfa_tpu_torch.ops.rig import rig_matmul_flops

        return counted + bs * rig_matmul_flops(rig, train=train)
    return counted


def _bf16(sr) -> bool:
    return sr.A[0].dtype == torch.bfloat16


def launch_vox_elems(sr, bs: int) -> int:
    """Elements of the largest vox scratch that one forward launch on scale
    `sr` allocates at batch `bs`: (N, B, T, nl*tile_v, C) of a bucket, or
    summed over the scale's buckets for the bf16 forwards, which run once a
    scale (`ops/rig_cuda._fwd_bf16`)."""
    per = [a[..., 0].numel() * bs * 256 for a in sr.A]
    return sum(per) if _bf16(sr) else max(per)


def vox_scratch_line(rig, bs: int, train: bool = False) -> str:
    """The largest vox scratch one rig kernel launch allocates at batch
    `bs`, in A's dtype (`launch_vox_elems`), beside the largest bucket's;
    with `train` on a bf16 rig also the largest fp32 dII scratch of one
    backward launch ((N, B, T, nl or 1, band, C) of a bucket: nl only for
    a window bucket that JAX's backward runs serially)."""
    elems, size = max((launch_vox_elems(sr, bs), sr.A[0].element_size())
                      for sr in rig.scales)
    bucket = max(a[..., 0].numel() * bs * 256 for sr in rig.scales for a in sr.A)
    line = (f"largest vox scratch of one kernel launch at batch {bs}: {elems} "
            f"elements, {elems * size} bytes (largest bucket's: {bucket} "
            f"elements, {bucket * size} bytes)")
    if train and any(_bf16(sr) for sr in rig.scales):
        from vfa_tpu_torch.ops.rig import window_bwd_serial

        dii = max(N * bs * T * K * 256
                  * (sr.nl if sr.window_hw
                     and window_bwd_serial(bs, K, R, 2, 2, 256) else 1)
                  for sr in rig.scales if _bf16(sr)
                  for N, T, R, K in (a.shape for a in sr.A))
        line += f"; largest dII scratch of one backward launch: {dii * 4} bytes"
    return line


def disk_loop(cfg, args, bs: int, run, device) -> float:
    """Seconds per call of `args.iters` calls fed from disk (the root
    `bench.py:364-420`): a JPEG frame set written once under
    `--disk_dir`, decoded by the SceneLoader's threads into uint8 batches
    (drop_last, so at least one full batch of frames), each batch copied to
    the card and normalized there (with `--train`, also jittered there,
    factors from `sample_jitter_params` with seed 0) and handed to `run`.
    Decode runs ahead on the loader's threads while the card works; one
    pass over the loader warms the page cache and the staging ring first."""
    from vfa_tpu_torch.data.augment import sample_jitter_params
    from vfa_tpu_torch.data.disk import DiskFrames, ensure_dataset
    from vfa_tpu_torch.data.frame_dataset import SceneLoader
    from vfa_tpu_torch.native.imageio import decoder_backend
    from vfa_tpu_torch.train_lib import stage_images

    n_frames = max(args.disk_frames, bs)
    fpaths = ensure_dataset(os.path.join(args.disk_dir, args.data), n_frames,
                            cfg.num_cam, cfg.resize_size, quality=90)
    ds = DiskFrames(cfg, fpaths, n_frames, args.image_backend)
    loader = SceneLoader(ds, batch_size=bs, shuffle=False,
                         num_threads=args.loader_threads, max_objects=8,
                         drop_last=True, images_dtype=np.uint8)
    jitter = args.train and not args.no_augment
    log(f"# from disk: {n_frames} frames x {cfg.num_cam} cameras under "
        f"{args.disk_dir}, decoder {decoder_backend(args.image_backend)}, "
        f"{args.loader_threads} loader threads, uint8 staging, ColorJitter "
        f"{'on the card' if jitter else 'off'}")
    aug_rng = np.random.default_rng(0)
    dtype = getattr(torch, args.dtype)

    def stage(x):
        params = sample_jitter_params(aug_rng, x.shape[0] * x.shape[1]) if jitter else None
        return stage_images(x, device, dtype, params)

    imgs = None
    for nb in loader:
        imgs = stage(nb["images"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    del imgs
    done, out = 0, None
    t0 = time.perf_counter()
    while done < args.iters:
        for nb in loader:
            out = run(stage(nb["images"]))
            done += 1
            if done >= args.iters:
                break
    finish(out, device, args.train)
    return (time.perf_counter() - t0) / args.iters


def bench_config(args):
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import tiny_config

    cfg = get_config(args.data)
    if args.grid2x:
        l, w, h = cfg.cube_size
        cfg = dataclasses.replace(cfg, cube_size=(l // 2, w // 2, h))
        log(f"# grid2x: BEV grid {cfg.grid_shape}")
    if args.tiny:
        cfg = tiny_config(cfg)
    return cfg


def main(argv=None, rig=None) -> dict:
    """Run the bench and print its JSON line; returns the printed dict.
    `rig` is an already built CameraRig for this configuration (built, or
    loaded from the rig cache, when None; not taken with --bev_shards,
    whose ranks build their slabs)."""
    args = parse_args(argv)
    if args.bev_shards:
        result = bev_main(argv, args)
    else:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is available")
        result = run(args, rig, device)
    print(json.dumps(result), flush=True)
    return result


def bev_main(argv, args) -> dict:
    """--bev_shards N: N ranks of `_bev_rank`, their logs on stderr; the
    first rank's result."""
    from vfa_tpu_torch.launch import run_ranks

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    if args.from_disk:
        # written once here, before the ranks read it
        from vfa_tpu_torch.data.disk import ensure_dataset

        cfg = bench_config(args)
        ensure_dataset(os.path.join(args.disk_dir, args.data),
                       max(args.disk_frames, bev_batch(args)), cfg.num_cam,
                       cfg.resize_size, quality=90)
    ranks = run_ranks("vfa_tpu_torch.bench:_bev_rank", args.bev_shards,
                      args=(list(argv) if argv is not None else sys.argv[1:],),
                      device=args.device,
                      threads=max(1, (os.cpu_count() or 1) // args.bev_shards),
                      timeout=3000)
    for r, res in enumerate(ranks):
        log(f"# rank {r}:\n" + res["log"].rstrip())
        log(f"# rank {r} kernel launches: {json.dumps(res['result']['launches'])}")
    return ranks[0]["result"]["result"]


def bev_batch(args) -> int:
    return args.batch or (1 if args.train else 2)


def _bev_rank(device, argv) -> dict:
    """One rank of --bev_shards: its slab of the BEV-sharded rig (built on
    the host through the rig cache), then `run` on a (data 1, bev N)
    mesh."""
    from vfa_tpu_torch.data.synthetic import make_calibrations
    from vfa_tpu_torch.geometry import make_grid
    from vfa_tpu_torch.ops.rig import default_tile_v, pyramid_feat_shapes
    from vfa_tpu_torch.parallel_bev import build_bev_sharded_rig, make_bev_mesh
    from vfa_tpu_torch.rig_cli import RIG_CACHE_DIR

    args = parse_args(argv)
    args.batch = bev_batch(args)
    cfg = bench_config(args)
    mesh = make_bev_mesh(data=1, bev=args.bev_shards)
    dtype = getattr(torch, args.dtype)
    buckets = args.buckets or (12 if (args.grid2x or not args.train) else 8)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        srig = build_bev_sharded_rig(
            make_calibrations(cfg), cfg,
            make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
            pyramid_feat_shapes(cfg.resize_size), num_shards=args.bev_shards,
            tile_v=default_tile_v(cfg.num_layers, dtype), dtype=dtype,
            band_buckets=buckets,
            cache_dir=os.path.expanduser(RIG_CACHE_DIR)).slab(mesh, device)
    log(f"# BEV-sharded rig: {args.bev_shards} slabs of {srig.slab_rows} rows, "
        f"{buckets} buckets, this rank's slab {srig.rows.index} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    from vfa_tpu_torch.kernels import launch_counts

    return {"result": run(args, srig, device), "launches": launch_counts()}


def run(args, rig, device) -> dict:
    """The bench on `device` (rig: a CameraRig, a BEV slab, or None to
    build one); returns the result dict."""
    from vfa_tpu_torch.data.synthetic import make_calibrations
    from vfa_tpu_torch.rig_cli import RIG_CACHE_DIR, build_cli_rig

    torch.backends.cudnn.allow_tf32 = CUDNN_TF32
    torch.backends.cuda.matmul.allow_tf32 = MATMUL_TF32
    log(f"# TF32: torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    log(card_line(device))

    cfg = bench_config(args)
    if args.grid2x and args.train and not args.remat:
        args.remat = True
        log("# grid2x train: backbone remat forced on")
    buckets = args.buckets or (12 if (args.grid2x or not args.train) else 8)
    if args.no_rig:
        rig = None
        log("# sampling: the reference voxel route (no rig)")
    elif rig is None:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            rig = build_cli_rig(cfg, make_calibrations(cfg), device,
                                buckets=buckets, layout=args.layout,
                                cache_dir=RIG_CACHE_DIR,
                                dtype=getattr(torch, args.dtype))
        log(f"# rig build: {time.perf_counter() - t0:.1f} s")
    else:
        log(f"# rig: given by the caller, {[len(s.A) for s in rig.scales]} "
            "buckets per scale")

    if args.batch:
        attempts = ((args.batch, 0),)
    elif args.grid2x:
        attempts = GRID2X_TRAIN_ATTEMPTS if args.train else GRID2X_SERVING_ATTEMPTS
    else:
        attempts = TRAIN_ATTEMPTS if args.train else SERVING_ATTEMPTS
    log(f"# memory options: remat {args.remat}, stem_remat {args.stem_remat}, "
        f"chunks {args.chunks or 'per attempt'}")
    runner = None
    for i, (bs, chunks) in enumerate(attempts):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        try:
            runner = warm_runner(cfg, args, bs, chunks, rig, device)
            outcome = "ok"
        except torch.cuda.OutOfMemoryError as e:
            outcome = f"out of memory ({str(e).splitlines()[0][:160]})"
            if i == len(attempts) - 1:
                log(f"# batch {bs}: {outcome}; chunks {args.chunks or chunks or 1}")
                raise
        peak = (f"{torch.cuda.max_memory_allocated(device)} bytes"
                if device.type == "cuda" else "not measured (no card)")
        log(f"# batch {bs}: {outcome}; chunks {args.chunks or chunks or 1}; "
            f"max_memory_allocated {peak}")
        if runner is not None:
            break
        # the failed attempt's model, inputs and outputs died with its
        # frames; collect them before the next attempt asks for memory
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    if args.from_disk:
        t = disk_loop(cfg, args, bs, runner, device)
    else:
        t0 = time.perf_counter()
        out = None
        for _ in range(args.iters):
            out = runner()
        finish(out, device, args.train)
        t = (time.perf_counter() - t0) / args.iters

    counted, syncs, _ = count_call(runner, device, args.train)
    flops = call_flops(counted, rig, bs, args.train, device, args.rig_impl)
    log(f"# host syncs in one warm call: {len(syncs)}"
        + "".join(f"\n#   {w.filename}:{w.lineno}: {w.message}" for w in syncs[:5]))

    if rig is not None:
        log(f"# {vox_scratch_line(rig, bs, args.train)}")
    scenes_per_sec = bs / t
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    log(f"# batch={bs} p50={t / bs * 1e3:.2f} ms/scene over {args.iters} iters "
        f"(dtype={args.dtype}, device={kind}, chunks={args.chunks or chunks or 1})")
    tflops_s = flops / t / 1e12
    peak = PEAK_BF16_TFLOPS.get(kind)
    log(f"# {flops / 1e9:.1f} GFLOP/call -> {tflops_s:.2f} TFLOP/s"
        + (f" = {tflops_s / peak * 100:.2f}% of {kind}'s dense bf16 peak "
           f"({peak} TFLOP/s)" if peak else "")
        + (" (this rank's: its slab's rig products)" if args.bev_shards else ""))
    g2x = "_grid2x" if args.grid2x else ""
    if args.bev_shards:
        g2x += f"_bev{args.bev_shards}"
    if args.from_disk:
        g2x += "_fromdisk"
    mode = "_train" if args.train else ""
    result = {
        "metric": f"{args.data.lower()}_{cfg.num_cam}cam{mode}{g2x}"
                  "_scenes_per_sec_per_chip",
        "value": round(scenes_per_sec, 3),
        "unit": "scenes/sec",
        "vs_baseline": None,
        "tflops_per_sec": round(tflops_s, 2),
        "dtype": args.dtype,
    }
    if peak:
        result["mfu"] = round(tflops_s / peak, 4)
    return result


if __name__ == "__main__":
    main()
