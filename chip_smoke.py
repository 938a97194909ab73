"""Chip smoke test of the PyTorch/CUDA port (vfa_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):
  1. build every hand-written kernel from csrc/ with nvcc (one process per
     source, all started together) and print ptxas' registers and spills
     per kernel (fails if a tensor-core pass, `rig_*_mma` or a pass
     `rig_ws*` of csrc/rig_ws.cuh, a stem kernel `stem_bwd_*`,
     `voxel_tap_bwd_kernel`, the serving epilogue or `mvdet_project_kernel`
     spills);
  2. hold each kernel against its plain PyTorch version at B = 1 and B = 2
     on the full MultiviewC fp32 rigs (7 x 720x1280 cameras, 156x156 BEV,
     nl 5), all 3 scales, every bucket (the forwards bucket by bucket): the
     window forward on the 12-bucket (serving) and the 8-bucket (training)
     rig, the window backward (dII and dKr, all buckets of a scale through
     one dII) on the 8-bucket rig, the flat forward and backward on the
     8-bucket flat rig (tile_v 160) and on a small 16-tap rig (cumsum'd
     features); all rig kernels run 3xTF32 on the tensor cores; and the two
     stem backward kernels at (14, 64, 360, 640), also on an integer-valued
     input where ties decide (stem_bwd_stats twice: the same bits), and
     their recomputed fp32 z equal to the forward's on every element (F3);
  3. drive the serving path, `python -m vfa_tpu_torch.predict` at full
     width with random seeded weights, once per rig layout, with every
     kernel's launch count set to 0 just before and read just after; then
     the same requests through the plain rig version, and compare heatmaps
     and decoded detections;
  4. drive the training path, `python -m vfa_tpu_torch.train` at full width
     (batch 2, 3 optimizer steps, then the validation loss), once through
     the window kernels and once through the flat kernels with the fused
     stem on, counts set to 0 before and read after; then the same run
     through the plain versions under autograd (unfused stem), and compare
     per-step losses and final parameters; then one step at batch 1;
  5. drive the bench, `python -m vfa_tpu_torch.bench`, counts set to 0
     just before each run and read just after: MultiviewC serving with the
     auto batch (each attempt's peak memory on stderr) on the 12-bucket
     rig; the first full-width runs of the 2D configs: MultiviewX (6 x
     720x1280, 160x250 BEV, nl 8) on one 8-bucket window rig, serving and
     training at batch 2, with K1 held against its plain version at B = 1,
     2 and 8 (the vox scratch past 2^31 elements) and K2 at B = 1, 2, and
     the rig's BEV features against the reference voxel route (rig=None)
     at batch 1; Wildtrack (7 x 720x1280, 120x360 BEV, nl 8) on one
     12-bucket window rig, K1 against its plain version and serving at
     batch 2. Their rigs are built on the host by processes started at
     the beginning (into a temporary rig cache, loaded from it here);
  5b. bf16 serving, the root bench's default dtype, through the bf16
     variants of the two forward kernels (`rig_window_fwd_bf16`,
     `rig_flat_fwd_bf16`, each one launch per scale over all its buckets on
     the warp-specialised TMA + wgmma tile of csrc/rig_ws.cuh): each held
     against its plain version (max abs err within 1e-2 of the plain max,
     rel-L2 4e-3) on every bucket of the full bf16 MultiviewC window rig
     (12-bucket policy, tile_v 160, R = 800) and of the flat rig cast to
     bf16 (bands 8 (mod 16) and 8-pixel buckets among them), at B = 1, 2,
     and of the bf16 MultiviewX (B = 1, 2, 8: the vox scratch past 2^31
     elements) and Wildtrack rigs; the serving CLI with `--dtype bfloat16`
     on both layouts (one bf16 launch per scale per request, no fp32 rig
     kernel;
     heatmap rel-L2 1e-2 against the plain route, the detections' overlap
     printed); the bench with `--dtype bfloat16`, auto batch, on all three
     datasets; then, with no rig held, MVDet's projection kernel
     (`csrc/mvdet_project.cu`) at the `mvdet_wt_serve_b32` cell's shapes
     against its plain version, timed beside it and the library chain it
     replaces (`phase_mvdet_project`), and MVDet's bf16 serving path at
     that cell's batch (`predict --arch mvdet`, 32 Wildtrack scenes: one
     `mvdet_project` launch a request and no other kernel,
     `phase_mvdet_path`; the kernels line prints that count).
     The three bf16 window rigs are built by one more host process;
  5c. bf16 training (mixed precision, `--dtype bfloat16`) through the bf16
     variants of the backward kernels (`rig_window_bwd_bf16`,
     `rig_flat_bwd_bf16`, both on csrc/rig_ws.cuh; `stem_bwd_stats_bf16`,
     `stem_bwd_dx_bf16`, which share a walk of their own in
     csrc/stem_bwd.cu: 8 columns a lane, each window's first maximum as the
     greatest of its pixels' keys, each pixel's dz from the windows whose
     winner it is, added as bf16 pairs where JAX rounds): the stem kernels
     against their plain versions on bf16 x at (14, 64, 360, 640), the tie
     case too (with phase 2; acc the same bits in two runs); each
     rig backward against its plain version at B = 1, 2 on the flat rig
     cast to bf16 and on the 8-bucket bf16 MultiviewC window rig, K2-bf16
     at B = 2 on the 8-bucket bf16 MultiviewX rig (nl 8): dKr within 1e-2
     of the plain max and rel-L2 4e-3; dII (a bf16 accumulator, rounded
     where JAX rounds it, per band add or, on the window buckets JAX runs
     serially, per layer, in JAX's order: bucket, tile) within the same
     bounds and with the same bits on a second run; each bucket's rounding
     of the bf16 training rig printed ("pipelined" or "serial", B = 1, 2,
     8); the training CLI for one step at
     batch 2 on the flat layout with the fused stem, then on the window
     layout, counts set to 0 before and read after (one bf16 backward
     launch per bucket, the window forward one a scale, no fp32 kernel),
     against the plain route (losses
     rel 1e-2, update rel-L2 2e-2); the bench `--dtype bfloat16 --train
     --batch 0` on MultiviewC. Those two rigs come from a fourth host
     process;
  5d. the on-disk path at full MultiviewC width (`phase_disk_path`; only
     the frame count is cut, to 20): a MultiviewC-format set written into a
     temporary directory (PNGs, annotations, the XMLs of the synthetic
     cameras, from which a fifth host process builds the bf16 8-bucket
     window rig), the loader's first batch held to the written pixels,
     `device_color_jitter` and the IoU on the card held to the CPU (1e-5),
     the GT as its own prediction (MODA and AP_50 100); then train on disk
     (bf16, batch 2, one epoch, the ColorJitter on the card), `--resume`
     to epoch 2 (its first lr equal to the uninterrupted schedule's), and
     evaluate on that checkpoint, counts set to 0 before each and read
     after (K1-bf16 and K2-bf16 must launch); the decoder, the matcher,
     the loader's ms per scene, the on-disk train step beside the staged
     one, and the bench `--from_disk` (serving, auto batch; training at
     batch 8) beside the staged bench cells;
  5e. the BEV-sharded path and multi-process training (`parallel_bev.py`,
     `parallel.py`), bf16, full MultiviewC width, each step fatal: the
     predict CLI on disk (`--root`, the resumed checkpoint of 5d,
     `--dtype bfloat16`; K1-bf16 once a scale, the serving epilogue
     `rig_bev_epilogue` once and nothing else, the
     heatmap within rel-L2 1e-2 of the plain route's, whether the figure
     was written); then 2 ranks sharing the card (gloo on CUDA tensors,
     `launch.run_ranks`), each on its slab of the 8-bucket BEV-sharded rig
     (2 slabs, built by a sixth host process into the run's rig cache):
     sampling and its gradients at B = 2 and 1 against the unsharded bf16
     window rig (forward within 1e-2 / rel-L2 4e-3; dII and dKr, summed
     over the ranks, within 1.5x of the unsharded route's distance from
     its fp32 route, the rig cast to fp32), per rank K1-bf16 once a scale
     and the bf16 window backward once a bucket (all serial, K3's
     rounding, at B = 1); each rank's K1-bf16 and bf16 window backward on
     its slab's unified buckets against their plain versions at B = 2 and
     1 (1e-2 / rel-L2 4e-3, dII the same bits twice); then one full-model
     train step at B = 1 against the unsharded step (its eval- and
     training-mode heatmaps before it, which hold the halo rows and the
     cross-slab norms cell by cell, within 1e-2 / rel-L2 4e-3; loss rel
     1e-2, update within 1.5x the bf16-vs-fp32 distance and 0.25); `python -m
     vfa_tpu_torch.train --multihost` in 2 processes at -b 1 against one
     process at -b 2 (2 steps, the same bounds); the bench `--bev_shards 2
     --dtype bfloat16` beside the unsharded bench at batch 2 (the cost of
     the path on one card; both 8 buckets, on the same rigs);
  5f. the bf16 voxel route and the memory options (PR 15), full MultiviewC
     width: one scene through the voxel route (rig=None) in bf16 after
     `cast_model` (no rig kernel), the integral image and `sample_voxels`
     of camera 0 at scale 0 on the card bit-equal to the CPU's on the same
     laterals, the summed BEV features against the fp32 and fp64 voxel
     routes on the same laterals and weights (F7, printed); the ordered
     transpose of the corner reads (`voxel_tap_bwd`, fp32 and bf16,
     csrc/voxel_tap_bwd.cu) on camera 0 at scale 0 against its plain
     version bit for bit and twice, timed beside its bound, its plain
     version and one `scatter_add_` of the same updates, and the card's
     `sample_voxels` gradient against the CPU's bit for bit; the voxel-route
     step at batch 1 in bf16 and in fp32 (cuDNN deterministic), each run
     twice from the same weights (losses and gradients the same bits; 21
     launches of the transpose a step, nothing else); one mixed-precision
     step with rig=None at batch 1 (the bench's runner); a mixed-precision step
     at batch 8 through the bf16 window rig with the fused stem under each
     memory option (none, backbone_remat, stem_remat, backbone_chunks=2,
     all three): peak memory, step p50 of 3, the launches of K1-bf16,
     K2-bf16, K6-bf16, K7-bf16 equal to the plain step's, its losses bit for
     bit, its gradients within twice the plain step's run-to-run distance;
     the bench `--train --dtype bfloat16 --grid2x` at auto batch (remat
     forced on, on the grid2x rig a seventh host process builds) and
     `--dtype bfloat16 --no-rig --batch 1`;
  6. time each kernel (CUDA events, warmed up) beside its bound and its
     plain version (the fp32 rig kernels' operations are held to 495 / 3 =
     165 TFLOP/s, fp32-accurate 3xTF32 on the tensor cores, the bf16 ones to
     989.4 TFLOP/s, dense bf16, each product counted once; the window
     backwards also alone at B = 1; the stem kernels, fp32 and bf16, with
     their GB/s and share of the byte bound, and the fused stem backward
     beside autograd of the unfused chain), split each forward's device time between its two passes
     (torch.profiler; K1-bf16's two and K2-bf16's five at B = 2 and 1, and
     K4-bf16's two and K5-bf16's five at B = 2, with the wall clock and host
     gap, by tools/prof_bf16_window.py in a process of its own on the run's
     rig cache), and print peak memory, the card's name and power
     limit, the `kernels` JSON line and, last, the `ok` JSON line.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores, dense
# TF32 on the tensor cores and HBM3 bandwidth. An fp32-accurate product on
# the tensor cores costs three TF32 products (3xTF32), so the rig kernels'
# operations are bounded by PEAK_TF32_FLOPS / 3 = 165 TFLOP/s; the stem
# kernels' comparisons run on the CUDA cores.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989.4e12   # dense bf16 on the tensor cores: the bf16 rig kernels
PEAK_BYTES_PER_S = 3.35e12
KERNEL_TOL = 1e-4      # max |kernel - plain| / max |plain|, fp32 both sides
# bf16 rig kernels against their plain versions: max |err| / max |plain| and
# rel-L2. Both round vox and the tiles to bf16 at the same points; the sums'
# order flips a rounding by about one bf16 ulp (2^-8 relative) now and then.
BF16_MAX, BF16_L2 = 1e-2, 4e-3
BF16_PATH_L2 = 1e-2    # bf16 heatmap, kernel route vs plain route, rel-L2
PATH_TOL = 1e-3        # heatmap, kernel route vs plain route, relative to max
LOSS_TOL = 1e-4        # per-step training loss, kernel route vs plain route
PARAM_RTOL, PARAM_ATOL = 5e-3, 1e-5   # parameters after the last step
UPDATE_TOL = 1e-1      # |update - plain route's update| / |plain route's update|, all parameters
BATCH = 2
TRAIN_FRAMES = 6       # 3 optimizer steps at batch 2
# Peak lr of the route comparison. A one-epoch OneCycle over 3 steps has no
# warm-up (step 0 runs at 0.46 x the peak). At the recipe's 0.02 the loss of
# the random-weight model doubles with every step, and already at 0.002 the
# trajectory amplifies fp32 rounding so much that one route run twice
# differs from itself by more than LOSS_TOL at step 2. At 0.0001 the routes
# can be held to the stated tolerances; the batch-1 step runs at the
# recipe's own lr.
TRAIN_LR = "0.0001"
# dscale / dbias of the stem: sums over 14 x 360 x 640 terms per channel, taken
# in another order than autograd's
STEM_PARAM_TOL = 1e-3
STEM_SHAPE = (7 * BATCH, 64, 360, 640)   # conv1's output at batch 2
# rig vs the reference voxel route at full width (tests/test_rig.py:47)
REF_RTOL, REF_ATOL = 2e-3, 2e-4
BENCH_ITERS, BENCH_WARMUP = 5, 2
BENCH = ["--batch", str(BATCH), "--iters", str(BENCH_ITERS), "--warmup",
         str(BENCH_WARMUP)]
BENCH_CALLS = 1 + BENCH_WARMUP + BENCH_ITERS + 1   # first, warm-up, timed, counted
# rigs built on the host while the card works, one process per group (a
# group's rigs one after another): (data, buckets, dtype); 8 buckets = the
# training policy, 12 = serving; the bf16 rigs are the bf16 serving runs'
PREBUILT = ((("MultiviewX", 8, "float32"),), (("Wildtrack", 12, "float32"),),
            (("MultiviewC", 12, "bfloat16"), ("MultiviewX", 12, "bfloat16"),
             ("Wildtrack", 12, "bfloat16")),
            (("MultiviewC", 8, "bfloat16"), ("MultiviewX", 8, "bfloat16")))
# bf16 training, kernel route vs plain route after one step at TRAIN_LR:
# per-step loss rel; the update of all parameters as one vector within
# BF16_NOISE_RATIO of the distance between the kernel route's bf16 and
# fp32 updates (what bf16 rounding itself does to the update), and within
# BF16_UPDATE_CAP of the plain route's update norm
BF16_LOSS_TOL, BF16_NOISE_RATIO, BF16_UPDATE_CAP = 1e-2, 1.5, 0.25
# where the training CLI runs write their checkpoints and metrics (a
# temporary directory of main's, removed at the end)
RUNS_DIR = None


def counters():
    """name -> wrapper of every kernel of the port; each wrapper counts its
    launches in `.launches`."""
    from vfa_tpu_torch.ops import projection, rig_cuda, stem, voxel

    return {"rig_window_fwd": rig_cuda.rig_window_fwd,
            "rig_window_bwd": rig_cuda.rig_window_bwd,
            "rig_flat_fwd": rig_cuda.rig_flat_fwd,
            "rig_flat_bwd": rig_cuda.rig_flat_bwd,
            "stem_bwd_stats": stem.stem_bwd_stats,
            "stem_bwd_dx": stem.stem_bwd_dx,
            "rig_window_fwd_bf16": rig_cuda.rig_window_fwd_bf16,
            "rig_flat_fwd_bf16": rig_cuda.rig_flat_fwd_bf16,
            "rig_window_bwd_bf16": rig_cuda.rig_window_bwd_bf16,
            "rig_flat_bwd_bf16": rig_cuda.rig_flat_bwd_bf16,
            "stem_bwd_stats_bf16": stem.stem_bwd_stats_bf16,
            "stem_bwd_dx_bf16": stem.stem_bwd_dx_bf16,
            "voxel_tap_bwd": voxel.voxel_tap_bwd,
            "voxel_tap_bwd_bf16": voxel.voxel_tap_bwd_bf16,
            "rig_bev_epilogue": rig_cuda.rig_bev_epilogue,
            "mvdet_project": projection.project_world}


def reset_launches() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_kernels(text: str):
    """(kernel, registers, spill stores + loads in bytes) of every entry
    function in a `-Xptxas -v` log, by the kernel's name in the source."""
    out, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            short = re.search(r"\d((?:rig|stem|voxel|mvdet)_[a-z0-9_]+)", m.group(1))
            name = short.group(1) if short else m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name, spill = None, 0
    return out


def phase_build():
    from vfa_tpu_torch.kernels import LIBRARY, SIGNATURES

    t0 = time.perf_counter()
    names = sorted(SIGNATURES)
    LIBRARY.build(names)
    for name in names:
        LIBRARY.load(name)
        for kernel, regs, spill in ptxas_kernels(LIBRARY.ptxas_log.get(name, "")):
            log(f"  ptxas[{name}]: {kernel}: {regs} registers, {spill} bytes "
                "spilled")
            if spill and re.match(
                    r"rig_(\w+_mma|ws\w+|bev_epilogue)|stem_bwd_|voxel_tap_bwd|mvdet_project",
                    kernel):
                raise AssertionError(f"{kernel} spills {spill} bytes")
    log(f"phase 1 build: {names} in {time.perf_counter() - t0:.1f} s")


def full_rig(device, training: bool, layout: str = "window",
             data: str = "MultiviewC", buckets: int = None, cache_dir=None,
             dtype: str = "float32"):
    """A full-width rig under the serving (12 buckets) or the training
    (8 buckets) policy, in `dtype` (its tile_v and A), built once (or
    loaded from `cache_dir`) and handed to the CLIs and the bench."""
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import make_calibrations
    from vfa_tpu_torch.rig_cli import build_cli_rig

    cfg = get_config(data)
    t0 = time.perf_counter()
    rig = build_cli_rig(cfg, make_calibrations(cfg), device, buckets=buckets,
                        training=training, layout=layout, cache_dir=cache_dir,
                        dtype=getattr(torch, dtype))
    a_bytes = sum(a.numel() * a.element_size() for s in rig.scales for a in s.A)
    log(f"full {data} {dtype} {layout} "
        f"rig: {[len(s.A) for s in rig.scales]} buckets, "
        f"tile_v {rig.scales[0].tile_v}, nl {rig.scales[0].nl}, A shapes "
        f"{[tuple(s.A[0].shape) for s in rig.scales]} (bucket 0 of each scale), "
        f"A {a_bytes} bytes ({a_bytes / 1e9:.3f} GB), "
        f"ready in {time.perf_counter() - t0:.1f} s")
    return rig


def start_rig_builds(cache_dir):
    """One host process per PREBUILT group, each building its rigs on the
    CPU (no card) into the rig cache at `cache_dir`, one after another;
    returns them running."""
    procs = []
    for group in PREBUILT:
        code = ("import torch\n"
                "from vfa_tpu_torch.config import get_config\n"
                "from vfa_tpu_torch.data.synthetic import make_calibrations\n"
                "from vfa_tpu_torch.rig_cli import build_cli_rig\n")
        for data, buckets, dtype in group:
            code += (f"cfg = get_config({data!r})\n"
                     f"build_cli_rig(cfg, make_calibrations(cfg), 'cpu', "
                     f"buckets={buckets}, cache_dir={cache_dir!r}, "
                     f"dtype=torch.{dtype})\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
            cwd=os.path.dirname(os.path.abspath(__file__))))
    return procs


_BUILD_LOGS = {}


def prebuilt_rig(procs, key, device, cache_dir):
    """Wait for the host process that builds rig `key` = (data, buckets,
    dtype), log its host build line, load the rig."""
    data, buckets, dtype = key
    g = next(i for i, group in enumerate(PREBUILT) if key in group)
    if g not in _BUILD_LOGS:
        out, _ = procs[g].communicate()
        if procs[g].returncode:
            raise RuntimeError(f"the rig builds {PREBUILT[g]} failed:\n{out}")
        _BUILD_LOGS[g] = [ln for ln in out.splitlines()
                          if ln.startswith("compiled rig:")]
    line = _BUILD_LOGS[g][PREBUILT[g].index(key)]
    log(f"host build of the {data} {dtype} rig (a process of its own, no "
        f"cache): {line}")
    return full_rig(device, training=buckets == 8, data=data, buckets=buckets,
                    cache_dir=cache_dir, dtype=dtype)


def small_taps_rig(device):
    """A small flat rig in the 16-tap integral-image form (one bucket)."""
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import make_calibrations, tiny_config
    from vfa_tpu_torch.geometry import make_grid
    from vfa_tpu_torch.ops.rig import build_rig, pyramid_feat_shapes

    cfg = tiny_config(get_config("MultiviewC"), factor=4)
    return build_rig(make_calibrations(cfg), cfg,
                     make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
                     pyramid_feat_shapes(cfg.resize_size), tile_v=16,
                     layout="flat", fold_prefix=False, device=device)


def layout_of(rig) -> str:
    return "window" if rig.scales[0].window_hw else "flat"


def is_bf16(rig) -> bool:
    return rig.scales[0].A[0].dtype == torch.bfloat16


def fwd_launches(rig) -> int:
    """Forward launches per request: the bf16 forwards run once per scale
    over all its buckets, the fp32 ones once per bucket."""
    if is_bf16(rig):
        return len(rig.scales)
    return sum(len(s.A) for s in rig.scales)


def fwd_name(rig) -> str:
    """The forward kernel a rig's launches go to: its layout's, the bf16
    variant for a bf16 rig."""
    return f"rig_{layout_of(rig)}_fwd" + ("_bf16" if is_bf16(rig) else "")


def rig_as_bf16(rig):
    """A flat rig with A cast to bf16: the bf16 flat rig (a flat rig's
    tile_v does not depend on the dtype and its A is built in fp32 and then
    cast; tests/test_torch_bf16.py::test_bf16_flat_rig_is_the_fp32_flat_rig_cast)."""
    if layout_of(rig) != "flat":
        raise ValueError("only a flat rig is the same in both dtypes")
    return type(rig)([dataclasses.replace(sr, A=tuple(a.to(torch.bfloat16)
                                                      for a in sr.A))
                      for sr in rig.scales], rig.grid_shape)


def scale_inputs(sr, B, seed, device):
    g = torch.Generator().manual_seed(seed)
    fh, fw = sr.feat_hw
    N = sr.A[0].shape[0]
    lat = torch.rand((B, N, fh, fw, 256), generator=g)
    if not sr.on_raw:
        lat = lat / (fh * fw)      # keeps the 2D cumsum O(1)
    bound = 1.0 / np.sqrt(256 * sr.nl)
    k = ((torch.rand((256 * sr.nl, 256), generator=g) * 2 - 1) * bound).to(device)
    dtype = sr.A[0].dtype   # a bf16 rig's kernels take bf16 features and Kr
    return lat.to(device=device, dtype=dtype), k.to(dtype)


def plain_tiles(lat, sr, k):
    from vfa_tpu_torch.ops.rig import collapse_per_layer, scale_features, scale_tiles

    return scale_tiles(scale_features(lat, sr), sr,
                       collapse_per_layer(k, lat.shape[-1], sr.nl, lat.dtype))


def check_close(what, got, want, tol=KERNEL_TOL, quiet=False):
    """(max abs err, max err / max |want|); raises past `tol`."""
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    if not quiet:
        log(f"  {what}: max abs err {err:.3e}, max rel err {rel:.3e} "
            f"(tolerance {tol:.0e} of the plain result's max)")
    if not np.isfinite(rel) or rel > tol:
        raise AssertionError(f"{what} disagrees with its plain version: rel {rel:.3e}")
    return err, rel


def check_bf16(what, got, want, quiet=False):
    """(max abs err, max err / max |want|) of a bf16 kernel against its
    plain version; raises past BF16_MAX of the plain max or BF16_L2 rel-L2."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    l2 = float(torch.linalg.vector_norm(got - want)
               / max(float(torch.linalg.vector_norm(want)), 1e-30))
    if not quiet:
        log(f"  {what}: max abs err {err:.3e}, max rel err {rel:.3e}, rel-L2 "
            f"{l2:.3e} (tolerance {BF16_MAX:.0e} of the plain max, rel-L2 "
            f"{BF16_L2:.0e})")
    if not (np.isfinite(rel) and rel <= BF16_MAX and l2 <= BF16_L2):
        raise AssertionError(f"{what} disagrees with its plain version: rel "
                             f"{rel:.3e}, rel-L2 {l2:.3e}")
    return err, rel


def worst_of(errs):
    return max(e[0] for e in errs), max(e[1] for e in errs)


def phase_kernel_vs_plain(rig, device, batches=(1, 2), where="phase 2"):
    """The forward kernel against its plain version, bucket by bucket: each
    bucket's rows of the scale's tiles held to the tolerance of its own
    plain result's max (a bf16 rig: the bf16 kernel, BF16_MAX and BF16_L2);
    one line per scale with its worst bucket."""
    from vfa_tpu_torch.bench import launch_vox_elems
    from vfa_tpu_torch.ops.rig_cuda import rig_tiles_cuda

    name = fwd_name(rig)
    bf16 = is_bf16(rig)
    tol = (f"{BF16_MAX:.0e} of each bucket's plain max, rel-L2 {BF16_L2:.0e}"
           if bf16 else f"{KERNEL_TOL:.0e} of each bucket's plain max")
    errs, vox_max = [], 0
    for B in batches:
        for si, sr in enumerate(rig.scales):
            lat, k = scale_inputs(sr, B, 100 * B + si, device)
            got = rig_tiles_cuda(lat, sr, k)
            sync(device)
            want = plain_tiles(lat, sr, k)
            tag = (f"{name} B={B} scale {si} ({len(sr.A)} buckets, "
                   f"{sum(a.shape[1] for a in sr.A)} tiles, bands "
                   f"{[a.shape[-1] for a in sr.A]})")
            per_bucket, off = [], 0
            for bi, A_b in enumerate(sr.A):
                rows = slice(off, off + A_b.shape[1] * sr.tile_v)
                check = check_bf16 if bf16 else check_close
                per_bucket.append(check(f"{tag} bucket {bi}", got[:, :, rows],
                                        want[:, :, rows], quiet=True))
                off = rows.stop
            vox_max = max(vox_max, launch_vox_elems(sr, B))
            err, rel = worst_of(per_bucket)
            log(f"  {tag}: worst bucket max abs err {err:.3e}, max rel err "
                f"{rel:.3e} (tolerance {tol})")
            errs += per_bucket
            del got, want
    log(f"{where} {name} vs plain: ok; the largest launch's vox scratch "
        f"{vox_max} elements ({'past' if vox_max > 2 ** 31 else 'within'} 2^31)")
    return worst_of(errs)


def grad_inputs(sr, B, seed, device):
    """Seeded padded features, per-layer collapse weight and cotangent of a
    scale's tiles."""
    from vfa_tpu_torch.ops.rig import collapse_per_layer, scale_features

    lat, k = scale_inputs(sr, B, seed, device)
    rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
    g = torch.randn((sr.A[0].shape[0], B, rows, 256),
                    generator=torch.Generator().manual_seed(seed + 1)).to(device, lat.dtype)
    return scale_features(lat, sr), collapse_per_layer(k, 256, sr.nl, lat.dtype), g


def plain_scale_bwd(ii, sr, Kr, g):
    from vfa_tpu_torch.ops.rig import flat_tiles_bwd, window_tiles_bwd

    dII, dKr, off = None, torch.zeros(Kr.shape, device=Kr.device), 0
    for bi, (A_b, s_b) in enumerate(zip(sr.A, sr.starts)):
        rows = A_b.shape[1] * sr.tile_v
        g_b = g[:, :, off:off + rows]
        if sr.window_hw:
            dII, d = window_tiles_bwd(ii, A_b, s_b, Kr, g_b, sr.window_hw[bi],
                                      sr.tile_v, dII=dII)
        else:
            dII, d = flat_tiles_bwd(ii, A_b, s_b, Kr, g_b, sr.tile_v, dII=dII)
        dKr += d
        off += rows
    return dII, dKr


def bwd_name(rig) -> str:
    return f"rig_{layout_of(rig)}_bwd" + ("_bf16" if is_bf16(rig) else "")


def phase_bwd_kernel_vs_plain(rig, device, batches=(1, 2), where="phase 2"):
    """The backward kernel against its plain version, all buckets of each
    scale through one dII. fp32: dII and dKr within KERNEL_TOL. bf16: dKr
    and dII by check_bf16 (both bf16 kernels add dII in the plain version's
    order at its rounding points, JAX's), and dII with the same bits on a
    second run."""
    from vfa_tpu_torch.ops.rig_cuda import rig_scale_bwd

    name = bwd_name(rig)
    errs = []
    for B in batches:
        for si, sr in enumerate(rig.scales):
            ii, Kr, g = grad_inputs(sr, B, 300 * B + si, device)
            got = rig_scale_bwd(ii, sr, Kr, g)
            sync(device)
            want = plain_scale_bwd(ii, sr, Kr, g)
            bands = [a.shape[-1] for a in sr.A]
            tag = (f"{name} B={B} scale {si} ({len(sr.A)} buckets"
                   + ("" if sr.window_hw else
                      f", bands {bands}: {sum(b % 16 == 8 for b in bands)} of "
                      "them 8 (mod 16)") + ")")
            if is_bf16(rig):
                errs.append(check_bf16(f"{tag} dII", got[0], want[0]))
                errs.append(check_bf16(f"{tag} dKr", got[1], want[1]))
                again = rig_scale_bwd(ii, sr, Kr, g)[0]
                sync(device)
                if not torch.equal(again, got[0]):
                    raise AssertionError(f"{tag}: two runs gave different dII bits")
                log(f"  {tag} dII: a second run gives the same bits")
                del again
            else:
                for part, a, b in zip(("dII", "dKr"), got, want):
                    errs.append(check_close(f"{tag} {part}", a, b))
            del got, want, ii, Kr, g
    log(f"{where} {name} vs plain: ok")
    return worst_of(errs)


def stem_inputs(device, integers: bool, shape=STEM_SHAPE, dtype=torch.float32):
    """Seeded x, scale, bias, dy of the stem tail in `dtype` and the
    forward's GroupNorm statistics. `integers`: integer-valued x with scale
    1, bias 0, so that ReLU zeros and equal maxima are everywhere."""
    from vfa_tpu_torch.ops.stem import group_norm_stats

    g = torch.Generator().manual_seed(11 + integers)
    M, C, H, W = shape
    x = torch.randn(shape, generator=g)
    scale, bias = torch.rand(C, generator=g) + 0.5, torch.rand(C, generator=g) - 0.5
    if integers:
        x, scale, bias = x.round(), torch.ones(C), torch.zeros(C)
    dy = torch.randn((M, C, (H + 1) // 2, (W + 1) // 2), generator=g)
    x, scale, bias, dy = (t.to(device, dtype) for t in (x, scale, bias, dy))
    _, mu, rstd = group_norm_stats(x, scale, bias, 16, 1e-5)
    return x, scale, bias, dy, mu, rstd


def phase_stem_vs_plain(device):
    """K6 and K7 against their plain versions on the same parameters, the
    whole backward against autograd of the unfused chain, and the identical
    zero pattern of dx on the integer-valued input; on the random input the
    kernels' recomputed z (`recompute_z`) equals the z of the forward's
    GroupNorm on every element (F3)."""
    from vfa_tpu_torch.ops import stem

    errs = {"stem_bwd_stats": [], "stem_bwd_dx": []}
    for integers in (False, True):
        x, scale, bias, dy, mu, rstd = stem_inputs(device, integers)
        tag = f"{tuple(x.shape)}{' integer-valued' if integers else ''}"
        params = stem.plane_params(mu, rstd, scale, bias)
        if not integers:
            z = stem.group_norm_stats(x, scale, bias, 16, 1e-5)[0]
            differ = int((stem.recompute_z(x, params) != z).sum())
            log(f"  stem recomputed z vs the forward's {tag}: {differ} of "
                f"{z.numel()} elements differ")
            if differ:
                raise AssertionError("the stem kernels' recomputed z differs "
                                     "from the forward's GroupNorm (F3)")
            del z
        acc = stem.stem_bwd_stats(x, dy, params)
        torch.cuda.synchronize()
        errs["stem_bwd_stats"].append(check_close(
            f"stem_bwd_stats {tag}", acc, stem.stem_bwd_stats_plain(x, dy, params)))
        if not torch.equal(acc, stem.stem_bwd_stats(x, dy, params)):
            raise AssertionError(f"stem_bwd_stats {tag}: two runs give other bits")
        log(f"  stem_bwd_stats {tag}: the same bits in two runs")
        c = torch.randn(mu.shape, generator=torch.Generator().manual_seed(5)).to(device) * 1e-3
        params = stem.plane_params(mu, rstd, scale, bias, c, -c)
        dx = stem.stem_bwd_dx(x, dy, params)
        torch.cuda.synchronize()
        errs["stem_bwd_dx"].append(check_close(
            f"stem_bwd_dx {tag}", dx, stem.stem_bwd_dx_plain(x, dy, params)))
        del acc, dx, params
        got = stem.gn_relu_pool_bwd(x, scale, bias, dy, mu, rstd)
        want = stem.gn_relu_pool_bwd_plain(x, scale, bias, dy)
        check_close(f"stem backward dx vs autograd of the chain {tag}", got[0], want[0])
        for part, a, b in zip(("dscale", "dbias"), got[1:], want[1:]):
            check_close(f"stem backward {part} vs autograd of the chain {tag}",
                        a, b, STEM_PARAM_TOL)
        if integers:
            # the routing itself: with c1 = c2 = 0 the dx kernel gives
            # rstd * scale * dz, zero exactly where dz is; the reference is
            # autograd of relu + max_pool2d on the forward's own z
            z = torch.nn.functional.group_norm(x, 16, scale, bias, 1e-5).requires_grad_()
            with torch.enable_grad():
                y = torch.nn.functional.max_pool2d(torch.relu(z), 3, 2, 1)
            (dz_ref,) = torch.autograd.grad(y, z, dy)
            dz = stem.stem_bwd_dx(x, dy, stem.plane_params(mu, rstd, scale, bias))
            differ = int(((dz == 0) != (dz_ref == 0)).sum())
            differ += int(((got[0] == 0) != (want[0] == 0)).sum())
            log(f"  stem backward {tag}: zero patterns of dz and dx differ at "
                f"{differ} of {dz.numel()} pixels ({int((dz_ref == 0).sum())} "
                f"zeros in dz)")
            if differ:
                raise AssertionError("the stem kernels route a tied maximum to "
                                     "another pixel than max_pool2d's backward")
            del z, y, dz, dz_ref
        del got, want, x, dy
    log("phase 2 stem kernels vs plain: ok")
    return {k: worst_of(v) for k, v in errs.items()}


def phase_stem_bf16_vs_plain(device):
    """The bf16 K6 and K7 against their plain versions on bf16 x and dy at
    STEM_SHAPE: both round z to bf16 before the ReLU and the comparisons
    and dz at the same points, so acc differs by fp32 sum order only
    (KERNEL_TOL) and dx by a one-ulp flip now and then (check_bf16); the
    zero patterns of dz are equal, on the integer-valued input too, and
    stem_bwd_stats gives the same bits in two runs."""
    from vfa_tpu_torch.ops import stem

    errs = {"stem_bwd_stats_bf16": [], "stem_bwd_dx_bf16": []}
    for integers in (False, True):
        x, scale, bias, dy, mu, rstd = stem_inputs(device, integers,
                                                   dtype=torch.bfloat16)
        tag = f"bf16 {tuple(x.shape)}{' integer-valued' if integers else ''}"
        params = stem.plane_params(mu, rstd, scale, bias)
        acc = stem.stem_bwd_stats(x, dy, params)
        torch.cuda.synchronize()
        errs["stem_bwd_stats_bf16"].append(check_close(
            f"stem_bwd_stats {tag}", acc, stem.stem_bwd_stats_plain(x, dy, params)))
        if not torch.equal(acc, stem.stem_bwd_stats(x, dy, params)):
            raise AssertionError(f"stem_bwd_stats {tag}: two runs give other bits")
        dz = stem.stem_bwd_dx(x, dy, params)
        differ = int(((dz == 0) != (stem.stem_bwd_dx_plain(x, dy, params) == 0)).sum())
        log(f"  stem bf16 {tag}: zero patterns of dz differ at {differ} of "
            f"{dz.numel()} pixels ({int((dz == 0).sum())} zeros)")
        if differ:
            raise AssertionError("the bf16 stem kernels route a gradient to "
                                 "another pixel than their plain version")
        c = torch.randn(mu.shape, generator=torch.Generator().manual_seed(5)).to(device) * 1e-3
        params = stem.plane_params(mu, rstd, scale, bias, c, -c)
        dx = stem.stem_bwd_dx(x, dy, params)
        torch.cuda.synchronize()
        errs["stem_bwd_dx_bf16"].append(check_bf16(
            f"stem_bwd_dx {tag}", dx, stem.stem_bwd_dx_plain(x, dy, params)))
        del acc, dx, dz, params, x, dy
    log("phase 2 bf16 stem kernels vs plain: ok")
    return {k: worst_of(v) for k, v in errs.items()}


def phase_train_path_bf16(rig, rig32, device, fused_stem: bool):
    """bf16 training (`--dtype bfloat16`, mixed precision) on a bf16 rig:
    one step at batch 2 through the bf16 kernels of the rig's layout (and,
    with `fused_stem`, the bf16 stem kernels), counts set to 0 just before
    and read just after: bf16 forward launches (`fwd_launches` a pass) and
    one bf16 backward launch per bucket, the stem's once each, no fp32
    kernel; then the same step
    through the plain versions under autograd (unfused stem), and through
    the fp32 kernels on `rig32` (the same rig in fp32), the yardstick of
    bf16 rounding's own effect. Losses within BF16_LOSS_TOL; the update of
    all parameters (one vector) within BF16_NOISE_RATIO of that effect
    and within BF16_UPDATE_CAP of the plain route's update norm."""
    from vfa_tpu_torch import train
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights

    layout = layout_of(rig)
    fwd, bwd = fwd_name(rig), bwd_name(rig)
    tag = f"bf16 {layout}{' + fused stem' if fused_stem else ''}"
    argv = ["--data", "MultiviewC", "--synthetic", "-e", "1", "--pretrained",
            "0", "--no_augment", "--seed", "0", "--device", "cuda",
            "--rig_layout", layout, "--dtype", "bfloat16", "--synthetic_frames",
            str(BATCH), "-b", str(BATCH), "--lr", TRAIN_LR, "--savedir", RUNS_DIR]
    os.environ["VFA_FUSED_STEM"] = "1" if fused_stem else "0"
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = train.main(argv, rig=rig)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    buckets = sum(len(s.A) for s in rig.scales)
    log(f"training path ({tag}) launches: {launches} (1 step, {buckets} "
        "buckets over the 3 scales, then the validation forward)")
    stem_n = 1 if fused_stem else 0
    if len(res["losses"]) != 1 or launches[fwd] <= fwd_launches(rig):
        raise AssertionError(f"the bf16 training path never launched {fwd}")
    # the validation forward (no gradient) takes the one-launch epilogue
    want = {fwd: None, bwd: buckets, "stem_bwd_stats_bf16": stem_n,
            "stem_bwd_dx_bf16": stem_n, "rig_bev_epilogue": None}
    for name, n in launches.items():
        if want.get(name, 0) is not None and n != want.get(name, 0):
            raise AssertionError(f"{name} launched {n} times on the {tag} "
                                 f"training path, expected {want.get(name, 0)}")
    os.environ["VFA_FUSED_STEM"] = "0"
    ref = train.main(argv + ["--rig_impl", "plain"], rig=rig)
    if launches != read_launches():
        raise AssertionError("the plain route launched a kernel")
    os.environ["VFA_FUSED_STEM"] = "1" if fused_stem else "0"
    fp32 = train.main(argv[:argv.index("--dtype")] + argv[argv.index("--dtype") + 2:],
                      rig=rig32)
    del os.environ["VFA_FUSED_STEM"]
    for i, (a, b) in enumerate(zip(res["losses"] + res["val_losses"],
                                   ref["losses"] + ref["val_losses"])):
        if not all(np.isfinite(v) for v in a.values()):
            raise AssertionError(f"{tag} step {i}: a non-finite loss")
        rel = abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-12)
        log(f"  {tag} step {i}: loss {a['loss']:.6f} kernel route, "
            f"{b['loss']:.6f} plain route, rel diff {rel:.3e} (tolerance "
            f"{BF16_LOSS_TOL:.0e})")
        if rel > BF16_LOSS_TOL:
            raise AssertionError(f"{tag} step {i}: loss differs from the plain route")
    init = init_weights(VFANet(res["model"].cfg),
                        torch.Generator().manual_seed(0)).state_dict()
    ref_params = dict(ref["model"].named_parameters())
    fp32_params = dict(fp32["model"].named_parameters())
    to_plain = to_fp32 = upd_sq = 0.0
    for name, p in res["model"].named_parameters():
        if p.dtype != torch.float32 or not torch.isfinite(p).all():
            raise AssertionError(f"{name}: not a finite fp32 master after the step")
        b = ref_params[name].detach()
        to_plain += float(((p.detach() - b).double() ** 2).sum())
        to_fp32 += float(((p.detach() - fp32_params[name].detach()).double() ** 2).sum())
        upd_sq += float(((b - init[name].to(b.device)).double() ** 2).sum())
    to_plain, to_fp32 = (to_plain / upd_sq) ** 0.5, (to_fp32 / upd_sq) ** 0.5
    log(f"phase 4 training path ({tag}): one step at batch {BATCH}, lr "
        f"{TRAIN_LR}: update {to_plain:.3e} of the plain route's update norm "
        f"away from it, the fp32 kernel route's {to_fp32:.3e} (tolerance "
        f"{BF16_NOISE_RATIO}x that, and {BF16_UPDATE_CAP}); {res['ms'][0]:.2f} "
        f"ms the step, plain route {ref['ms'][0]:.2f}, fp32 {fp32['ms'][0]:.2f}; "
        f"peak memory {peak / 2**30:.2f} GiB")
    if not (to_plain <= BF16_NOISE_RATIO * to_fp32 and to_plain <= BF16_UPDATE_CAP):
        raise AssertionError(f"{tag}: the update differs from the plain route's "
                             f"by {to_plain:.3e} of its norm")
    del ref, fp32, init, ref_params, fp32_params
    return launches, res, peak


def phase_train_path(rig, device, fused_stem: bool):
    """The training path through the kernels of the rig's layout (and, with
    `fused_stem`, the stem kernels), then through the plain versions from
    the same seed (plain rig route, unfused stem), then one step at
    batch 1."""
    from vfa_tpu_torch import train

    layout = layout_of(rig)
    fwd, bwd = f"rig_{layout}_fwd", f"rig_{layout}_bwd"
    tag = f"{layout}{' + fused stem' if fused_stem else ''}"
    common = ["--data", "MultiviewC", "--synthetic", "-e", "1", "--pretrained",
              "0", "--no_augment", "--seed", "0", "--device", "cuda",
              "--rig_layout", layout, "--savedir", RUNS_DIR]
    argv = common + ["--synthetic_frames", str(TRAIN_FRAMES), "-b", str(BATCH),
                     "--lr", TRAIN_LR]
    os.environ["VFA_FUSED_STEM"] = "1" if fused_stem else "0"
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = train.main(argv, rig=rig)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = len(res["losses"])
    buckets = sum(len(s.A) for s in rig.scales)
    log(f"training path ({tag}) launches: {launches} ({steps} steps, {buckets} "
        f"buckets over the 3 scales)")
    stem_steps = steps if fused_stem else 0
    want = {fwd: None, bwd: steps * buckets, "stem_bwd_stats": stem_steps,
            "stem_bwd_dx": stem_steps}
    if steps != TRAIN_FRAMES // BATCH or launches[fwd] <= 0:
        raise AssertionError(f"the training path never launched {fwd}")
    for name, n in launches.items():
        if want.get(name, 0) is not None and n != want.get(name, 0):
            raise AssertionError(
                f"{name} launched {n} times on the {tag} training path, "
                f"expected {want.get(name, 0)} ({steps} steps, {buckets} buckets)")
    os.environ["VFA_FUSED_STEM"] = "0"
    ref = train.main(argv + ["--rig_impl", "plain"], rig=rig)
    if launches != read_launches():
        raise AssertionError("the plain route launched a kernel")

    for i, (a, b) in enumerate(zip(res["losses"] + res["val_losses"],
                                   ref["losses"] + ref["val_losses"])):
        for key in a:
            if not np.isfinite(a[key]):
                raise AssertionError(f"step {i}: non-finite {key}")
        rel = abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-12)
        log(f"  step {i}: loss {a['loss']:.6f} kernel route, {b['loss']:.6f} "
            f"plain route, rel diff {rel:.3e} (tolerance {LOSS_TOL:.0e})")
        if rel > LOSS_TOL:
            raise AssertionError(f"step {i}: loss differs from the plain route")
    # parameters and BatchNorm buffers after the last step, and the update
    # of all of them since the seeded init as one vector, buffers left out (at this lr the
    # updates are near PARAM_ATOL, so the absolute check alone would pass a
    # wrong gradient; single tensors are too noisy for a relative check: a
    # conv in front of a BatchNorm has a near-zero gradient)
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights

    init_sd = init_weights(VFANet(res["model"].cfg),
                           torch.Generator().manual_seed(0)).state_dict()
    trained = {name for name, _ in res["model"].named_parameters()}
    worst = worst_share = diff_sq = upd_sq = 0.0
    ref_sd = ref["model"].state_dict()
    for name, t in res["model"].state_dict().items():
        a, b = t.float(), ref_sd[name].float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {name} after training")
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        share = float((diff / (PARAM_ATOL + PARAM_RTOL * b.abs())).max())
        worst_share = max(worst_share, share)
        if share > 1:
            raise AssertionError(f"{name} differs from the plain route by "
                                 f"{float(diff.max()):.3e}")
        if name in trained:
            diff_sq += float((diff.double() ** 2).sum())
            upd_sq += float(((b - init_sd[name].to(b.device)).double() ** 2).sum())
    worst_upd = (diff_sq / upd_sq) ** 0.5
    if not worst_upd <= UPDATE_TOL:
        raise AssertionError(f"the 3-step update differs from the plain "
                             f"route's by {worst_upd:.3e} of its norm")
    ref_p50 = float(np.median(ref["ms"]))
    del ref, ref_sd, init_sd

    os.environ["VFA_FUSED_STEM"] = "1" if fused_stem else "0"
    one = train.main(common + ["--synthetic_frames", "1", "-b", "1"], rig=rig)
    del os.environ["VFA_FUSED_STEM"]
    if len(one["losses"]) != 1 or not np.isfinite(one["losses"][0]["loss"]):
        raise AssertionError("the batch-1 step gave no finite loss")
    log(f"phase 4 training path ({tag}): {steps} steps at batch {BATCH}, losses "
        f"and parameters equal to the plain route (max abs parameter diff "
        f"{worst:.3e}, at most {worst_share:.2f} of rtol {PARAM_RTOL} / atol "
        f"{PARAM_ATOL}; update "
        f"diff {worst_upd:.3e} of the update's norm, tolerance {UPDATE_TOL}); p50 "
        f"{np.median(res['ms']):.2f} ms/step, plain route {ref_p50:.2f}; one "
        f"step at batch 1, loss "
        f"{one['losses'][0]['loss']:.6f}; peak memory {peak / 2**30:.2f} GiB")
    return launches, res, peak


def phase_main_path(rig, device, scenes: int):
    """The serving CLI at full width on `rig` (a bf16 rig: `--dtype
    bfloat16`), counts set to 0 just before and read just after:
    `fwd_launches` launches of the rig's forward kernel per request (one a
    scale for the bf16 window kernel, one a bucket otherwise) and no other
    kernel;
    then the same requests through the plain rig version. fp32: heatmaps
    within PATH_TOL, detections equal; bf16: heatmap rel-L2 within
    BF16_PATH_L2, the detections' overlap printed."""
    from vfa_tpu_torch import predict

    layout = layout_of(rig)
    fwd = fwd_name(rig)
    bf16 = is_bf16(rig)
    argv = ["--data", "MultiviewC", "--synthetic", "--scenes", str(scenes),
            "--batch", str(BATCH), "--seed", "0", "--cls_thresh", "0.5",
            "--device", "cuda", "--rig_layout", layout,
            "--dtype", "bfloat16" if bf16 else "float32"]
    tag = f"{layout}{', bf16' if bf16 else ''}"
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = predict.main(argv, rig=rig)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    buckets = sum(len(s.A) for s in rig.scales)
    per = fwd_launches(rig)
    log(f"serving path ({tag}) launches: {launches} ({len(res['ms'])} requests, "
        f"{buckets} buckets over the 3 scales, {per} launches a request)")
    if launches[fwd] != per * len(res["ms"]):
        raise AssertionError(f"the serving path launched {fwd} {launches[fwd]} "
                             f"times, expected {per} per request")
    # bf16: the one-launch epilogue once a request
    epilogue = len(res["ms"]) if bf16 else 0
    if launches["rig_bev_epilogue"] != epilogue:
        raise AssertionError(f"the serving path launched rig_bev_epilogue "
                             f"{launches['rig_bev_epilogue']} times, expected {epilogue}")
    if any(n for name, n in launches.items() if name not in (fwd, "rig_bev_epilogue")):
        raise AssertionError("the serving path launched another kernel")
    ref = predict.main(argv + ["--rig_impl", "plain"], rig=rig)

    for i, (h, hr) in enumerate(zip(res["heatmaps"], ref["heatmaps"])):
        if not torch.isfinite(h).all():
            raise AssertionError(f"request {i}: non-finite heatmap")
        if tuple(h.shape) != (BATCH, 1, 156, 156):
            raise AssertionError(f"request {i}: heatmap shape {tuple(h.shape)}")
        err = float((h - hr).abs().max()) / max(float(hr.abs().max()), 1e-12)
        l2 = float(torch.linalg.vector_norm(h - hr) / torch.linalg.vector_norm(hr))
        tol = f"rel-L2 {BF16_PATH_L2:.0e}" if bf16 else f"{PATH_TOL:.0e}"
        log(f"  request {i}: heatmap kernel vs plain route, max rel err {err:.3e}, "
            f"rel-L2 {l2:.3e} (tolerance {tol})")
        if (l2 > BF16_PATH_L2) if bf16 else (err > PATH_TOL):
            raise AssertionError(f"request {i}: heatmap differs from the plain route")
    n_det = n_both = n_ref = 0
    for s, (d, dr) in enumerate(zip(res["detections"], ref["detections"])):
        if bf16:
            # a detection of the kernel route that the plain route also has
            # (location within 0.5 per coordinate)
            n_both += sum(any(np.all(np.abs(np.asarray(o.location)
                                            - np.asarray(orf.location)) <= 0.5)
                              for orf in dr) for o in d)
            n_ref += len(dr)
        else:
            if len(d) != len(dr):
                raise AssertionError(f"scene {s}: {len(d)} detections vs {len(dr)} plain")
            for o, orf in zip(d, dr):
                np.testing.assert_allclose(o.location, orf.location, rtol=1e-4, atol=0.5)
                np.testing.assert_allclose(o.conf, orf.conf, rtol=1e-3, atol=1e-4)
        n_det += len(d)
    same = (f"{n_both} of them also in the plain route's {n_ref}" if bf16
            else "equal to the plain route")
    log(f"phase 3 serving path ({tag}): {len(res['ms'])} requests, {n_det} "
        f"detections (conf > 0.5), {same}; p50 "
        f"{np.median(res['ms']):.2f} ms/request (batch {BATCH}), plain route "
        f"{np.median(ref['ms']):.2f}; peak memory {peak / 2**30:.2f} GiB")
    return launches, res, peak


def phase_bench(argv, rig, kernels, calls=None):
    """`python -m vfa_tpu_torch.bench` in this process on a built rig, every
    kernel's count set to 0 just before and read just after. Each of
    `kernels` must have launched; with `calls` (the bench's calls at one
    batch: first, warm-up, timed, counted) exactly once per bucket a call.
    TF32 goes back off for the parity phases (the bench turns cuDNN's on)."""
    from vfa_tpu_torch import bench

    reset_launches()
    res = bench.main(argv, rig=rig)
    launches = read_launches()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    buckets = sum(len(s.A) for s in rig.scales)
    tag = " ".join(argv)
    if not (np.isfinite(res["value"]) and res["value"] > 0
            and res["tflops_per_sec"] > 0 and "mfu" in res):
        raise AssertionError(f"bench {tag}: bad result {res}")
    for name, n in launches.items():
        want = None if calls is None else calls * buckets
        if name in kernels and (n <= 0 or want is not None and n != want):
            raise AssertionError(f"bench {tag}: {name} launched {n} times, "
                                 f"expected {want or 'some'}")
        if name not in kernels and n:
            raise AssertionError(f"bench {tag}: {name} launched {n} times")
    per = f"; {buckets} per call over {calls} calls" if calls else ""
    log(f"phase 5 bench {tag}: {res}; launches {launches}{per}")
    return res, launches


EPILOGUE_BATCH = 32    # the benchmark's serving batch
EPILOGUE_REPS = 10


def phase_bev_epilogue(rig, device, data: str, batch: int = EPILOGUE_BATCH) -> dict:
    """The serving epilogue `csrc/rig_bev_epilogue.cu` on a bf16 serving
    rig at `batch` (random tiles of each scale's rows, the rig's inv_perms):
    bit for bit its plain version `rig_bev_sum`; its time against the
    per-scale chain it replaces (three `rig_epilogue` camera sums, the fp32
    adds over scales, the bf16 cast), CUDA events, best of two interleaved
    rounds of EPILOGUE_REPS; its bound: the gathered rows, the inv_perms
    and the BEV written, at PEAK_BYTES_PER_S."""
    from vfa_tpu_torch.ops.rig import rig_bev_sum, rig_epilogue
    from vfa_tpu_torch.ops.rig_cuda import rig_bev_epilogue

    gen = torch.Generator(device=device).manual_seed(11)
    tiles, inv_perms, biases = [], [], []
    for sr in rig.scales:
        rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
        N = sr.inv_perm.shape[0]
        tiles.append(torch.randn((N, batch, rows, 256), device=device, dtype=torch.bfloat16,
                                 generator=gen))
        biases.append((torch.randn((256,), device=device, generator=gen) * 0.5).to(
            torch.bfloat16))
        inv_perms.append(sr.inv_perm)
    N, V2d = inv_perms[0].shape
    kernel = lambda: rig_bev_epilogue(tiles, inv_perms, biases)
    chain = lambda: sum(rig_epilogue(t, ip, b, torch.float32, True)
                        for t, ip, b in zip(tiles, inv_perms, biases)).to(torch.bfloat16)
    got = kernel()
    same = torch.equal(got.view(torch.int16),
                       rig_bev_sum(tiles, inv_perms, biases).view(torch.int16))
    differs = (got.float() - chain().float()).abs() > 0
    if not same:
        raise AssertionError(f"rig_bev_epilogue {data}: not its plain version's bits")
    del got
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms, plain_ms = [], []
    for _ in range(2):
        ms.append(cuda_time_ms(kernel, EPILOGUE_REPS))
        plain_ms.append(cuda_time_ms(chain, EPILOGUE_REPS))
    chain_peak = torch.cuda.max_memory_allocated() - base
    S = len(tiles)
    nbytes = S * N * batch * V2d * 512 + S * N * V2d * 8 + batch * V2d * 512
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    res = {"ms": min(ms), "plain_ms": min(plain_ms), "bound_ms": bound, "bytes": nbytes,
           "share_of_bound": bound / min(ms), "gb_per_s": nbytes / min(ms) * 1e-6,
           "batch": batch, "tiles_bytes": sum(t.numel() * 2 for t in tiles),
           "chain_transient_bytes": chain_peak, "chain_elements_changed": int(differs.sum())}
    log(f"rig_bev_epilogue {data} at B={batch}: {res['ms']:.3f} ms "
        f"({res['ms'] / batch:.4f} a scene), per-scale chain {res['plain_ms']:.3f} ms; "
        f"bound {bound:.3f} ms by bytes ({nbytes} B; {res['share_of_bound']:.1%} of the "
        f"bound, {res['gb_per_s']:.0f} GB/s); the same bits as rig_bev_sum; "
        f"{res['chain_elements_changed']} of {batch * V2d * 256} elements differ from the "
        f"chain's (its camera sum's order); tiles {res['tiles_bytes']} B, the chain's "
        f"transients {chain_peak} B")
    del tiles, kernel, chain
    torch.cuda.empty_cache()
    return res


MVDET_BATCH = 32       # the benchmark's MVDet serving batch
MVDET_REPS = 10


def phase_mvdet_project(device, batch: int = MVDET_BATCH) -> dict:
    """MVDet's projection `csrc/mvdet_project.cu` at the benchmark cell's
    shapes (`batch` scenes x 7 Wildtrack cameras of 512 x 90 x 160 random
    bf16 features, channels-last, to the 120 x 360 grid on maps of 270 x
    480, at the synthetic cameras' positions): against its plain version
    (`project_world_plain`, by `kernel_vs_plain` within one bf16 ulp or
    ATOL on at most ULP_SHARE of the elements, the card tests' limits), one
    launch a call; its time (CUDA events, best of two interleaved rounds of
    MVDET_REPS), its bound (the features read once and the world features
    written once, at PEAK_BYTES_PER_S), the plain version's time, and the
    library chain it replaces in `MVDet.project` (per camera: the fp32
    upsample, its bf16 cast, `grid_sample`, the copy into the world
    features) as `library_ms`."""
    import torch.nn.functional as F

    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import make_calibrations
    from vfa_tpu_torch.geometry import ground_positions, make_grid
    from vfa_tpu_torch.ops.projection import (ULP_SHARE, kernel_vs_plain, project_world,
                                              project_world_plain, sample_grid, warp)

    cfg = get_config("Wildtrack")
    size = tuple(int(s / 4) for s in cfg.image_size)
    grid = make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name)
    pos = ground_positions(make_calibrations(cfg), grid, cfg.name, cfg.image_size,
                           size).to(device)
    N, C, (L, W) = cfg.num_cam, 512, cfg.grid_shape
    feats = torch.randn((batch * N, C, 90, 160), device=device,
                        generator=torch.Generator(device=device).manual_seed(12))
    feats = feats.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    feats = feats.unflatten(0, (batch, N))
    world = torch.empty((batch, N * C + 2, L, W), device=device, dtype=torch.bfloat16)
    reset_launches()
    kernel = lambda: project_world(feats, pos, size, world)
    kernel()
    if read_launches()["mvdet_project"] != 1:
        raise AssertionError("mvdet_project: not one launch a call")
    plain = project_world_plain(feats, pos, size, torch.empty_like(world))
    torch.cuda.synchronize()
    worst, share = kernel_vs_plain(world, plain, feats)
    err = (0.0, 0.0)
    for n in range(N):
        a, b = world[:, n * C:(n + 1) * C], plain[:, n * C:(n + 1) * C]
        d = float((a.float() - b.float()).abs().max())
        err = (max(err[0], d), max(err[1], d / float(b.abs().max())))
    del plain
    torch.cuda.empty_cache()
    if worst > 1 or share > ULP_SHARE:
        raise AssertionError(f"mvdet_project: {worst} bf16 ulps from its plain version on "
                             f"{share:.2e} of the elements (limits 1 and {ULP_SHARE:.0e})")
    g = sample_grid(pos, *size)

    def chain():
        for n in range(N):
            up = F.interpolate(feats[:, n].float(), size, mode="bilinear", align_corners=False)
            up.to(torch.bfloat16)
            world[:, n * C:(n + 1) * C] = warp(up, g[n])

    ms, plain_ms, library_ms = [], [], []
    for _ in range(2):
        ms.append(cuda_time_ms(kernel, MVDET_REPS))
        plain_ms.append(cuda_time_ms(lambda: project_world_plain(feats, pos, size, world), 2))
        library_ms.append(cuda_time_ms(chain, 2))
    nbytes = 2 * (batch * N * C * 90 * 160 + batch * (N * C + 2) * L * W)
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    res = {"ms": min(ms), "plain_ms": min(plain_ms), "library_ms": min(library_ms),
           "bound_ms": bound, "bytes": nbytes, "share_of_bound": bound / min(ms),
           "gb_per_s": nbytes / min(ms) * 1e-6, "batch": batch, "err": err,
           "one_ulp_share": share}
    log(f"mvdet_project at B={batch}: {res['ms']:.3f} ms ({res['ms'] / batch:.4f} a scene); "
        f"bound {bound:.3f} ms by bytes ({nbytes} B; {res['share_of_bound']:.1%} of the bound, "
        f"{res['gb_per_s']:.0f} GB/s); plain {res['plain_ms']:.3f} ms; the library chain "
        f"(upsample, cast, grid_sample, copy) {res['library_ms']:.3f} ms; max abs err "
        f"{err[0]:.3e}, one bf16 ulp on {share:.2e} of the elements")
    del feats, world
    torch.cuda.empty_cache()
    return res


def phase_mvdet_path(device, batch: int = MVDET_BATCH) -> dict:
    """MVDet's serving path as the benchmark's `mvdet_wt_serve_b32` cell
    drives it: `predict --arch mvdet --dtype bfloat16` on `batch` synthetic
    Wildtrack scenes (7 x 720 x 1280 cameras) in one request, counts set to
    0 just before and read just after: `mvdet_project` once a request and
    no other kernel of the port; the heatmaps finite, of the grid's
    shape."""
    from vfa_tpu_torch import predict

    argv = ["--arch", "mvdet", "--data", "Wildtrack", "--synthetic", "--scenes", str(batch),
            "--batch", str(batch), "--seed", "0", "--device", "cuda", "--dtype", "bfloat16"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = predict.main(argv)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"MVDet serving path (bf16, batch {batch}): launches {launches} "
        f"({len(res['ms'])} requests, ms {res['ms']}); max_memory_allocated {peak} bytes")
    if launches["mvdet_project"] != len(res["ms"]):
        raise AssertionError(f"MVDet's serving path launched mvdet_project "
                             f"{launches['mvdet_project']} times, expected one a request")
    if any(n for name, n in launches.items() if name != "mvdet_project"):
        raise AssertionError("MVDet's serving path launched another kernel")
    for h in res["heatmaps"]:
        if tuple(h.shape) != (batch, 1, 120, 360) or not torch.isfinite(h).all():
            raise AssertionError(f"MVDet heatmap {tuple(h.shape)}, finite "
                                 f"{bool(torch.isfinite(h).all())}")
    torch.cuda.empty_cache()
    return {"launches": launches["mvdet_project"] // len(res["ms"]),
            "requests": len(res["ms"]), "ms": res["ms"], "peak": peak}


def phase_rig_vs_reference(rig, device, data: str):
    """The kernel route's summed BEV features against the reference voxel
    route's (rig=None) at full width, batch 1, same seeded weights, scale by
    scale and summed (the model's camera and scale sums, before the final
    cast): max abs and rel error beside tests/test_rig.py:47's rtol / atol,
    and the largest |err| / (atol + rtol |ref|)."""
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import make_scene
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights, voxel_contribution
    from vfa_tpu_torch.ops.rig_cuda import rig_sample_scale_cuda
    from vfa_tpu_torch.ops.voxel import sample_voxels, voxel_boxes

    cfg = get_config(data)
    model = init_weights(VFANet(cfg), torch.Generator().manual_seed(0)).to(device).eval()
    f64 = lambda t: t.to(torch.float64)
    scene = make_scene(cfg, seed=0, num_objects=6)
    images = torch.from_numpy(scene.images[None]).to(device)
    calibs = torch.from_numpy(scene.calibs[None]).to(device)
    grid = torch.from_numpy(scene.grid).to(device)
    L, W = cfg.grid_shape
    N = cfg.num_cam
    reset_launches()
    got_sum = want_sum = exact_sum = 0.0
    rows, rows64 = [], []
    with torch.no_grad():
        lats = model.laterals(images)
        boxes = [voxel_boxes(calibs[:, n], grid, dataset=cfg.name,
                             grid_height=cfg.grid_h, cube_size=cfg.cube_size,
                             image_size=cfg.image_size) for n in range(N)]
        for si, (sr, lat, lin) in enumerate(zip(rig.scales, lats, model.collapses())):
            lat5 = lat.permute(0, 2, 3, 1).reshape(1, N, *lat.shape[2:], -1)
            got = rig_sample_scale_cuda(lat5, sr, lin.weight.t(), lin.bias,
                                        out_dtype=torch.float32,
                                        camera_sum=True).reshape(1, L, W, -1)
            want = sum(voxel_contribution(lat[n:n + 1], boxes[n], lin)
                       for n in range(N))
            # the same voxel route in float64 (same boxes and weights): what
            # both fp32 routes round away from
            exact = sum(torch.relu(torch.nn.functional.linear(
                sample_voxels(f64(lat[n:n + 1]), f64(boxes[n])), f64(lin.weight),
                f64(lin.bias))) for n in range(N))
            rows.append((f"scale {si}", got, want))
            rows64 += [(f"scale {si}, rig route vs fp64 voxel route", got, exact),
                       (f"scale {si}, fp32 voxel route vs fp64 voxel route", want, exact)]
            got_sum, want_sum = got_sum + got, want_sum + want
            exact_sum = exact_sum + exact
    rows.append(("sum of the 3 scales", got_sum, want_sum))
    rows64 += [("sum, rig route vs fp64 voxel route", got_sum, exact_sum),
               ("sum, fp32 voxel route vs fp64 voxel route", want_sum, exact_sum)]
    if read_launches()["rig_window_fwd"] != sum(len(s.A) for s in rig.scales):
        raise AssertionError("the rig route did not run through rig_window_fwd")
    out = {}
    for tag, got, want in rows + rows64:
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"{data} rig vs reference {tag}: non-finite")
        diff = (got.double() - want.double()).abs()
        err, ref_max = float(diff.max()), float(want.abs().max())
        share = float((diff / (REF_ATOL + REF_RTOL * want.double().abs())).max())
        log(f"  {data} rig vs reference voxel route, {tag}: max abs err "
            f"{err:.3e}, max rel err {err / ref_max:.3e} (of max |ref| "
            f"{ref_max:.3e}); largest |err| / (atol + rtol |ref|) {share:.3f} "
            f"(rtol {REF_RTOL:.0e}, atol {REF_ATOL:.0e}, tests/test_rig.py:47)")
        out[tag] = (err, err / ref_max, share)
    log(f"phase 5 {data} rig vs reference at full width, batch 1: the fp32 "
        "routes are "
        f"{'within' if out['sum of the 3 scales'][2] <= 1 else 'OUTSIDE'} the "
        "tolerance of each other (ROADMAP F2); the rig route is "
        f"{out['sum, rig route vs fp64 voxel route'][2]:.3f} and the fp32 voxel "
        f"route {out['sum, fp32 voxel route vs fp64 voxel route'][2]:.3f} of it "
        "from the fp64 voxel route")
    if not out["sum, rig route vs fp64 voxel route"][2] <= 1:
        raise AssertionError(f"{data}: the rig route is outside rtol {REF_RTOL} / "
                             f"atol {REF_ATOL} of the fp64 voxel route")
    return out


def kernel_work(rig, B, backward: bool):
    """(flops, bytes) of all launches of one forward or one backward, each
    input read once and each output written once.
    Forward: A, starts, the padded features and Kr read, the tiles written.
    Backward: the A-sized product runs twice (vox, then A^T @ dvox) and so
    does the collapse-sized one (dKr, dvox), twice the forward's
    operations; A, starts, the padded features, Kr and g (tiles-sized) are
    read, dII is read and written (every bucket adds into it), dKr is
    written."""
    from vfa_tpu_torch.ops.rig import rig_matmul_flops

    flops = (2 if backward else 1) * B * rig_matmul_flops(rig, 256, 256)
    nbytes = 0
    e = rig.scales[0].A[0].element_size()   # features, Kr and tiles in A's dtype
    for sr in rig.scales:
        fh, fw = sr.feat_hw
        N = sr.A[0].shape[0]
        if sr.window_hw:
            pixels = (-(-fh // 8) * 8) * (-(-fw // 16) * 16)
        else:
            pixels = fh * fw + max(a.shape[-1] for a in sr.A)
        rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
        nbytes += sum(a.numel() * e + s.numel() * 4 for a, s in zip(sr.A, sr.starts))
        nbytes += (3 if backward else 1) * N * B * pixels * 256 * e    # ii (+ dII)
        nbytes += (2 if backward else 1) * sr.nl * 256 * 256 * e       # Kr (+ dKr)
        nbytes += N * B * rows * 256 * e                               # tiles or g
    return flops, nbytes


def rig_peak(rig) -> float:
    """The operation rate a rig kernel is held to: dense bf16 for the bf16
    variants, the fp32-accurate 3xTF32 rate (495 / 3) for the fp32 ones."""
    return PEAK_BF16_FLOPS if is_bf16(rig) else PEAK_TF32_FLOPS / 3


def bound_ms(flops, nbytes, peak_flops=PEAK_TF32_FLOPS / 3):
    """(ms, "operations" or "bytes"): the least time the card can take.
    Operations are counted once and, by default, held to the fp32-accurate
    tensor-core rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_numbers(rig, device, backward: bool, rounds: int = 2, batch: int = BATCH):
    """(ms, plain_ms, bound_ms, bound_by) of one rig kernel over the rig's
    three scales at batch `batch`: best of `rounds` interleaved rounds of
    kernel and plain version."""
    from vfa_tpu_torch.ops.rig_cuda import rig_scale_bwd, rig_tiles_cuda

    name = bwd_name(rig) if backward else fwd_name(rig)
    peak = rig_peak(rig)
    rate = ("989.4 TFLOP/s (dense bf16 on the tensor cores" if is_bf16(rig)
            else "165 TFLOP/s (3xTF32 on the tensor cores")
    if backward:
        inputs, kernel, plain = grad_inputs, rig_scale_bwd, plain_scale_bwd
    else:
        inputs, kernel, plain = scale_inputs, rig_tiles_cuda, plain_tiles
    ms = plain_ms = 0.0
    for si, sr in enumerate(rig.scales):
        first, *rest = inputs(sr, batch, 7 + si, device)
        k_ms, p_ms = [], []
        for _ in range(rounds):
            k_ms.append(cuda_time_ms(lambda: kernel(first, sr, *rest), reps=5))
            p_ms.append(cuda_time_ms(lambda: plain(first, sr, *rest), reps=3))
        f, b = kernel_work(type(rig)([sr], rig.grid_shape), batch, backward)
        log(f"  scale {si} B={batch}: {name} "
            + " / ".join(f"{t:.3f}" for t in k_ms) + " ms, plain "
            + " / ".join(f"{t:.3f}" for t in p_ms)
            + f" ms, bound {bound_ms(f, b, peak)[0]:.3f} ms at {rate}; "
            f"{bound_ms(f, b, PEAK_FP32_FLOPS)[0]:.3f} "
            f"ms at the CUDA cores' 67 TFLOP/s; {f / 1e9:.1f} GFLOP, "
            f"{b / 1e9:.3f} GB)")
        ms += min(k_ms)
        plain_ms += min(p_ms)
        del first, rest
    return (ms, plain_ms, *bound_ms(*kernel_work(rig, batch, backward), peak))


def phase_pass_shares(rig, device, batch: int = BATCH):
    """Device time of the fp32 forward kernel's two passes over one
    batch-`batch` forward of the rig's three scales, from a torch.profiler
    capture after a warm-up; logged as ms and as shares of the two passes'
    sum (the bf16 kernels' passes: `phase_bf16_passes`)."""
    from torch.profiler import ProfilerActivity, profile

    from vfa_tpu_torch.ops.rig_cuda import rig_tiles_cuda

    name = fwd_name(rig)
    passes = ("rig_vox_mma", "rig_collapse_mma")
    inputs = [scale_inputs(sr, batch, 7 + si, device) for si, sr in enumerate(rig.scales)]

    def forward():
        for sr, (lat, k) in zip(rig.scales, inputs):
            rig_tiles_cuda(lat, sr, k)
        torch.cuda.synchronize()

    forward()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        forward()
    events = prof.key_averages()
    ms = {p: sum(e.device_time_total for e in events if p in e.key) / 1e3
          for p in passes}
    total = sum(ms.values())
    if not total > 0:
        top = sorted(events, key=lambda e: -e.device_time_total)[:8]
        raise AssertionError(
            f"the profiler saw no device time of {name}'s passes {passes}; "
            "its largest: " + "; ".join(f"{e.key[:80]} {e.device_time_total}"
                                       for e in top))
    log(f"{name} passes at B={batch} (torch.profiler, one forward over the 3 "
        "scales): " + ", ".join(f"{p} {t:.3f} ms ({t / total:.1%})" for p, t in ms.items()))
    return ms


def phase_bf16_passes(rig_cache, layout: str):
    """Device time by pass, wall clock and host gap of the bf16 forward (one
    batch-2 forward) and backward (batch 2; on the window layout also batch
    1) over the 3 MultiviewC scales: window, K1-bf16 on the 12-bucket bf16
    rig and K2-bf16 on the 8-bucket one; flat, K4-bf16 and K5-bf16 on the
    8-bucket flat rig cast to bf16. `tools/prof_bf16_window.py` in a
    process of its own on the rigs of the run's cache (torch.profiler in
    this process stops seeing kernels after a few captures). Returns its
    JSON."""
    proc = subprocess.run(
        [sys.executable, "tools/prof_bf16_window.py", "--layout", layout,
         "--no_plain", "--json", "--cache_dir", rig_cache]
        + (["--b1"] if layout == "window" else []), capture_output=True,
        text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode or not lines or not lines[-1].startswith("{"):
        raise RuntimeError(f"tools/prof_bf16_window.py failed:\n{proc.stdout}"
                           f"\n{proc.stderr[-3000:]}")
    for ln in lines[:-1]:
        log(f"  {ln}")
    res = json.loads(lines[-1])
    for key, r in res.items():
        total = sum(r["passes_ms"].values())
        if not total > 0:
            raise AssertionError(f"{key}: the profiler saw no device time of the passes")
        log(f"rig_{layout}_{'fwd' if key == 'fwd' else 'bwd'}_bf16 "
            f"{key} passes (torch.profiler): "
            + ", ".join(f"{p} {t:.3f} ms ({t / total:.1%})"
                        for p, t in r["passes_ms"].items())
            + f"; device {r['device_ms']:.3f} ms, wall clock {r['wall_ms']:.3f} "
            f"ms, host gap {r['wall_ms'] - r['device_ms']:.3f} ms")
    return res


def phase_bf16_rounding(rig):
    """Each bucket of the bf16 window training rig with the rounding of
    its bf16 dII at B = 1, 2, 8 (`ops/rig.window_bwd_serial`, JAX's choice
    of kernel): "pipelined" (once per window) or "serial" (once per
    layer)."""
    from vfa_tpu_torch.ops.rig import window_bwd_serial

    for si, sr in enumerate(rig.scales):
        for bi, A_b in enumerate(sr.A):
            T, R, K = A_b.shape[1:]
            how = {B: "serial" if window_bwd_serial(B, K, R, A_b.element_size(),
                                                    A_b.element_size(), 256)
                   else "pipelined" for B in (1, 2, 8)}
            log(f"  bf16 dII rounding, scale {si} bucket {bi} (T {T}, rows {R}, "
                f"band {K} = {sr.window_hw[bi][0]}x{sr.window_hw[bi][1]}): "
                + ", ".join(f"B={B} {h}" for B, h in how.items()))


def phase_tf32_arithmetic(device):
    """Log what the split buys: the plain 3xTF32 product of `ops.rig`
    (the arithmetic the rig kernels are written to) against PyTorch's
    fp32 product on the card, with one, three and four TF32 products."""
    from vfa_tpu_torch.ops.rig import matmul_3xtf32

    g = torch.Generator().manual_seed(3)
    a = torch.rand((320, 2048), generator=g).to(device)
    b = torch.randn((2048, 256), generator=g).to(device)
    want = a @ b
    errs = {n: float((matmul_3xtf32(a, b, n) - want).abs().max() / want.abs().max())
            for n in (1, 3, 4)}
    log("3xTF32 arithmetic (plain, ops.rig.matmul_3xtf32) on a (320, 2048) @ "
        "(2048, 256) product, max err of the fp32 product's max: "
        + ", ".join(f"{n} product{'s' if n > 1 else ''} {e:.3e}"
                    for n, e in errs.items()))
    if not errs[3] < 1e-5 < errs[1]:
        raise AssertionError("the 3xTF32 split does not behave as the kernels assume")


def phase_stem_numbers(device, dtype=torch.float32):
    """name -> (ms, plain_ms, bound_ms, bound_by, GB/s, share of the bound)
    of the two stem kernels at STEM_SHAPE in `dtype` (the bf16 variants'
    names end in _bf16). Neither is a matrix product: a few tens of
    comparisons and ~10 flops per pixel. Bytes: x and dy read (in `dtype`)
    and the (M*C, 8) fp32 parameters, acc (stats, fp32) or dx (dx, in
    `dtype`) written. Then, as context, the whole fused backward
    (`gn_relu_pool_bwd`: both kernels and the small reductions between
    them) beside autograd of the unfused chain from its stored activations
    (what the fused stem replaces)."""
    from vfa_tpu_torch.ops import stem

    x, scale, bias, dy, mu, rstd = stem_inputs(device, integers=False, dtype=dtype)
    params = stem.plane_params(mu, rstd, scale, bias, mu * 1e-3, rstd * 1e-3)
    e = x.element_size()
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    out = {}
    for name, kernel, plain, written in (
            ("stem_bwd_stats" + suffix, stem.stem_bwd_stats,
             stem.stem_bwd_stats_plain, x.shape[0] * 4 * x.shape[1] * 4),
            ("stem_bwd_dx" + suffix, stem.stem_bwd_dx, stem.stem_bwd_dx_plain,
             x.numel() * e)):
        k_ms, p_ms = [], []
        for _ in range(2):
            k_ms.append(cuda_time_ms(lambda: kernel(x, dy, params), reps=10))
            p_ms.append(cuda_time_ms(lambda: plain(x, dy, params), reps=3))
        nbytes = e * (x.numel() + dy.numel()) + 4 * params.numel() + written
        flops = 50 * x.numel()
        b_ms, by = bound_ms(flops, nbytes, PEAK_FP32_FLOPS)
        gbps = nbytes / min(k_ms) / 1e6
        log(f"  {name} {tuple(x.shape)}: " + " / ".join(f"{t:.3f}" for t in k_ms)
            + " ms, plain " + " / ".join(f"{t:.3f}" for t in p_ms)
            + f" ms, bound {b_ms:.3f} ms by {by} ({nbytes / 1e9:.3f} GB, "
            f"~{flops / 1e9:.1f} GFLOP); {gbps:.0f} GB/s, "
            f"{b_ms / min(k_ms):.1%} of the bound")
        out[name] = (min(k_ms), min(p_ms), b_ms, by, gbps, b_ms / min(k_ms))
    del params
    fused = cuda_time_ms(lambda: stem.gn_relu_pool_bwd(x, scale, bias, dy, mu, rstd),
                         reps=5)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
        y = stem._chain(*leaves, 16, 1e-5)
        unfused = cuda_time_ms(lambda: torch.autograd.grad(y, leaves, dy,
                                                           retain_graph=True), reps=5)
    del y, leaves
    log(f"  stem backward at {tuple(x.shape)} {dtype}: fused (stem_bwd_stats + "
        f"stem_bwd_dx + reductions) {fused:.3f} ms, kernels alone "
        f"{sum(v[0] for v in out.values()):.3f} ms; autograd "
        f"of the unfused chain from its stored activations {unfused:.3f} ms")
    return out


DISK_FRAMES = 20       # frames of the on-disk MultiviewC set (the only cut)
DISK_SEED = 7
JITTER_TOL = 1e-5      # device_color_jitter and the IoU, CUDA against the CPU


def disk_root(base: str) -> str:
    return os.path.join(base, "MultiviewC")


def start_disk_rig_build(cache_dir, base):
    """A host process that builds the bf16 8-bucket window rig (the training
    policy) for the calibrations parsed back from the on-disk set's XMLs
    into the rig cache at `cache_dir`; returns it running. The XMLs are
    written here first."""
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.disk import write_multiviewc_calibrations

    write_multiviewc_calibrations(disk_root(base), get_config("MultiviewC"))
    code = ("import numpy as np, os, torch\n"
            "from vfa_tpu_torch.config import get_config\n"
            "from vfa_tpu_torch.calib import camera_matrix, load_extrinsic, load_intrinsic\n"
            "from vfa_tpu_torch.data.adapters import _MC_EXTR, _MC_INTR\n"
            "from vfa_tpu_torch.rig_cli import build_cli_rig\n"
            f"c = os.path.join({disk_root(base)!r}, 'calibrations')\n"
            "calibs = np.stack([camera_matrix(\n"
            "    load_intrinsic(os.path.join(c, 'intrinsic', _MC_INTR[i])),\n"
            "    load_extrinsic(os.path.join(c, 'extrinsic', _MC_EXTR[i]))[0])\n"
            "    for i in range(7)])\n"
            "build_cli_rig(get_config('MultiviewC'), calibs, 'cpu', buckets=8, "
            f"training=True, cache_dir={cache_dir!r}, dtype=torch.bfloat16)\n")
    return subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        cwd=os.path.dirname(os.path.abspath(__file__)))


def phase_disk_path(proc, base, rig_cache, device, serve_rig, staged):
    """The on-disk path at full MultiviewC width (7 x 720x1280 cameras,
    ResNet18-GN, the 156x156 BEV); only the frame count is cut, to
    DISK_FRAMES. Writes the set (PNGs, annotations, the XMLs the host
    process `proc` built the bf16 8-bucket window rig from), holds the
    loader's first batch to the written pixels, the device jitter and the
    IoU on the card to the CPU, the metrics on the GT as its own prediction;
    then drives the CLIs in this process, counts set to 0 before each and
    read after: train on disk (uint8 staging, the ColorJitter on the card,
    bf16, batch 2, one epoch), `--resume` to epoch 2, evaluate on that
    checkpoint; and the bench `--from_disk` (serving on `serve_rig`,
    training at batch 8). `staged`: the same run's staged bench results."""
    import contextlib
    import io

    from vfa_tpu_torch import bench, evaluate, train
    from vfa_tpu_torch.config import TrainConfig, get_config
    from vfa_tpu_torch.data.adapters import MultiviewC
    from vfa_tpu_torch.data.augment import device_color_jitter, sample_jitter_params
    from vfa_tpu_torch.data.disk import write_multiviewc
    from vfa_tpu_torch.data.frame_dataset import FrameDataset, SceneLoader
    from vfa_tpu_torch.eval.evaluate import evaluate_ap_aos, evaluate_rcll_prec_moda_modp
    from vfa_tpu_torch.eval.iou import iou_3d_pairwise
    from vfa_tpu_torch.native import matcher_backend
    from vfa_tpu_torch.native.imageio import decoder_backend
    from vfa_tpu_torch.rig_cli import build_cli_rig
    from vfa_tpu_torch.train_lib import current_lr

    t_phase = time.perf_counter()
    root = disk_root(base)
    cfg = dataclasses.replace(get_config("MultiviewC"), root=root)
    t0 = time.perf_counter()
    val_frames = range(int(DISK_FRAMES * 0.9), DISK_FRAMES)
    pixels = write_multiviewc(root, cfg, DISK_FRAMES, seed=DISK_SEED,
                              keep_frames=val_frames)
    log(f"phase 5d disk path: wrote {DISK_FRAMES} frames x 7 cameras of "
        f"{cfg.resize_size[0]}x{cfg.resize_size[1]} PNG (the frame count is the "
        f"only cut: the full set has {cfg.num_frame}) in "
        f"{time.perf_counter() - t0:.1f} s; decoder {decoder_backend('auto')}, "
        f"matcher {matcher_backend()}")
    base_ds = MultiviewC(root, world_size=cfg.world_size, cube_LWH=cfg.cube_size)
    train_ds = FrameDataset(base_ds, cfg, split="train")
    val_ds = FrameDataset(base_ds, cfg, split="val")

    # the loader: the first val batch is the written pixels; ms per scene
    first = next(iter(SceneLoader(val_ds, batch_size=2, images_dtype=np.uint8)))
    for b, f in enumerate(first["frame"]):
        for cam in range(1, 8):
            if not np.array_equal(first["images"][b, cam - 1], pixels[(cam, int(f))]):
                raise AssertionError(f"loader: frame {f} camera {cam} differs from "
                                     "the written pixels")
    loader = SceneLoader(train_ds, batch_size=2, shuffle=True, images_dtype=np.uint8)
    t0 = time.perf_counter()
    n = sum(len(b["frame"]) for b in loader)
    loader_ms = (time.perf_counter() - t0) * 1e3 / n
    x = first["images"]
    pageable = cuda_time_ms(lambda: torch.from_numpy(x).to(device), reps=5)
    pinned_x = torch.from_numpy(x).pin_memory()
    pinned = cuda_time_ms(lambda: pinned_x.to(device, non_blocking=True), reps=5)
    log(f"  loader: first val batch equal to the written pixels (frames "
        f"{first['frame'].tolist()}, 7 cameras); {n} train scenes in "
        f"{loader_ms:.2f} ms per scene (8 threads, uint8, PNG); H2D of one "
        f"uint8 batch of 2 ({x.nbytes} bytes): pageable {pageable:.3f} ms, "
        f"pinned non_blocking {pinned:.3f} ms (the CLIs copy pageable)")

    # device jitter and IoU on the card against the CPU
    imgs = torch.from_numpy(first["images"][0]).float() * (1.0 / 255.0)
    fac, order = sample_jitter_params(np.random.default_rng(0), imgs.shape[0])
    order[:6] = np.arange(6)
    got = device_color_jitter(imgs.to(device), fac, order).cpu()
    want = device_color_jitter(imgs, fac, order)
    jerr = float((got - want).abs().max())
    rng = np.random.default_rng(1)
    boxes = rng.uniform([0, 0, 0, 20, 20, 20, -np.pi], [400, 400, 100, 200, 200, 200, np.pi],
                        (2, 300, 7)).astype(np.float32)
    boxes[1, :100] = boxes[0, :100]
    a, bx = torch.from_numpy(boxes[0]), torch.from_numpy(boxes[1])
    ierr = float((iou_3d_pairwise(a.to(device), bx.to(device)).cpu()
                  - iou_3d_pairwise(a, bx)).abs().max())
    batch8 = torch.rand(8 * 7, *imgs.shape[1:], device=device)
    fac8, order8 = sample_jitter_params(np.random.default_rng(2), batch8.shape[0])
    jitter_ms = cuda_time_ms(lambda: device_color_jitter(batch8, fac8, order8), reps=5)
    del batch8
    log(f"  device_color_jitter CUDA vs CPU, 7 images at 720x1280: max abs err "
        f"{jerr:.3e}; IoU 300x300 pairs CUDA vs CPU: {ierr:.3e} (tolerance "
        f"{JITTER_TOL:.0e}); the jitter of a batch of 8 scenes (56 images) on "
        f"the card: {jitter_ms:.3f} ms")
    if not (jerr <= JITTER_TOL and ierr <= JITTER_TOL):
        raise AssertionError("the jitter or the IoU differs between the card and the CPU")

    # the metrics on the GT as its own prediction
    gt = np.array([[f, *o.location[:3], *np.asarray(o.dimension)[::-1], o.rotation]
                   for f, objs in enumerate(base_ds.labels) for o in objs], np.float64)
    files = {n: os.path.join(base, f"{n}.txt") for n in ("gt", "pred", "pr_gt", "pr_pred")}
    np.savetxt(files["gt"], gt)
    np.savetxt(files["pred"], np.c_[gt, np.ones(len(gt))])
    np.savetxt(files["pr_gt"], gt[:, :3])
    np.savetxt(files["pr_pred"], gt[:, :3])
    rcll, prec, moda, modp = evaluate_rcll_prec_moda_modp(files["pr_pred"], files["pr_gt"])
    ap = evaluate_ap_aos(files["pred"], files["gt"], device=device)
    log(f"  GT as its own prediction ({len(gt)} cows): MODA {moda}, MODP {modp}, "
        f"AP_50 {ap[3]}, AOS_50 {ap[4]}")
    if moda != 100.0 or abs(ap[3] - 100.0) > 1e-9:
        raise AssertionError("the GT as its own prediction does not score 100")

    # train on disk, resume, evaluate, through the prebuilt rig
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the disk rig build failed:\n{out}")
    log("host build of the disk set's bf16 rig (a process of its own): "
        + next(ln for ln in out.splitlines() if ln.startswith("compiled rig:")))
    rig = build_cli_rig(cfg, train_ds.calibs, device, buckets=8, training=True,
                        cache_dir=rig_cache, dtype=torch.bfloat16)
    savedir = os.path.join(base, "disk_runs")
    argv = ["--data", "MultiviewC", "--root", root, "-b", str(BATCH), "--dtype",
            "bfloat16", "--pretrained", "0", "--savedir", savedir, "--device", "cuda"]
    kernels = ("rig_window_fwd_bf16", "rig_window_bwd_bf16")
    runs = {}
    for tag, extra in (("train", ["-e", "1"]), ("resume", ["-e", "2", "--resume"])):
        if tag == "resume":
            extra = extra + [os.path.basename(runs["train"][0]["savedir"])]
        reset_launches()
        res = train.main(argv + extra, rig=rig)
        launches = read_launches()
        runs[tag] = (res, launches)
        log(f"  train on disk ({tag}): launches {launches}; steps "
            f"{len(res['ms'])}, p50 {np.median(res['ms']):.2f} ms a step, loader "
            f"wait p50 {np.median(res['wait_ms']):.2f} ms")
        # + the one-launch epilogue in the validation forward
        if any(launches[k] <= 0 for k in kernels + ("rig_bev_epilogue",)) or any(
                n for k, n in launches.items()
                if k not in kernels + ("rig_bev_epilogue",)):
            raise AssertionError(f"train on disk ({tag}) launched {launches}")
        if not all(np.isfinite(d["loss"]) for d in res["losses"]):
            raise AssertionError(f"train on disk ({tag}): a non-finite loss")
    first_run, resumed = runs["train"][0], runs["resume"][0]
    run_dir = first_run["savedir"]
    for path in (os.path.join(run_dir, "metrics.jsonl"), first_run["checkpoints"][0]):
        if not os.path.exists(path):
            raise AssertionError(f"train on disk wrote no {path}")
    spe = first_run["steps_per_epoch"]
    want_lr = current_lr(TrainConfig(epochs=2, pretrained=False, compute_dtype="bfloat16"),
                         spe, spe)
    log(f"  resumed at epoch {resumed['start_epoch']}; its first step's lr "
        f"{resumed['lrs'][0]!r}, the uninterrupted -e 2 schedule's at step {spe} "
        f"{want_lr!r}")
    if resumed["start_epoch"] != 2 or resumed["lrs"][0] != want_lr:
        raise AssertionError("--resume did not continue at epoch 2 on the schedule")
    stage_ms = float(np.median(first_run["ms"] + resumed["ms"]))
    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev = evaluate.main(["--data", "MultiviewC", "--root", root, "--checkpoint",
                            resumed["checkpoints"][-1], "-b", str(BATCH), "--dtype",
                            "bfloat16", "--rig_buckets", "8", "--cls_thresh", "0",
                            "--device", "cuda", "--out_dir", os.path.join(base, "eval")],
                           rig=rig)
    text = buf.getvalue()
    log("  " + text.strip().replace("\n", "\n  "))
    ev_launches = read_launches()
    if not (all(os.path.exists(p) for p in ev["paths"].values()) and "MODA" in text
            and "AP_50" in text and ev_launches["rig_window_fwd_bf16"] > 0):
        raise AssertionError(f"evaluate on disk: {ev['paths']}, launches {ev_launches}")
    log(f"  evaluate (cls_thresh 0: every NMS peak of the top 100, so that a "
        f"2-epoch model prints the metric lines): launches {ev_launches}")

    # the staged training CLI on the same rig (synthetic scenes in host memory)
    staged_res = train.main(["--data", "MultiviewC", "--synthetic", "--synthetic_frames",
                             str(len(train_ds)), "-b", str(BATCH), "-e", "1", "--dtype",
                             "bfloat16", "--pretrained", "0", "--no_augment",
                             "--savedir", savedir, "--device", "cuda"], rig=rig)

    # the bench from disk, serving (auto batch) and training at batch 8
    disk_dir = os.path.join(base, "bench_frames")
    bench_res = {}
    for tag, extra, brig in (("serving", ["--batch", "0"], serve_rig),
                             ("training", ["--train", "--batch", "8"], rig)):
        reset_launches()
        bench_res[tag] = bench.main(["--data", "MultiviewC", "--dtype", "bfloat16",
                                     "--from_disk", "--disk_dir", disk_dir, "--iters",
                                     "5", "--warmup", "1"] + extra, rig=brig)
        launches = read_launches()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        want = kernels if tag == "training" else kernels[:1]
        if any(launches[k] <= 0 for k in want):
            raise AssertionError(f"bench --from_disk {tag}: launches {launches}")
        log(f"  bench --from_disk {tag}: {bench_res[tag]}; launches {launches}")
    predicted = phase_predict_on_disk(root, resumed["checkpoints"][-1], rig, device, base)
    del rig
    torch.cuda.empty_cache()
    log(f"phase 5d disk path: train step p50 on disk {stage_ms:.2f} ms (uint8 "
        f"staging + jitter on the card), staged synthetic {np.median(staged_res['ms']):.2f} "
        f"ms (fp32 host images, no jitter), batch {BATCH}; loader {loader_ms:.2f} ms "
        f"per scene; bench bf16 serving from disk {bench_res['serving']['value']} "
        f"scenes/s, staged {staged['serving']['value']}; bf16 training (batch 8) from "
        f"disk {bench_res['training']['value']}, staged {staged['training']['value']}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"train": runs["train"][1], "resume": runs["resume"][1], "evaluate": ev_launches,
            "predict": predicted}


# phase 5e: the BEV-sharded path (parallel_bev.py) and --multihost
# (parallel.py), 2 ranks sharing the one card through gloo on CUDA tensors
BEV_SHARDS = 2


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def bev_config(tiny: bool):
    """(cfg, calibs, grid, feat shapes) of MultiviewC at full width (7 x
    720x1280 cameras, 156x156 BEV), or the tiny configuration with its 7
    cameras (`tiny` only drives the phase on the CPU)."""
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import make_calibrations, tiny_config
    from vfa_tpu_torch.geometry import make_grid
    from vfa_tpu_torch.ops.rig import pyramid_feat_shapes

    cfg = get_config("MultiviewC")
    if tiny:
        cfg = dataclasses.replace(tiny_config(cfg), num_cam=7)
    return (cfg, make_calibrations(cfg), make_grid(cfg.world_size, cfg.cube_size[:2], cfg.name),
            pyramid_feat_shapes(cfg.resize_size))


def bev_rig(rig_cache, buckets: int, tiny: bool = False):
    """The bf16 BEV-sharded rig of BEV_SHARDS slabs (`buckets` a slab),
    loaded from or built into the rig cache at `rig_cache`."""
    from vfa_tpu_torch.ops.rig import default_tile_v
    from vfa_tpu_torch.parallel_bev import build_bev_sharded_rig

    cfg, calibs, grid, shapes = bev_config(tiny)
    return build_bev_sharded_rig(calibs, cfg, grid, shapes, num_shards=BEV_SHARDS,
                                 tile_v=default_tile_v(cfg.num_layers, torch.bfloat16),
                                 dtype=torch.bfloat16, band_buckets=buckets,
                                 cache_dir=rig_cache)


def start_bev_rig_build(cache_dir):
    """A host process that builds the bf16 BEV-sharded rig (8 buckets a
    slab, the training policy; the phase's sampling, train step and bench
    all take it) into the rig cache; returns it running."""
    code = ("import time, chip_smoke\n"
            "t0 = time.perf_counter()\n"
            f"r = chip_smoke.bev_rig({cache_dir!r}, 8)\n"
            "a = sum(t.numel() * t.element_size() for s in r.scales for t in s.A)\n"
            "print(f'bev rig: 8 buckets a slab, {r.num_shards} slabs of '\n"
            "      f'{r.slab_rows} rows, A {a} bytes (both slabs), '\n"
            "      f'{time.perf_counter() - t0:.1f} s')\n")
    return subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        cwd=os.path.dirname(os.path.abspath(__file__)))


def bev_inputs(cfg, shapes, nl, B, device, dtype=torch.bfloat16):
    """Seeded features (B, N, fh, fw, 256), collapse kernels and biases of
    the three scales, and the loss weights w (B, L, W, 256)."""
    g = torch.Generator().manual_seed(70 + B)
    L, W = cfg.grid_shape
    lats = [torch.rand((B, cfg.num_cam, fh, fw, 256), generator=g) for fh, fw in shapes]
    ks = [torch.randn((256 * nl, 256), generator=g) * 0.05 for _ in shapes]
    bs = [torch.randn((256,), generator=g) * 0.1 for _ in shapes]
    w = torch.randn((B, L, W, 256), generator=g)
    cast = lambda ts: [t.to(torch.bfloat16).to(device=device, dtype=dtype) for t in ts]
    return cast(lats), cast(ks), cast(bs), w.to(device)


def sample_and_grad(sample, lats, ks, bs, w):
    """(features, feature grads, collapse grads in fp32) of sum(out * w)."""
    la = [t.clone().requires_grad_() for t in lats]
    ka = [t.clone().requires_grad_() for t in ks]
    out = sample(la, ka, bs)
    (out.float() * w).sum().backward()
    return out.detach(), [t.grad for t in la], [t.grad.float() for t in ka]


def unsharded_sample(rig):
    from vfa_tpu_torch.ops.rig_cuda import rig_sample_scale_cuda

    L, W = rig.grid_shape

    def sample(lats, ks, bs):
        out = 0
        for sr, lat, k, b in zip(rig.scales, lats, ks, bs):
            out = out + rig_sample_scale_cuda(lat, sr, k, b, out_dtype=torch.float32,
                                              camera_sum=True)
        return out.reshape(lats[0].shape[0], L, W, -1).to(lats[0].dtype)

    return sample


def model_step(cfg, rig, mesh, device, dtype: str, B: int = 1) -> dict:
    """One train step of the seeded full-width model (init seed 0) at
    TRAIN_LR on synthetic scenes 0..B-1, on `mesh` (None: one process):
    the loss, the update of all parameters as one vector and the
    launches; the heatmap of the model before it in eval mode (serving:
    running statistics) and in training mode (batch statistics), its
    buffers kept; then a second step on the same batch, whose ms it
    reports (the first pays the warm-up)."""
    from vfa_tpu_torch.config import TrainConfig
    from vfa_tpu_torch.entry import DIM_MEAN, synthetic_batch
    from vfa_tpu_torch.kernels import launch_counts
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights
    from vfa_tpu_torch.train_lib import (_forward, batch_to_device, make_optimizer,
                                         make_train_step)

    tcfg = TrainConfig(pretrained=False, lr=float(TRAIN_LR), epochs=1, compute_dtype=dtype)
    model = init_weights(VFANet(cfg), torch.Generator().manual_seed(0)).to(device)
    model.mesh = mesh
    flat = lambda: torch.cat([p.detach().reshape(-1).float() for p in model.parameters()])
    before = flat()
    step = make_train_step(model, make_optimizer(model, tcfg, 1), cfg, tcfg,
                           dim_mean=DIM_MEAN, mesh=mesh)
    batch = batch_to_device(synthetic_batch(cfg, range(B)), device,
                            torch.bfloat16 if dtype == "bfloat16" else None)
    heat = {}
    for mode in ("eval", "train"):
        saved = [b.clone() for b in model.buffers()]
        with torch.no_grad():
            heat[mode] = _forward(model.train(mode == "train"), getattr(torch, dtype),
                                  batch, rig)["heatmap"].float().cpu()
        for b, v in zip(model.buffers(), saved):
            b.copy_(v)
    sync(device)
    n0 = launch_counts()
    loss = float(step(batch, rig)["loss"])
    sync(device)
    launches = launch_delta(n0, launch_counts())
    update = (flat() - before).cpu()
    t0 = time.perf_counter()
    step(batch, rig)
    sync(device)
    return {"loss": loss, "update": update, "launches": launches, "heatmap": heat,
            "ms": (time.perf_counter() - t0) * 1e3}


def bev_rank(device, rig_cache, tiny: bool) -> dict:
    """One rank of phase 5e's sharded sampling and train step: its slab of
    the 8-bucket bf16 BEV-sharded rig (from the rig cache), sampling and
    its gradients at B = 2 and B = 1 (the collapse gradients summed over
    the slabs in fp32), launches counted around each; then K1-bf16 and the
    bf16 window backward on the slab's unified buckets (zero A tiles,
    re-clamped origins, the common windows, the rebuilt dII order) against
    their plain versions at B = 2 and B = 1 (K3's per-layer rounding), as
    phase 2 holds them on the unsharded rig; then one full-model train
    step at B = 1. Rank 0 also returns the tensors."""
    import torch.distributed as dist

    from vfa_tpu_torch import parallel_bev
    from vfa_tpu_torch.kernels import launch_counts
    from vfa_tpu_torch.ops.rig import window_bwd_serial

    mesh = parallel_bev.make_bev_mesh(data=1, bev=BEV_SHARDS)
    t0 = time.perf_counter()
    srig = bev_rig(rig_cache, 8, tiny).slab(mesh, device)
    first = srig.rows.index == 0
    res = {"load_s": time.perf_counter() - t0,
           "buckets": [len(sr.A) for sr in srig.scales],
           # (camera, tile) pairs of the slab's buckets, and those all zero
           "tiles": sum(a.shape[0] * a.shape[1] for sr in srig.scales for a in sr.A),
           "zero_tiles": sum(int((~a.flatten(2).ne(0).any(-1)).sum())
                             for sr in srig.scales for a in sr.A),
           "A_bytes": sum(a.numel() * a.element_size() for sr in srig.scales for a in sr.A)}
    cfg, _, _, shapes = bev_config(tiny)
    sharded = lambda la, ka, bs: parallel_bev.gather_bev(
        parallel_bev.sample_bev_sharded(la, srig, ka, bs), srig)
    for B in (2, 1):
        lats, ks, bs, w = bev_inputs(cfg, shapes, srig.scales[0].nl, B, device)
        sync(device)
        n0 = launch_counts()
        out, dII, dK = sample_and_grad(sharded, lats, ks, bs, w)
        sync(device)
        launches = launch_delta(n0, launch_counts())
        t0 = time.perf_counter()               # again, warm: its ms
        sample_and_grad(sharded, lats, ks, bs, w)
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        for g in dK:                     # the collapses sum over the slabs
            dist.all_reduce(g)
        res[B] = {"launches": launches, "ms": ms,
                  "serial": sum(window_bwd_serial(B, a.shape[3], a.shape[2], 2, 2, 256)
                                for sr in srig.scales for a in sr.A)}
        if first:
            res[B].update(out=out.cpu(), dII=[t.cpu() for t in dII], dK=[t.cpu() for t in dK])
        del out, dII, dK, lats, ks, bs, w
    where = f"phase 5e slab {srig.rows.index}"
    res["plain_fwd"] = phase_kernel_vs_plain(srig, device, (2, 1), where)
    res["plain_bwd"] = phase_bwd_kernel_vs_plain(srig, device, (2, 1), where)
    step = model_step(cfg, srig, mesh, device, "bfloat16")
    if not first:
        del step["update"]
    res["step"] = step
    return res


def rig_as_fp32(rig):
    """A rig with A cast to fp32: the same sampling without bf16 rounding
    of the features (the reference of the bf16 routes' noise)."""
    return type(rig)([dataclasses.replace(sr, A=tuple(a.float() for a in sr.A))
                      for sr in rig.scales], rig.grid_shape)


def noise_check(what, got, bf16, fp32):
    """The sharded bf16 route's distance from the fp32 route within
    BF16_NOISE_RATIO of the unsharded bf16 route's (what bf16 rounding
    does to the unsharded result); returns (sharded/unsharded rel-L2,
    ratio)."""
    norm = lambda t: float(torch.linalg.vector_norm(t.float()))
    err_s = norm(got.float() - fp32.float())
    err_u = norm(bf16.float() - fp32.float())
    rel = norm(got.float() - bf16.float()) / max(norm(bf16), 1e-30)
    ratio = err_s / max(err_u, 1e-30)
    log(f"  {what}: sharded vs unsharded rel-L2 {rel:.3e}; distance from the "
        f"fp32 route {err_s:.4e}, the unsharded bf16 route's {err_u:.4e} (ratio "
        f"{ratio:.3f}, tolerance {BF16_NOISE_RATIO})")
    if not ratio <= BF16_NOISE_RATIO:
        raise AssertionError(f"{what}: the sharded route is {ratio:.3f} times the "
                             "unsharded route's distance from fp32")
    return rel, ratio


def check_bev_launches(tag, launches, want):
    """Each of `want`'s kernels launched exactly that often; nothing else."""
    bad = {k: n for k, n in launches.items() if n != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{tag}: launches {launches}, want {want}")


def phase_bev(proc, rig_cache, device, rig16, tiny=False) -> dict:
    """Phase 5e (2, 3): BEV-sharded sampling with its gradients at B = 2
    and 1 and one full-model bf16 train step at B = 1 in BEV_SHARDS ranks on
    the card (gloo, CUDA tensors), against the unsharded bf16 window rig
    `rig16` (8 buckets) and, for the noise of the sums across ranks, the
    same rig cast to fp32; each rank's kernels against their plain versions
    on its slab (`bev_rank`)."""
    from vfa_tpu_torch.launch import run_ranks

    t_phase = time.perf_counter()
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the BEV rig builds failed:\n{out}")
        for line in out.splitlines():
            if line.startswith("bev rig:"):
                log(f"phase 5e host build (a process of its own): {line}")
    t0 = time.perf_counter()
    runs = run_ranks("chip_smoke:bev_rank", BEV_SHARDS, args=(rig_cache, tiny),
                     device=device.type, threads=4, timeout=1200)
    ranks = [r["result"] for r in runs]
    log(f"phase 5e BEV-sharded ranks: {BEV_SHARDS} ranks sharing the card ran in "
        f"{time.perf_counter() - t0:.1f} s (slab load {ranks[0]['load_s']:.1f} s, "
        f"A of a slab {ranks[0]['A_bytes']} bytes, buckets {ranks[0]['buckets']})")
    for r, (rank, run) in enumerate(zip(ranks, runs)):
        log(f"  rank {r}: {rank['zero_tiles']} of its slab's {rank['tiles']} (camera, "
            "tile) pairs are all-zero A tiles of the unified buckets; its kernels "
            "against their plain versions on the slab:")
        for line in run["log"].splitlines():
            if line.startswith(("  rig_window_", "phase 5e slab")):
                log(f"  {line}")
    nb, ns = sum(ranks[0]["buckets"]), len(ranks[0]["buckets"])
    on_card = device.type == "cuda"
    want = {"rig_window_fwd_bf16": ns, "rig_window_bwd_bf16": nb} if on_card else {}
    rig32 = rig_as_fp32(rig16)
    cfg, _, _, shapes = bev_config(tiny)
    nl = rig16.scales[0].nl
    out = {"ms": {}}
    for B in (2, 1):
        for r, rank in enumerate(ranks):
            check_bev_launches(f"rank {r} sampling at B={B}", rank[B]["launches"], want)
        serial = ranks[0][B]["serial"]
        if on_card and (B == 1 and serial != nb or B == 2 and serial == nb):
            raise AssertionError(f"B={B}: {serial} of {nb} slab buckets serial (K3)")
        lats, ks, bs, w = bev_inputs(cfg, shapes, nl, B, device)
        o16, d16, k16 = sample_and_grad(unsharded_sample(rig16), lats, ks, bs, w)
        lats32, ks32, bs32 = ([t.float() for t in ts] for ts in (lats, ks, bs))
        o32, d32, k32 = sample_and_grad(unsharded_sample(rig32), lats32, ks32, bs32, w)
        got = ranks[0][B]
        check_bf16(f"B={B} sharded BEV features vs unsharded", got["out"].to(device), o16)
        for si in range(ns):
            noise_check(f"B={B} scale {si} dII", got["dII"][si].to(device), d16[si], d32[si])
            noise_check(f"B={B} scale {si} dKr", got["dK"][si].to(device), k16[si], k32[si])
        out["ms"][B] = [rank[B]["ms"] for rank in ranks]
        log(f"  B={B}: per rank K1-bf16 {ns} launches (one a scale), the bf16 "
            f"window backward {nb} (one a bucket; {serial} serial, K3's per-layer "
            f"rounding), no other kernel; sampling + backward (a second, warm call) "
            + ", ".join(f"{m:.2f}" for m in out["ms"][B]) + " ms per rank")
        del lats, ks, bs, w, o16, d16, k16, o32, d32, k32, lats32, ks32, bs32
    # the full-model BEV-sharded train step at B = 1; the heatmaps before
    # it, in eval and training mode, hold the halo rows and the cross-slab
    # norms cell by cell
    s16 = model_step(cfg, rig16, None, device, "bfloat16")
    s32 = model_step(cfg, rig32, None, device, "float32")
    got = ranks[0]["step"]
    out["heatmap"] = {mode: check_bf16(
        f"full-model sharded heatmap before the step ({mode} mode) vs unsharded",
        got["heatmap"][mode], s16["heatmap"][mode]) for mode in ("eval", "train")}
    for r, rank in enumerate(ranks):
        check_bev_launches(f"rank {r} train step", rank["step"]["launches"], want)
    losses = [rank["step"]["loss"] for rank in ranks]
    if not all(abs(x - s16["loss"]) <= BF16_LOSS_TOL * abs(s16["loss"]) for x in losses):
        raise AssertionError(f"sharded step losses {losses}, unsharded {s16['loss']}")
    norm = lambda t: float(torch.linalg.vector_norm(t))
    dist_u = norm(got["update"] - s16["update"]) / norm(s16["update"])
    noise = norm(s32["update"] - s16["update"]) / norm(s16["update"])
    log(f"phase 5e full-model BEV-sharded bf16 train step (B=1, lr {TRAIN_LR}, halos "
        f"and cross-slab norms): losses {losses} vs unsharded {s16['loss']} (rel "
        f"{BF16_LOSS_TOL:.0e}); update {dist_u:.3e} of the unsharded update's norm "
        f"away from it, the fp32 route's {noise:.3e} (tolerance {BF16_NOISE_RATIO}x "
        f"that, and {BF16_UPDATE_CAP}); a second, warm step "
        + ", ".join(f"{rank['step']['ms']:.1f}" for rank in ranks)
        + f" ms per rank, unsharded {s16['ms']:.1f} ms")
    if not (dist_u <= BF16_NOISE_RATIO * noise and dist_u <= BF16_UPDATE_CAP):
        raise AssertionError("the sharded step's update is off the unsharded one's")
    out.update(plain_fwd=worst_of([rank["plain_fwd"] for rank in ranks]),
               plain_bwd=worst_of([rank["plain_bwd"] for rank in ranks]),
               launches_b2=ranks[0][2]["launches"], launches_b1=ranks[0][1]["launches"],
               step=ranks[0]["step"]["launches"], step_ms=[r["step"]["ms"] for r in ranks],
               unsharded_step_ms=s16["ms"], serial_b1=ranks[0][1]["serial"], buckets=nb,
               seconds=time.perf_counter() - t_phase)
    return out


def rank_home(base, rig_cache) -> str:
    """A HOME whose ~/.cache/vfa_tpu_torch_rig is the run's rig cache: the
    CLIs' ranks load the prebuilt rigs from there."""
    home = os.path.join(base, "home")
    os.makedirs(os.path.join(home, ".cache"), exist_ok=True)
    link = os.path.join(home, ".cache", "vfa_tpu_torch_rig")
    if not os.path.exists(link):
        os.symlink(rig_cache, link)
    return home


def phase_multihost(rig16, home, base, device, tiny=False) -> dict:
    """Phase 5e (4): `python -m vfa_tpu_torch.train --multihost` in 2
    processes on the card (-b 1 each, 2 steps, bf16) against one process at
    -b 2 on the same frames: the epoch's train loss within BF16_LOSS_TOL,
    the update within BF16_NOISE_RATIO of the one-process bf16 route's
    distance from its fp32 route (the rig cast to fp32) and within
    BF16_UPDATE_CAP of its norm."""
    from vfa_tpu_torch import train
    from vfa_tpu_torch.checkpoint import load_state
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights
    from vfa_tpu_torch.parallel import free_port

    t_phase = time.perf_counter()
    argv = ["--data", "MultiviewC", "--synthetic", "--synthetic_frames", "4", "-e", "1",
            "--pretrained", "0", "--no_augment", "--vis_iter", "0", "--lr", TRAIN_LR,
            "--device", device.type] + (["--tiny"] if tiny else [])
    multi = os.path.join(base, "multihost")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vfa_tpu_torch.train", *argv, "--dtype", "bfloat16",
         "-b", "1", "--savedir", multi, "--multihost", "--coordinator",
         f"localhost:{port}", "--num_processes", "2", "--process_id", str(r)],
        env={**os.environ, "HOME": home}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__))) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise RuntimeError(f"--multihost rank {r} failed:\n{text[-4000:]}")
    ms = []
    for r, text in enumerate(logs):
        keep = [ln for ln in text.splitlines() if ln.startswith(
            ("multihost:", "compiled rig:", "[TRAIN]", "[VAL]", "steps ", "kernel launches"))]
        log(f"  --multihost rank {r}: " + "\n    ".join(keep))
        # the last step's (the first pays the warm-up)
        ms.append(float(re.search(r"ms per step ([0-9. ]+);", text).group(1).split()[-1]))
        if device.type == "cuda":
            launches = json.loads(re.search(r"kernel launches \(this process\): (\{.*\})",
                                            text).group(1))
            if (launches["rig_window_fwd_bf16"] <= 0 or launches["rig_window_bwd_bf16"] <= 0
                    or any(n for k, n in launches.items() if not k.endswith("_bf16"))):
                raise AssertionError(f"--multihost rank {r} launched {launches}")
    one16 = train.main(argv + ["--dtype", "bfloat16", "-b", "2", "--savedir",
                               os.path.join(base, "one16")], rig=rig16)
    one32 = train.main(argv + ["-b", "2", "--savedir", os.path.join(base, "one32")],
                       rig=rig_as_fp32(rig16))
    run = os.path.join(multi, os.listdir(multi)[0])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = {r["tag"]: r for r in map(json.loads, f)}
    state = load_state(os.path.join(run, "checkpoints", "epoch_0001"))["model"]
    cfg = bev_config(tiny)[0]
    names = [n for n, _ in VFANet(cfg).named_parameters()]
    init = init_weights(VFANet(cfg), torch.Generator().manual_seed(1)).state_dict()
    flat = lambda sd: torch.cat([sd[n].detach().reshape(-1).float().cpu() for n in names])
    upd = {k: flat(sd) - flat(init) for k, sd in (
        ("multi", state), ("one16", one16["model"].state_dict()),
        ("one32", one32["model"].state_dict()))}
    norm = lambda t: float(torch.linalg.vector_norm(t))
    dist_u = norm(upd["multi"] - upd["one16"]) / norm(upd["one16"])
    noise = norm(upd["one32"] - upd["one16"]) / norm(upd["one16"])
    want = float(np.mean([d["loss"] for d in one16["losses"]]))
    log(f"phase 5e --multihost: 2 ranks (-b 1 each) vs one process (-b 2), 2 steps "
        f"bf16: train loss {rows['train']['loss']:.6f} vs {want:.6f} (rel "
        f"{BF16_LOSS_TOL:.0e}), val {rows['val']['loss']:.6f} vs "
        f"{one16['val_losses'][0]['loss']:.6f}; update {dist_u:.3e} of the one-process "
        f"update's norm away from it, its fp32 route's {noise:.3e} (tolerance "
        f"{BF16_NOISE_RATIO}x that, and {BF16_UPDATE_CAP}); the second step {ms} ms per "
        f"rank, one process {one16['ms'][-1]:.1f} ms; {time.perf_counter() - t_phase:.1f} s")
    if not (abs(rows["train"]["loss"] - want) <= BF16_LOSS_TOL * abs(want)
            and dist_u <= BF16_NOISE_RATIO * noise and dist_u <= BF16_UPDATE_CAP):
        raise AssertionError("--multihost does not match one process")
    return {"ms": ms, "one_ms": one16["ms"][-1]}


def phase_bev_bench(rig16, home, device, tiny=False) -> dict:
    """Phase 5e (5): the bench `--bev_shards 2 --dtype bfloat16` on
    MultiviewC serving (2 ranks sharing the card, each on its slab from
    the rig cache), beside the unsharded bench of this call on `rig16`,
    at the same batch and with the same 8 buckets: the cost of the path
    on one card, not a speed-up."""
    import contextlib
    import io

    from vfa_tpu_torch import bench

    argv = ["--data", "MultiviewC", "--dtype", "bfloat16", "--batch", "2", "--buckets",
            "8", "--iters", "5", "--warmup", "1", "--device", device.type]
    argv += ["--tiny"] if tiny else []
    old = os.environ.get("HOME")
    os.environ["HOME"] = home
    buf = io.StringIO()
    try:
        with contextlib.redirect_stderr(buf):
            sharded = bench.main(argv + ["--bev_shards", str(BEV_SHARDS)])
    finally:
        os.environ["HOME"] = old
    err = buf.getvalue()
    per_rank = [json.loads(m) for m in re.findall(r"# rank \d kernel launches: (\{.*\})", err)]
    if len(per_rank) != BEV_SHARDS or (device.type == "cuda" and any(
            r["rig_window_fwd_bf16"] <= 0 or any(n for k, n in r.items() if not k.endswith("_bf16"))
            for r in per_rank)):
        raise AssertionError(f"bench --bev_shards: launches {per_rank}\n{err[-3000:]}")
    plain = bench.main(argv, rig=rig16)
    log(f"phase 5e bench bf16 serving, batch 2, 8 buckets: unsharded {plain['value']} scenes/s; "
        f"--bev_shards {BEV_SHARDS} (2 ranks sharing the one card through gloo: the "
        f"cost of the path on one card, not a speed-up) {sharded['value']} scenes/s "
        f"({sharded['metric']}); the ranks' launches {per_rank}")
    return {"sharded": sharded, "unsharded": plain, "launches": per_rank}


def phase_predict_on_disk(root, ckpt, rig, device, base, tiny=False) -> dict:
    """Phase 5e (1): the predict CLI on disk (a val scene of the written
    set, the resumed run's checkpoint, bf16, the 8-bucket rig), counts set
    to 0 before and read after (K1-bf16 once a scale, the serving epilogue
    once, no other kernel),
    its heatmap against the plain route's (rel-L2 BF16_PATH_L2)."""
    from vfa_tpu_torch import predict

    argv = ["--data", "MultiviewC", "--root", root, "--checkpoint", ckpt, "--index",
            "0", "--out", os.path.join(base, "prediction.png"), "--dtype", "bfloat16",
            "--rig_buckets", "8", "--cls_thresh", "0.5", "--device", device.type]
    argv += ["--tiny"] if tiny else []
    reset_launches()
    res = predict.main(argv, rig=rig)
    launches = read_launches()
    plain = predict.main(argv + ["--rig_impl", "plain"], rig=rig)
    got, want = res["heatmaps"][0], plain["heatmaps"][0]
    l2 = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    log(f"phase 5e predict on disk: launches {launches}; {len(res['detections'][0])} "
        f"detections; heatmap rel-L2 {l2:.3e} from the plain route's (tolerance "
        f"{BF16_PATH_L2:.0e}); {res['ms'][0]:.1f} ms; figure "
        + (f"written to {res['figure']}" if res["figure"] else "not written "
           "(matplotlib is not installed)"))
    want_launches = ({"rig_window_fwd_bf16": 3, "rig_bev_epilogue": 1}
                     if device.type == "cuda" else {})
    check_bev_launches("predict on disk", launches, want_launches)
    if not l2 <= BF16_PATH_L2:
        raise AssertionError("predict on disk disagrees with the plain route")
    return {"launches": launches, "figure": res["figure"], "ms": res["ms"][0]}


# Phase 5f: the bf16 voxel route and the memory options (PR 15)
MEM_BATCH = 8          # the bench's bf16 training batch
MEM_STEPS = 3
MEM_OPTIONS = (("none", {}), ("backbone_remat", {"backbone_remat": True}),
               ("stem_remat", {"stem_remat": True}),
               ("backbone_chunks=2", {"backbone_chunks": 2}),
               ("all three", {"backbone_remat": True, "stem_remat": True,
                              "backbone_chunks": 2}))
MEM_KERNELS = ("rig_window_fwd_bf16", "rig_window_bwd_bf16", "stem_bwd_stats_bf16",
               "stem_bwd_dx_bf16")
GRID2X_BUCKETS = 12    # the bench's grid2x policy


def grid2x_config(tiny: bool = False):
    """MultiviewC with the ground cube halved (a 312x312 BEV), as the
    bench's --grid2x makes it (`tiny` only drives the phase on the CPU)."""
    from vfa_tpu_torch import bench

    return bench.bench_config(bench.parse_args(["--grid2x"] + (["--tiny"] if tiny else [])))


def grid2x_rig(device, cache_dir, tiny: bool = False):
    """The bf16 grid2x MultiviewC rig the bench samples through (12
    buckets), loaded from or built into the rig cache at `cache_dir`."""
    from vfa_tpu_torch.data.synthetic import make_calibrations
    from vfa_tpu_torch.rig_cli import build_cli_rig

    cfg = grid2x_config(tiny)
    return build_cli_rig(cfg, make_calibrations(cfg), device, buckets=GRID2X_BUCKETS,
                         cache_dir=cache_dir, dtype=torch.bfloat16)


def start_grid2x_rig_build(cache_dir, tiny: bool = False):
    """A host process that builds the bf16 grid2x rig into the rig cache;
    returns it running."""
    code = f"import chip_smoke\nchip_smoke.grid2x_rig('cpu', {cache_dir!r}, {tiny})\n"
    return subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        cwd=os.path.dirname(os.path.abspath(__file__)))


def errors(got, want) -> tuple:
    """(max abs err, max abs err / max |want|, rel-L2) in float64."""
    d = (got.double() - want.double()).abs()
    ref = want.double()
    return (float(d.max()), float(d.max() / ref.abs().max()),
            float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(ref)))


VOXEL_TAP_REPS = 5
VOXEL_TAP = {torch.float32: "voxel_tap_bwd", torch.bfloat16: "voxel_tap_bwd_bf16"}


def voxel_tap_work(order, shape, dtype) -> tuple:
    """(bytes, operations) of the ordered transpose of one sample_voxels
    call: the stacked corner cotangents (4 B P, C) fp32 and the order index
    read once, the integral image's cotangent written once; a product and
    an add an update and channel, the chain's 15 joins a pixel and channel."""
    B, C, H, W = shape
    entries = order.rows.numel()
    nbytes = (entries // 4 * C * 4 + order.ptr.numel() * 4 + entries * 8
              + B * C * H * W * torch.finfo(dtype).bits // 8)
    return nbytes, 2 * entries * C + 15 * B * H * W * C


def scatter_add_ms(g, order, shape, dtype) -> float:
    """One `scatter_add_` of the same updates (the 16 taps' rnd(g * w), in
    `dtype`) into the integral image's cotangent (B = 1), laid out as
    torch.gather's backward lays it out: what the port ran before, the sums
    in another order, with atomics."""
    B, C, H, W = shape
    counts = order.ptr[1:] - order.ptr[:-1]
    key = torch.repeat_interleave(torch.arange(counts.numel(), device=g.device), counts,
                                  output_size=order.rows.numel())
    src = (g[order.rows.long()] * order.w[:, None]).to(dtype).t().contiguous()[None]
    index = (key % (H * W))[None, None].expand(1, C, -1)
    target = torch.zeros((1, C, H * W), dtype=dtype, device=g.device)
    ms = cuda_time_ms(lambda: target.zero_().scatter_add_(-1, index, src), 3)
    del src, index
    return ms


def phase_voxel_tap(lat, box, device) -> dict:
    """Phase 5f: csrc/voxel_tap_bwd.cu at full MultiviewC width, camera 0 at
    scale 0 (laterals (1, 256, 90, 160), boxes (1, 5, 156, 156, 4)). For
    fp32 and bf16, on seeded corner cotangents: the kernel against its
    plain version on the card (`corner_taps_bwd`, XLA's order) bit for bit,
    and the same bits on a second launch; its time, the plain version's,
    the order index's build (`tap_order`), one `scatter_add_` of the same
    updates (library_ms) and the bound. Then the gradient of
    `sample_voxels` w.r.t. the laterals on the card against the CPU's (the
    same laterals, boxes and cotangent; the plain version there), bit for
    bit. Launches made here are not the main path's."""
    from vfa_tpu_torch.ops.voxel import (corner_taps_bwd, sample_voxels, tap_order,
                                         voxel_tap_bwd)

    B, C, H, W = lat.shape
    shape = (B, C, H, W)
    order = tap_order(box, (H, W))
    index_ms = cuda_time_ms(lambda: tap_order(box, (H, W)), 3) if device.type == "cuda" else 0.0
    most = int((order.ptr[1:] - order.ptr[:-1]).max())
    gen = torch.Generator().manual_seed(5)
    g = torch.randn((order.rows.numel() // 4, C), generator=gen).to(device)
    out = {}
    for dtype, name in VOXEL_TAP.items():
        got = voxel_tap_bwd(g, order, shape, dtype)
        again = voxel_tap_bwd(g, order, shape, dtype)
        want = corner_taps_bwd(g, order, shape, dtype)
        sync(device)
        e = errors(got.float(), want.float())
        if not (torch.equal(got, want) and torch.equal(again, got)):
            raise AssertionError(f"5f {name}: the kernel differs from its plain version "
                                 f"({e}) or from its own second launch")
        nbytes, flops = voxel_tap_work(order, shape, dtype)
        b_ms, by = bound_ms(flops, nbytes, PEAK_FP32_FLOPS)
        if device.type == "cuda":
            ms = cuda_time_ms(lambda: voxel_tap_bwd(g, order, shape, dtype), VOXEL_TAP_REPS)
            plain_ms = cuda_time_ms(lambda: corner_taps_bwd(g, order, shape, dtype), 1, 0)
            library_ms = scatter_add_ms(g, order, shape, dtype)
        else:
            ms = plain_ms = library_ms = 0.0
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                     "library_ms": library_ms, "err": e[:2], "bytes": nbytes,
                     "flops": flops}
        log(f"phase 5f {name} (camera 0, scale 0, {tuple(shape)} under "
            f"{tuple(box.shape)} boxes, {order.rows.numel()} updates, up to {most} a "
            f"pixel from one tap): equals its plain version bit for bit, twice; "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms by {by} "
            f"({nbytes} bytes, {b_ms / ms if ms else 0:.1%} of the bound), one "
            f"scatter_add_ of the same updates {library_ms:.3f} ms; order index "
            f"{index_ms:.3f} ms")
    del g
    nl, L, Wd = box.shape[1:4]
    dv = torch.randn((B, L, Wd, C * nl), generator=gen)
    card = {}
    for dtype, name in VOXEL_TAP.items():
        x = lat.detach().to(dtype)
        leaves = [x.clone().requires_grad_(), x.cpu().requires_grad_()]
        dx = [torch.autograd.grad(sample_voxels(t, box.to(t.device)), t,
                                  dv.to(t.device))[0] for t in leaves]
        card[name] = torch.equal(dx[0].cpu(), dx[1])
        log(f"phase 5f {name}: the gradient of sample_voxels w.r.t. the {dtype} "
            f"laterals on the card {'equals' if card[name] else 'DIFFERS FROM'} the "
            f"CPU's bit for bit ({errors(dx[0].cpu().float(), dx[1].float())[2]:.3e} "
            "rel-L2)")
    if not all(card.values()):
        raise AssertionError(f"5f: the card's voxel-route gradient differs from the CPU's {card}")
    for name in out:
        out[name]["index_ms"] = index_ms
    return out


def _voxel_steps(cfg, device, dtype, batch, want):
    """`voxel_step_twice`'s two runs: (losses, gradients, launches, ms) each."""
    from vfa_tpu_torch import bench
    from vfa_tpu_torch.config import TrainConfig
    from vfa_tpu_torch.model.vfanet import VFANet, init_weights
    from vfa_tpu_torch.train_lib import make_optimizer, make_train_step

    runs = []
    for _ in range(2):
        model = init_weights(VFANet(cfg), torch.Generator().manual_seed(0)).to(device)
        tcfg = TrainConfig(pretrained=False, compute_dtype=dtype)
        step = make_train_step(model, make_optimizer(model, tcfg, bench.STEPS_PER_EPOCH),
                               cfg, tcfg, dim_mean=bench.DIM_MEAN if cfg.mode == "3D" else None)
        ms = []
        for i in range(2 if runs else 1):
            reset_launches()
            sync(device)
            t0 = time.perf_counter()
            losses = step(batch, None)
            sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            launches = read_launches()
            check_bev_launches(f"5f voxel-route step ({dtype})", launches, want)
            if i == 0:
                runs.append(({k: float(v) for k, v in losses.items()},
                             {n: p.grad.detach().clone() for n, p in model.named_parameters()
                              if p.grad is not None}, launches, ms))
        del model, step
    return runs


def voxel_step_twice(cfg, device, dtype: str) -> dict:
    """One training step at batch 1 through the voxel route (rig=None;
    `--dtype bfloat16`: mixed precision), twice from the same seeded
    weights and batch: the losses and every gradient the same bits in both
    runs (the integral image's gradient is added in XLA's order, no
    atomics). Counts set to 0 just before each step and read just after:
    the ordered transpose once a camera and scale, nothing else. fp32 runs
    with `torch.backends.cudnn.deterministic`. The second run's step and a
    third step after it are timed (host clock, synced)."""
    from vfa_tpu_torch import bench

    batch = bench.make_inputs(cfg, 1, device, True, getattr(torch, dtype))
    name = VOXEL_TAP[getattr(torch, dtype)]
    want = {name: cfg.num_cam * 3} if device.type == "cuda" else {}
    # fp32: cuDNN's default convolution backward algorithms add with atomics
    # (83 of 98 gradients differ run to run without this flag; bf16 gets
    # deterministic ones; tools/voxel_step_twice.py)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = dtype == "float32"
    try:
        runs = _voxel_steps(cfg, device, dtype, batch, want)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (l0, g0, launches, _), (l1, g1, _, ms) = runs
    same = l0 == l1 and set(g0) == set(g1) and all(torch.equal(g0[k], g1[k]) for k in g0)
    finite = all(np.isfinite(v) for v in l0.values())
    log(f"phase 5f voxel-route training step at batch 1 ({dtype}), twice from the same "
        f"weights and batch: losses {l0}; losses and {len(g0)} gradients "
        f"{'the same bits' if same else 'DIFFERENT'} in both runs; launches {launches}; "
        f"{ms[0]:.1f} ms, then {ms[1]:.1f} ms")
    if not (same and finite):
        raise AssertionError(f"5f voxel-route step ({dtype}): same bits {same}, losses {l0}, {l1}")
    return {"launches": launches[name], "ms": ms, "losses": l0}


def phase_voxel_bf16(device, tiny=False) -> dict:
    """Phase 5f (a): the reference voxel route (rig=None) in bf16 at full
    MultiviewC width, one scene. A serving forward after `cast_model`
    (finite, no rig kernel launched); the integral image and `sample_voxels`
    of camera 0 at scale 0 on the card bit-equal to the same code on the
    CPU for the same bf16 laterals and boxes; the summed BEV features
    (fp32 sums before the cast) against the fp32 and the fp64 voxel routes
    on the same laterals and weights, the bf16 sum equal to the model's
    own (F7, ROADMAP Queue 3); the ordered transpose of the corner reads
    on camera 0 at scale 0 (`phase_voxel_tap`: the kernel against its plain
    version, the card's gradient against the CPU's); the voxel-route step
    at batch 1 in bf16 and in fp32, each run twice (`voxel_step_twice`: the
    same bits, the kernel once a camera and scale); one mixed-precision
    training step at batch 1 with rig=None (the bench's runner): finite
    losses, ms, peak memory."""
    import torch.nn.functional as F

    from vfa_tpu_torch import bench
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import make_scene, tiny_config
    from vfa_tpu_torch.model.vfanet import VFANet, cast_model, init_weights, voxel_contribution
    from vfa_tpu_torch.ops.voxel import integral_image, sample_voxels, voxel_boxes

    cfg = get_config("MultiviewC")
    cfg = tiny_config(cfg) if tiny else cfg
    scene = make_scene(cfg, seed=0, num_objects=6)
    images = torch.from_numpy(scene.images[None]).to(device=device, dtype=torch.bfloat16)
    calibs = torch.from_numpy(scene.calibs[None]).to(device)
    grid = torch.from_numpy(scene.grid).to(device)
    model = cast_model(init_weights(VFANet(cfg), torch.Generator().manual_seed(0)),
                       torch.bfloat16).to(device).eval()
    N, (L, W) = cfg.num_cam, cfg.grid_shape
    reset_launches()
    with torch.no_grad():
        sync(device)
        t0 = time.perf_counter()
        pred = model(images, None, calibs, grid)
        sync(device)
        serve_ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        bad = [k for k, v in pred.items() if not bool(torch.isfinite(v.float()).all())]
        if bad or pred["heatmap"].shape != (1, 1, L, W) or any(launches.values()):
            raise AssertionError(f"5f bf16 voxel route serving: non-finite {bad}, "
                                 f"heatmap {tuple(pred['heatmap'].shape)}, launches {launches}")
        lats = model.laterals(images)
        boxes = [voxel_boxes(calibs[:, n], grid, dataset=cfg.name, grid_height=cfg.grid_h,
                             cube_size=cfg.cube_size, image_size=cfg.image_size)
                 for n in range(N)]
        lat, box = lats[0][0:1], boxes[0]
        ii, vox = integral_image(lat), sample_voxels(lat, box)
        ii_cpu, vox_cpu = integral_image(lat.cpu()), sample_voxels(lat.cpu(), box.cpu())
        same = (torch.equal(ii.cpu(), ii_cpu), torch.equal(vox.cpu(), vox_cpu))
        log(f"phase 5f bf16 voxel route: camera 0, scale 0, laterals "
            f"{tuple(lat.shape)}, boxes {tuple(box.shape)}: the card's integral image "
            f"{'equals' if same[0] else 'DIFFERS FROM'} the CPU's bit for bit, vox "
            f"{'equals' if same[1] else 'DIFFERS FROM'} it")
        if not all(same):
            raise AssertionError("5f: the bf16 integral image or vox differ between "
                                 "the card and the CPU")
        f64 = lambda t: t.to(torch.float64)
        sums = {"bf16": 0.0, "fp32": 0.0, "fp64": 0.0}
        for n in range(N):
            cam = {"bf16": 0.0, "fp32": 0.0, "fp64": 0.0}
            for lat, lin in zip(lats, model.collapses()):
                ln = lat[n:n + 1]
                cam["bf16"] = cam["bf16"] + voxel_contribution(ln, boxes[n], lin)
                cam["fp32"] = cam["fp32"] + torch.relu(F.linear(
                    sample_voxels(ln.float(), boxes[n]), lin.weight.float(), lin.bias.float()))
                cam["fp64"] = cam["fp64"] + torch.relu(F.linear(
                    sample_voxels(f64(ln), f64(boxes[n])), f64(lin.weight), f64(lin.bias)))
            sums = {k: sums[k] + cam[k] for k in sums}
        model_bev = model.bev_features(images, None, calibs, grid)
    if not torch.equal(model_bev, sums["bf16"].to(torch.bfloat16)):
        raise AssertionError("5f: the model's bf16 BEV features differ from the "
                             "route's sum")
    f7 = {}
    for tag, got, want in (("bf16 vs fp32", sums["bf16"], sums["fp32"]),
                           ("bf16 vs fp64", sums["bf16"], sums["fp64"]),
                           ("fp32 vs fp64", sums["fp32"], sums["fp64"])):
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"5f F7 {tag}: non-finite")
        f7[tag] = errors(got, want)
        log(f"  F7 summed BEV features, {tag} voxel route (same bf16 laterals and "
            f"weights, 1 scene): max abs err {f7[tag][0]:.4e}, max rel err "
            f"{f7[tag][1]:.4e}, rel-L2 {f7[tag][2]:.4e}")
    # the ordered transpose of the corner reads (csrc/voxel_tap_bwd.cu) on
    # camera 0 at scale 0, then the voxel-route step run twice
    taps = phase_voxel_tap(lats[0][0:1], boxes[0], device)
    del lats, boxes, model_bev, sums, pred, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    twice = {d: voxel_step_twice(cfg, device, d) for d in ("bfloat16", "float32")}
    # one mixed-precision training step with rig=None, the bench's runner
    args = bench.parse_args(["--train", "--dtype", "bfloat16", "--no-rig", "--batch", "1"])
    held = 0
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
    run = bench.make_runner(cfg, args, 1, 0, None, device)
    ms = []
    for _ in range(2):
        sync(device)
        t0 = time.perf_counter()
        out = run()
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    losses = {k: float(v) for k, v in out.items()}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del run
    log(f"phase 5f bf16 voxel route: serving forward {serve_ms:.1f} ms; a "
        f"mixed-precision training step at batch 1 {ms[1]:.1f} ms (first {ms[0]:.1f}), "
        f"losses {losses}, max_memory_allocated {peak} bytes ({peak - held} above "
        "what was held before)")
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"5f voxel-route training step: losses {losses}")
    return {"f7": f7, "serve_ms": serve_ms, "train_ms": ms[1], "train_peak": peak - held,
            "taps": taps, "twice": twice}


def phase_memory_options(rig, device, tiny=False) -> dict:
    """Phase 5f (b): a mixed-precision training step through the bf16
    window rig at batch MEM_BATCH, with the fused stem on, under each of
    MEM_OPTIONS, from the same seeded weights and batch: peak memory
    (`max_memory_allocated`, and the part above what was allocated before
    the model was built: the rig, the batch and earlier phases' tensors are
    not the option's), the step p50 of MEM_STEPS, the launches of
    MEM_KERNELS in the first step. Fails unless every option launches what
    the plain step does (the rig kernels as often; the stem's K6/K7 once a
    step, once a chunk with backbone chunks, which run the stem per chunk)
    and its first step is the same step as its reference's: the losses bit
    for bit, all gradients no farther than twice the plain step's own
    run-to-run distance (rel-L2; cuDNN's weight-gradient algorithms need
    not be deterministic). The reference is the plain step; with backbone
    chunks it is the same chunks run without recompute: the backbone then
    runs at half the batch (cuDNN may take other algorithms) and a feature
    module's weight gradient is two bf16 partial sums added, so the chunks
    against the plain step are held as phase 5c holds a bf16 route against
    the plain one: losses rel BF16_LOSS_TOL, gradients within
    BF16_NOISE_RATIO of the plain step's distance from the same step in
    fp32 (fp32 compute, the rig cast to fp32)."""
    from vfa_tpu_torch.config import TrainConfig, get_config
    from vfa_tpu_torch.data.synthetic import tiny_config
    from vfa_tpu_torch.entry import DIM_MEAN, synthetic_batch
    from vfa_tpu_torch.model import resnet, vfanet
    from vfa_tpu_torch.train_lib import batch_to_device, make_optimizer, make_train_step

    cfg = get_config("MultiviewC")
    cfg = tiny_config(cfg) if tiny else cfg
    scenes = synthetic_batch(cfg, range(MEM_BATCH))
    batch = batch_to_device(scenes, device, torch.bfloat16)
    state = vfanet.init_weights(vfanet.VFANet(cfg),
                                torch.Generator().manual_seed(0)).state_dict()
    tcfg = TrainConfig(pretrained=False, lr=float(TRAIN_LR), epochs=1,
                       compute_dtype="bfloat16")

    def run(options, recompute=True, fp32=False):
        held = 0
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)
        model = vfanet.VFANet(cfg, **options)
        model.load_state_dict(state, strict=True)
        model.to(device)
        tc, inputs = tcfg, (batch, rig)
        if fp32:              # freed with this call: the other peaks stay clean
            tc = dataclasses.replace(tcfg, compute_dtype="float32")
            inputs = (batch_to_device(scenes, device), rig_as_fp32(rig))
        step = make_train_step(model, make_optimizer(model, tc, MEM_STEPS), cfg, tc,
                               dim_mean=DIM_MEAN)
        saved = resnet.remat, vfanet.remat
        if not recompute:          # every recomputed region run once, as is
            resnet.remat = vfanet.remat = lambda module, fn, *args: fn(*args)
        ms, losses, grads, launches = [], None, None, None
        try:
            for i in range(MEM_STEPS):
                reset_launches()
                sync(device)
                t0 = time.perf_counter()
                out = step(*inputs)
                sync(device)
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    losses = {k: float(v) for k, v in out.items()}
                    grads = torch.cat([p.grad.reshape(-1).float() for p in model.parameters()])
                    launches = {k: v for k, v in read_launches().items() if k in MEM_KERNELS}
        finally:
            resnet.remat, vfanet.remat = saved
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        return {"losses": losses, "grads": grads, "launches": launches,
                "ms": float(np.median(ms)), "steps_ms": ms, "peak": peak,
                "own": peak - held}

    norm = lambda t: float(torch.linalg.vector_norm(t))
    dist = lambda a, b: norm(a["grads"] - b["grads"]) / norm(b["grads"])
    loss_rel = lambda a, b: max(abs(a["losses"][k] - b["losses"][k]) / abs(b["losses"][k])
                                for k in b["losses"])
    old = os.environ.get("VFA_FUSED_STEM")
    os.environ["VFA_FUSED_STEM"] = "1"
    out, failures = {}, []
    try:
        plain = run({})
        again = run({})
        noise = dist(again, plain)
        if again["losses"] != plain["losses"] or again["launches"] != plain["launches"]:
            failures.append(f"the plain step run twice: losses {plain['losses']} / "
                            f"{again['losses']}, launches {plain['launches']} / "
                            f"{again['launches']}")
        del again
        f32 = run({}, fp32=True)
        bf16_noise = dist(plain, f32)
        del f32
        once = run({"backbone_chunks": 2}, recompute=False)
        log(f"phase 5f memory options: 2 backbone chunks without recompute: "
            f"max_memory_allocated {once['peak']} bytes ({once['own']} above what was "
            f"held before the model), step p50 {once['ms']:.1f} ms; "
            f"losses rel {loss_rel(once, plain):.3e} from the plain step's, gradients "
            f"rel-L2 {dist(once, plain):.3e} from its (the plain step's distance from "
            f"its fp32 twin {bf16_noise:.3e})")
        if not (loss_rel(once, plain) <= BF16_LOSS_TOL
                and dist(once, plain) <= BF16_NOISE_RATIO * bf16_noise):
            failures.append(f"2 chunks: losses {loss_rel(once, plain):.3e} (bound "
                            f"{BF16_LOSS_TOL}), gradients {dist(once, plain):.3e} (bound "
                            f"{BF16_NOISE_RATIO} x {bf16_noise:.3e}) from the plain step's")
        for name, options in MEM_OPTIONS:
            r = plain if name == "none" else run(options)
            chunks = options.get("backbone_chunks", 1)
            ref = once if chunks > 1 else plain
            want = {k: n * (chunks if k.startswith("stem_") else 1)
                    for k, n in plain["launches"].items()}
            exact = r["losses"] == ref["losses"]
            log(f"phase 5f memory options, bf16 training at batch {MEM_BATCH} (window "
                f"rig, fused stem): {name}: max_memory_allocated {r['peak']} bytes "
                f"({r['own']} above the {r['peak'] - r['own']} held before the model: the "
                f"rig, the batch, earlier phases' tensors); step "
                f"p50 {r['ms']:.1f} ms (steps " + " ".join(f"{t:.1f}" for t in r["steps_ms"])
                + f"); launches in one step {r['launches']}; against the "
                f"{'chunks without recompute' if ref is once else 'plain step'}: losses "
                f"{'bit-equal' if exact else 'DIFFER'}, gradients rel-L2 {dist(r, ref):.3e} "
                f"(the plain step's own run-to-run {noise:.3e}); from the plain step "
                f"{dist(r, plain):.3e}")
            if r["launches"] != want:
                failures.append(f"{name}: launches {r['launches']}, want {want}")
            if not exact:
                failures.append(f"{name}: losses {r['losses']}, reference {ref['losses']}")
            if not dist(r, ref) <= 2 * noise:
                failures.append(f"{name}: gradients {dist(r, ref):.3e} from the reference's, "
                                f"twice the run-to-run distance is {2 * noise:.3e}")
            out[name] = {k: r[k] for k in ("peak", "own", "ms", "launches", "losses")}
            out[name]["grad_rel_l2"] = dist(r, plain)
            del r
    finally:
        if old is None:
            os.environ.pop("VFA_FUSED_STEM")
        else:
            os.environ["VFA_FUSED_STEM"] = old
    if device.type == "cuda" and any(plain["launches"][k] != 1 for k in MEM_KERNELS[2:]):
        failures.append(f"the fused stem's kernels did not run once a step: {plain['launches']}")
    if failures:
        raise AssertionError("5f memory options:\n  " + "\n  ".join(failures))
    out["run_to_run"], out["bf16_vs_fp32"] = noise, bf16_noise
    out["chunks_once"] = {"peak": once["peak"], "own": once["own"], "ms": once["ms"],
                          "grad_rel_l2": dist(once, plain), "loss_rel": loss_rel(once, plain)}
    return out


def phase_grid2x_and_voxel_bench(proc, rig_cache, device, tiny=False) -> dict:
    """Phase 5f (c): the bench `--train --dtype bfloat16 --grid2x` at auto
    batch (backbone remat forced on; the (batch, chunks) attempts of the
    root bench) on the grid2x rig a host process built, and the bench
    `--dtype bfloat16 --no-rig --batch 1` (the voxel route serving): the
    batch and chunks reached, scenes/s, the peak memory of each attempt."""
    import contextlib
    import io

    from vfa_tpu_torch import bench

    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"the grid2x rig build failed:\n{out}")
    log("host build of the bf16 grid2x MultiviewC rig (a process of its own): "
        + " ".join(ln for ln in out.splitlines() if ln.startswith("compiled rig:")))
    rig = grid2x_rig(device, rig_cache, tiny)
    tail = ["--device", device.type] + (["--tiny"] if tiny else [])
    argv = ["--data", "MultiviewC", "--dtype", "bfloat16", "--train", "--grid2x",
            "--iters", "3", "--warmup", "1"] + tail
    buf = io.StringIO()
    reset_launches()
    held = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    with contextlib.redirect_stderr(buf):
        res = bench.main(argv, rig=rig)
    launches = read_launches()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err = buf.getvalue()
    sys.stderr.write(err)
    del rig
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reached = re.search(r"# batch=(\d+) p50=([0-9.]+) ms/scene .*chunks=(\d+)\)", err)
    attempts = re.findall(r"# batch (\d+): (ok|out of memory)[^;\n]*; chunks (\d+); "
                          r"max_memory_allocated (\d+|not measured)", err)
    log(f"phase 5f bench {' '.join(argv)}: {res}; attempts (batch, outcome, chunks, "
        f"peak bytes) {attempts}, of which {held} bytes were held before the bench "
        f"(the grid2x rig, earlier phases' tensors); launches {launches}")
    if "# grid2x train: backbone remat forced on" not in err or not reached:
        raise AssertionError(f"bench --grid2x --train: no forced remat or no batch\n{err[-3000:]}")
    if device.type == "cuda" and not (launches["rig_window_fwd_bf16"] > 0
                                      and launches["rig_window_bwd_bf16"] > 0):
        raise AssertionError(f"bench --grid2x --train: launches {launches}")
    if not (np.isfinite(res["value"]) and res["value"] > 0):
        raise AssertionError(f"bench --grid2x --train: {res}")
    argv = ["--data", "MultiviewC", "--dtype", "bfloat16", "--no-rig", "--batch", "1",
            "--iters", "3", "--warmup", "1"] + tail
    reset_launches()
    vox = bench.main(argv)
    launches_vox = read_launches()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 5f bench {' '.join(argv)}: {vox}; launches {launches_vox}")
    if any(launches_vox.values()) or not vox["value"] > 0:
        raise AssertionError(f"bench --no-rig: {vox}, launches {launches_vox}")
    return {"grid2x": res, "batch": int(reached.group(1)), "chunks": int(reached.group(3)),
            "attempts": attempts, "held": held, "launches": launches, "no_rig": vox}


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global RUNS_DIR
    t_start = time.perf_counter()
    rig_cache = tempfile.mkdtemp(prefix="chip_smoke_rigs_")
    disk = tempfile.mkdtemp(prefix="chip_smoke_disk_")
    RUNS_DIR = os.path.join(disk, "runs")
    builds = start_rig_builds(rig_cache)
    try:
        builds.append(start_disk_rig_build(rig_cache, disk))
        builds.append(start_bev_rig_build(rig_cache))
        builds.append(start_grid2x_rig_build(rig_cache))
        return run_phases(device, t_start, builds, rig_cache, disk)
    finally:
        for proc in builds:
            proc.kill()
            proc.wait()
        shutil.rmtree(rig_cache, ignore_errors=True)
        shutil.rmtree(disk, ignore_errors=True)


def run_phases(device, t_start, builds, rig_cache, disk) -> int:
    phase_build()
    phase_tf32_arithmetic(device)
    err, num = {}, {}

    # the stem kernels alone
    err.update(phase_stem_vs_plain(device))
    num.update(phase_stem_numbers(device))
    err.update(phase_stem_bf16_vs_plain(device))
    num.update(phase_stem_numbers(device, torch.bfloat16))
    torch.cuda.empty_cache()

    # window layout, serving
    rig = full_rig(device, training=False)
    err["rig_window_fwd"] = phase_kernel_vs_plain(rig, device)
    serve_launches, res, peak = phase_main_path(rig, device, scenes=6)
    num["rig_window_fwd"] = phase_numbers(rig, device, backward=False)
    phase_pass_shares(rig, device)
    bench_mc, _ = phase_bench(["--data", "MultiviewC", "--batch", "0", "--iters",
                               "5", "--warmup", "1"], rig, ["rig_window_fwd"])
    del rig
    torch.cuda.empty_cache()

    # window layout, training
    train_rig = full_rig(device, training=True)
    err["rig_window_fwd"] = worst_of([err["rig_window_fwd"],
                                      phase_kernel_vs_plain(train_rig, device)])
    err["rig_window_bwd"] = phase_bwd_kernel_vs_plain(train_rig, device)
    train_launches, train_res, train_peak = phase_train_path(
        train_rig, device, fused_stem=False)
    del train_res["model"]
    torch.cuda.empty_cache()
    num["rig_window_bwd"] = phase_numbers(train_rig, device, backward=True)
    # the serial TPU kernel's case (K3, B = 1) alone
    k3 = phase_numbers(train_rig, device, backward=True, batch=1)
    log(f"rig_window_bwd at B=1 (replaces vfa_tpu/ops/rig_pallas.py:355): "
        f"{k3[0]:.3f} ms, plain {k3[1]:.3f} ms, bound {k3[2]:.3f} ms by {k3[3]}")
    # bf16 training on the window layout (K2/K3 bf16), on the 8-bucket bf16
    # MultiviewC rig (tile_v 160), the fp32 training rig the yardstick
    mc16t = prebuilt_rig(builds, ("MultiviewC", 8, "bfloat16"), device, rig_cache)
    err["rig_window_bwd_bf16"] = phase_bwd_kernel_vs_plain(mc16t, device)
    torch.cuda.empty_cache()
    train16_launches, train16_res, train16_peak = phase_train_path_bf16(
        mc16t, train_rig, device, fused_stem=False)
    del train16_res["model"]
    torch.cuda.empty_cache()
    num["rig_window_bwd_bf16"] = phase_numbers(mc16t, device, backward=True)
    phase_bf16_rounding(mc16t)
    k3_16 = phase_numbers(mc16t, device, backward=True, batch=1)
    log(f"rig_window_bwd_bf16 at B=1 (replaces vfa_tpu/ops/rig_pallas.py:355 "
        f"on bf16): {k3_16[0]:.3f} ms, plain {k3_16[1]:.3f} ms, bound "
        f"{k3_16[2]:.3f} ms by {k3_16[3]}")
    bench16_train = phase_bench(
        ["--data", "MultiviewC", "--dtype", "bfloat16", "--train", "--batch", "0",
         "--iters", "5", "--warmup", "1"], mc16t,
        ["rig_window_fwd_bf16", "rig_window_bwd_bf16"])[0]
    del mc16t
    torch.cuda.empty_cache()
    del train_rig
    torch.cuda.empty_cache()

    # flat layout: one rig (the 8-bucket training policy) serves both runs
    taps_rig = small_taps_rig(device)
    phase_kernel_vs_plain(taps_rig, device)
    phase_bwd_kernel_vs_plain(taps_rig, device, batches=(2,))
    del taps_rig
    # into the run's rig cache, where tools/prof_bf16_window.py finds it
    flat_rig = full_rig(device, training=True, layout="flat", cache_dir=rig_cache)
    err["rig_flat_fwd"] = phase_kernel_vs_plain(flat_rig, device)
    err["rig_flat_bwd"] = phase_bwd_kernel_vs_plain(flat_rig, device)
    torch.cuda.empty_cache()
    flat_serve_launches, flat_res, flat_peak = phase_main_path(
        flat_rig, device, scenes=6)
    flat_train_launches, flat_train_res, flat_train_peak = phase_train_path(
        flat_rig, device, fused_stem=True)
    del flat_train_res["model"]
    torch.cuda.empty_cache()
    num["rig_flat_fwd"] = phase_numbers(flat_rig, device, backward=False)
    phase_pass_shares(flat_rig, device)
    num["rig_flat_bwd"] = phase_numbers(flat_rig, device, backward=True)
    # bf16 flat: the same rig with A cast to bf16
    flat16 = rig_as_bf16(flat_rig)
    torch.cuda.empty_cache()
    err["rig_flat_fwd_bf16"] = phase_kernel_vs_plain(flat16, device)
    flat16_launches, flat16_res, flat16_peak = phase_main_path(flat16, device, scenes=6)
    num["rig_flat_fwd_bf16"] = phase_numbers(flat16, device, backward=False)
    # bf16 training on the flat layout with the fused stem (K5, K6, K7 bf16)
    err["rig_flat_bwd_bf16"] = phase_bwd_kernel_vs_plain(flat16, device)
    torch.cuda.empty_cache()
    flat16_train_launches, flat16_train_res, flat16_train_peak = phase_train_path_bf16(
        flat16, flat_rig, device, fused_stem=True)
    del flat16_train_res["model"], flat_rig
    torch.cuda.empty_cache()
    num["rig_flat_bwd_bf16"] = phase_numbers(flat16, device, backward=True)
    del flat16
    torch.cuda.empty_cache()
    passes16_flat = phase_bf16_passes(rig_cache, "flat")

    # the 2D configs at full width: MultiviewX on one 8-bucket window rig
    mx_rig = prebuilt_rig(builds, ("MultiviewX", 8, "float32"), device, rig_cache)
    err["rig_window_fwd"] = worst_of([err["rig_window_fwd"], phase_kernel_vs_plain(
        mx_rig, device, batches=(1, 2, 8))])
    err["rig_window_bwd"] = worst_of([err["rig_window_bwd"],
                                      phase_bwd_kernel_vs_plain(mx_rig, device)])
    torch.cuda.empty_cache()
    bench_mx, _ = phase_bench(["--data", "MultiviewX"] + BENCH, mx_rig,
                              ["rig_window_fwd"], BENCH_CALLS)
    bench_mx_train, _ = phase_bench(["--data", "MultiviewX", "--train"] + BENCH,
                                    mx_rig, ["rig_window_fwd", "rig_window_bwd"],
                                    BENCH_CALLS)
    mx_num = {k: phase_numbers(mx_rig, device, backward=k == "rig_window_bwd",
                               rounds=1)
              for k in ("rig_window_fwd", "rig_window_bwd")}
    mx_ref = phase_rig_vs_reference(mx_rig, device, "MultiviewX")
    mx_buckets = sum(len(s.A) for s in mx_rig.scales)
    del mx_rig
    torch.cuda.empty_cache()
    # Wildtrack on one 12-bucket window rig
    wt_rig = prebuilt_rig(builds, ("Wildtrack", 12, "float32"), device, rig_cache)
    err["rig_window_fwd"] = worst_of([err["rig_window_fwd"],
                                      phase_kernel_vs_plain(wt_rig, device)])
    bench_wt, _ = phase_bench(["--data", "Wildtrack"] + BENCH, wt_rig,
                              ["rig_window_fwd"], BENCH_CALLS)
    wt_num = phase_numbers(wt_rig, device, backward=False, rounds=1)
    wt_buckets = sum(len(s.A) for s in wt_rig.scales)
    del wt_rig
    torch.cuda.empty_cache()

    # bf16 serving, the root bench's default dtype, on the three datasets
    mc16 = prebuilt_rig(builds, ("MultiviewC", 12, "bfloat16"), device, rig_cache)
    err["rig_window_fwd_bf16"] = phase_kernel_vs_plain(mc16, device)
    serve16_launches, serve16_res, serve16_peak = phase_main_path(mc16, device, scenes=6)
    num["rig_window_fwd_bf16"] = phase_numbers(mc16, device, backward=False)
    torch.cuda.empty_cache()
    epilogue = {"MultiviewC": phase_bev_epilogue(mc16, device, "MultiviewC")}
    passes16 = phase_bf16_passes(rig_cache, "window")
    bench16 = {"MultiviewC": phase_bench(
        ["--data", "MultiviewC", "--dtype", "bfloat16", "--batch", "0", "--iters",
         "5", "--warmup", "1"], mc16, ["rig_window_fwd_bf16", "rig_bev_epilogue"])[0]}
    # the on-disk path: its rig comes from the last host process
    disk_launches = phase_disk_path(
        builds[len(PREBUILT)], disk, rig_cache, device, mc16,
        {"serving": bench16["MultiviewC"], "training": bench16_train})
    del mc16
    torch.cuda.empty_cache()
    # 5e: the BEV-sharded path and --multihost, 2 ranks on the card
    t5e = time.perf_counter()
    mc16t = prebuilt_rig(builds, ("MultiviewC", 8, "bfloat16"), device, rig_cache)
    bev = phase_bev(builds[len(PREBUILT) + 1], rig_cache, device, mc16t)
    torch.cuda.empty_cache()
    home = rank_home(disk, rig_cache)
    multihost = phase_multihost(mc16t, home, disk, device)
    bev_bench = phase_bev_bench(mc16t, home, device)
    log(f"phase 5e: {time.perf_counter() - t5e:.1f} s")
    # 5f: the memory options on the bf16 training rig, the bf16 voxel route,
    # the grid2x training bench (its rig from the last host process)
    t5f = time.perf_counter()
    memory = phase_memory_options(mc16t, device)
    del mc16t
    torch.cuda.empty_cache()
    voxel16 = phase_voxel_bf16(device)
    torch.cuda.empty_cache()
    bench5f = phase_grid2x_and_voxel_bench(builds[len(PREBUILT) + 2], rig_cache, device)
    torch.cuda.empty_cache()
    log(f"phase 5f: {time.perf_counter() - t5f:.1f} s")
    num16 = {}
    for data in ("MultiviewX", "Wildtrack"):
        rig16 = prebuilt_rig(builds, (data, 12, "bfloat16"), device, rig_cache)
        err["rig_window_fwd_bf16"] = worst_of([
            err["rig_window_fwd_bf16"], phase_kernel_vs_plain(
                rig16, device, batches=(1, 2, 8) if data == "MultiviewX" else (1, 2))])
        torch.cuda.empty_cache()
        num16[data] = (phase_numbers(rig16, device, backward=False, rounds=1),
                       fwd_launches(rig16))
        if data == "Wildtrack":
            epilogue[data] = phase_bev_epilogue(rig16, device, data)
        bench16[data] = phase_bench(
            ["--data", data, "--dtype", "bfloat16", "--batch", "0", "--iters", "5",
             "--warmup", "1"], rig16, ["rig_window_fwd_bf16", "rig_bev_epilogue"])[0]
        del rig16
        torch.cuda.empty_cache()
    # MVDet's projection kernel, then its serving path, with no rig held
    mvdet = phase_mvdet_project(device)
    mvdet_path = phase_mvdet_path(device)

    # K2-bf16 on MultiviewX (nl 8)
    mx16t = prebuilt_rig(builds, ("MultiviewX", 8, "bfloat16"), device, rig_cache)
    err["rig_window_bwd_bf16"] = worst_of([
        err["rig_window_bwd_bf16"], phase_bwd_kernel_vs_plain(mx16t, device, batches=(2,))])
    torch.cuda.empty_cache()
    mx16_num = (phase_numbers(mx16t, device, backward=True, rounds=1),
                sum(len(s.A) for s in mx16t.scales))
    del mx16t
    torch.cuda.empty_cache()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for tag, r, pk in (("window", res, peak), ("flat", flat_res, flat_peak),
                       ("window, bf16", serve16_res, serve16_peak),
                       ("flat, bf16", flat16_res, flat16_peak)):
        log(f"p50 ms per request ({tag} rig, batch {BATCH}): "
            f"{float(np.median(r['ms'])):.3f}; max_memory_allocated {pk} bytes")
    for tag, r, pk in (("window", train_res, train_peak),
                       ("flat + fused stem", flat_train_res, flat_train_peak)):
        log(f"p50 ms per training step ({tag}, batch {BATCH}): "
            f"{float(np.median(r['ms'])):.3f} (steps "
            + " ".join(f"{t:.1f}" for t in r["ms"])
            + f"); max_memory_allocated {pk} bytes")
    for bwd, fwd in (("rig_window_bwd", "rig_window_fwd"),
                     ("rig_flat_bwd", "rig_flat_fwd")):
        log(f"{bwd} / {fwd}: {num[bwd][0] / num[fwd][0]:.3f} "
            f"({num[bwd][0]:.3f} / {num[fwd][0]:.3f} ms; twice the operations)")
    for tag, n, buckets in (
            ("rig_window_fwd MultiviewX", mx_num["rig_window_fwd"], mx_buckets),
            ("rig_window_bwd MultiviewX", mx_num["rig_window_bwd"], mx_buckets),
            ("rig_window_fwd Wildtrack", wt_num, wt_buckets)):
        log(f"{tag} at B={BATCH}: {n[0]:.3f} ms, plain {n[1]:.3f} ms, bound "
            f"{n[2]:.3f} ms by {n[3]} ({n[2] / n[0]:.1%} of the bound); "
            f"{buckets} launches per {'step' if 'bwd' in tag else 'request'}")
    for name in ("rig_window_fwd_bf16", "rig_flat_fwd_bf16", "rig_window_bwd_bf16",
                 "rig_flat_bwd_bf16", "stem_bwd_stats_bf16", "stem_bwd_dx_bf16"):
        n = num[name]
        log(f"{name} MultiviewC at B={BATCH}: {n[0]:.3f} ms, plain {n[1]:.3f} ms, "
            f"bound {n[2]:.3f} ms by {n[3]} ({n[2] / n[0]:.1%} of the bound); "
            f"fp32 {name[:-5]} {num[name[:-5]][0]:.3f} ms")
    for name, r in (("rig_window_fwd_bf16 (fwd)", passes16["fwd"]),
                    (f"rig_window_bwd_bf16 (bwd_b{BATCH})", passes16[f"bwd_b{BATCH}"]),
                    ("rig_window_bwd_bf16 (bwd_b1)", passes16["bwd_b1"]),
                    ("rig_flat_fwd_bf16 (fwd)", passes16_flat["fwd"]),
                    (f"rig_flat_bwd_bf16 (bwd_b{BATCH})",
                     passes16_flat[f"bwd_b{BATCH}"])):
        log(f"{name} MultiviewC passes: "
            + ", ".join(f"{p} {t:.3f} ms" for p, t in r["passes_ms"].items())
            + f"; device {r['device_ms']:.3f} ms, wall clock {r['wall_ms']:.3f} "
            f"ms, host gap {r['wall_ms'] - r['device_ms']:.3f} ms")
    n, buckets = mx16_num
    log(f"rig_window_bwd_bf16 MultiviewX at B={BATCH}: {n[0]:.3f} ms, plain "
        f"{n[1]:.3f} ms, bound {n[2]:.3f} ms by {n[3]} ({n[2] / n[0]:.1%} of the "
        f"bound); {buckets} launches per step")
    for tag, r, pk in (("window, bf16", train16_res, train16_peak),
                       ("flat + fused stem, bf16", flat16_train_res, flat16_train_peak)):
        log(f"ms for one bf16 training step ({tag}, batch {BATCH}): "
            f"{r['ms'][0]:.3f}; max_memory_allocated {pk} bytes")
    for data, (n, launches) in num16.items():
        log(f"rig_window_fwd_bf16 {data} at B={BATCH}: {n[0]:.3f} ms, plain "
            f"{n[1]:.3f} ms, bound {n[2]:.3f} ms by {n[3]} ({n[2] / n[0]:.1%} of "
            f"the bound); {launches} launches per request")
    for tag, r in (("MultiviewC serving, auto batch", bench_mc),
                   ("MultiviewX serving", bench_mx),
                   ("MultiviewX training", bench_mx_train),
                   ("Wildtrack serving", bench_wt),
                   *((f"{d} bf16 serving, auto batch", r16)
                     for d, r16 in bench16.items()),
                   ("MultiviewC bf16 training, auto batch", bench16_train)):
        log(f"bench {tag}: {r['value']} scenes/s, {r['tflops_per_sec']} "
            f"TFLOP/s, mfu {r['mfu']}, dtype {r['dtype']}")
    share = mx_ref["sum of the 3 scales"]
    log(f"MultiviewX rig vs reference voxel route (batch 1): max abs err "
        f"{share[0]:.3e}, max rel err {share[1]:.3e}, {share[2]:.3f} of rtol "
        f"{REF_RTOL:.0e} / atol {REF_ATOL:.0e}")
    for name, _ in MEM_OPTIONS:
        r = memory[name]
        log(f"5f bf16 training step at batch {MEM_BATCH} (window rig, fused stem), "
            f"{name}: max_memory_allocated {r['peak']} bytes, {r['own']} above what was "
            f"held before its model, step p50 {r['ms']:.1f} ms, "
            f"gradients {r['grad_rel_l2']:.3e} from the plain step's (run-to-run "
            f"{memory['run_to_run']:.3e})")
    for tag, e in voxel16["f7"].items():
        log(f"5f F7, summed BEV features of the voxel route, {tag}: max abs err "
            f"{e[0]:.4e}, max rel err {e[1]:.4e}, rel-L2 {e[2]:.4e}")
    log(f"5f bf16 voxel route: serving forward {voxel16['serve_ms']:.1f} ms at batch 1; "
        f"training step {voxel16['train_ms']:.1f} ms at batch 1, max_memory_allocated "
        f"{voxel16['train_peak']} bytes above what was held before; bench --no-rig bf16 "
        f"serving at batch 1 "
        f"{bench5f['no_rig']['value']} scenes/s")
    for name, r in voxel16["taps"].items():
        log(f"5f {name} (camera 0, scale 0, batch 1): {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms by {r['bound_by']} "
            f"({r['bound_ms'] / r['ms']:.1%} of the bound), scatter_add_ "
            f"{r['library_ms']:.3f} ms, order index {r['index_ms']:.3f} ms")
    for dtype, r in voxel16["twice"].items():
        log(f"5f voxel-route training step at batch 1 ({dtype}): {r['ms'][0]:.1f} ms, "
            f"{r['ms'][1]:.1f} ms; the same bits twice; {r['launches']} launches of the "
            "ordered transpose a step")
    log(f"5f bench --train --dtype bfloat16 --grid2x (backbone remat forced on): batch "
        f"{bench5f['batch']}, chunks {bench5f['chunks']}, {bench5f['grid2x']['value']} "
        f"scenes/s; attempts {bench5f['attempts']} ({bench5f['held']} bytes held before "
        "the bench)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card.splitlines()[0]}")

    def mem_launches(name):
        """A kernel's launches in one step under each memory option (5f)."""
        return {opt: memory[opt]["launches"][name] for opt, _ in MEM_OPTIONS}

    def entry(name, source, replaces, launches, **extra):
        ms, plain_ms, b_ms, by, *rate = num[name]
        if rate:
            extra.update(gb_per_s=rate[0], share_of_bound=rate[1])
        extra.setdefault("dtype", "float32")
        return {"name": name, "route": "cuda",
                "source": f"vfa_tpu_torch/csrc/{source}.cu", "replaces": replaces,
                "launches": launches, "max_abs_err": err[name][0],
                "max_rel_err": err[name][1], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by, "library_ms": None, **extra}

    def voxel_entry(name, dtype):
        """The ordered transpose of the voxel route's corner reads (5f):
        launches a training step at batch 1, camera 0 at scale 0 timed."""
        r = voxel16["taps"][name]
        return {"name": name, "route": "cuda",
                "source": "vfa_tpu_torch/csrc/voxel_tap_bwd.cu",
                "replaces": "vfa_tpu/geometry.py:117 (XLA scatter-add, the transpose "
                            "of jnp.take; not a Pallas kernel)",
                "launches": voxel16["twice"][dtype]["launches"],
                "max_abs_err": r["err"][0], "max_rel_err": r["err"][1], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "dtype": dtype, "index_ms": r["index_ms"], "same_bits_twice": True,
                "card_equals_cpu": True}

    print(json.dumps({"kernels": [
        entry("rig_window_fwd", "rig_window_fwd", "vfa_tpu/ops/rig_pallas.py:89",
              serve_launches["rig_window_fwd"],
              launches_train=train_launches["rig_window_fwd"]),
        entry("rig_window_bwd", "rig_window_bwd",
              "vfa_tpu/ops/rig_pallas.py:194,355",
              train_launches["rig_window_bwd"]),
        entry("rig_flat_fwd", "rig_flat_fwd", "vfa_tpu/ops/rig_pallas.py:31",
              flat_serve_launches["rig_flat_fwd"],
              launches_train=flat_train_launches["rig_flat_fwd"]),
        entry("rig_flat_bwd", "rig_flat_bwd", "vfa_tpu/ops/rig_pallas.py:434",
              flat_train_launches["rig_flat_bwd"]),
        entry("stem_bwd_stats", "stem_bwd", "vfa_tpu/ops/stem.py:223",
              flat_train_launches["stem_bwd_stats"]),
        entry("stem_bwd_dx", "stem_bwd", "vfa_tpu/ops/stem.py:253",
              flat_train_launches["stem_bwd_dx"]),
        entry("rig_window_fwd_bf16", "rig_window_fwd", "vfa_tpu/ops/rig_pallas.py:89",
              serve16_launches["rig_window_fwd_bf16"], dtype="bfloat16",
              launches_memory_options=mem_launches("rig_window_fwd_bf16"),
              launches_grid2x_bench=bench5f["launches"]["rig_window_fwd_bf16"],
              launches_disk_train=disk_launches["train"]["rig_window_fwd_bf16"],
              launches_disk_evaluate=disk_launches["evaluate"]["rig_window_fwd_bf16"],
              launches_predict_disk=disk_launches["predict"]["launches"]["rig_window_fwd_bf16"],
              launches_bev_rank_b2=bev["launches_b2"]["rig_window_fwd_bf16"],
              launches_bev_rank_b1=bev["launches_b1"]["rig_window_fwd_bf16"],
              launches_bev_train_step=bev["step"]["rig_window_fwd_bf16"],
              bev_slab_max_abs_err=bev["plain_fwd"][0],
              bev_slab_max_rel_err=bev["plain_fwd"][1],
              passes_ms=passes16["fwd"]["passes_ms"],
              host_gap_ms=passes16["fwd"]["wall_ms"] - passes16["fwd"]["device_ms"]),
        entry("rig_flat_fwd_bf16", "rig_flat_fwd", "vfa_tpu/ops/rig_pallas.py:31",
              flat16_launches["rig_flat_fwd_bf16"], dtype="bfloat16",
              passes_ms=passes16_flat["fwd"]["passes_ms"],
              host_gap_ms=passes16_flat["fwd"]["wall_ms"]
              - passes16_flat["fwd"]["device_ms"]),
        entry("rig_window_bwd_bf16", "rig_window_bwd",
              "vfa_tpu/ops/rig_pallas.py:194,355",
              train16_launches["rig_window_bwd_bf16"], dtype="bfloat16",
              launches_memory_options=mem_launches("rig_window_bwd_bf16"),
              launches_grid2x_bench=bench5f["launches"]["rig_window_bwd_bf16"],
              passes_ms=passes16[f"bwd_b{BATCH}"]["passes_ms"],
              passes_ms_b1=passes16["bwd_b1"]["passes_ms"], ms_b1=k3_16[0],
              plain_ms_b1=k3_16[1], bound_ms_b1=k3_16[2],
              launches_disk_train=disk_launches["train"]["rig_window_bwd_bf16"],
              launches_bev_rank_b2=bev["launches_b2"]["rig_window_bwd_bf16"],
              launches_bev_rank_b1_serial=bev["launches_b1"]["rig_window_bwd_bf16"],
              launches_bev_train_step_b1_serial=bev["step"]["rig_window_bwd_bf16"],
              bev_slab_max_abs_err=bev["plain_bwd"][0],
              bev_slab_max_rel_err=bev["plain_bwd"][1]),
        entry("rig_flat_bwd_bf16", "rig_flat_bwd", "vfa_tpu/ops/rig_pallas.py:434",
              flat16_train_launches["rig_flat_bwd_bf16"], dtype="bfloat16",
              passes_ms=passes16_flat[f"bwd_b{BATCH}"]["passes_ms"],
              host_gap_ms=passes16_flat[f"bwd_b{BATCH}"]["wall_ms"]
              - passes16_flat[f"bwd_b{BATCH}"]["device_ms"]),
        entry("stem_bwd_stats_bf16", "stem_bwd", "vfa_tpu/ops/stem.py:223",
              flat16_train_launches["stem_bwd_stats_bf16"], dtype="bfloat16",
              launches_memory_options=mem_launches("stem_bwd_stats_bf16")),
        entry("stem_bwd_dx_bf16", "stem_bwd", "vfa_tpu/ops/stem.py:253",
              flat16_train_launches["stem_bwd_dx_bf16"], dtype="bfloat16",
              launches_memory_options=mem_launches("stem_bwd_dx_bf16")),
        *(voxel_entry(name, dtype) for name, dtype in (("voxel_tap_bwd", "float32"),
                                                        ("voxel_tap_bwd_bf16", "bfloat16"))),
        {"name": "rig_bev_epilogue", "route": "cuda",
         "source": "vfa_tpu_torch/csrc/rig_bev_epilogue.cu",
         "replaces": "vfa_tpu/ops/rig_pallas.py:873 (_bev_unpermute, an XLA gather; "
                     "not a Pallas kernel) and the bias, ReLU and sums after it",
         "launches": serve16_launches["rig_bev_epilogue"], "max_abs_err": 0.0,
         "max_rel_err": 0.0, "dtype": "bfloat16", "library_ms": None,
         "ms": epilogue["Wildtrack"]["ms"], "plain_ms": epilogue["Wildtrack"]["plain_ms"],
         "bound_ms": epilogue["Wildtrack"]["bound_ms"], "bound_by": "bytes",
         "batch": EPILOGUE_BATCH, "by_dataset": epilogue},
        {"name": "mvdet_project", "route": "cuda",
         "source": "vfa_tpu_torch/csrc/mvdet_project.cu",
         "replaces": "no TPU kernel (the JAX package has no MVDet): the library chain of "
                     "MVDet.project, upsample, cast, grid_sample and copy, per camera",
         "launches": mvdet_path["launches"], "max_abs_err": mvdet["err"][0],
         "max_rel_err": mvdet["err"][1],
         "dtype": "bfloat16", "ms": mvdet["ms"], "plain_ms": mvdet["plain_ms"],
         "library_ms": mvdet["library_ms"], "bound_ms": mvdet["bound_ms"],
         "bound_by": "bytes", "batch": MVDET_BATCH,
         "one_ulp_share": mvdet["one_ulp_share"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
