"""Chip smoke test of the PyTorch/CUDA port (vfa_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):
  1. build every hand-written kernel from csrc/ with nvcc (one process per
     source, all started together) and print ptxas' registers and spills
     per kernel (fails if a tensor-core pass `rig_*_mma` spills);
  2. hold each kernel against its plain PyTorch version at B = 1 and B = 2
     on the full MultiviewC fp32 rigs (7 x 720x1280 cameras, 156x156 BEV,
     nl 5), all 3 scales, every bucket (the forwards bucket by bucket): the
     window forward on the 12-bucket (serving) and the 8-bucket (training)
     rig, the window backward (dII and dKr, all buckets of a scale through
     one dII) on the 8-bucket rig, the flat forward and backward on the
     8-bucket flat rig (tile_v 160) and on a small 16-tap rig (cumsum'd
     features); all rig kernels run 3xTF32 on the tensor cores; and the two
     stem backward kernels at (14, 64, 360, 640), also on an integer-valued
     input where ties decide;
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
  5. time each kernel (CUDA events, warmed up) beside its bound and its
     plain version (the rig kernels' operations are held to 495 / 3 = 165
     TFLOP/s, fp32-accurate 3xTF32 on the tensor cores; the window backward
     also alone at B = 1), split each forward's device time between its two
     passes (torch.profiler), and print peak memory, the card's name and
     power limit, the `kernels` JSON line and, last, the `ok` JSON line.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
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
PEAK_BYTES_PER_S = 3.35e12
KERNEL_TOL = 1e-4      # max |kernel - plain| / max |plain|, fp32 both sides
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


def counters():
    """name -> wrapper of every kernel of the port; each wrapper counts its
    launches in `.launches`."""
    from vfa_tpu_torch.ops import rig_cuda, stem

    return {"rig_window_fwd": rig_cuda.rig_window_fwd,
            "rig_window_bwd": rig_cuda.rig_window_bwd,
            "rig_flat_fwd": rig_cuda.rig_flat_fwd,
            "rig_flat_bwd": rig_cuda.rig_flat_bwd,
            "stem_bwd_stats": stem.stem_bwd_stats,
            "stem_bwd_dx": stem.stem_bwd_dx}


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
            short = re.search(r"\d((?:rig|stem)_[a-z_]+)", m.group(1))
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
            if spill and re.match(r"rig_\w+_mma", kernel):
                raise AssertionError(f"{kernel} spills {spill} bytes")
    log(f"phase 1 build: {names} in {time.perf_counter() - t0:.1f} s")


def full_rig(device, training: bool, layout: str = "window"):
    """The full MultiviewC fp32 rig under the serving (12 buckets) or the
    training (8 buckets) policy, built once and handed to the CLIs."""
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import make_calibrations
    from vfa_tpu_torch.rig_cli import build_cli_rig

    cfg = get_config("MultiviewC")
    t0 = time.perf_counter()
    rig = build_cli_rig(cfg, make_calibrations(cfg), device, training=training,
                        layout=layout)
    a_bytes = sum(a.numel() * 4 for s in rig.scales for a in s.A)
    log(f"full MultiviewC fp32 {layout} {'training' if training else 'serving'} "
        f"rig: {[len(s.A) for s in rig.scales]} buckets, "
        f"tile_v {rig.scales[0].tile_v}, A {a_bytes} bytes "
        f"({a_bytes / 1e9:.3f} GB), built in {time.perf_counter() - t0:.1f} s")
    return rig


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


def scale_inputs(sr, B, seed, device):
    g = torch.Generator().manual_seed(seed)
    fh, fw = sr.feat_hw
    N = sr.A[0].shape[0]
    lat = torch.rand((B, N, fh, fw, 256), generator=g)
    if not sr.on_raw:
        lat = lat / (fh * fw)      # keeps the 2D cumsum O(1)
    bound = 1.0 / np.sqrt(256 * sr.nl)
    k = ((torch.rand((256 * sr.nl, 256), generator=g) * 2 - 1) * bound).to(device)
    return lat.to(device), k


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


def worst_of(errs):
    return max(e[0] for e in errs), max(e[1] for e in errs)


def phase_kernel_vs_plain(rig, device, batches=(1, 2)):
    """The forward kernel against its plain version, bucket by bucket: each
    bucket's rows of the scale's tiles held to the tolerance of its own
    plain result's max; one line per scale with its worst bucket."""
    from vfa_tpu_torch.ops.rig_cuda import rig_tiles_cuda

    name = f"rig_{layout_of(rig)}_fwd"
    errs = []
    for B in batches:
        for si, sr in enumerate(rig.scales):
            lat, k = scale_inputs(sr, B, 100 * B + si, device)
            got = rig_tiles_cuda(lat, sr, k)
            torch.cuda.synchronize()
            want = plain_tiles(lat, sr, k)
            tag = (f"{name} B={B} scale {si} ({len(sr.A)} buckets, "
                   f"{sum(a.shape[1] for a in sr.A)} tiles, bands "
                   f"{[a.shape[-1] for a in sr.A]})")
            per_bucket, off = [], 0
            for bi, A_b in enumerate(sr.A):
                rows = slice(off, off + A_b.shape[1] * sr.tile_v)
                per_bucket.append(check_close(f"{tag} bucket {bi}", got[:, :, rows],
                                              want[:, :, rows], quiet=True))
                off = rows.stop
            err, rel = worst_of(per_bucket)
            log(f"  {tag}: worst bucket max abs err {err:.3e}, max rel err "
                f"{rel:.3e} (tolerance {KERNEL_TOL:.0e} of each bucket's plain max)")
            errs += per_bucket
            del got, want
    log(f"phase 2 {name} vs plain: ok")
    return worst_of(errs)


def grad_inputs(sr, B, seed, device):
    """Seeded padded features, per-layer collapse weight and cotangent of a
    scale's tiles."""
    from vfa_tpu_torch.ops.rig import collapse_per_layer, scale_features

    lat, k = scale_inputs(sr, B, seed, device)
    rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
    g = torch.randn((sr.A[0].shape[0], B, rows, 256),
                    generator=torch.Generator().manual_seed(seed + 1)).to(device)
    return scale_features(lat, sr), collapse_per_layer(k, 256, sr.nl, lat.dtype), g


def plain_scale_bwd(ii, sr, Kr, g):
    from vfa_tpu_torch.ops.rig import flat_tiles_bwd, window_tiles_bwd

    dII, dKr, off = None, torch.zeros_like(Kr), 0
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


def phase_bwd_kernel_vs_plain(rig, device, batches=(1, 2)):
    from vfa_tpu_torch.ops.rig_cuda import rig_scale_bwd

    name = f"rig_{layout_of(rig)}_bwd"
    errs = []
    for B in batches:
        for si, sr in enumerate(rig.scales):
            ii, Kr, g = grad_inputs(sr, B, 300 * B + si, device)
            got = rig_scale_bwd(ii, sr, Kr, g)
            torch.cuda.synchronize()
            want = plain_scale_bwd(ii, sr, Kr, g)
            for part, a, b in zip(("dII", "dKr"), got, want):
                errs.append(check_close(
                    f"{name} B={B} scale {si} ({len(sr.A)} buckets) {part}", a, b))
            del got, want, ii, Kr, g
    log(f"phase 2 {name} vs plain: ok")
    return worst_of(errs)


def stem_inputs(device, integers: bool, shape=STEM_SHAPE):
    """Seeded x, scale, bias, dy of the stem tail and the forward's
    GroupNorm statistics. `integers`: integer-valued x with scale 1, bias 0,
    so that ReLU zeros and equal maxima are everywhere."""
    from vfa_tpu_torch.ops.stem import group_norm_stats

    g = torch.Generator().manual_seed(11 + integers)
    M, C, H, W = shape
    x = torch.randn(shape, generator=g)
    scale, bias = torch.rand(C, generator=g) + 0.5, torch.rand(C, generator=g) - 0.5
    if integers:
        x, scale, bias = x.round(), torch.ones(C), torch.zeros(C)
    dy = torch.randn((M, C, (H + 1) // 2, (W + 1) // 2), generator=g)
    x, scale, bias, dy = (t.to(device) for t in (x, scale, bias, dy))
    _, mu, rstd = group_norm_stats(x, scale, bias, 16, 1e-5)
    return x, scale, bias, dy, mu, rstd


def phase_stem_vs_plain(device):
    """K6 and K7 against their plain versions on the same parameters, the
    whole backward against autograd of the unfused chain, and the identical
    zero pattern of dx on the integer-valued input."""
    from vfa_tpu_torch.ops import stem

    errs = {"stem_bwd_stats": [], "stem_bwd_dx": []}
    for integers in (False, True):
        x, scale, bias, dy, mu, rstd = stem_inputs(device, integers)
        tag = f"{tuple(x.shape)}{' integer-valued' if integers else ''}"
        params = stem.plane_params(mu, rstd, scale, bias)
        acc = stem.stem_bwd_stats(x, dy, params)
        torch.cuda.synchronize()
        errs["stem_bwd_stats"].append(check_close(
            f"stem_bwd_stats {tag}", acc, stem.stem_bwd_stats_plain(x, dy, params)))
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
              "--rig_layout", layout]
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
    from vfa_tpu_torch import predict

    layout = layout_of(rig)
    fwd = f"rig_{layout}_fwd"
    argv = ["--data", "MultiviewC", "--synthetic", "--scenes", str(scenes),
            "--batch", str(BATCH), "--seed", "0", "--cls_thresh", "0.5",
            "--device", "cuda", "--rig_layout", layout]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = predict.main(argv, rig=rig)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"serving path ({layout}) launches: {launches}")
    if launches[fwd] <= 0:
        raise AssertionError(f"the serving path never launched {fwd}")
    if any(n for name, n in launches.items() if name != fwd):
        raise AssertionError("the serving path launched another kernel")
    ref = predict.main(argv + ["--rig_impl", "plain"], rig=rig)

    for i, (h, hr) in enumerate(zip(res["heatmaps"], ref["heatmaps"])):
        if not torch.isfinite(h).all():
            raise AssertionError(f"request {i}: non-finite heatmap")
        if tuple(h.shape) != (BATCH, 1, 156, 156):
            raise AssertionError(f"request {i}: heatmap shape {tuple(h.shape)}")
        err = float((h - hr).abs().max()) / max(float(hr.abs().max()), 1e-12)
        log(f"  request {i}: heatmap kernel vs plain route, max rel err {err:.3e} "
            f"(tolerance {PATH_TOL:.0e})")
        if err > PATH_TOL:
            raise AssertionError(f"request {i}: heatmap differs from the plain route")
    n_det = 0
    for s, (d, dr) in enumerate(zip(res["detections"], ref["detections"])):
        if len(d) != len(dr):
            raise AssertionError(f"scene {s}: {len(d)} detections vs {len(dr)} plain")
        for o, orf in zip(d, dr):
            np.testing.assert_allclose(o.location, orf.location, rtol=1e-4, atol=0.5)
            np.testing.assert_allclose(o.conf, orf.conf, rtol=1e-3, atol=1e-4)
        n_det += len(d)
    log(f"phase 3 serving path ({layout}): {len(res['ms'])} requests, {n_det} "
        f"detections (conf > 0.5), equal to the plain route; p50 "
        f"{np.median(res['ms']):.2f} ms/request (batch {BATCH}), plain route "
        f"{np.median(ref['ms']):.2f}; peak memory {peak / 2**30:.2f} GiB")
    return launches, res, peak


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
    for sr in rig.scales:
        fh, fw = sr.feat_hw
        N = sr.A[0].shape[0]
        if sr.window_hw:
            pixels = (-(-fh // 8) * 8) * (-(-fw // 16) * 16)
        else:
            pixels = fh * fw + max(a.shape[-1] for a in sr.A)
        rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
        nbytes += sum(a.numel() * 4 + s.numel() * 4 for a, s in zip(sr.A, sr.starts))
        nbytes += (3 if backward else 1) * N * B * pixels * 256 * 4    # ii (+ dII)
        nbytes += (2 if backward else 1) * sr.nl * 256 * 256 * 4       # Kr (+ dKr)
        nbytes += N * B * rows * 256 * 4                               # tiles or g
    return flops, nbytes


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

    name = f"rig_{layout_of(rig)}_{'bwd' if backward else 'fwd'}"
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
            + f" ms, bound {bound_ms(f, b)[0]:.3f} ms at 165 TFLOP/s "
            f"(3xTF32 on the tensor cores; {bound_ms(f, b, PEAK_FP32_FLOPS)[0]:.3f} "
            f"ms at the CUDA cores' 67 TFLOP/s; {f / 1e9:.1f} GFLOP, "
            f"{b / 1e9:.3f} GB)")
        ms += min(k_ms)
        plain_ms += min(p_ms)
        del first, rest
    return (ms, plain_ms, *bound_ms(*kernel_work(rig, batch, backward)))


def phase_pass_shares(rig, device, batch: int = BATCH):
    """Device time of the forward kernel's two passes, pass 1 `rig_vox_mma`
    (the A product) and pass 2 `rig_collapse_mma`, over one batch-`batch`
    forward of the rig's three scales, from a torch.profiler capture after
    a warm-up; logged as ms and as shares of the two passes' sum."""
    from torch.profiler import ProfilerActivity, profile

    from vfa_tpu_torch.ops.rig_cuda import rig_tiles_cuda

    name = f"rig_{layout_of(rig)}_fwd"
    inputs = [scale_inputs(sr, batch, 7 + si, device) for si, sr in enumerate(rig.scales)]

    def forward():
        for sr, (lat, k) in zip(rig.scales, inputs):
            rig_tiles_cuda(lat, sr, k)
        torch.cuda.synchronize()

    forward()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        forward()
    ms = {p: sum(e.device_time_total for e in prof.key_averages() if p in e.key) / 1e3
          for p in ("rig_vox_mma", "rig_collapse_mma")}
    total = sum(ms.values())
    if not total > 0:
        raise AssertionError(f"the profiler saw no device time of {name}'s passes")
    log(f"{name} passes at B={batch} (torch.profiler, one forward over the 3 "
        "scales): " + ", ".join(f"{p} {t:.3f} ms ({t / total:.1%})" for p, t in ms.items()))
    return ms


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


def phase_stem_numbers(device):
    """name -> (ms, plain_ms, bound_ms, bound_by) of the two stem kernels at
    STEM_SHAPE. Neither is a matrix product: a few tens of comparisons and
    ~10 flops per pixel. Bytes: x and dy read and the (M*C, 8) parameters,
    acc (stats) or dx (dx) written."""
    from vfa_tpu_torch.ops import stem

    x, scale, bias, dy, mu, rstd = stem_inputs(device, integers=False)
    params = stem.plane_params(mu, rstd, scale, bias, mu * 1e-3, rstd * 1e-3)
    out = {}
    for name, kernel, plain, written in (
            ("stem_bwd_stats", stem.stem_bwd_stats, stem.stem_bwd_stats_plain,
             x.shape[0] * 4 * x.shape[1]),
            ("stem_bwd_dx", stem.stem_bwd_dx, stem.stem_bwd_dx_plain, x.numel())):
        k_ms, p_ms = [], []
        for _ in range(2):
            k_ms.append(cuda_time_ms(lambda: kernel(x, dy, params), reps=10))
            p_ms.append(cuda_time_ms(lambda: plain(x, dy, params), reps=3))
        nbytes = 4 * (x.numel() + dy.numel() + params.numel() + written)
        flops = 50 * x.numel()
        b_ms, by = bound_ms(flops, nbytes, PEAK_FP32_FLOPS)
        log(f"  {name} {tuple(x.shape)}: " + " / ".join(f"{t:.3f}" for t in k_ms)
            + " ms, plain " + " / ".join(f"{t:.3f}" for t in p_ms)
            + f" ms, bound {b_ms:.3f} ms by {by} ({nbytes / 1e9:.3f} GB, "
            f"~{flops / 1e9:.1f} GFLOP)")
        out[name] = (min(k_ms), min(p_ms), b_ms, by)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase_build()
    phase_tf32_arithmetic(device)
    err, num = {}, {}

    # the stem kernels alone
    err.update(phase_stem_vs_plain(device))
    num.update(phase_stem_numbers(device))
    torch.cuda.empty_cache()

    # window layout, serving
    rig = full_rig(device, training=False)
    err["rig_window_fwd"] = phase_kernel_vs_plain(rig, device)
    serve_launches, res, peak = phase_main_path(rig, device, scenes=6)
    num["rig_window_fwd"] = phase_numbers(rig, device, backward=False)
    phase_pass_shares(rig, device)
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
    del train_rig
    torch.cuda.empty_cache()

    # flat layout: one rig (the 8-bucket training policy) serves both runs
    taps_rig = small_taps_rig(device)
    phase_kernel_vs_plain(taps_rig, device)
    phase_bwd_kernel_vs_plain(taps_rig, device, batches=(2,))
    del taps_rig
    flat_rig = full_rig(device, training=True, layout="flat")
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

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for tag, r, pk in (("window", res, peak), ("flat", flat_res, flat_peak)):
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
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card.splitlines()[0]}")

    def entry(name, source, replaces, launches, **extra):
        ms, plain_ms, b_ms, by = num[name]
        return {"name": name, "route": "cuda",
                "source": f"vfa_tpu_torch/csrc/{source}.cu", "replaces": replaces,
                "launches": launches, "max_abs_err": err[name][0],
                "max_rel_err": err[name][1], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": by, "library_ms": None, **extra}

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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
