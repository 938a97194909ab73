"""Chip smoke test of the PyTorch/CUDA port (vfa_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):
  1. build every hand-written kernel from csrc/ with nvcc (one process per
     source, all started together) and print ptxas' register / shared
     memory / spill lines;
  2. hold each kernel against its plain PyTorch version on the full
     MultiviewC fp32 rig (7 x 720x1280 cameras, 156x156 BEV, nl 5), all 3
     scales, at B = 1 and B = 2: the forward kernel on every bucket of the
     12-bucket (serving) rig, the backward kernel (dII and dKr, all buckets
     of a scale through one dII) on the 8-bucket (training) rig;
  3. drive the serving path, `python -m vfa_tpu_torch.predict` at full
     width with random seeded weights, with every kernel's launch count set
     to 0 just before and read just after; then the same requests through
     the plain rig version, and compare heatmaps and decoded detections;
  4. drive the training path, `python -m vfa_tpu_torch.train` at full width
     (batch 2, 3 optimizer steps, then the validation loss), counts set to
     0 before and read after; then the same run through the plain versions
     under autograd, and compare per-step losses and final parameters;
     then one step at batch 1;
  5. time each kernel (CUDA events, warmed up) beside its bound and its
     plain version, and print peak memory, the card's name and power limit,
     the `kernels` JSON line and, last, the `ok` JSON line.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores and
# HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
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


def phase_build():
    from vfa_tpu_torch.kernels import LIBRARY, SIGNATURES

    t0 = time.perf_counter()
    names = sorted(SIGNATURES)
    LIBRARY.build(names)
    for name in names:
        LIBRARY.load(name)
        for line in LIBRARY.ptxas_log.get(name, "").splitlines():
            if re.search(r"registers|spill|smem", line):
                log(f"  ptxas[{name}]: {line.strip()}")
    log(f"phase 1 build: {names} in {time.perf_counter() - t0:.1f} s")


def full_rig(device, training: bool):
    """The full MultiviewC fp32 rig under the serving (12 buckets) or the
    training (8 buckets) policy, built once and handed to the CLIs."""
    from vfa_tpu_torch.config import get_config
    from vfa_tpu_torch.data.synthetic import make_calibrations
    from vfa_tpu_torch.rig_cli import build_cli_rig

    cfg = get_config("MultiviewC")
    rig = build_cli_rig(cfg, make_calibrations(cfg), device, training=training)
    a_bytes = sum(a.numel() * 4 for s in rig.scales for a in s.A)
    log(f"full MultiviewC fp32 {'training' if training else 'serving'} rig: "
        f"{[len(s.A) for s in rig.scales]} buckets, "
        f"tile_v {rig.scales[0].tile_v}, A {a_bytes / 1e9:.3f} GB")
    return rig


def scale_inputs(sr, B, seed, device):
    g = torch.Generator().manual_seed(seed)
    fh, fw = sr.feat_hw
    N = sr.A[0].shape[0]
    lat = torch.rand((B, N, fh, fw, 256), generator=g).to(device)
    bound = 1.0 / np.sqrt(256 * sr.nl)
    k = ((torch.rand((256 * sr.nl, 256), generator=g) * 2 - 1) * bound).to(device)
    return lat, k


def plain_tiles(lat, sr, k):
    from vfa_tpu_torch.ops.rig import collapse_per_layer, pad_features, window_tiles

    ii = pad_features(lat)
    Kr = collapse_per_layer(k, lat.shape[-1], sr.nl, lat.dtype)
    return torch.cat([window_tiles(ii, A_b, s_b, Kr, win, sr.tile_v)
                      for A_b, s_b, win in zip(sr.A, sr.starts, sr.window_hw)], 2)


def phase_kernel_vs_plain(rig, device):
    from vfa_tpu_torch.ops.rig_cuda import rig_tiles_cuda

    worst_abs, worst_rel = 0.0, 0.0
    for B in (1, 2):
        for si, sr in enumerate(rig.scales):
            lat, k = scale_inputs(sr, B, 100 * B + si, device)
            got = rig_tiles_cuda(lat, sr, k)
            torch.cuda.synchronize()
            want = plain_tiles(lat, sr, k)
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            log(f"  rig_window_fwd B={B} scale {si} ({len(sr.A)} buckets, "
                f"{sum(a.shape[1] for a in sr.A)} tiles): max abs err {err:.3e}, "
                f"max rel err {rel:.3e} (tolerance {KERNEL_TOL:.0e} rel)")
            if not np.isfinite(rel) or rel > KERNEL_TOL:
                raise AssertionError(f"rig_window_fwd disagrees with its plain "
                                     f"version at B={B}, scale {si}: rel {rel:.3e}")
            del got, want
    log("phase 2 forward kernel vs plain: ok")
    return worst_abs, worst_rel


def grad_inputs(sr, B, seed, device):
    """Seeded padded features, per-layer collapse weight and cotangent of a
    scale's tiles."""
    from vfa_tpu_torch.ops.rig import collapse_per_layer, pad_features

    lat, k = scale_inputs(sr, B, seed, device)
    rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
    g = torch.randn((sr.A[0].shape[0], B, rows, 256),
                    generator=torch.Generator().manual_seed(seed + 1)).to(device)
    return pad_features(lat), collapse_per_layer(k, 256, sr.nl, lat.dtype), g


def plain_scale_bwd(ii, sr, Kr, g):
    from vfa_tpu_torch.ops.rig import window_tiles_bwd

    dII, dKr, off = None, torch.zeros_like(Kr), 0
    for A_b, s_b, win in zip(sr.A, sr.starts, sr.window_hw):
        rows = A_b.shape[1] * sr.tile_v
        dII, d = window_tiles_bwd(ii, A_b, s_b, Kr, g[:, :, off:off + rows],
                                  win, sr.tile_v, dII=dII)
        dKr += d
        off += rows
    return dII, dKr


def phase_bwd_kernel_vs_plain(rig, device):
    from vfa_tpu_torch.ops.rig_cuda import rig_scale_bwd

    worst_abs, worst_rel = 0.0, 0.0
    for B in (1, 2):
        for si, sr in enumerate(rig.scales):
            ii, Kr, g = grad_inputs(sr, B, 300 * B + si, device)
            got = rig_scale_bwd(ii, sr, Kr, g)
            torch.cuda.synchronize()
            want = plain_scale_bwd(ii, sr, Kr, g)
            for name, a, b in zip(("dII", "dKr"), got, want):
                err = float((a - b).abs().max())
                rel = err / float(b.abs().max())
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
                log(f"  rig_window_bwd B={B} scale {si} ({len(sr.A)} buckets) "
                    f"{name}: max abs err {err:.3e}, max rel err {rel:.3e} "
                    f"(tolerance {KERNEL_TOL:.0e} rel)")
                if not np.isfinite(rel) or rel > KERNEL_TOL:
                    raise AssertionError(
                        f"rig_window_bwd {name} disagrees with its plain "
                        f"version at B={B}, scale {si}: rel {rel:.3e}")
            del got, want, ii, Kr, g
    log("phase 2 backward kernel vs plain: ok")
    return worst_abs, worst_rel


def phase_train_path(rig, device):
    """The training path through both kernels, then through their plain
    versions from the same seed, then one step at batch 1."""
    from vfa_tpu_torch import train
    from vfa_tpu_torch.ops.rig_cuda import rig_window_bwd, rig_window_fwd

    common = ["--data", "MultiviewC", "--synthetic", "-e", "1", "--pretrained",
              "0", "--no_augment", "--seed", "0", "--device", "cuda"]
    argv = common + ["--synthetic_frames", str(TRAIN_FRAMES), "-b", str(BATCH),
                     "--lr", TRAIN_LR]
    torch.cuda.reset_peak_memory_stats()
    rig_window_fwd.launches = rig_window_bwd.launches = 0
    res = train.main(argv, rig=rig)
    launches = {"rig_window_fwd": rig_window_fwd.launches,
                "rig_window_bwd": rig_window_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = len(res["losses"])
    buckets = sum(len(s.A) for s in rig.scales)
    log(f"training path launches: {launches} ({steps} steps, {buckets} "
        f"buckets over the 3 scales)")
    if launches["rig_window_fwd"] <= 0:
        raise AssertionError("the training path never launched rig_window_fwd")
    if steps != TRAIN_FRAMES // BATCH or launches["rig_window_bwd"] != steps * buckets:
        raise AssertionError(
            f"rig_window_bwd launched {launches['rig_window_bwd']} times, "
            f"expected {steps} steps x {buckets} buckets")
    ref = train.main(argv + ["--rig_impl", "plain"], rig=rig)
    if launches != {"rig_window_fwd": rig_window_fwd.launches,
                    "rig_window_bwd": rig_window_bwd.launches}:
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
    del ref, ref_sd, init_sd

    one = train.main(common + ["--synthetic_frames", "1", "-b", "1"], rig=rig)
    if len(one["losses"]) != 1 or not np.isfinite(one["losses"][0]["loss"]):
        raise AssertionError("the batch-1 step gave no finite loss")
    log(f"phase 4 training path: {steps} steps at batch {BATCH}, losses and "
        f"parameters equal to the plain route (max abs parameter diff "
        f"{worst:.3e}, at most {worst_share:.2f} of rtol {PARAM_RTOL} / atol "
        f"{PARAM_ATOL}; update "
        f"diff {worst_upd:.3e} of the update's norm, tolerance {UPDATE_TOL}); p50 "
        f"{np.median(res['ms']):.2f} ms/step; one step at batch 1, loss "
        f"{one['losses'][0]['loss']:.6f}; peak memory {peak / 2**30:.2f} GiB")
    return launches, res, peak


def phase_main_path(rig, device):
    from vfa_tpu_torch import predict
    from vfa_tpu_torch.ops.rig_cuda import rig_window_bwd, rig_window_fwd

    argv = ["--data", "MultiviewC", "--synthetic", "--scenes", "6",
            "--batch", str(BATCH), "--seed", "0", "--cls_thresh", "0.5",
            "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    rig_window_fwd.launches = rig_window_bwd.launches = 0
    res = predict.main(argv, rig=rig)
    launches = {"rig_window_fwd": rig_window_fwd.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"serving path launches: {launches}")
    if launches["rig_window_fwd"] <= 0:
        raise AssertionError("the serving path never launched rig_window_fwd")
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
    log(f"phase 3 serving path: {len(res['ms'])} requests, {n_det} detections "
        f"(conf > 0.5), equal to the plain route; p50 {np.median(res['ms']):.2f} "
        f"ms/request (batch {BATCH}); peak memory {peak / 2**30:.2f} GiB")
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
        hp, wp = -(-fh // 8) * 8, -(-fw // 16) * 16
        rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
        nbytes += sum(a.numel() * 4 + s.numel() * 4 for a, s in zip(sr.A, sr.starts))
        nbytes += (3 if backward else 1) * N * B * hp * wp * 256 * 4   # ii (+ dII)
        nbytes += (2 if backward else 1) * sr.nl * 256 * 256 * 4       # Kr (+ dKr)
        nbytes += N * B * rows * 256 * 4                               # tiles or g
    return flops, nbytes


def phase_numbers(rig, device, backward: bool):
    """(ms, plain_ms, bound_ms, bound_by) of one kernel over the rig's three
    scales at batch BATCH: best of two interleaved rounds of kernel and
    plain version."""
    from vfa_tpu_torch.ops.rig_cuda import rig_scale_bwd, rig_tiles_cuda

    if backward:
        name, inputs, kernel, plain = ("rig_window_bwd", grad_inputs,
                                       rig_scale_bwd, plain_scale_bwd)
    else:
        name, inputs, kernel, plain = ("rig_window_fwd", scale_inputs,
                                       rig_tiles_cuda, plain_tiles)
    ms = plain_ms = 0.0
    for si, sr in enumerate(rig.scales):
        first, *rest = inputs(sr, BATCH, 7 + si, device)
        k_ms = cuda_time_ms(lambda: kernel(first, sr, *rest), reps=5)
        p_ms = cuda_time_ms(lambda: plain(first, sr, *rest), reps=3)
        k2_ms = cuda_time_ms(lambda: kernel(first, sr, *rest), reps=5)
        p2_ms = cuda_time_ms(lambda: plain(first, sr, *rest), reps=3)
        f, b = kernel_work(type(rig)([sr], rig.grid_shape), BATCH, backward)
        bound = max(f / PEAK_FP32_FLOPS, b / PEAK_BYTES_PER_S) * 1e3
        log(f"  scale {si} B={BATCH}: {name} {k_ms:.3f} / {k2_ms:.3f} ms, "
            f"plain {p_ms:.3f} / {p2_ms:.3f} ms, bound {bound:.3f} ms "
            f"({f / 1e9:.1f} GFLOP, {b / 1e9:.3f} GB)")
        ms += min(k_ms, k2_ms)
        plain_ms += min(p_ms, p2_ms)
        del first, rest
    flops, nbytes = kernel_work(rig, BATCH, backward)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return ms, plain_ms, max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase_build()
    rig = full_rig(device, training=False)
    fwd_err = phase_kernel_vs_plain(rig, device)
    serve_launches, res, peak = phase_main_path(rig, device)
    fwd = phase_numbers(rig, device, backward=False)
    del rig
    torch.cuda.empty_cache()

    train_rig = full_rig(device, training=True)
    bwd_err = phase_bwd_kernel_vs_plain(train_rig, device)
    train_launches, train_res, train_peak = phase_train_path(train_rig, device)
    del train_res["model"]
    torch.cuda.empty_cache()
    bwd = phase_numbers(train_rig, device, backward=True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"p50 ms per request (batch {BATCH}): {float(np.median(res['ms'])):.3f}; "
        f"max_memory_allocated {peak} bytes")
    log(f"p50 ms per training step (batch {BATCH}): "
        f"{float(np.median(train_res['ms'])):.3f} (steps "
        + " ".join(f"{t:.1f}" for t in train_res["ms"])
        + f"); max_memory_allocated {train_peak} bytes; "
        f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card.splitlines()[0]}")

    def entry(name, replaces, launches, err, numbers, **extra):
        ms, plain_ms, bound_ms, bound_by = numbers
        return {"name": name, "route": "cuda",
                "source": f"vfa_tpu_torch/csrc/{name}.cu", "replaces": replaces,
                "launches": launches, "max_abs_err": err[0],
                "max_rel_err": err[1], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        entry("rig_window_fwd", "vfa_tpu/ops/rig_pallas.py:89",
              serve_launches["rig_window_fwd"], fwd_err, fwd,
              launches_train=train_launches["rig_window_fwd"]),
        entry("rig_window_bwd", "vfa_tpu/ops/rig_pallas.py:194,355",
              train_launches["rig_window_bwd"], bwd_err, bwd),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
