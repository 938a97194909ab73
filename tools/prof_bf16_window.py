"""Time the bf16 rig kernels of the full MultiviewC rigs on the card. Window
layout (the default): K1-bf16 (`rig_tiles_cuda`, one forward over the 3
scales of the 12-bucket serving rig) and K2-bf16 / K3-bf16
(`rig_scale_bwd`, one backward over the 3 scales of the 8-bucket training
rig). `--layout flat`: K4-bf16 and K5-bf16, the same calls on the 8-bucket
flat rig (tile_v 160) cast to bf16, which serves both. Each beside its
plain version, its device time by pass (torch.profiler), the wall clock of
the same call and the host gap between them, and for each bucket of the
backward's rig the dII reduce's adds per covered pixel
(`ScaleRig.dii_order`) and the fp32 dII scratch of one launch. CUDA events,
warmed up, best of `--rounds`.

    python tools/prof_bf16_window.py [--layout flat] [--batch 2] [--rounds 3]
        [--b1] [--cache_dir DIR] [--no_plain] [--json]

`--b1` adds the backward at batch 1 (on the window rig JAX's serial K3 on
every bucket); `--cache_dir` loads the rigs from (or saves them to) a rig
cache (the flat one as fp32, cast here); `--no_plain` skips the plain
versions; `--json` ends with one JSON line of every number. Prints the
card's name and power limit first."""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vfa_tpu_torch.config import get_config  # noqa: E402
from vfa_tpu_torch.data.synthetic import make_calibrations  # noqa: E402
from vfa_tpu_torch.ops import rig as trig  # noqa: E402
from vfa_tpu_torch.ops.rig_cuda import rig_scale_bwd, rig_tiles_cuda  # noqa: E402
from vfa_tpu_torch.rig_cli import build_cli_rig  # noqa: E402

FWD_PASSES = ("rig_wsvox", "rig_wscollapse")
BWD_PASSES = ("rig_wsvox", "rig_wsdkr", "rig_dkr_reduce", "rig_wsdvox",
              "rig_wsdband", "rig_dii_reduce")


def events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def passes(fn, names):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    ms = {n: sum(e.device_time_total for e in ev if n in e.key) / 1e3 for n in names}
    return ms, sum(e.device_time_total for e in ev) / 1e3


def inputs(rig, B, dev, seed):
    out = []
    for si, sr in enumerate(rig.scales):
        g = torch.Generator().manual_seed(seed + si)
        lat = torch.rand((B, sr.A[0].shape[0], *sr.feat_hw, 256), generator=g)
        k = torch.randn((256 * sr.nl, 256), generator=g) * 0.05
        lat, k = lat.to(dev, torch.bfloat16), k.to(dev, torch.bfloat16)
        ii = trig.scale_features(lat, sr)
        Kr = trig.collapse_per_layer(k, 256, sr.nl, torch.bfloat16)
        rows = sum(a.shape[1] for a in sr.A) * sr.tile_v
        gg = torch.randn((sr.A[0].shape[0], B, rows, 256), generator=g).to(
            dev, torch.bfloat16)
        out.append((lat, k, ii, Kr, gg))
    return out


def report(tag, rig, fn, plain, names, rounds):
    k_ms = min(events_ms(fn, 5) for _ in range(rounds))
    p_ms = events_ms(plain, 1) if plain else float("nan")
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    ms, dev = passes(fn, names)
    print(f"{tag}: {k_ms:.3f} ms (CUDA events, best of {rounds}), plain "
          f"{p_ms:.3f} ms; passes " + ", ".join(f"{n} {t:.3f}" for n, t in ms.items())
          + f" ms; device {dev:.3f} ms, wall clock {min(wall):.3f} ms, host gap "
          f"{min(wall) - dev:.3f} ms", flush=True)
    return {"ms": k_ms, "plain_ms": p_ms, "passes_ms": ms, "device_ms": dev,
            "wall_ms": min(wall)}


def flat_bf16_rig(cfg, calibs, dev, cache_dir):
    """The 8-bucket flat rig (the training policy, which chip_smoke.py
    drives for both paths) with A cast to bf16: a flat rig's tile_v does
    not depend on the dtype, and its bf16 A is the fp32 A cast."""
    rig = build_cli_rig(cfg, calibs, dev, training=True, layout="flat",
                        cache_dir=cache_dir)
    return type(rig)([dataclasses.replace(sr, A=tuple(a.to(torch.bfloat16)
                                                      for a in sr.A))
                      for sr in rig.scales], rig.grid_shape)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layout", choices=["window", "flat"], default="window")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--b1", action="store_true")
    ap.add_argument("--cache_dir", default=None)
    ap.add_argument("--no_plain", action="store_true")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    out = {}
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = get_config("MultiviewC")
    calibs = make_calibrations(cfg)
    flat = args.layout == "flat"
    fwd_tag, bwd_tag = ("K4-bf16", "K5-bf16") if flat else ("K1-bf16", "K2-bf16")
    if flat:
        serve = flat_bf16_rig(cfg, calibs, dev, args.cache_dir)
        torch.cuda.empty_cache()
    else:
        serve = build_cli_rig(cfg, calibs, dev, buckets=12,
                              cache_dir=args.cache_dir, dtype=torch.bfloat16)
    x = inputs(serve, args.batch, dev, 7)
    out["fwd"] = report(
        f"{fwd_tag} forward B={args.batch}", serve,
        lambda: [rig_tiles_cuda(lat, sr, k) for sr, (lat, k, *_) in zip(serve.scales, x)],
        None if args.no_plain else
        lambda: [trig.scale_tiles(ii, sr, Kr) for sr, (_, _, ii, Kr, _) in zip(serve.scales, x)],
        FWD_PASSES, args.rounds)
    del x
    if flat:
        train = serve
    else:
        del serve
        torch.cuda.empty_cache()
        train = build_cli_rig(cfg, calibs, dev, buckets=8,
                              cache_dir=args.cache_dir, dtype=torch.bfloat16)

    def plain_bwd(ii, sr, Kr, g):
        dII, off = None, 0
        for bi, (A_b, s_b) in enumerate(zip(sr.A, sr.starts)):
            T = A_b.shape[1]
            g_b = g[:, :, off * sr.tile_v:(off + T) * sr.tile_v]
            if flat:
                dII, _ = trig.flat_tiles_bwd(ii, A_b, s_b, Kr, g_b, sr.tile_v,
                                             dII=dII)
            else:
                dII, _ = trig.window_tiles_bwd(ii, A_b, s_b, Kr, g_b,
                                               sr.window_hw[bi], sr.tile_v,
                                               dII=dII)
            off += T

    # the dII reduce's work: each covered pixel's list of band adds, and the
    # fp32 scratch of one backward launch (per layer on a serial window)
    for si, sr in enumerate(train.scales):
        for bi, (pixels, ptr, _) in enumerate(sr.dii_order):
            cover = torch.diff(ptr.long())
            N, T, R, K = sr.A[bi].shape
            serial = not flat and trig.window_bwd_serial(args.batch, K, R, 2, 2, 256)
            shape = f"window {sr.window_hw[bi]}" if not flat else f"band {K}"
            print(f"  dII scale {si} bucket {bi}: {shape}, {N * T} "
                  f"{'bands' if flat else 'windows'}, {pixels.shape[0]} pixels "
                  f"covered, adds per pixel mean {float(cover.float().mean()):.2f}, "
                  f"max {int(cover.max())}; scratch at B={args.batch} "
                  f"{N * args.batch * T * (sr.nl if serial else 1) * K * 256 * 4} "
                  "bytes", flush=True)
    for B in ([args.batch, 1] if args.b1 else [args.batch]):
        x = inputs(train, B, dev, 17)
        out[f"bwd_b{B}"] = report(
            f"{bwd_tag} backward B={B}", train,
            lambda: [rig_scale_bwd(ii, sr, Kr, g) for sr, (_, _, ii, Kr, g) in zip(train.scales, x)],
            None if args.no_plain else
            lambda: [plain_bwd(ii, sr, Kr, g) for sr, (_, _, ii, Kr, g) in zip(train.scales, x)],
            BWD_PASSES, args.rounds)
        del x
        torch.cuda.empty_cache()
    if args.json:
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
