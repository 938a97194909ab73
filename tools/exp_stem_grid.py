"""Experiment: launch shape and ring depth of the stem backward kernels (K6
stem_bwd_stats, K7 stem_bwd_dx, `vfa_tpu_torch/csrc/stem_bwd.cu`).

A warp item is one plane, STRIP pool-window rows and 128 columns, and a
warp's ring holds STEM_STAGES row pairs; both are constants of the source.
This builds copies of the source with other values of each (one nvcc for
each copy, all started together, bound through `kernels.KernelLibrary`) and
times both kernels at the full MultiviewC stem shape (14, 64, 360, 640) fp32
in interleaved rounds (CUDA events, best of the rounds). It checks that
every copy writes the same dx bits as the shipped kernel (through
`ops/stem.py::stem_bwd_dx`), the same acc bits
in two runs and an acc within 1e-4 of the plain version's max, and prints
each time with its achieved GB/s and share of the byte bound (3.35 TB/s).
Needs one GPU and nvcc.

    python tools/exp_stem_grid.py
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPE = (14, 64, 360, 640)
PEAK_BYTES_PER_S = 3.35e12
ROUNDS = 3
REPS = 20
VARIANTS = [(s, 4) for s in (2, 3, 4, 5, 6, 8, 12, 32, 90)] + [(5, 2), (5, 6)]


def cuda_ms(fn, reps=REPS):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def variant_library(strip, stages):
    """A KernelLibrary over a copy of csrc/stem_bwd.cu with STRIP = `strip`
    and STEM_STAGES = `stages`."""
    from vfa_tpu_torch.kernels import BUILD, CSRC, KernelLibrary

    with open(os.path.join(CSRC, "stem_bwd.cu"), encoding="utf-8") as fh:
        text = fh.read()
    for name, value in (("STRIP", strip), ("STEM_STAGES", stages)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        assert n == 1, name
    where = os.path.join(BUILD, "exp_stem_grid", f"strip{strip}_stages{stages}")
    os.makedirs(where, exist_ok=True)
    with open(os.path.join(where, "stem_bwd.cu"), "w", encoding="utf-8") as fh:
        fh.write(text)
    return KernelLibrary(build_dir=where, csrc=where)


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_stem_grid: no CUDA device")
        return 2
    from vfa_tpu_torch.ops import stem

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(11)
    M, C, H, W = SHAPE
    OH = (H + 1) // 2
    x = torch.randn(SHAPE, generator=g).to(dev)
    scale = (torch.rand(C, generator=g) + 0.5).to(dev)
    bias = (torch.rand(C, generator=g) - 0.5).to(dev)
    dy = torch.randn((M, C, OH, (W + 1) // 2), generator=g).to(dev)
    _, mu, rstd = stem.group_norm_stats(x, scale, bias, 16, 1e-5)
    params = stem.plane_params(mu, rstd, scale, bias, mu * 1e-3, rstd * 1e-3)
    want_acc = stem.stem_bwd_stats_plain(x, dy, params)
    stats_bytes = 4 * (x.numel() + dy.numel() + params.numel() + M * 4 * C)
    dx_bytes = 4 * (2 * x.numel() + dy.numel() + params.numel())
    stream = lambda: torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), dy.data_ptr(), params.data_ptr())
    # scratch for the most items any strip gives (strip 1)
    partial = torch.empty((M * C, OH * -(-W // 128), 2), device=dev)

    libs = {v: variant_library(*v) for v in VARIANTS}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(["stem_bwd"]), libs.values()))

    def pair(lib):
        """(K6, K7) launchers of `lib`."""
        lib = lib.load("stem_bwd")

        def k6():
            acc = torch.empty((M, 4, C), device=dev)
            err = lib.stem_bwd_stats_f32(*ptrs, partial.data_ptr(), acc.data_ptr(),
                                         M, C, H, W, stream())
            assert err == 0, err
            return acc

        def k7():
            dx = torch.empty_like(x)
            err = lib.stem_bwd_dx_f32(*ptrs, dx.data_ptr(), M, C, H, W, stream())
            assert err == 0, err
            return dx
        return k6, k7

    runs = {f"strip {s}, STEM_STAGES {n}": pair(lib) for (s, n), lib in libs.items()}
    ref_dx = stem.stem_bwd_dx(x, dy, params)
    for name, (k6, k7) in runs.items():
        acc, dx = k6(), k7()
        torch.cuda.synchronize()
        rel = float((acc - want_acc).abs().max() / want_acc.abs().max())
        same = torch.equal(dx, ref_dx)
        print(f"{name}: acc vs plain {rel:.3e} of the max, acc same bits in a "
              f"second run: {torch.equal(acc, k6())}, dx bits equal to the "
              f"shipped kernel's: {same}")
        if rel > 1e-4 or not same:
            raise AssertionError(f"{name} disagrees")
    del ref_dx, dx, acc

    times = {name: ([], []) for name in runs}
    for _ in range(ROUNDS):
        for name, (k6, k7) in runs.items():
            times[name][0].append(cuda_ms(k6))
            times[name][1].append(cuda_ms(k7))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; shape {SHAPE}; best of {ROUNDS} rounds of {REPS} launches; "
          f"bounds {stats_bytes / PEAK_BYTES_PER_S * 1e3:.4f} / "
          f"{dx_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms")
    for name, (t6, t7) in times.items():
        b6, b7 = min(t6), min(t7)
        print(f"{name}: stem_bwd_stats {b6:.4f} ms ({stats_bytes / b6 / 1e6:.0f} GB/s, "
              f"{stats_bytes / PEAK_BYTES_PER_S * 1e3 / b6:.1%} of the bound), "
              f"stem_bwd_dx {b7:.4f} ms ({dx_bytes / b7 / 1e6:.0f} GB/s, "
              f"{dx_bytes / PEAK_BYTES_PER_S * 1e3 / b7:.1%}); rounds "
              + " ".join(f"{a:.4f}/{b:.4f}" for a, b in zip(t6, t7)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
