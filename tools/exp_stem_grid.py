"""Experiment: launch shape, ring depth and the walk's costs of the stem
backward kernels (K6 stem_bwd_stats, K7 stem_bwd_dx,
`vfa_tpu_torch/csrc/stem_bwd.cu`), fp32 or bf16.

A warp item is one plane, a strip of pool-window rows and a segment of
columns (fp32: STRIP rows, 128 columns; bf16: BF_STATS_STRIP rows for the
stats kernel and BF_DX_STRIP for the dx kernel, 240 columns), and a warp's
ring holds STEM_STAGES (bf16: BF_STAGES) window rows; all are constants of
the source (a bf16 variant sets both strips to its value). This builds copies of the source with other
values of each (one nvcc for each copy, all started together, bound through
`kernels.KernelLibrary`) and times both kernels at the full MultiviewC stem
shape (14, 64, 360, 640) in interleaved rounds (CUDA events, best of the
rounds). It checks that every copy writes the same dx bits as the shipped
kernel (through `ops/stem.py::stem_bwd_dx`), the same acc bits in two runs
and an acc within 1e-4 of the plain version's max, and prints each time
with its achieved GB/s and share of the byte bound (3.35 TB/s).

With --dtype bfloat16 it also times copies of the source that each take
one part of the bf16 walk away, at the shipped constants, to split the
walk's cost: 8-byte copies in place of 16-byte ones, 16-byte copies that
bypass L1 (cp.async.cg in place of .ca), z taken as x (no recompute:
no fused multiply-add or rounding), the stats kernel's sum of dz*x without
the mean, and dz as the plain sum of the candidate windows' gradients (no
payload test). Those copies compute other values and are timed only. Needs one GPU and nvcc.

    python tools/exp_stem_grid.py [--dtype bfloat16]
"""

from __future__ import annotations

import argparse
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
# per dtype: the source's strip constants and ring depth, and the (strip,
# stages) to build
CONSTANTS = {"float32": (("STRIP",), "STEM_STAGES"),
             "bfloat16": (("BF_STATS_STRIP", "BF_DX_STRIP"), "BF_STAGES")}
VARIANTS = {
    "float32": [(s, 4) for s in (2, 3, 4, 5, 6, 8, 12, 32, 90)] + [(5, 2), (5, 6)],
    "bfloat16": [(s, 4) for s in (4, 6, 8, 12, 16, 23, 30, 45, 90)] + [(6, 3), (30, 3),
                                                                       (6, 6), (30, 6)],
}
# bf16 cost splits: name -> [(source text, replacement)], each found once
EXPERIMENTS = {
    "8-byte copies": [
        ("rows_of(x, dy, x, W, 8, 2) ? stem_bwd_stats_bf16_kernel<true>",
         "false ? stem_bwd_stats_bf16_kernel<true>"),
        ("rows_of(x, dy, dx, W, 8, 2) ? stem_bwd_dx_bf16_kernel<true>",
         "false ? stem_bwd_dx_bf16_kernel<true>")],
    "z = x (no recompute)": [
        ("const unsigned z = bf_pack(__fmaf_rn(pl.a, bf_lo(xw[j]), pl.b),\n"
         "                               __fmaf_rn(pl.a, bf_hi(xw[j]), pl.b));",
         "const unsigned z = xw[j];")],
    "16-byte copies past L1 (cp.async.cg)": [
        ("cp_async<16, true>(dst, in0 ? row + c : xs, in0);",
         "cp_async<16>(dst, in0 ? row + c : xs, in0);")],
    "stats: sum dz*x (no x - mean)": [
        ("s_dzx = fmaf(bf_lo(dz[j]), bf_lo(xv[j]) - pl.mean, s_dzx);",
         "s_dzx = fmaf(bf_lo(dz[j]), bf_lo(xv[j]), s_dzx);"),
        ("s_dzx = fmaf(bf_hi(dz[j]), bf_hi(xv[j]) - pl.mean, s_dzx);",
         "s_dzx = fmaf(bf_hi(dz[j]), bf_hi(xv[j]), s_dzx);")],
    "dz = a + g (no payload test)": [
        ('  unsigned m, d;\n  asm("set.eq.bf16x2.bf16x2 %0, %1, %2;" : "=r"(m) : "r"(pp), "r"(wp));\n'
         '  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(m), "r"(g), "r"(a));\n'
         "  return d;",
         "  return a + g;")],
}


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


def variant_library(tag, values, edits=()):
    """A KernelLibrary over a copy of csrc/stem_bwd.cu with the constants
    `values` ({name: value}) and the text edits `edits`."""
    from vfa_tpu_torch.kernels import BUILD, CSRC, KernelLibrary

    with open(os.path.join(CSRC, "stem_bwd.cu"), encoding="utf-8") as fh:
        text = fh.read()
    for name, value in values.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        assert n == 1, name
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    where = os.path.join(BUILD, "exp_stem_grid", re.sub(r"\W+", "_", tag))
    os.makedirs(where, exist_ok=True)
    with open(os.path.join(where, "stem_bwd.cu"), "w", encoding="utf-8") as fh:
        fh.write(text)
    return KernelLibrary(build_dir=where, csrc=where)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(CONSTANTS), default="float32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_stem_grid: no CUDA device")
        return 2
    from vfa_tpu_torch.ops import stem

    dtype = getattr(torch, args.dtype)
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(11)
    M, C, H, W = SHAPE
    OH, OW = (H + 1) // 2, (W + 1) // 2
    x = torch.randn(SHAPE, generator=g).to(dev, dtype)
    scale = (torch.rand(C, generator=g) + 0.5).to(dev, dtype)
    bias = (torch.rand(C, generator=g) - 0.5).to(dev, dtype)
    dy = torch.randn((M, C, OH, OW), generator=g).to(dev, dtype)
    _, mu, rstd = stem.group_norm_stats(x, scale, bias, 16, 1e-5)
    params = stem.plane_params(mu, rstd, scale, bias, mu * 1e-3, rstd * 1e-3)
    want_acc = stem.stem_bwd_stats_plain(x, dy, params)
    e = x.element_size()
    stats_bytes = e * (x.numel() + dy.numel()) + 4 * (params.numel() + M * 4 * C)
    dx_bytes = e * (2 * x.numel() + dy.numel()) + 4 * params.numel()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), dy.data_ptr(), params.data_ptr())
    seg = stem.ITEM[dtype][1]
    # scratch for the most items any strip gives (strip 1)
    partial = torch.empty((M * C, OH * -(-W // seg), 2), device=dev)

    strip_names, stages_name = CONSTANTS[args.dtype]
    builds = {f"strip {s}, stages {n}": (variant_library(
        f"{suffix}_strip{s}_stages{n}", {**dict.fromkeys(strip_names, s),
                                         stages_name: n}), s, True)
        for s, n in VARIANTS[args.dtype]}
    if dtype == torch.bfloat16:
        shipped = stem.ITEM[dtype][0]
        for name, edits in EXPERIMENTS.items():
            builds[f"{name} (timed only)"] = (
                variant_library(f"bf16_{name}", {}, edits), shipped, False)
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: b[0].build(["stem_bwd"]), builds.values()))

    def pair(lib, strip):
        """(K6, K7) launchers of `lib`, built with `strip` window rows an item."""
        lib = lib.load("stem_bwd")
        per_plane = -(-OH // strip) * -(-W // seg)

        def k6():
            acc = torch.empty((M, 4, C), device=dev)
            err = getattr(lib, f"stem_bwd_stats_{suffix}")(
                *ptrs, partial.data_ptr(), acc.data_ptr(), M, C, H, W, per_plane,
                stream())
            assert err == 0, err
            return acc

        def k7():
            dx = torch.empty_like(x)
            err = getattr(lib, f"stem_bwd_dx_{suffix}")(*ptrs, dx.data_ptr(), M, C,
                                                         H, W, stream())
            assert err == 0, err
            return dx
        return k6, k7

    runs = {name: pair(lib, strip) for name, (lib, strip, _) in builds.items()}
    ref_dx = stem.stem_bwd_dx(x, dy, params)
    for name, (k6, k7) in runs.items():
        if not builds[name][2]:
            continue
        acc, dx = k6(), k7()
        torch.cuda.synchronize()
        rel = float((acc - want_acc).abs().max() / want_acc.abs().max())
        same = torch.equal(dx, ref_dx)
        print(f"{name}: acc vs plain {rel:.3e} of the max, acc same bits in a "
              f"second run: {torch.equal(acc, k6())}, dx bits equal to the "
              f"shipped kernel's: {same}")
        if rel > 1e-4 or not same:
            raise AssertionError(f"{name} disagrees")
    del ref_dx

    times = {name: ([], []) for name in runs}
    for _ in range(ROUNDS):
        for name, (k6, k7) in runs.items():
            times[name][0].append(cuda_ms(k6))
            times[name][1].append(cuda_ms(k7))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; shape {SHAPE} {args.dtype}; best of {ROUNDS} rounds of "
          f"{REPS} launches; bounds {stats_bytes / PEAK_BYTES_PER_S * 1e3:.4f} / "
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
