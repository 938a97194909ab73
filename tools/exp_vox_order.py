"""Experiment: grid order of the rig forward's first pass (the A product).

`rig_vox_mma` (`vfa_tpu_torch/csrc/rig_mma.cuh`) puts the scene innermost
in its grid: the B CTAs that read one 64-row tile of A are neighbours in
launch order and can share it through L2. This times that order against
the scene-outermost one (grid (ceil(R/64), T, N*B), the order the pass had
before), both through the same tile code (`vox_tile`), on every bucket of
the full MultiviewC fp32 window serving rig (12 buckets) and flat rig (8
buckets) at batch 2, in turns (outer, inner, inner, outer), and checks that
the two orders write the same vox bit for bit. Needs one GPU and nvcc.

    python tools/exp_vox_order.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCH = 2
REPS = 3

SOURCE = r"""
#include "rig_mma.cuh"

template <bool WINDOW>
__global__ void __launch_bounds__(THREADS)
vox_scene_outer(const float* __restrict__ ii, const float* __restrict__ A,
                const int* __restrict__ starts, float* __restrict__ vox, int B,
                int pixels, int Wp, int T, int R, int K, int ww) {
  vox_tile<WINDOW>(ii, A, starts, vox, B, pixels, Wp, T, R, K, ww,
                   blockIdx.z / B, blockIdx.z % B, blockIdx.y, blockIdx.x * BM);
}

template <bool WINDOW>
int run(int inner, const float* ii, const float* A, const int* starts,
        float* vox, int N, int B, int pixels, int Wp, int T, int R, int K,
        int ww, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inner)
    return (int)launch_tile(rig_vox_mma<WINDOW>, vox_grid(R, T, N, B), s, ii,
                            A, starts, vox, B, pixels, Wp, T, R, K, ww);
  return (int)launch_tile(vox_scene_outer<WINDOW>,
                          dim3((R + BM - 1) / BM, T, N * B), s, ii, A, starts,
                          vox, B, pixels, Wp, T, R, K, ww);
}

extern "C" int vox_pass_f32(int inner, int window, const float* ii,
                            const float* A, const int* starts, float* vox,
                            int N, int B, int pixels, int Wp, int T, int R,
                            int K, int ww, void* stream) {
  return window ? run<true>(inner, ii, A, starts, vox, N, B, pixels, Wp, T, R,
                            K, ww, stream)
                : run<false>(inner, ii, A, starts, vox, N, B, pixels, Wp, T,
                             R, K, ww, stream);
}
"""


def build():
    from vfa_tpu_torch.kernels import BUILD, CSRC, NVCC_FLAGS, KernelLibrary

    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "exp_vox_order.cu")
    so = os.path.join(BUILD, "libexp_vox_order.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([KernelLibrary.nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", so, src],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(so).vox_pass_f32
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, I, P, P, P, P] + [I] * 8 + [P]
    fn.restype = ctypes.c_int
    return fn


def bucket_launches(fn, rig, device):
    """(launch(inner, vox_list), vox buffers of order outer, of order inner)
    of pass 1 over every bucket of every scale at BATCH."""
    from chip_smoke import scale_inputs
    from vfa_tpu_torch.ops.rig import scale_features

    calls = []
    for si, sr in enumerate(rig.scales):
        lat, _ = scale_inputs(sr, BATCH, 7 + si, device)
        ii = scale_features(lat, sr)
        N, B = ii.shape[:2]
        window = bool(sr.window_hw)
        pixels = ii[0, 0].numel() // ii.shape[-1]
        Wp = ii.shape[3] if window else 0
        for bi, (A_b, s_b) in enumerate(zip(sr.A, sr.starts)):
            T, R, K = A_b.shape[1:]
            ww = sr.window_hw[bi][1] if window else 0
            calls.append((ii, A_b, s_b, N, B, pixels, Wp, T, R, K, ww, window))
    bufs = [[torch.empty((c[3], c[4], c[7], c[8], 256), device=device)
             for c in calls] for _ in range(2)]

    def launch(inner):
        stream = torch.cuda.current_stream(device).cuda_stream
        for (ii, A_b, s_b, N, B, pixels, Wp, T, R, K, ww, window), vox in zip(
                calls, bufs[inner]):
            err = fn(inner, int(window), ii.data_ptr(), A_b.data_ptr(),
                     s_b.data_ptr(), vox.data_ptr(), N, B, pixels, Wp, T, R, K,
                     ww, stream)
            if err:
                raise RuntimeError(f"vox_pass_f32 failed with cudaError_t {err}")
    return launch, bufs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from chip_smoke import cuda_time_ms, full_rig

    device = torch.device("cuda")
    fn = build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card.splitlines()[0]}")
    for layout, training in (("window", False), ("flat", True)):
        rig = full_rig(device, training=training, layout=layout)
        launch, bufs = bucket_launches(fn, rig, device)
        times = {0: [], 1: []}
        for inner in (0, 1, 1, 0):
            times[inner].append(cuda_time_ms(lambda: launch(inner), reps=REPS))
        same = all(torch.equal(a, b) for a, b in zip(*bufs))
        print(f"{layout} rig, pass 1 over every bucket of the 3 scales at "
              f"B={BATCH}: scene outermost "
              + " / ".join(f"{t:.3f}" for t in times[0]) + " ms, scene innermost "
              + " / ".join(f"{t:.3f}" for t in times[1])
              + f" ms; vox bit-equal: {same}")
        if not same:
            raise AssertionError("the two grid orders wrote different vox")
        del rig, launch, bufs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
