// Window-layout compiled-rig forward for NVIDIA Hopper (sm_90a), fp32.
//
// Replaces vfa_tpu/ops/rig_pallas.py::_kernel_win (the TPU Pallas kernel
// launched by the window branch of _bucket_fwd_call). For each camera n,
// bucket tile t and scene b it computes
//
//     window = ii[n, b, ry : ry + wh, rx : rx + ww, :]   (wh*ww, C)
//     vox    = A[n, t] @ window                          (nl*tile_v, C), fp32
//     out    = sum_l vox[l*tile_v + v, :] @ Kr[l]        (tile_v, n_out), fp32
//
// and writes rows (off_t + t)*tile_v + v of the scale's shared
// (N, B, rows_total, n_out) tiles buffer, so every bucket's launch lands in
// place. (ry, rx) = starts[2*(n*T + t)], [2*(n*T + t) + 1]; every window
// lies inside the image padded to (fh up to 8, fw up to 16) -- the rig
// builder checks that.
//
// What bounds it on the H100 (SXM, 700 W): at the full MultiviewC fp32 rig
// (tile_v 64, 12 buckets, C = n_out = 256) the products are 705 GFLOP per
// scene; on the CUDA cores (fp32, no tensor cores, 67 TFLOP/s) that is
// 10.5 ms per scene. A is 2.89 GB and has to be read once per batch:
// 0.86 ms at 3.35 TB/s. So the work is bound by fp32 operations, not by
// bytes, from batch 1 up.
//
// What the design does about it: both products run as register-tiled
// SGEMMs at the FMA rate. Every CTA is independent (the TPU grid's
// cross-step DMA pipeline, scene packing and VMEM budgets are not carried
// over). The CTA tile (64 x 128 outputs from 16-deep double-buffered
// slices) and both passes live in rig_gemm.cuh, shared with the backward
// and with the flat layout's kernels (rig_flat_fwd.cu).
//   pass 1 (rig_vox_kernel, rig_gemm.cuh): vox = A[n,t] @ window for every
//          (n, t, b); the A operand is A's rows, the B operand the window's
//          pixels, gathered by (ry + k / ww, rx + k % ww).
//   pass 2 (rig_collapse_kernel, rig_gemm.cuh): out = vox2 @ Kr2 with
//          vox2[(t, v), l*C + c] = vox[t][l*tile_v + v][c] and Kr2 = Kr as
//          (nl*C, n_out), one GEMM over all cells of the bucket, so Kr is
//          read once per 64 cells.
// vox goes through a device scratch buffer (N, B, T, nl*tile_v, C): at the
// full rig and batch 2 that is 1.75 GB per scale written and read once,
// about 1 ms at 3.35 TB/s against ~7 ms of fp32 work per scale.
// Tensor cores (3xTF32 or bf16 wgmma), TMA and a persistent schedule are
// later work.

#include "rig_gemm.cuh"

// ii (N, B, Hp, Wp, C) fp32; A (N, T, nl*tile_v, wh*ww) fp32; starts
// (N*T*2) int32; Kr (nl, C, n_out) fp32; vox scratch (N, B, T,
// nl*tile_v, C) fp32; out (N, B, rows_total, n_out) fp32. All contiguous,
// 16-byte aligned. Returns a cudaError_t (0 = both passes launched).
extern "C" int rig_window_fwd_f32(const float* ii, const float* A,
                                  const int* starts, const float* Kr,
                                  float* vox, float* out, int N, int B,
                                  int Hp, int Wp, int C, int T, int nl,
                                  int tile_v, int wh, int ww, int n_out,
                                  int off_t, int rows_total, void* stream) {
  return rig_fwd_launch<true>(ii, A, starts, Kr, vox, out, N, B, Hp * Wp, Wp,
                              C, T, nl, tile_v, wh * ww, ww, n_out, off_t,
                              rows_total, stream);
}
