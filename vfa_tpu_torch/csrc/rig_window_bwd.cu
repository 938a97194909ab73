// Window-layout compiled-rig backward for NVIDIA Hopper (sm_90a), fp32.
//
// Replaces vfa_tpu/ops/rig_pallas.py::_bwd_kernel_win_pipe and
// ::_bwd_kernel_win (the TPU Pallas kernels launched by the window branch
// of _bucket_bwd_call: the pipelined one for >= 2 scene groups, the serial
// one otherwise). One kernel sequence serves every batch size. For one
// bucket, with g the cotangent of the forward's tiles buffer, it computes
//
//     vox      = A[n, t] @ window(n, b, t)                  (recomputed)
//     dKr[l]  += sum_{n,b,t} vox_l^T @ g[n, b, t]           (C, n_out)
//     dvox_l   = g[n, b, t] @ Kr[l]^T                       (tile_v, C)
//     dII[n, b, window(n, t)] += A[n, t]^T @ dvox           (wh*ww, C)
//
// where vox_l / dvox_l are rows l*tile_v .. (l+1)*tile_v of the
// (nl*tile_v, C) block and g[n, b, t] rows (off_t + t)*tile_v .. of the
// scale's (N, B, rows_total, n_out) cotangent. dII is the scale's single
// zero-filled image-sized accumulator, shared by every bucket's launch;
// dKr is accumulated across buckets too.
//
// What bounds it on the H100 (SXM, 700 W): the A-sized product and the
// collapse-sized product each run twice, so the backward is twice the
// forward's fp32 work (2 x 705 GFLOP per scene at the full MultiviewC rig)
// against one read of A (2.9 GB): bound by fp32 operations on the CUDA
// cores, as the forward is.
//
// What the design does about it: four register-tiled SGEMM passes over the
// CTA tile of rig_gemm.cuh, every CTA independent; the passes live in
// rig_bwd.cuh, shared with the flat layout's backward (rig_flat_bwd.cu). The TPU kernels'
// two-slot DMA pipeline, scene packing, VMEM budgets and the split into a
// pipelined and a serial kernel do not come across.
//   pass 1 (rig_vox_kernel, shared with the forward): vox into a device
//          scratch (N, B, T, nl*tile_v, C).
//   pass 2 (rig_dkr_kernel): dKr as one (nl*C) x n_out product whose depth
//          runs over every cell (n, b, t, v) of the bucket. The depth is
//          split over CTAs; each adds its partial tile with fp32 atomics.
//   pass 3 (rig_dvox_kernel): dvox = g @ KrT over all cells, written over
//          the vox scratch (pass 2 has finished: same stream). KrT is Kr
//          with its last two axes swapped, (nl, n_out, C), prepared by the
//          wrapper so the B operand is read along contiguous rows.
//   pass 4 (rig_dii_kernel): A[n, t]^T @ dvox per (n, t, b), added into
//          dII at the window's pixels.
// The TPU grid is sequential, which is what makes its read-modify-write of
// overlapping windows safe. Here CTAs of different tiles run concurrently
// and their windows overlap, so pass 4 adds with fp32 atomics (the 16-byte
// vector form of sm_90 where the toolkit has it). The order of those sums,
// and of pass 2's, is therefore not fixed from run to run: results agree
// to fp32 rounding, not bit for bit.

#include "rig_bwd.cuh"

// ii, dII (N, B, Hp, Wp, C) fp32; A (N, T, nl*tile_v, wh*ww) fp32; starts
// (N*T*2) int32; KrT (nl, n_out, C) fp32; g (N, B, rows_total, n_out) fp32;
// vox scratch (N, B, T, nl*tile_v, C) fp32; dKr (nl, C, n_out) fp32. dII
// and dKr are added to. All contiguous, 16-byte aligned. Returns a
// cudaError_t (0 = all four passes launched).
extern "C" int rig_window_bwd_f32(const float* ii, const float* A,
                                  const int* starts, const float* KrT,
                                  const float* g, float* vox, float* dII,
                                  float* dKr, int N, int B, int Hp, int Wp,
                                  int C, int T, int nl, int tile_v, int wh,
                                  int ww, int n_out, int off_t,
                                  int rows_total, void* stream) {
  return rig_bwd_launch<true>(ii, A, starts, KrT, g, vox, dII, dKr, N, B,
                              Hp * Wp, Wp, C, T, nl, tile_v, wh * ww, ww,
                              n_out, off_t, rows_total, stream);
}
