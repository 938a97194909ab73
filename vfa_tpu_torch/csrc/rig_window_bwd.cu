// Window-layout compiled-rig backward for NVIDIA Hopper (sm_90a), fp32 in
// and out, on the tensor cores.
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
// What bounds it on the H100 (SXM, 700 W): operations. The A-sized product
// and the collapse-sized product each run twice, twice the forward's work
// (2 x 705 GFLOP per scene at the full MultiviewC rig) against one read of
// A (3.1 GB). The CUDA cores give 67 TFLOP/s of fp32 at most; the tensor
// cores give 495 TFLOP/s of TF32, and a product that stays fp32-accurate
// costs three TF32 products, so the card's least time is the operations at
// 165 TFLOP/s.
//
// What the design does about it (rig_mma.cuh, shared with the flat
// layout's backward): every pass is a product on one CTA tile built on
// wgmma.mma_async m64n64k8 (TF32) with the 3xTF32 split, fed by a 4-stage
// cp.async ring in dynamic shared memory; every CTA is independent. The TPU kernels' two-slot DMA pipeline, scene packing, VMEM
// budgets and the split into a pipelined and a serial kernel do not come
// across. For TF32 wgmma reads a shared-memory operand only
// depth-contiguous, which no pass offers for its 256-channel operand. All
// four therefore compute the product transposed: the channels are the M of
// wgmma and come from registers, where each thread builds and splits its
// fragment from the slice as it lies; the pass's 64 rows are the N and come
// from shared memory, rewritten once per slice, split and depth-contiguous.
//   pass 1 (rig_vox_mma): vox into a device scratch (N, B, T, nl*tile_v,
//          C). Register operand: the window's pixels (channel-contiguous
//          rows, addressed per pixel from the tile's window origin);
//          shared-memory operand: 64 rows of A, already depth-contiguous.
//   pass 2 (rig_dkr_mma, rig_dkr_reduce): dKr as one (nl*C) x n_out product
//          whose depth runs over every cell (n, b, t, v) of the bucket.
//          Register operand: g; shared-memory operand: 64 channels of vox,
//          which arrive depth-strided and are transposed by the rewrite.
//          The depth is split into as many chunks of whole tiles as fill
//          the card (13 at nl 5); each CTA leaves its partial tile in a
//          workspace and a second stage adds the chunks into dKr in a fixed
//          order, so dKr has the same bits every run (two passes over at
//          most 16 x 1.3 MB, less than the atomics' traffic). Inside a
//          chunk a chain in the tensor cores' accumulators ends after 1024
//          depths: they do not round to nearest, and the error grows with
//          the chain.
//   pass 3 (rig_dvox_mma): dvox = g @ KrT over all cells, written over the
//          vox scratch (pass 2 has finished: same stream). Register
//          operand: KrT, Kr with its last two axes swapped, (nl, n_out, C),
//          prepared by the wrapper; shared-memory operand: 64 rows of g.
//   pass 4 (rig_dii_mma): A[n, t]^T @ dvox per (n, t, b), added into dII at
//          the window's pixels. Register operand: dvox; shared-memory
//          operand: 64 pixels of A, read along A's strided axis and
//          transposed by the rewrite.
// The tile is 64 rows high: nl*tile_v = 320 is 5 of them.
// The TPU grid is sequential, which is what makes its read-modify-write of
// overlapping windows safe. Here CTAs of different tiles run concurrently
// and their windows overlap, so pass 4 adds with fp32 atomics (the 16-byte
// vector form of sm_90 from CUDA 12.1 on). The order of those sums
// is therefore not fixed from run to run: dII agrees to fp32 rounding, not
// bit for bit.

#include "rig_mma.cuh"

// ii, dII (N, B, Hp, Wp, C) fp32; A (N, T, nl*tile_v, wh*ww) fp32; starts
// (N*T*2) int32; KrT (nl, n_out, C) fp32; g (N, B, rows_total, n_out) fp32;
// vox scratch (N, B, T, nl*tile_v, C) fp32; ws workspace (16, nl, C, n_out)
// fp32; dKr (nl, C, n_out) fp32. dII and dKr are added to. All contiguous,
// 16-byte aligned. Returns a cudaError_t (0 = all passes launched).
extern "C" int rig_window_bwd_f32(const float* ii, const float* A,
                                  const int* starts, const float* KrT,
                                  const float* g, float* vox, float* ws,
                                  float* dII, float* dKr, int N, int B, int Hp,
                                  int Wp, int C, int T, int nl, int tile_v,
                                  int wh, int ww, int n_out, int off_t,
                                  int rows_total, void* stream) {
  return rig_bwd_launch<true>(ii, A, starts, KrT, g, vox, ws, dII, dKr, N, B,
                              Hp * Wp, Wp, C, T, nl, tile_v, wh * ww, ww,
                              n_out, off_t, rows_total, stream);
}
