// Flat-layout compiled-rig backward for NVIDIA Hopper (sm_90a), fp32 in and
// out, on the tensor cores.
//
// Replaces vfa_tpu/ops/rig_pallas.py::_bwd_kernel (the TPU Pallas kernel
// launched by the flat branch of _bucket_bwd_call). For one bucket, with g
// the cotangent of the forward's tiles buffer, it computes
//
//     vox      = A[n, t] @ band(n, b, t)                    (recomputed)
//     dKr[l]  += sum_{n,b,t} vox_l^T @ g[n, b, t]           (C, n_out)
//     dvox_l   = g[n, b, t] @ Kr[l]^T                       (tile_v, C)
//     dII[n, b, start : start + band] += A[n, t]^T @ dvox   (band, C)
//
// with band(n, b, t) = ii[n, b, start : start + band], start =
// starts[n*T + t]. dII (N, B, fh*fw + max_band, C) is the scale's single
// zero-filled accumulator, shared by every bucket's launch; its last
// max_band rows are padding that the caller drops. dKr is accumulated
// across buckets too.
//
// What bounds it on the H100 (SXM, 700 W): operations, twice the flat
// forward's (the A-sized and the collapse-sized product each run twice)
// against one read of A (6.0 GB at the full MultiviewC rig). Kept
// fp32-accurate on the tensor cores they cost three TF32 products each:
// the card's least time is the operations at 495 / 3 = 165 TFLOP/s.
//
// What the design does about it: the passes of the window backward
// (rig_mma.cuh; see rig_window_bwd.cu for each pass and for how wgmma is
// fed: recompute vox, dKr with the depth split over CTAs and reduced in a
// fixed order, dvox over the vox scratch, A^T @ dvox added into dII), on
// bands addressed as start + k. A band is only a multiple of 8 (112 ...
// 1992 pixels on the full rig), so pass 1's last 16-deep slice may be half
// empty: the loader zero-fills whole 16-byte quads past the band; pass 4
// tiles the band by 64 pixels and masks quads past it the same way.
// nl*tile_v = 800 rows are 12.5 tiles of 64 (4 % idle rows).
// The TPU kernel's grid is sequential, which makes its read-modify-write of
// overlapping bands safe. Here CTAs of different tiles run concurrently,
// so pass 4 adds with fp32 atomics (16 bytes at a time). Flat bands of
// neighbouring tiles overlap far more than windows do (each spans whole
// image rows), so more atomics land on one address and the sums' order
// varies more from run to run: dII agrees to fp32 rounding, not bit for
// bit. The contention is measured, not designed around.

#include "rig_mma.cuh"

// ii, dII (N, B, pixels, C) fp32 with pixels = fh*fw + max_band; A
// (N, T, nl*tile_v, band) fp32; starts (N*T) int32; KrT (nl, n_out, C)
// fp32; g (N, B, rows_total, n_out) fp32; vox scratch (N, B, T,
// nl*tile_v, C) fp32; ws workspace (16, nl, C, n_out) fp32; dKr
// (nl, C, n_out) fp32. dII and dKr are added to. All contiguous, 16-byte
// aligned. Returns a cudaError_t (0 = all passes launched).
extern "C" int rig_flat_bwd_f32(const float* ii, const float* A,
                                const int* starts, const float* KrT,
                                const float* g, float* vox, float* ws,
                                float* dII, float* dKr, int N, int B,
                                int pixels, int C, int T, int nl, int tile_v,
                                int band, int n_out, int off_t, int rows_total,
                                void* stream) {
  return rig_bwd_launch<false>(ii, A, starts, KrT, g, vox, ws, dII, dKr, N, B,
                               pixels, 0, C, T, nl, tile_v, band, 0, n_out,
                               off_t, rows_total, stream);
}
