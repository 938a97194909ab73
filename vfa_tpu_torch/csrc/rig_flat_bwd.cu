// Flat-layout compiled-rig backward for NVIDIA Hopper (sm_90a), fp32 in and
// out, on the tensor cores; its bf16 variant is at the end of the file.
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
// bit. The contention is measured, not designed around. (The bf16 variant
// adds in a fixed order instead, see there.)

#include "rig_mma.cuh"
#include "rig_ws.cuh"

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

// The bf16 variant (K5-bf16): ii, A, KrT, g and dII bf16, the same shapes;
// the vox scratch the same bytes (two bf16 planes), ws and dKr fp32. JAX's
// rounding points on bf16 inputs (_bwd_kernel, rig_pallas.py:477-502): vox,
// dvox and dKr fp32, each band's fp32 sum added to the bf16 dII and rounded
// once. JAX's grid is sequential, (camera, tile, scene) with the scene
// fastest, and a scale's buckets run in order: a pixel's adds come bucket
// by bucket, tile by tile. The passes of rig_window_bwd_bf16
// (rig_window_bwd.cu) on the warp-specialised tile of rig_ws.cuh, a band a
// window of one row over an image of one row (Hp 1, Wp = pixels), never
// serial:
//   pass 1 (rig_wsvox<EPI_SPLIT>): vox as hi + lo planes;
//   pass 2 (rig_wsdkr + rig_dkr_reduce): dKr in a fixed order;
//   pass 3 (rig_wsdvox): dvox as hi + lo planes;
//   pass 4 (rig_wsdband + rig_dii_reduce): each (camera, scene, tile)
//          band's fp32 A^T dvox into `scratch` (N*B, T, 1, band, 256), then
//          each (pixel, scene) of dII read once, its adds (pixels, ptr,
//          adds: ops/rig.flat_dii_index) made in tile order, each rounded
//          once to bf16, and written once: JAX's order and the same bits
//          every run, no atomics. Positions past the band are neither
//          written nor read; dII's last max_band rows are padding that the
//          caller drops, and no band reaches past them.
// A band is a multiple of 8: one that is 8 (mod 16) takes pass 1's last
// 16-pixel box whole against A's zeros past the band, and pass 4's last
// 128-position block stores only positions inside the band.
// What bounds it on the H100 (SXM, 700 W): operations at the dense bf16
// rate, twice the forward's (4.42 TFLOP at batch 2 on the full MultiviewC
// flat rig, 4.47 ms at 989.4 TFLOP/s); the scratch round trip of the reduce
// (a pixel is covered 13-23 times on average) is bytes.
extern "C" int rig_flat_bwd_bf16(const void* ii, const void* A,
                                 const int* starts, const void* KrT,
                                 const void* g, void* vox, float* ws, void* dII,
                                 float* dKr, float* scratch,
                                 const int* pixels_idx, const int* ptr,
                                 const int* adds, int n_pixels, int N, int B,
                                 int pixels, int C, int T, int nl, int tile_v,
                                 int band, int n_out, int off_t,
                                 int rows_total, void* stream) {
  using wsb::bf16;
  if (C != wsb::CH || n_out != wsb::CH || band < 8 || band % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return wsb::ws_bwd_launch(
      static_cast<const bf16*>(ii), static_cast<const bf16*>(A), starts,
      static_cast<const bf16*>(KrT), static_cast<const bf16*>(g),
      static_cast<bf16*>(vox), ws, static_cast<bf16*>(dII), dKr, scratch,
      pixels_idx, ptr, adds, n_pixels, 0, N, B, 1, pixels, T, nl, tile_v,
      band, 0, off_t, rows_total, static_cast<cudaStream_t>(stream));
}
