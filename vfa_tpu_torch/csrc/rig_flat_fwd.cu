// Flat-layout compiled-rig forward for NVIDIA Hopper (sm_90a), fp32 in and
// out, on the tensor cores.
//
// Replaces vfa_tpu/ops/rig_pallas.py::_kernel (the TPU Pallas kernel
// launched by the flat branch of _bucket_fwd_call). For each camera n,
// bucket tile t and scene b it computes
//
//     band = ii[n, b, start : start + band, :]          (band, C)
//     vox  = A[n, t] @ band                             (nl*tile_v, C), fp32
//     out  = sum_l vox[l*tile_v + v, :] @ Kr[l]         (tile_v, n_out), fp32
//
// and writes rows (off_t + t)*tile_v + v of the scale's shared
// (N, B, rows_total, n_out) tiles buffer. ii is the features flattened to
// (fh*fw, C) per (n, b) (raw, or 2D-cumsum'd for a 16-tap rig) and padded
// by max_band zero rows, so a band never leaves the buffer; start =
// starts[n*T + t]. start and band are multiples of 8.
//
// What bounds it on the H100 (SXM, 700 W): operations, as for the window
// forward, only more of them: a flat band spans whole image rows, so A is
// several times the window rig's and mostly zeros (6.0 GB at the full
// MultiviewC rig), and the A product grows with it while the collapse stays
// the same: 1.1 TFLOP per scene. A is read once per batch (1.8 ms at 3.35
// TB/s); the fp32-accurate products at 495 / 3 = 165 TFLOP/s (3xTF32) take
// 6.7 ms per scene.
//
// What the design does about it: the window forward's two passes on the
// wgmma tile of rig_mma.cuh (see rig_window_fwd.cu), with the band's pixel
// k at row start + k instead of a 2D window gather. A band is only a
// multiple of 8 (112 ... 1992 pixels on the full rig), so pass 1's last
// 16-deep slice may be half empty: both operands' loaders zero-fill whole
// 16-byte quads past the band (A's row would otherwise be read 8 floats past
// its end, on the last row of the last tile past the buffer). nl*tile_v =
// 800 is no multiple of the 64-row CTA tile: rows past it are zeros in A's
// loader and are not stored. The TPU kernel's double-buffered band DMA
// across the scene axis is not carried over; the scene is the innermost
// grid index instead, so the B CTAs that read one A tile share it in L2.

#include "rig_bf16.cuh"
#include "rig_mma.cuh"

// ii (N, B, pixels, C) fp32 with pixels = fh*fw + max_band; A
// (N, T, nl*tile_v, band) fp32; starts (N*T) int32; Kr (nl, C, n_out) fp32;
// vox scratch (N, B, T, nl*tile_v, C) fp32; out (N, B, rows_total, n_out)
// fp32. All contiguous, 16-byte aligned. Returns a cudaError_t (0 = both
// passes launched).
extern "C" int rig_flat_fwd_f32(const float* ii, const float* A,
                                const int* starts, const float* Kr, float* vox,
                                float* out, int N, int B, int pixels, int C,
                                int T, int nl, int tile_v, int band, int n_out,
                                int off_t, int rows_total, void* stream) {
  return rig_fwd_launch<false>(ii, A, starts, Kr, vox, out, N, B, pixels, 0, C,
                               T, nl, tile_v, band, 0, n_out, off_t,
                               rows_total, stream);
}

// The bf16 variant: ii, A, Kr, the vox scratch and out all bf16, the same
// shapes; the rounding points of _kernel on bf16 inputs (see
// rig_window_fwd_bf16), both passes on the wgmma bf16 tile of rig_bf16.cuh.
// A band is a multiple of 8 values, one 16-byte quad, so pass 1's last slice
// is zero-filled past the band in whole quads; nl*tile_v = 800 rows are no
// multiple of the 64-row CTA tile: rows past it are zeros in A's loader and
// are not stored.
extern "C" int rig_flat_fwd_bf16(const void* ii, const void* A,
                                 const int* starts, const void* Kr, void* vox,
                                 void* out, int N, int B, int pixels, int C,
                                 int T, int nl, int tile_v, int band,
                                 int n_out, int off_t, int rows_total,
                                 void* stream) {
  using bft::bf16;
  return bft::rig_fwd_launch(
      static_cast<const bf16*>(ii), static_cast<const bf16*>(A), starts,
      static_cast<const bf16*>(Kr), static_cast<bf16*>(vox),
      static_cast<bf16*>(out), N, B, pixels, C, T, nl, tile_v, band, n_out,
      off_t, rows_total, stream);
}
