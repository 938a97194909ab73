// Flat-layout compiled-rig forward for NVIDIA Hopper (sm_90a), fp32.
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
// What bounds it on the H100 (SXM, 700 W): fp32 operations on the CUDA
// cores, as the window kernel, only more of them: a flat band spans whole
// image rows, so A is several times the window rig's and mostly zeros,
// and the A product grows with it while the collapse stays the same. A is
// read once per batch; at 3.35 TB/s that stays an order of magnitude below
// the time of the products at 67 TFLOP/s.
//
// What the design does about it: the same two register-tiled SGEMM passes
// as the window forward (rig_gemm.cuh), with the band's pixel k at row
// start + k instead of a 2D window gather. The CTA tile works on 16-deep
// slices and a band is only a multiple of 8: on the last slice both
// operands' loaders return zeros past the band (A's row would otherwise be
// read 8 floats past its end, on the last row of the last tile past the
// buffer). nl*tile_v = 800 is no multiple of the 64-row CTA tile: rows
// past it are zeros in A's loader and are not stored. The TPU kernel's
// double-buffered band DMA across the scene axis is not carried over.

#include "rig_gemm.cuh"

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
