// Flat-layout compiled-rig forward for NVIDIA Hopper (sm_90a), fp32 in and
// out, on the tensor cores; its bf16 variant (K4-bf16) is at the end of the
// file.
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

#include "rig_mma.cuh"
#include "rig_ws.cuh"

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

// The bf16 variant (K4-bf16), one call per scale over all its buckets, as
// rig_window_fwd_bf16 (rig_window_fwd.cu): ii (N, B, pixels, C), Kr, the
// vox scratch and out bf16; per bucket bk (nb of them, host arrays) A[bk]
// (N, T[bk], nl*tile_v, K[bk]) bf16 with K[bk] the band (a multiple of 8),
// starts[bk] (N*T[bk]) int32 and its tiles' offset off_t[bk]; the buckets'
// vox scratches one after another in `vox`, (N, B, T[bk], nl*tile_v, C)
// each. JAX's rounding points on bf16 inputs (vox summed in fp32 and
// rounded to bf16, then the collapse summed in fp32 and rounded to bf16).
// Two launches, on the warp-specialised TMA + wgmma m64n256k16 tile of
// rig_ws.cuh, a flat band taken as a window of one row over an image of
// one row (Hp 1, Wp = pixels):
//   pass 1 (rig_wsvox<EPI_BF16>): every bucket's vox, persistent CTAs; a
//          band's 64-depth stage is four 16-pixel TMA boxes from start + k,
//          a band that is 8 (mod 16) takes its last box whole against A's
//          zeros past the band;
//   pass 2 (rig_wscollapse): every bucket's collapse.
// What bounds it on the H100 (SXM, 700 W): operations at the dense bf16
// rate. The full MultiviewC flat rig cast to bf16 (tile_v 160, A 3.0 GB)
// makes a batch-2 forward 2.21 TFLOP, 2.23 ms at 989.4 TFLOP/s; A is read
// once (0.9 ms at 3.35 TB/s). The one-launch vox scratch is N*B*sum(T)*R*C
// bf16, 0.44 GB a scene at scale 0.
extern "C" int rig_flat_fwd_bf16(const void* ii, const void* const* A,
                                 const int* const* starts, const int* T,
                                 const int* K, const int* off_t, int nb,
                                 const void* Kr, void* vox, void* out, int N,
                                 int B, int pixels, int C, int nl, int tile_v,
                                 int n_out, int rows_total, void* stream) {
  using wsb::bf16;
  if (C != wsb::CH || n_out != wsb::CH) return (int)cudaErrorInvalidValue;
  return wsb::ws_fwd_launch(
      static_cast<const bf16*>(ii), reinterpret_cast<const bf16* const*>(A),
      starts, T, K, nullptr, off_t, nb, static_cast<const bf16*>(Kr),
      static_cast<bf16*>(vox), static_cast<bf16*>(out), N, B, 1, pixels, nl,
      tile_v, rows_total, static_cast<cudaStream_t>(stream));
}
