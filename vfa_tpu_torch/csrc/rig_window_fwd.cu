// Window-layout compiled-rig forward for NVIDIA Hopper (sm_90a), fp32 in
// and out, on the tensor cores.
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
// What bounds it on the H100 (SXM, 700 W): operations. At the full
// MultiviewC fp32 rig (tile_v 64, 12 buckets, C = n_out = 256) the products
// are 705 GFLOP per scene against one read of A per batch (2.89 GB: 0.86 ms
// at 3.35 TB/s). Kept fp32-accurate on the tensor cores, a product costs
// three TF32 products (3xTF32), so the card's least time is the operations
// at 495 / 3 = 165 TFLOP/s: 4.3 ms per scene.
//
// What the design does about it: both products run on the wgmma TF32 tile
// of rig_mma.cuh with the 3xTF32 split, the tile all four rig kernels share
// (see there for how wgmma is fed). Every CTA is independent (the TPU grid's
// cross-step DMA pipeline, scene packing and VMEM budgets are not carried
// over).
//   pass 1 (rig_vox_mma, also the backward's first pass): vox = A[n,t] @
//          window for every (n, t, b). Register operand: the window's pixels,
//          gathered by (ry + k / ww, rx + k % ww); shared-memory operand:
//          64 rows of A. The scene is the grid's innermost index, so the B
//          CTAs that read one A tile run together and share it through L2.
//   pass 2 (rig_collapse_mma): out = vox2 @ Kr2 with vox2[(t, v), l*C + c]
//          = vox[t][l*tile_v + v][c] and Kr2 = Kr as (nl*C, n_out), one
//          product over all cells of the bucket, depth nl*C = 1280 in one
//          chain of accumulators. Register operand: Kr's rows; shared-memory
//          operand: 64 cells of vox.
// vox goes through a device scratch buffer (N, B, T, nl*tile_v, C): at the
// full rig and batch 2 that is 1.75 GB per scale written and read once,
// about 1 ms at 3.35 TB/s.

#include "rig_mma.cuh"
#include "rig_ws.cuh"

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

// The bf16 variant (K1-bf16), one call per scale over all its buckets: ii
// (N, B, Hp, Wp, C), Kr, the vox scratch and out bf16; per bucket bk (nb of
// them, host arrays) A[bk] (N, T[bk], nl*tile_v, wh*ww[bk]) bf16 with K[bk]
// = wh*ww, starts[bk] (N*T[bk]*2) int32 and its tiles' offset off_t[bk].
// The buckets' vox scratches lie one after another in `vox`, (N, B, T[bk],
// nl*tile_v, C) each. vox = A @ window summed in fp32 and rounded to bf16,
// then the collapse summed in fp32 and rounded to bf16, as _kernel_win
// rounds on bf16 inputs. Two launches:
//   pass 1 (rig_wsvox<EPI_BF16>, rig_ws.cuh): every bucket's vox on the
//          warp-specialised TMA + wgmma m64n256k16 tile, persistent CTAs;
//   pass 2 (rig_wscollapse, rig_ws.cuh): every bucket's collapse on the
//          same tile, 64 cells a consumer warpgroup sharing Kr's rows.
// What bounds it on the H100 (SXM, 700 W): operations at the dense bf16
// rate. The full MultiviewC bf16 rig (tile_v 160, A 1.98 GB) makes a
// batch-2 forward 1.69 TFLOP, 1.71 ms at 989.4 TFLOP/s, against 2.65 GB of
// A, features, Kr and tiles (0.79 ms at 3.35 TB/s).
extern "C" int rig_window_fwd_bf16(const void* ii, const void* const* A,
                                   const int* const* starts, const int* T,
                                   const int* K, const int* ww,
                                   const int* off_t, int nb, const void* Kr,
                                   void* vox, void* out, int N, int B, int Hp,
                                   int Wp, int C, int nl, int tile_v,
                                   int n_out, int rows_total, void* stream) {
  using wsb::bf16;
  if (C != wsb::CH || n_out != wsb::CH) return (int)cudaErrorInvalidValue;
  return wsb::ws_fwd_launch(
      static_cast<const bf16*>(ii), reinterpret_cast<const bf16* const*>(A),
      starts, T, K, ww, off_t, nb, static_cast<const bf16*>(Kr),
      static_cast<bf16*>(vox), static_cast<bf16*>(out), N, B, Hp, Wp, nl,
      tile_v, rows_total, static_cast<cudaStream_t>(stream));
}
