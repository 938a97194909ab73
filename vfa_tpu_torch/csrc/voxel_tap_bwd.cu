// Backward of the voxel route's four integral-image corner reads for
// NVIDIA Hopper (sm_90a): the cotangent of the integral image ii (B, C, H,
// W), fp32 or bf16, from the cotangents of the corner reads lt, rb, rt, lb,
// added in the order and with the roundings of XLA.
//
// Replaces vfa_tpu/ops/voxel.py::sample_voxels' scatter-adds, which are no
// Pallas kernel: the JAX package reads the integral image through
// vfa_tpu/geometry.py::grid_sample_bilinear, whose four `jnp.take` per
// corner (:117) XLA transposes to scatter-adds. Through torch.gather's
// backward the port added those updates with atomics, in no fixed order,
// so its gradient changed from run to run and, on bf16, was noise against
// JAX's (the reverse scan of the integral image amplifies every rounding).
// This kernel adds them as XLA does (vfa_tpu_torch/ops/voxel.py, the notes
// above CHAIN_LENGTH; `corner_taps_bwd` is its plain version):
//
//   for each (scene b, pixel q), over the 16 chain positions j (the taps of
//   lb, rt, rb, lt, each corner's (x1, y1), (x0, y1), (x1, y0), (x0, y0)):
//     s_j = 0; for each update of position j at q, in point order:
//       s_j = rnd(s_j + rnd(g[row] * w))        (rnd: to ii's dtype)
//     r = s_0, then r = rnd(r + s_j) for j = 1 .. 15
//   out[b, c, q] = r
//
// with the updates of every (j, b, q) listed, in point order, by the order
// index that the wrapper builds with one stable sort (ops/voxel.py::
// tap_order): ptr (16 B H W + 1), rows and w (one entry an update; a row of
// g (4 B P, C) fp32 and the tap's weight times its in-image mask).
//
// What bounds it on the H100 (SXM, 700 W): bytes. Two operations an
// update and channel against 4 B P C fp32 cotangents read: at full
// MultiviewC, one camera at one scale, 4 x 121,680 points x 256 channels,
// 0.50 GB (0.15 ms at 3.35 TB/s). Each point's cotangent feeds its four
// taps, i.e. four pixels that different warps walk at different times, so
// the kernel reads it up to four times where L2 does not keep it.
//
// What the design does about it: output-stationary, no atomics. A warp
// owns one (scene, pixel), the lanes across channels (8 channels a lane,
// 256 a pass; more channels take more passes), and walks that pixel's
// updates in XLA's order: every load of a cotangent row is 32 lanes on
// consecutive addresses, every add is the lane's own, and each pixel is
// written once. Every product and add is an explicit round-to-nearest
// intrinsic, so that nvcc contracts none of them into a fused multiply-add
// (XLA's op-by-op CPU code has none). The same bits come out of every run,
// and equal the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAIN = 16;     // chain positions: 4 corners x 4 taps
constexpr int WARPS = 8;      // (scene, pixel) items a block
constexpr int LANE_CH = 8;    // channels a lane per pass
constexpr int PASS_CH = 32 * LANE_CH;

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <bool BF16, typename T>
__global__ void __launch_bounds__(32 * WARPS)
voxel_tap_bwd_kernel(const float* __restrict__ g, const int* __restrict__ ptr,
                     const int* __restrict__ rows, const float* __restrict__ w,
                     T* __restrict__ out, int B, int HW, int C) {
  const int lane = threadIdx.x & 31;
  const long long items = (long long)B * HW;
  const long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= items) return;
  const long long b = item / HW, q = item % HW;
  for (int c0 = 0; c0 < C; c0 += PASS_CH) {
    float res[LANE_CH];
    for (int j = 0; j < CHAIN; ++j) {
      // entries of (j, b, q): k = (j * B + b) * HW + q
      const long long k = j * items + item;
      const int e1 = ptr[k + 1];
      float acc[LANE_CH];
#pragma unroll
      for (int i = 0; i < LANE_CH; ++i) acc[i] = 0.f;
      for (int e = ptr[k]; e < e1; ++e) {
        const float* row = g + (size_t)rows[e] * C + c0 + lane;
        const float we = w[e];
#pragma unroll
        for (int i = 0; i < LANE_CH; ++i) {
          if (c0 + lane + 32 * i < C) {
            acc[i] = rnd<BF16>(__fadd_rn(acc[i], rnd<BF16>(__fmul_rn(row[32 * i], we))));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < LANE_CH; ++i) {
        res[i] = j == 0 ? acc[i] : rnd<BF16>(__fadd_rn(res[i], acc[i]));
      }
    }
#pragma unroll
    for (int i = 0; i < LANE_CH; ++i) {
      const int c = c0 + lane + 32 * i;
      if (c < C) store(out + ((size_t)b * C + c) * HW + q, res[i]);
    }
  }
}

template <bool BF16, typename T>
int launch(const float* g, const int* ptr, const int* rows, const float* w,
           T* out, int B, int HW, int C, void* stream) {
  if (B < 0 || HW < 0 || C < 0) return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * HW;
  if (items == 0 || C == 0) return (int)cudaSuccess;
  const long long blocks = (items + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  voxel_tap_bwd_kernel<BF16, T><<<(unsigned)blocks, 32 * WARPS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      g, ptr, rows, w, out, B, HW, C);
  return (int)cudaGetLastError();
}

}  // namespace

// g (4 B P, C) fp32, the cotangents of lt, rb, rt, lb (corner, scene,
// point); ptr (16 B HW + 1), rows, w (ptr[16 B HW] entries) the order
// index; out (B, C, HW) written. Returns a cudaError_t.
extern "C" int voxel_tap_bwd_f32(const float* g, const int* ptr,
                                 const int* rows, const float* w, float* out,
                                 int B, int HW, int C, void* stream) {
  return launch<false>(g, ptr, rows, w, out, B, HW, C, stream);
}

// As voxel_tap_bwd_f32, out bf16: every update and every add rounded to bf16.
extern "C" int voxel_tap_bwd_bf16(const float* g, const int* ptr,
                                  const int* rows, const float* w, void* out,
                                  int B, int HW, int C, void* stream) {
  return launch<true>(g, ptr, rows, w, static_cast<__nv_bfloat16*>(out), B,
                      HW, C, stream);
}
