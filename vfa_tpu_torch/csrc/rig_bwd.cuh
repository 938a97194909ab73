// Shared passes of the compiled-rig backward kernels (rig_window_bwd.cu,
// rig_flat_bwd.cu), on the CTA tile of rig_gemm.cuh: the dKr product, the
// dvox product and the A^T product that is added into dII, the last one
// written for both band layouts. See rig_window_bwd.cu for the sequence.

#pragma once

#include "rig_gemm.cuh"

namespace {

__device__ __forceinline__ void add4(float* dst, float a, float b, float c,
                                     float d) {
#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(a, b, c, d));
#else
  atomicAdd(dst + 0, a);
  atomicAdd(dst + 1, b);
  atomicAdd(dst + 2, c);
  atomicAdd(dst + 3, d);
#endif
}

// Add a CTA tile: row_ptr(m) -> pointer to D[m0 + m][n0] or nullptr.
template <class RowPtr>
__device__ __forceinline__ void add_tile(const float (&acc)[8][8],
                                         RowPtr row_ptr) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* dst = row_ptr(i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4);
    if (!dst) continue;
    add4(dst + tx * 4, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    add4(dst + 64 + tx * 4, acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// Pass 2. grid (nl*CH/BM, CH/BN, splits). D[(l, c), o] over the depth
// index d = (nb*T + t)*tile_v + v; this CTA takes depths
// [z*chunk, (z+1)*chunk), chunk % BK == 0.
__global__ void __launch_bounds__(THREADS)
rig_dkr_kernel(const float* __restrict__ vox, const float* __restrict__ g,
               float* __restrict__ dKr, int NB, int T, int nl, int tile_v,
               int off_t, int rows_total, int chunk) {
  const int l = blockIdx.x / (CH / BM);
  const int c0 = (blockIdx.x % (CH / BM)) * BM;
  const int o0 = blockIdx.y * BN;
  const int cells = T * tile_v;
  const int depth = NB * cells;
  const int d0 = blockIdx.z * chunk;
  const size_t R = (size_t)nl * tile_v;

  float acc[8][8];
  gemm_tile<true, true>(
      chunk,
      [&](int k, int q) -> const float* {
        const int d = d0 + k;
        if (d >= depth) return nullptr;
        const int nb = d / cells;
        const int rr = d % cells;
        const int t = rr / tile_v;
        const int v = rr % tile_v;
        return vox + (((size_t)nb * T + t) * R + (size_t)l * tile_v + v) * CH +
               c0 + q * 4;
      },
      [&](int k) -> const float* {
        const int d = d0 + k;
        if (d >= depth) return nullptr;
        const int nb = d / cells;
        const int rr = d % cells;
        return g + ((size_t)nb * rows_total + (size_t)off_t * tile_v + rr) * CH +
               o0;
      },
      acc);
  float* dst0 = dKr + ((size_t)l * CH + c0) * CH + o0;
  add_tile(acc, [&](int m) -> float* { return dst0 + (size_t)m * CH; });
}

// Pass 3. grid (ceil(T*tile_v/BM), nl*CH/BN, N*B).
__global__ void __launch_bounds__(THREADS)
rig_dvox_kernel(const float* __restrict__ g, const float* __restrict__ KrT,
                float* __restrict__ dvox, int T, int nl, int tile_v,
                int off_t, int rows_total) {
  const int cells = T * tile_v;
  const int r0 = blockIdx.x * BM;
  const int l = blockIdx.y / (CH / BN);
  const int c0 = (blockIdx.y % (CH / BN)) * BN;
  const size_t R = (size_t)nl * tile_v;
  const float* g_nb = g + ((size_t)blockIdx.z * rows_total +
                           (size_t)off_t * tile_v) * CH;
  const float* KrT_l = KrT + (size_t)l * CH * CH + c0;

  float acc[8][8];
  gemm_tile<false, false>(
      CH,
      [&](int m, int k) -> const float* {
        return r0 + m < cells ? g_nb + (size_t)(r0 + m) * CH + k : nullptr;
      },
      [&](int k) -> const float* { return KrT_l + (size_t)k * CH; },
      acc);
  float* dst0 = dvox + (size_t)blockIdx.z * T * R * CH + c0;
  store_tile(acc, [&](int m) -> float* {
    const int rr = r0 + m;
    if (rr >= cells) return nullptr;
    const int t = rr / tile_v;
    const int v = rr % tile_v;
    return dst0 + ((size_t)t * R + (size_t)l * tile_v + v) * CH;
  });
}

// Pass 4. grid (ceil(K/BM) * CH/BN, T, N*B). D[pixel, c] over depth r < R
// (padded to a multiple of BK with zeros), added into dII at the band's
// pixels (addressed as in rig_vox_kernel).
template <bool WINDOW>
__global__ void __launch_bounds__(THREADS)
rig_dii_kernel(const float* __restrict__ A, const int* __restrict__ starts,
               const float* __restrict__ dvox, float* __restrict__ dII, int B,
               int pixels, int Wp, int T, int R, int K, int ww) {
  const int mb = blockIdx.x / (CH / BN);
  const int cb = blockIdx.x % (CH / BN);
  const int t = blockIdx.y;
  const int n = blockIdx.z / B;
  const int i = n * T + t;
  const int s0 = WINDOW ? starts[2 * i] : starts[i];
  const int s1 = WINDOW ? starts[2 * i + 1] : 0;
  const float* A_t = A + (size_t)i * R * K;
  const float* dvox_t = dvox + ((size_t)blockIdx.z * T + t) * R * CH + cb * BN;
  const int m0 = mb * BM;

  float acc[8][8];
  gemm_tile<true, true>(
      (R + BK - 1) / BK * BK,
      [&](int r, int q) -> const float* {
        return r < R && m0 + q * 4 < K ? A_t + (size_t)r * K + m0 + q * 4
                                       : nullptr;
      },
      [&](int r) -> const float* {
        return r < R ? dvox_t + (size_t)r * CH : nullptr;
      },
      acc);
  float* img = dII + (size_t)blockIdx.z * pixels * CH + cb * BN;
  add_tile(acc, [&](int m) -> float* {
    const int p = m0 + m;
    if (p >= K) return nullptr;
    if constexpr (WINDOW) {
      return img + ((size_t)(s0 + p / ww) * Wp + s1 + p % ww) * CH;
    } else {
      return img + (size_t)(s0 + p) * CH;
    }
  });
}

// All four passes of a backward launch; arguments as rig_fwd_launch, with
// KrT (nl, n_out, C), g the cotangent of the scale's tiles, and dII, dKr
// added to.
template <bool WINDOW>
inline int rig_bwd_launch(const float* ii, const float* A, const int* starts,
                          const float* KrT, const float* g, float* vox,
                          float* dII, float* dKr, int N, int B, int pixels,
                          int Wp, int C, int T, int nl, int tile_v, int K,
                          int ww, int n_out, int off_t, int rows_total,
                          void* stream) {
  const int R = nl * tile_v;
  const int NB = N * B;
  if (C != CH || n_out != CH || K < 1 || K % (WINDOW ? BK : 8) != 0 || T < 1 ||
      T > 65535 || NB > 65535 || R < 1 ||
      (long long)NB * T * tile_v > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  dim3 g1((R + BM - 1) / BM * (CH / BN), T, NB);
  rig_vox_kernel<WINDOW><<<g1, THREADS, 0, s>>>(ii, A, starts, vox, B, pixels,
                                                Wp, T, R, K, ww);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // depth per CTA: at least 256, and no more than 24 splits (the output is
  // 40 CTA tiles, so 24 splits are about 7 CTAs per SM)
  const int depth = NB * T * tile_v;
  int splits = (depth + 255) / 256;
  if (splits > 24) splits = 24;
  const int chunk = ((depth + splits - 1) / splits + BK - 1) / BK * BK;
  splits = (depth + chunk - 1) / chunk;
  dim3 g2(nl * CH / BM, CH / BN, splits);
  rig_dkr_kernel<<<g2, THREADS, 0, s>>>(vox, g, dKr, NB, T, nl, tile_v, off_t,
                                        rows_total, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dim3 g3((T * tile_v + BM - 1) / BM, nl * CH / BN, NB);
  rig_dvox_kernel<<<g3, THREADS, 0, s>>>(g, KrT, vox, T, nl, tile_v, off_t,
                                         rows_total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dim3 g4((K + BM - 1) / BM * (CH / BN), T, NB);
  rig_dii_kernel<WINDOW><<<g4, THREADS, 0, s>>>(A, starts, vox, dII, B, pixels,
                                                Wp, T, R, K, ww);
  return (int)cudaGetLastError();
}

}  // namespace
