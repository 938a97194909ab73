// Shared pieces of the compiled-rig kernels (rig_window_fwd.cu,
// rig_flat_fwd.cu and, through rig_bwd.cuh, rig_window_bwd.cu and
// rig_flat_bwd.cu): a register-tiled fp32 SGEMM CTA tile, the A-product
// pass vox = A[n, t] @ band that both directions and both band layouts run,
// and the forward's collapse pass.
//
// One 128-thread CTA computes a 64 x 128 output tile, each thread 8 x 8 of
// it, from 16-deep slices of both operands double-buffered through shared
// memory (the next slice is loaded to registers while the current one is
// multiplied): 64 FMAs per 4 shared float4 loads.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // output rows per CTA
constexpr int BN = 128;       // output columns per CTA
constexpr int BK = 16;        // depth of one staged slice
constexpr int THREADS = 128;  // 8 row groups x 16 column groups
constexpr int AS_LD = BM + 4; // padded row of the transposed A slice
constexpr int CH = 256;       // channels: C == n_out == 256

// One CTA's 64 x 128 tile of  D = Aop @ Bop  over K (the last slice may be
// ragged: the operands' accessors return nullptr past K).
// A_KMAJOR false: a_row(m, k) points to Aop[m0 + m][k .. k + 3], k % 4 == 0
//   (16-byte aligned), or is nullptr outside the problem (zeros).
// A_KMAJOR true: Aop is stored depth-major; a_row(k, q) points to
//   Aop[m0 + 4q .. m0 + 4q + 3][k] as 4 consecutive floats (16-byte
//   aligned), or is nullptr (zeros).
// b_row(k) points to Bop[k][n0 .. n0 + 127] (16-byte aligned); with B_CHECK
//   it may be nullptr for a depth index outside the problem (zeros).
// acc[i][j] is row (i < 4 ? ty*4 + i : 32 + ty*4 + i - 4),
// column (j < 4 ? tx*4 + j : 64 + tx*4 + j - 4).
template <bool A_KMAJOR, bool B_CHECK, class ARow, class BRow>
__device__ __forceinline__ void gemm_tile(int K, ARow a_row, BRow b_row,
                                          float (&acc)[8][8]) {
  __shared__ __align__(16) float As[2][BK * AS_LD];
  __shared__ __align__(16) float Bs[2][BK * BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra[2], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int idx = tid + THREADS * p;
      const float* src;
      if constexpr (A_KMAJOR) {
        src = a_row(k0 + idx / 16, idx % 16);  // 16 depths x 16 quads
      } else {
        src = a_row(idx / 4, k0 + (idx % 4) * 4);  // 64 rows x 4 quads
      }
      ra[p] = src ? *reinterpret_cast<const float4*>(src)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int idx = tid + THREADS * p;     // 16 rows x 32 quads
      const float* src = b_row(k0 + idx / 32);
      if constexpr (B_CHECK) {
        rb[p] = src ? *reinterpret_cast<const float4*>(src + (idx % 32) * 4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        rb[p] = *reinterpret_cast<const float4*>(src + (idx % 32) * 4);
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int idx = tid + THREADS * p;
      if constexpr (A_KMAJOR) {
        *reinterpret_cast<float4*>(
            &As[buf][(idx / 16) * AS_LD + (idx % 16) * 4]) = ra[p];
      } else {
        const int m = idx / 4;
        const int k = (idx % 4) * 4;
        As[buf][(k + 0) * AS_LD + m] = ra[p].x;
        As[buf][(k + 1) * AS_LD + m] = ra[p].y;
        As[buf][(k + 2) * AS_LD + m] = ra[p].z;
        As[buf][(k + 3) * AS_LD + m] = ra[p].w;
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int idx = tid + THREADS * p;
      *reinterpret_cast<float4*>(&Bs[buf][(idx / 32) * BN + (idx % 32) * 4]) =
          rb[p];
    }
  };

  const int nk = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k * AS_LD + ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k * AS_LD + 32 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k * BN + tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k * BN + 64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
}

// Store a CTA tile: row_ptr(m) -> pointer to D[m0 + m][n0] or nullptr.
template <class RowPtr>
__device__ __forceinline__ void store_tile(const float (&acc)[8][8],
                                           RowPtr row_ptr) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* dst = row_ptr(i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4);
    if (!dst) continue;
    *reinterpret_cast<float4*>(dst + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// The A-product pass: vox[n, b, t] = A[n, t] @ band(n, b, t), fp32.
// grid (ceil(R/BM) * CH/BN, T, N*B). The A operand is A's rows, the B
// operand the band's pixels out of the (n, b) image of `pixels` rows:
//   WINDOW: pixel k of the (wh, ww) window at (ry, rx) = starts[2i], [2i+1]
//           is row (ry + k / ww) * Wp + rx + k % ww; K = wh*ww, K % BK == 0;
//   flat:   pixel k of the band at start = starts[i] is row start + k;
//           K = band, a multiple of 8, so the last slice may be half empty.
template <bool WINDOW>
__global__ void __launch_bounds__(THREADS)
rig_vox_kernel(const float* __restrict__ ii, const float* __restrict__ A,
               const int* __restrict__ starts, float* __restrict__ vox,
               int B, int pixels, int Wp, int T, int R, int K, int ww) {
  const int mb = blockIdx.x / (CH / BN);
  const int nb = blockIdx.x % (CH / BN);
  const int t = blockIdx.y;
  const int n = blockIdx.z / B;
  const int i = n * T + t;
  const int s0 = WINDOW ? starts[2 * i] : starts[i];
  const int s1 = WINDOW ? starts[2 * i + 1] : 0;
  const float* A_t = A + (size_t)i * R * K;
  const float* img = ii + (size_t)blockIdx.z * pixels * CH + nb * BN;
  const int m0 = mb * BM;

  float acc[8][8];
  gemm_tile<false, !WINDOW>(
      K,
      [&](int m, int k) -> const float* {
        return m0 + m < R && k < K ? A_t + (size_t)(m0 + m) * K + k : nullptr;
      },
      [&](int k) -> const float* {
        if constexpr (WINDOW) {
          return img + ((size_t)(s0 + k / ww) * Wp + s1 + k % ww) * CH;
        } else {
          return k < K ? img + (size_t)(s0 + k) * CH : nullptr;
        }
      },
      acc);
  float* dst0 = vox + ((size_t)blockIdx.z * T + t) * R * CH + nb * BN;
  store_tile(acc, [&](int m) -> float* {
    return m0 + m < R ? dst0 + (size_t)(m0 + m) * CH : nullptr;
  });
}

// The forward's collapse pass: out = vox2 @ Kr2 with vox2[(t, v), l*C + c]
// = vox[t][l*tile_v + v][c] and Kr2 = Kr as (nl*C, n_out), one GEMM over
// all cells of the bucket, written at tile offset off_t of the scale's
// (N, B, rows_total, n_out) tiles. grid (ceil(T*tile_v/BM), n_out/BN, N*B).
__global__ void __launch_bounds__(THREADS)
rig_collapse_kernel(const float* __restrict__ vox, const float* __restrict__ Kr,
                    float* __restrict__ out, int T, int nl, int tile_v,
                    int off_t, int rows_total) {
  const int cells = T * tile_v;
  const int r0 = blockIdx.x * BM;
  const int nb = blockIdx.y;
  const size_t R = (size_t)nl * tile_v;
  const float* vox_nb = vox + (size_t)blockIdx.z * T * R * CH;

  float acc[8][8];
  gemm_tile<false, false>(
      nl * CH,
      [&](int m, int k) -> const float* {
        const int rr = r0 + m;
        if (rr >= cells) return nullptr;
        const int t = rr / tile_v;
        const int v = rr % tile_v;
        const int l = k / CH;
        return vox_nb + ((size_t)t * R + (size_t)l * tile_v + v) * CH + k % CH;
      },
      [&](int k) -> const float* { return Kr + (size_t)k * CH + nb * BN; },
      acc);
  float* dst0 = out + ((size_t)blockIdx.z * rows_total + (size_t)off_t * tile_v) * CH
                + nb * BN;
  store_tile(acc, [&](int m) -> float* {
    return r0 + m < cells ? dst0 + (size_t)(r0 + m) * CH : nullptr;
  });
}

// Both passes of a forward launch. pixels = rows of one (n, b) image;
// WINDOW: K = wh*ww, Wp and ww as above; flat: K = band, Wp = ww = 0.
template <bool WINDOW>
inline int rig_fwd_launch(const float* ii, const float* A, const int* starts,
                          const float* Kr, float* vox, float* out, int N,
                          int B, int pixels, int Wp, int C, int T, int nl,
                          int tile_v, int K, int ww, int n_out, int off_t,
                          int rows_total, void* stream) {
  const int R = nl * tile_v;
  if (C != CH || n_out != CH || K < 1 || K % (WINDOW ? BK : 8) != 0 || T < 1 ||
      T > 65535 || N * B > 65535 || R < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 g1((R + BM - 1) / BM * (CH / BN), T, N * B);
  rig_vox_kernel<WINDOW><<<g1, THREADS, 0, s>>>(ii, A, starts, vox, B, pixels,
                                                Wp, T, R, K, ww);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g2((T * tile_v + BM - 1) / BM, CH / BN, N * B);
  rig_collapse_kernel<<<g2, THREADS, 0, s>>>(vox, Kr, out, T, nl, tile_v,
                                             off_t, rows_total);
  return (int)cudaGetLastError();
}

}  // namespace
