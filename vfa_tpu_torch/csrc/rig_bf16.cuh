// Tensor-core passes of the bf16 compiled-rig flat forward (rig_flat_fwd.cu:
// rig_flat_fwd_bf16, K4-bf16) for NVIDIA Hopper (sm_90a): one CTA tile on
// wgmma.mma_async m64n64k16 bf16 with fp32 accumulators, and the two passes
// of a forward launch written on it. The fp32 kernels keep their own tile
// (rig_mma.cuh); the bf16 window forward (K1-bf16) runs on the
// warp-specialised tile of rig_ws.cuh. The passes of the bf16 backwards on
// this tile are in rig_bf16_bwd.cuh.
//
// What is computed, with JAX's rounding points (vfa_tpu/ops/rig_pallas.py
// _kernel, run on bf16 features, A and Kr):
//   pass 1: vox = A_tile @ band, bf16 products summed in fp32, vox rounded
//           to bf16 (to nearest even) into the device scratch;
//   pass 2: out = sum_l vox_l @ Kr_l over all cells of the bucket, summed in
//           fp32 (one chain of depth nl*C), rounded to bf16 into the scale's
//           tiles buffer at off_t.
//
// The tile. A CTA of one warpgroup (4 warps) computes a 64 x 256 output tile
// D = Aop @ Bop (256 = all channels: the B operand is always a whole row of
// the band or of Kr). Operands come in 32-deep slices (two k16 steps) through
// a ring of 4 stages in dynamic shared memory, filled by cp.async 16 bytes
// (8 values) a thread, one __syncthreads a slice: 21 KB a stage, 84 KB in
// all, two CTAs an SM.
//
// How wgmma is fed. Aop's rows are depth-contiguous in device memory (rows of
// A; cells of vox), Bop's are channel-contiguous (pixels of the band; rows of
// Kr). The product is computed transposed, D^T (256 x 64) = Bop^T @ Aop^T:
//   - Bop^T is wgmma's register operand, four 64-row blocks (channels). A
//     warp's 16 x 16 fragment of a block is one ldmatrix.x4.trans from the
//     slice as it lies in shared memory ([depth][channel], rows padded to
//     256 + 8 values, so the 8 rows of an 8x8 matrix hit 8 different bank
//     quads);
//   - Aop^T is the shared-memory operand, depth-contiguous (K-major, no
//     transpose bit). cp.async writes each 16-byte quad of Aop straight into
//     wgmma's core-matrix order (8 rows x 8 depths = 128 contiguous bytes;
//     the next 8 depths 128 bytes on, the next 8 rows 512 bytes on), so no
//     pass rewrites it.
// bf16 needs neither the 3xTF32 split nor the fp32 tile's rewrite of the
// shared-memory operand (`prep`); per k16 step a warp issues 4 ldmatrix and
// 4 wgmma. The accumulators are stored through shared memory: each thread
// writes its 128 values as bf16 into a [row][channel] staging tile, then
// the CTA copies whole 16-byte quads of rows out.
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): a batch-2 flat
// forward over the full MultiviewC rig cast to bf16 takes 13.09 ms against
// a 2.23 ms bound; 186-192 registers, no spill, one WARPGROUP.DEPBAR per 8
// HGMMA in the SASS.
// What is left on the table: each 64-row CTA reads the whole 256-channel B
// slice for 1 MFLOP of products (20 KB a slice); rig_ws.cuh's tile (two
// warpgroups sharing one TMA-fed slice, m64n256k16) is the way for K4-bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bft {
namespace {

using bf16 = __nv_bfloat16;

constexpr int CH = 256;        // channels: C == n_out == 256 == tile width
constexpr int BM = 64;         // output rows per CTA
constexpr int BK = 32;         // depth of one staged slice (two k16 steps)
constexpr int THREADS = 128;   // one warpgroup
constexpr int STAGES = 4;      // slices in flight per CTA
constexpr int A_BYTES = BM * BK * 2;        // core-matrix order, no padding
constexpr int LDB = CH + 8;                 // values a staged row of Bop
constexpr int B_BYTES = BK * LDB * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int LDD = CH + 8;                 // values a row of the staging tile
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
static_assert(BM * LDD * 2 <= SMEM_BYTES, "the staging tile reuses the ring");
static_assert(STAGE_BYTES % 128 == 0, "stages stay 128-byte aligned");

// 16 bytes global -> shared, asynchronously; zeros for a null source.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  if (src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
                 : "memory");
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Shared-memory matrix descriptor of wgmma for a K-major operand without
// swizzle: core matrices of 8 rows x 16 bytes; the next 8 depths `lbo`
// bytes on, the next 8 rows `sbo` bytes on.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Four 8x8 bf16 matrices from shared memory, transposed on the way: the
// register fragment of a 16 x 16 block of wgmma's A operand from rows that
// lie [depth][row].
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d (this warpgroup's 64 x 64 fragment) += a (64 x 16, registers) @ b
// (16 x 64, shared memory, K-major), bf16 in, fp32 sums, asynchronous.
__device__ __forceinline__ void wgmma_bf16(float (&d)[8][4],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// One CTA's 64 x 256 tile of  D = Aop @ Bop  over nk slices of 32 depths,
// computed transposed (see the top of this file).
// seek(kt) is called once per thread before the sources of slice kt are
// asked for. Sources return a 16-byte aligned pointer, or nullptr for zeros:
//   a_src(m, k) -> Aop[m0 + m][32*kt + k .. + 7]   (k a multiple of 8)
//   b_src(k)    -> Bop[32*kt + k][0 .. 255]
// acc[mb][j][e] is element (channel 64*mb + 16*warp + g + 8*(e/2), row
// 8*j + 2*t + e%2) of D^T, g = lane/4, t = lane%4 (wgmma's accumulator
// layout); store_tile knows it.
template <class Seek, class ASrc, class BSrc>
__device__ __forceinline__ void mma_tile(int nk, Seek seek, ASrc a_src,
                                         BSrc b_src, float (&acc)[4][8][4]) {
  extern __shared__ __align__(128) unsigned char bsmem[];
  __syncthreads();   // a tile before this one may still be read
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](int kt) {
    unsigned char* As = bsmem + (kt % STAGES) * STAGE_BYTES;
    unsigned char* Bs = As + A_BYTES;
    seek(kt);
#pragma unroll
    for (int p = 0; p < 2; ++p) {   // BM * BK / 8 = 256 quads of Aop
      const int idx = tid + p * THREADS;
      const int m = idx >> 2;
      const int q = idx & 3;
      copy16(As + ((m >> 3) * 4 + q) * 128 + (m & 7) * 16, a_src(m, 8 * q));
    }
    // one row of Bop a thread: 4 neighbouring threads take 64 bytes of it
    // per copy, 8 copies a row
    const int r = tid >> 2;
    const bf16* src = b_src(r);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int c = ((tid & 3) + 4 * p) * 8;
      copy16(Bs + (r * LDB + c) * 2, src ? src + c : nullptr);
    }
  };

  // One slice: two k16 steps s, each 4 ldmatrix (the warp's 16 channels of
  // each 64-channel block mb) and 4 wgmma.
  auto compute = [&](int kt) {
    const unsigned char* As = bsmem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* Bs = As + A_BYTES;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t a[4][4];
      const int k = 16 * s + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
        const int c = 64 * mb + 16 * warp + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(a[mb], Bs + (k * LDB + c) * 2);
      }
      const uint64_t d = smem_desc(As + 256 * s, 128, 512);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) wgmma_bf16(acc[mb], a[mb], d);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    }
  };

  // Slice kt + 3 is requested after the barrier that ends the reading of
  // what it overwrites (slice kt - 1's, whose products every warp has waited
  // for at the end of its iteration). Each thread makes its landed copies
  // visible to wgmma's reads (the async proxy) before the barrier.
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2) : "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    compute(kt);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  // the sums are final only past the last wait: no read of them may be
  // scheduled before this point
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[i][j][e])::"memory");
}

// Write a CTA tile out as bf16 (rounded to nearest even): row_ptr(m) ->
// pointer to D[m0 + m][0] or nullptr. Through a [row][channel] staging tile
// in the ring's shared memory, then 16-byte quads of whole rows.
template <class RowPtr>
__device__ __forceinline__ void store_tile(const float (&acc)[4][8][4],
                                           RowPtr row_ptr) {
  extern __shared__ __align__(128) unsigned char bsmem[];
  bf16* D = reinterpret_cast<bf16*>(bsmem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cw = 16 * (tid >> 5) + g;
  __syncthreads();   // every warp is done reading the ring
#pragma unroll
  for (int mb = 0; mb < 4; ++mb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        D[(8 * j + 2 * t + (e & 1)) * LDD + 64 * mb + cw + 8 * (e >> 1)] =
            __float2bfloat16_rn(acc[mb][j][e]);
  __syncthreads();
#pragma unroll
  for (int p = 0; p < BM * CH / 8 / THREADS; ++p) {
    const int idx = tid + p * THREADS;
    const int m = idx >> 5;
    const int c = (idx & 31) * 8;
    bf16* dst = row_ptr(m);
    if (dst)
      *reinterpret_cast<uint4*>(dst + c) =
          *reinterpret_cast<const uint4*>(D + m * LDD + c);
  }
}

// Pass 1: vox[n, b, t] = A[n, t] @ band(n, b, t) (pixels starts[n*T + t] ..
// of the (n, b) image), rows m0 .. m0 + 63 of it,
// rounded to bf16. K is a multiple of 8, so a ragged last slice ends on a
// quad; rows past R are zeros and are not stored. grid vox_grid(): the scene
// is the innermost index, so the B CTAs that read one A tile run together
// and share it through L2.
__global__ void __launch_bounds__(THREADS)
rig_bfvox_mma(const bf16* __restrict__ ii, const bf16* __restrict__ A,
              const int* __restrict__ starts, bf16* __restrict__ vox, int B,
              int pixels, int T, int R, int K) {
  const int n = blockIdx.z;
  const int b = blockIdx.x % B;
  const int t = blockIdx.y;
  const int m0 = (blockIdx.x / B) * BM;
  const int i = n * T + t;
  const int nb = n * B + b;
  const int s0 = starts[i];
  const bf16* A_t = A + (size_t)i * R * K;
  const bf16* img = ii + (size_t)nb * pixels * CH;
  int k0 = 0;

  float acc[4][8][4];
  mma_tile(
      (K + BK - 1) / BK, [&](int kt) { k0 = kt * BK; },
      [&](int m, int k) -> const bf16* {
        return m0 + m < R && k0 + k < K ? A_t + (size_t)(m0 + m) * K + k0 + k
                                        : nullptr;
      },
      [&](int k) -> const bf16* {
        return k0 + k < K ? img + (size_t)(s0 + k0 + k) * CH : nullptr;
      },
      acc);
  bf16* dst0 = vox + ((size_t)nb * T + t) * R * CH;
  store_tile(acc, [&](int m) -> bf16* {
    return m0 + m < R ? dst0 + (size_t)(m0 + m) * CH : nullptr;
  });
}

inline dim3 vox_grid(int R, int T, int N, int B) {
  return dim3(B * ((R + BM - 1) / BM), T, N);
}

// Pass 2, the collapse: out = sum_l vox_l @ Kr[l] over all cells (t, v) of
// the bucket, as one product of depth nl*C: row t*tile_v + v of Aop is
// vox[t][l*tile_v + v][c] at depth l*C + c (a 32-deep slice never crosses a
// layer); Bop is Kr seen as (nl*C, n_out). Rows land in place at
// (off_t + t)*tile_v + v of the scale's (N, B, rows_total, n_out) tiles;
// rows past T*tile_v are not written. grid (ceil(T*tile_v/BM), 1, N*B).
__global__ void __launch_bounds__(THREADS)
rig_bfcollapse_mma(const bf16* __restrict__ vox, const bf16* __restrict__ Kr,
                   bf16* __restrict__ out, int T, int nl, int tile_v,
                   int off_t, int rows_total) {
  __shared__ int row_of[BM];   // vox row t*R + v of cell r0 + m; -1: none
  const int cells = T * tile_v;
  const int r0 = blockIdx.x * BM;
  const size_t R = (size_t)nl * tile_v;
  if (threadIdx.x < BM) {
    const int rr = r0 + threadIdx.x;
    row_of[threadIdx.x] =
        rr < cells ? (int)((rr / tile_v) * R + rr % tile_v) : -1;
  }
  // (mma_tile's first barrier makes row_of visible to every thread)
  const bf16* vox_nb = vox + (size_t)blockIdx.z * T * R * CH;
  const bf16* vox_l = vox_nb;   // vox_nb + layer l's rows + channel c0
  int k0 = 0;

  float acc[4][8][4];
  mma_tile(
      nl * (CH / BK),
      [&](int kt) {
        k0 = kt * BK;
        vox_l = vox_nb + (size_t)(k0 / CH) * tile_v * CH + k0 % CH;
      },
      [&](int m, int k) -> const bf16* {
        const int row = row_of[m];
        return row < 0 ? nullptr : vox_l + (size_t)row * CH + k;
      },
      [&](int k) -> const bf16* { return Kr + (size_t)(k0 + k) * CH; },
      acc);
  bf16* dst0 = out + ((size_t)blockIdx.z * rows_total +
                      (size_t)off_t * tile_v + r0) * CH;
  store_tile(acc, [&](int m) -> bf16* {
    return r0 + m < cells ? dst0 + (size_t)m * CH : nullptr;
  });
}

template <class Kernel, class... Args>
inline cudaError_t launch_smem(Kernel kernel, dim3 grid, int smem,
                               cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, s>>>(args...);
  return cudaGetLastError();
}

template <class Kernel, class... Args>
inline cudaError_t launch_tile(Kernel kernel, dim3 grid, cudaStream_t s,
                               Args... args) {
  return launch_smem(kernel, grid, SMEM_BYTES, s, args...);
}

// Both passes of a flat bf16 forward launch. pixels = rows of one (n, b)
// image, K = band. Kr (nl, C, n_out); vox the (N, B, T, nl*tile_v, C) bf16
// scratch; out the scale's (N, B, rows_total, n_out) bf16 tiles, written at
// tile offset off_t.
inline int rig_fwd_launch(const bf16* ii, const bf16* A, const int* starts,
                          const bf16* Kr, bf16* vox, bf16* out, int N, int B,
                          int pixels, int C, int T, int nl, int tile_v, int K,
                          int n_out, int off_t, int rows_total, void* stream) {
  const int R = nl * tile_v;
  if (C != CH || n_out != CH || K < 1 || K % 8 != 0 || T < 1 || T > 65535 ||
      N < 1 || N > 65535 || N * B > 65535 || B < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_tile(rig_bfvox_mma, vox_grid(R, T, N, B), s, ii, A,
                                starts, vox, B, pixels, T, R, K);
  if (err != cudaSuccess) return (int)err;
  err = launch_tile(rig_bfcollapse_mma,
                    dim3((T * tile_v + BM - 1) / BM, 1, N * B), s, vox, Kr,
                    out, T, nl, tile_v, off_t, rows_total);
  return (int)err;
}

}  // namespace
}  // namespace bft
