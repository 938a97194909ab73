// Tensor-core passes of all four compiled-rig kernels (rig_window_fwd.cu,
// rig_flat_fwd.cu, rig_window_bwd.cu, rig_flat_bwd.cu) for NVIDIA Hopper
// (sm_90a): one CTA tile on wgmma.mma_async m64n64k8 TF32 with a 3xTF32
// split that keeps fp32 accuracy, and the two passes of a forward launch and
// the four of a backward launch written on it, for both band layouts. See
// rig_window_fwd.cu and rig_window_bwd.cu for the sequences and the reasons.
//
// The tile. A CTA of one warpgroup (4 warps) computes a 64 x 256 output tile
// D = Aop @ Bop (256 = all channels, so the B operand is always a whole row
// of the band, of g, of Kr, of Kr^T or of dvox). Operands come in 16-deep
// slices through a ring of 4 stages in dynamic shared memory, filled by
// cp.async 16 bytes a thread, one __syncthreads a slice (102 KB with the
// split buffers below, so two CTAs an SM). 64 rows divide nl*tile_v = 320
// and waste 4 % of 800.
//
// wgmma and its obstacle. For TF32 wgmma reads a shared-memory operand only
// depth-contiguous, and in every pass the 256-wide operand lies the other
// way (channel-contiguous rows of depth), in two passes the 64-row operand
// too. So the product is computed transposed, D^T (256 x 64) = Bop^T @
// Aop^T:
//   - Bop^T is wgmma's register operand, four blocks of 64 channels. A
//     thread builds its fragment from the slice as it lies in shared
//     memory (16-byte loads, rows padded to 256 + 8 floats against bank
//     conflicts) and splits it into hi and lo on the way, in registers;
//   - Aop^T is the shared-memory operand (64 columns). Its slice is small
//     (64 x 16), so once per slice all threads rewrite it, split, into two
//     buffers (hi, lo) in the core-matrix order wgmma wants, which also
//     transposes it where it arrived as [k][m] (`prep`; rows padded to
//     16 + 4 or 64 + 8 floats).
// Per k8 step that is 12 wgmma (4 channel blocks x 3 products); the two
// steps of a slice are started back to back, the second fragment and the
// next slice's prep are computed while they run, and all are waited for at
// the end of the slice. Waiting later (one batch left in flight across
// slices) took 255 registers and spilled (35.6 against 34.6 ms, window
// backward; NVIDIA H100 80GB HBM3, 700 W); waiting at the top of the next
// slice made ptxas serialise every wgmma (44.5 ms).
// The first version of the backward's passes ran mma.sync.m16n8k8 on the
// same ring: 45.4 ms against 34.7 ms with wgmma for the window backward,
// 67.5 against 49.2 ms for the flat one (same card; PERF.md). The forward's
// two passes ran as a register-tiled fp32 SGEMM on the CUDA cores: 36.5 and
// 55.1 ms a batch-2 window and flat forward, 17.9 and 24.8 ms on this tile.
// What is left on the table: N = 64 per wgmma (a 128-column tile needs 256
// accumulator registers), TMA and warp specialisation (one barrier a slice
// stalls the whole warpgroup), and the register operand's split, redone by
// each of the 4 warps' lanes for its own channels only (no redundancy
// there) but still 5 ALU operations a value.
//
// 3xTF32. Each fp32 operand value x is split into hi = x rounded to TF32
// and lo = x - hi rounded to TF32 (to nearest, ties away, as cvt.rna.tf32
// rounds; a tensor core fed raw fp32 bits would truncate); a product is
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi accumulated in fp32, small terms
// first. One TF32 product alone keeps three digits. The rounding is done
// on the bits with an integer add and a mask: cvt.rna.tf32.f32 gives the
// same values but runs at a fraction of that rate (with mma.sync: 53.4 ms
// with cvt, 49.0 ms without, same card).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CH = 256;           // channels: C == n_out == 256 == tile width
constexpr int BM = 64;            // output rows per CTA
constexpr int BK = 16;            // depth of one staged slice (two k8 steps)
constexpr int THREADS = 128;      // one warpgroup; warp w owns channels 64w .. 64w + 63
constexpr int STAGES = 4;         // slices in flight per CTA
constexpr int LDA_MK = BK + 4;    // padded rows of a slice, see above
constexpr int LDA_KM = BM + 8;
constexpr int LDB = CH + 8;
constexpr int A_FLOATS = BM * LDA_MK > BK * LDA_KM ? BM * LDA_MK : BK * LDA_KM;
constexpr int STAGE_FLOATS = A_FLOATS + BK * LDB;
constexpr int HL_FLOATS = BM * BK;   // one split part of a slice of A, see prep
constexpr int SMEM_BYTES =
    (STAGES * STAGE_FLOATS + 4 * HL_FLOATS) * (int)sizeof(float);
constexpr int DKR_MAX_SPLITS = 16;  // depth chunks of the dKr pass (workspace size)
constexpr int DKR_CHAIN = 1024;     // longest chain of depths summed by the tensor cores

// 16 bytes global -> shared, asynchronously; zeros for a null source.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  if (src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
                 : "memory");
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// Shared-memory matrix descriptor of wgmma for a depth-contiguous TF32
// operand without swizzle: 8 rows x 16 bytes (4 depths) form a core matrix
// of 128 contiguous bytes; the next 4 depths are `lbo` bytes on, the next 8
// rows `sbo` bytes on.
__device__ __forceinline__ uint64_t smem_desc(const float* p, int lbo, int sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (this warpgroup's 64 x 64 fragment) += a (64 x 8, from registers) @ b
// (8 x 64, from shared memory, depth-contiguous), TF32, asynchronous.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4],
                                           const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
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

// One CTA's 64 x 256 tile of  D = Aop @ Bop  over nk slices of 16 depths,
// computed transposed: D^T (256 x 64) = Bop^T @ Aop^T, with Bop^T as the
// register operand of wgmma (four 64-row blocks; the thread builds the
// fragment from the slice as it lies, and splits it) and Aop^T as its
// shared-memory operand (64 columns, depth-contiguous, split once per
// slice by `prep`).
// seek(kt) is called once per thread before the sources of slice kt are
// asked for (it may move per-slice state). Sources return a 16-byte
// aligned pointer to 4 floats, or nullptr for zeros:
//   A_MK:  a_src(m, k) -> Aop[m0 + m][16*kt + k .. + 3]
//   else:  a_src(k, m) -> Aop[16*kt + k][m0 + m .. + 3]
//   b_src(k) -> Bop[16*kt + k][0 .. 255]
// acc[mb][j] is the m64n8 piece (mb, j) of the warpgroup's fragment;
// store_tile knows the rows and columns of its values.
template <bool A_MK, class Seek, class ASrc, class BSrc>
__device__ __forceinline__ void mma_tile(int nk, Seek seek, ASrc a_src,
                                         BSrc b_src, float (&acc)[4][8][4]) {
  extern __shared__ __align__(128) float smem[];
  float* hl = smem + STAGES * STAGE_FLOATS;   // [slice parity][hi, lo][HL_FLOATS]
  __syncthreads();   // a tile before this one may still be read
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wn = (tid >> 5) * 64;

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](int kt) {
    float* As = smem + (kt % STAGES) * STAGE_FLOATS;
    float* Bs = As + A_FLOATS;
    seek(kt);
#pragma unroll
    for (int p = 0; p < 2; ++p) {   // 4 * BM quads of A, 2 a thread
      const int idx = tid + p * THREADS;
      if constexpr (A_MK) {
        const int m = idx >> 2;
        const int k = (idx & 3) * 4;
        copy16(As + m * LDA_MK + k, a_src(m, k));
      } else {
        const int k = idx / (BM / 4);
        const int m = (idx % (BM / 4)) * 4;
        copy16(As + k * LDA_KM + m, a_src(k, m));
      }
    }
    constexpr int TPR = THREADS / BK;   // threads per row of B
    const int r = tid / TPR;
    const float* src = b_src(r);
#pragma unroll
    for (int p = 0; p < CH / 4 / TPR; ++p) {
      const int q = (tid % TPR + p * TPR) * 4;
      copy16(Bs + r * LDB + q, src ? src + q : nullptr);
    }
  };

  // Split slice kt of A into hi and lo, each laid out as wgmma reads a
  // depth-contiguous operand: core matrices of 8 rows x 4 depths, the 4
  // depth quads of 8 rows side by side (128 bytes apart), the next 8 rows
  // 512 bytes on. A thread moves 2 quads (row m, depths 4q .. 4q + 3).
  auto prep = [&](int kt) {
    const float* As = smem + (kt % STAGES) * STAGE_FLOATS;
    float* hi = hl + (kt & 1) * 2 * HL_FLOATS;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int idx = tid + p * THREADS;
      const int m = idx % BM;
      const int q = idx / BM;
      float4 v;
      if constexpr (A_MK) {
        v = *reinterpret_cast<const float4*>(As + m * LDA_MK + 4 * q);
      } else {
        const float* a = As + 4 * q * LDA_KM + m;
        v = make_float4(a[0], a[LDA_KM], a[2 * LDA_KM], a[3 * LDA_KM]);
      }
      uint4 h, l;
      split_tf32(v.x, h.x, l.x);
      split_tf32(v.y, h.y, l.y);
      split_tf32(v.z, h.z, l.z);
      split_tf32(v.w, h.w, l.w);
      float* dst = hi + ((m >> 3) * 4 + q) * 32 + (m & 7) * 4;
      *reinterpret_cast<uint4*>(dst) = h;
      *reinterpret_cast<uint4*>(dst + HL_FLOATS) = l;
    }
    // make the writes visible to wgmma's reads (the async proxy), once the
    // next barrier has been passed
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };

  // One slice: two k8 steps s. Slot (g, half h) of the register fragment's
  // 64-row block mb is channel wn + 32*(mb/2) + 4g + 2*(mb%2) + h, so that a
  // thread's 4 channels of depth t + 8s + 4e lie 16 bytes in a row (and the
  // loads are free of bank conflicts).
  auto compute = [&](int kt) {
    const float* Bs = smem + (kt % STAGES) * STAGE_FLOATS + A_FLOATS;
    const float* hi = hl + (kt & 1) * 2 * HL_FLOATS;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // step s has registers of its own: step 0's products run on the
      // tensor cores while step 1's fragment is loaded and split
      uint32_t bh[4][4], bl[4][4];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int mh = 0; mh < 2; ++mh) {
          const float4 v = *reinterpret_cast<const float4*>(
              Bs + (t + 8 * s + 4 * e) * LDB + wn + 32 * mh + 4 * g);
          split_tf32(v.x, bh[2 * mh][2 * e], bl[2 * mh][2 * e]);
          split_tf32(v.y, bh[2 * mh][2 * e + 1], bl[2 * mh][2 * e + 1]);
          split_tf32(v.z, bh[2 * mh + 1][2 * e], bl[2 * mh + 1][2 * e]);
          split_tf32(v.w, bh[2 * mh + 1][2 * e + 1], bl[2 * mh + 1][2 * e + 1]);
        }
      const uint64_t d_hi = smem_desc(hi + s * 64, 128, 512);
      const uint64_t d_lo = smem_desc(hi + HL_FLOATS + s * 64, 128, 512);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
        wgmma_tf32(acc[mb], bl[mb], d_hi);
        wgmma_tf32(acc[mb], bh[mb], d_lo);
        wgmma_tf32(acc[mb], bh[mb], d_hi);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    }
  };

  // Slice kt + 3 is requested, and slice kt + 1 split, after the barrier
  // that ends the reading of what they overwrite (slice kt - 1's, whose
  // products every warp has waited for at the end of its iteration).
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2) : "memory");
  __syncthreads();
  if (nk > 0) prep(0);
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 3) : "memory");
    __syncthreads();
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    compute(kt);
    if (kt + 1 < nk) prep(kt + 1);   // while slice kt's products run
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

__device__ __forceinline__ void put4(float* dst, const float4& v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ void add4(float* dst, const float4& v) {
#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(dst), v);
#else
  atomicAdd(dst + 0, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
#endif
}

// Write a CTA tile out, 16 bytes at a time: row_ptr(m) -> pointer to
// D[m0 + m][0] or nullptr, put = put4 or add4. The fragment is D^T: of
// each of its 16 rows of D (8j + 2t + e) a thread holds 2 x 4 consecutive
// channels (see compute).
template <class RowPtr, class Put>
__device__ __forceinline__ void store_tile(const float (&acc)[4][8][4],
                                           RowPtr row_ptr, Put put) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wn = (threadIdx.x >> 5) * 64;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float* dst = row_ptr(8 * j + 2 * t + e);
      if (!dst) continue;
#pragma unroll
      for (int mh = 0; mh < 2; ++mh)
        put(dst + wn + 32 * mh + 4 * g,
            make_float4(acc[2 * mh][j][e], acc[2 * mh][j][2 + e],
                        acc[2 * mh + 1][j][e], acc[2 * mh + 1][j][2 + e]));
    }
}

// Row of the (n, b) image that holds pixel k of a band: WINDOW, pixel k of
// the (wh, ww) window at (s0, s1) of an image Wp wide; flat, pixel k of the
// band that starts at row s0.
template <bool WINDOW>
__device__ __forceinline__ size_t band_row(int k, int s0, int s1, int Wp,
                                           int ww) {
  if constexpr (WINDOW) {
    return (size_t)(s0 + k / ww) * Wp + s1 + k % ww;
  } else {
    return (size_t)(s0 + k);
  }
}

// Pass 1 of both directions: vox[n, b, t] = A[n, t] @ band(n, b, t), rows
// m0 .. m0 + 63 of it. A's rows are depth-contiguous (A_MK); K is a
// multiple of 8, so a ragged last slice ends on a quad.
template <bool WINDOW>
__device__ __forceinline__ void vox_tile(const float* __restrict__ ii,
                                         const float* __restrict__ A,
                                         const int* __restrict__ starts,
                                         float* __restrict__ vox, int B,
                                         int pixels, int Wp, int T, int R,
                                         int K, int ww, int n, int b, int t,
                                         int m0) {
  const int i = n * T + t;
  const int nb = n * B + b;
  const int s0 = WINDOW ? starts[2 * i] : starts[i];
  const int s1 = WINDOW ? starts[2 * i + 1] : 0;
  const float* A_t = A + (size_t)i * R * K;
  const float* img = ii + (size_t)nb * pixels * CH;
  int k0 = 0;

  float acc[4][8][4];
  mma_tile<true>(
      (K + BK - 1) / BK, [&](int kt) { k0 = kt * BK; },
      [&](int m, int k) -> const float* {
        return m0 + m < R && k0 + k < K ? A_t + (size_t)(m0 + m) * K + k0 + k
                                        : nullptr;
      },
      [&](int k) -> const float* {
        return k0 + k < K ? img + band_row<WINDOW>(k0 + k, s0, s1, Wp, ww) * CH
                          : nullptr;
      },
      acc);
  float* dst0 = vox + ((size_t)nb * T + t) * R * CH;
  store_tile(
      acc,
      [&](int m) -> float* {
        return m0 + m < R ? dst0 + (size_t)(m0 + m) * CH : nullptr;
      },
      put4);
}

// Pass 1 as a kernel, grid vox_grid(): the scene is the innermost index, so
// the B CTAs of one (n, t, row block), which read the same 64 rows of A,
// are neighbours in launch order and all but the first read that A tile
// from L2 (A is 2.9 GB on the full window rig, 6.0 GB flat: one pass over
// it per batch instead of B). At batch 2 that took 0.8 % (window) and 2.4 %
// (flat) off the pass against the scene-outermost order, the same vox bit
// for bit (tools/exp_vox_order.py; PERF.md).
template <bool WINDOW>
__global__ void __launch_bounds__(THREADS)
rig_vox_mma(const float* __restrict__ ii, const float* __restrict__ A,
            const int* __restrict__ starts, float* __restrict__ vox, int B,
            int pixels, int Wp, int T, int R, int K, int ww) {
  vox_tile<WINDOW>(ii, A, starts, vox, B, pixels, Wp, T, R, K, ww, blockIdx.z,
                   blockIdx.x % B, blockIdx.y, (blockIdx.x / B) * BM);
}

inline dim3 vox_grid(int R, int T, int N, int B) {
  return dim3(B * ((R + BM - 1) / BM), T, N);
}

// Forward pass 2, the collapse: out = sum_l vox_l @ Kr[l] over all cells
// (t, v) of the bucket, as one product of depth nl*C. Row t*tile_v + v of
// the A operand is vox[t][l*tile_v + v][c] at depth l*C + c (channel-
// contiguous, A_MK; a 16-deep slice never crosses a layer); the B operand
// is Kr seen as (nl*C, n_out), so no transposed copy is needed. Rows land
// in place at (off_t + t)*tile_v + v of the scale's (N, B, rows_total,
// n_out) tiles; rows past T*tile_v are not written. grid
// (ceil(T*tile_v/BM), 1, N*B). The chain of depths in the accumulators is
// nl*C long: 1280 at nl 5, 2048 at nl 8 (rig_dkr_mma says why it matters).
__global__ void __launch_bounds__(THREADS)
rig_collapse_mma(const float* __restrict__ vox, const float* __restrict__ Kr,
                 float* __restrict__ out, int T, int nl, int tile_v, int off_t,
                 int rows_total) {
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
  const float* vox_nb = vox + (size_t)blockIdx.z * T * R * CH;
  const float* vox_l = vox_nb;   // vox_nb + layer l's rows + channel c0
  int k0 = 0;

  float acc[4][8][4];
  mma_tile<true>(
      nl * (CH / BK),
      [&](int kt) {
        k0 = kt * BK;
        vox_l = vox_nb + (size_t)(k0 / CH) * tile_v * CH + k0 % CH;
      },
      [&](int m, int k) -> const float* {
        const int row = row_of[m];
        return row < 0 ? nullptr : vox_l + (size_t)row * CH + k;
      },
      [&](int k) -> const float* { return Kr + (size_t)(k0 + k) * CH; },
      acc);
  float* dst0 = out + ((size_t)blockIdx.z * rows_total +
                       (size_t)off_t * tile_v + r0) * CH;
  store_tile(
      acc,
      [&](int m) -> float* {
        return r0 + m < cells ? dst0 + (size_t)m * CH : nullptr;
      },
      put4);
}

// Pass 2: partial dKr as one (nl*C) x n_out product whose depth runs over
// the cells (n, b, t, v) of the bucket. grid (nl*C/BM, splits): CTA
// (x, z) takes tiles [z*per, (z+1)*per) of the N*B*T tiles, each in
// ceil(tile_v/16) slices, and leaves its BM x 256 sum in ws[z]. vox rows are
// channel-contiguous, i.e. the A operand lies as [k][m].
// The tensor cores do not round their fp32 sums to nearest, and the error
// grows with the length of the chain: over a chunk of 26 k cells it reached
// 5e-5 of dKr's max (NVIDIA H100 80GB HBM3, full MultiviewC window rig). So
// a chain ends after about DKR_CHAIN depths and is added into ws[z] with
// ordinary fp32 adds (each thread re-reads the quads it wrote itself).
__global__ void __launch_bounds__(THREADS)
rig_dkr_mma(const float* __restrict__ vox, const float* __restrict__ g,
            float* __restrict__ ws, int NBT, int T, int nl, int tile_v,
            int off_t, int rows_total, int per) {
  const int l = blockIdx.x / (CH / BM);
  const int c0 = (blockIdx.x % (CH / BM)) * BM;
  const int j0 = blockIdx.y * per;
  const int j1 = min(j0 + per, NBT);
  const int steps = (tile_v + BK - 1) / BK;
  const int chain = max(1, DKR_CHAIN / (steps * BK));   // tiles per chain
  const size_t R = (size_t)nl * tile_v;
  float* dst0 = ws + (((size_t)blockIdx.y * nl + l) * CH + c0) * CH;
  auto row_ptr = [&](int m) -> float* { return dst0 + (size_t)m * CH; };

  for (int ja = j0; ja < j1; ja += chain) {
    const float* vox_v = nullptr;   // vox[tile j][l*tile_v + v0][c0]
    const float* g_v = nullptr;     // g[nb][(off_t + t)*tile_v + v0][0]
    int v0 = 0;
    float acc[4][8][4];
    mma_tile<false>(
        (min(ja + chain, j1) - ja) * steps,
        [&](int kt) {
          const int j = ja + kt / steps;
          v0 = (kt % steps) * BK;
          vox_v = vox + ((size_t)j * R + (size_t)l * tile_v + v0) * CH + c0;
          g_v = g + ((size_t)(j / T) * rows_total +
                     (size_t)(off_t + j % T) * tile_v + v0) * CH;
        },
        [&](int k, int m) -> const float* {
          return v0 + k < tile_v ? vox_v + (size_t)k * CH + m : nullptr;
        },
        [&](int k) -> const float* {
          return v0 + k < tile_v ? g_v + (size_t)k * CH : nullptr;
        },
        acc);
    if (ja == j0) {
      store_tile(acc, row_ptr, put4);
    } else {
      store_tile(acc, row_ptr, [](float* dst, const float4& v) {
        float4 d = *reinterpret_cast<float4*>(dst);
        d.x += v.x;
        d.y += v.y;
        d.z += v.z;
        d.w += v.w;
        *reinterpret_cast<float4*>(dst) = d;
      });
    }
  }
}

// Pass 2, second stage: dKr += ws[0] + ws[1] + ... in that order, 4 floats
// a thread (n = nl*C*n_out).
__global__ void __launch_bounds__(256)
rig_dkr_reduce(const float* __restrict__ ws, float* __restrict__ dKr, int n,
               int splits) {
  const int i = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int z = 1; z < splits; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(ws + (size_t)z * n + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  float4 d = *reinterpret_cast<float4*>(dKr + i);
  d.x += s.x;
  d.y += s.y;
  d.z += s.z;
  d.w += s.w;
  *reinterpret_cast<float4*>(dKr + i) = d;
}

// Pass 3: dvox_l = g[n, b, cells] @ Kr[l]^T over all cells of the bucket,
// written over the vox scratch. grid (ceil(T*tile_v/BM), nl, N*B); depth
// n_out = 256. g's rows are depth-contiguous (A_MK); KrT[l] is (n_out, C).
__global__ void __launch_bounds__(THREADS)
rig_dvox_mma(const float* __restrict__ g, const float* __restrict__ KrT,
             float* __restrict__ dvox, int T, int nl, int tile_v, int off_t,
             int rows_total) {
  const int cells = T * tile_v;
  const int r0 = blockIdx.x * BM;
  const int l = blockIdx.y;
  const size_t R = (size_t)nl * tile_v;
  const float* g_nb = g + ((size_t)blockIdx.z * rows_total +
                           (size_t)off_t * tile_v) * CH;
  const float* KrT_l = KrT + (size_t)l * CH * CH;
  int k0 = 0;

  float acc[4][8][4];
  mma_tile<true>(
      CH / BK, [&](int kt) { k0 = kt * BK; },
      [&](int m, int k) -> const float* {
        return r0 + m < cells ? g_nb + (size_t)(r0 + m) * CH + k0 + k : nullptr;
      },
      [&](int k) -> const float* { return KrT_l + (size_t)(k0 + k) * CH; },
      acc);
  float* dst0 = dvox + (size_t)blockIdx.z * T * R * CH;
  store_tile(
      acc,
      [&](int m) -> float* {
        const int rr = r0 + m;
        if (rr >= cells) return nullptr;
        return dst0 + ((size_t)(rr / tile_v) * R + (size_t)l * tile_v +
                       rr % tile_v) * CH;
      },
      put4);
}

// Pass 4: dII[band(n, b, t)] += A[n, t]^T @ dvox[n, b, t].
// grid (ceil(K/BM), T, N*B); depth R in slices of 16 (the last one may be
// ragged: zeros past R). A is read along its rows, the strided axis of the
// product, i.e. the A operand lies as [k][m]; K is a multiple of 8, so a
// quad of pixels is inside the band or past it as a whole.
template <bool WINDOW>
__global__ void __launch_bounds__(THREADS)
rig_dii_mma(const float* __restrict__ A, const int* __restrict__ starts,
            const float* __restrict__ dvox, float* __restrict__ dII, int B,
            int pixels, int Wp, int T, int R, int K, int ww) {
  const int m0 = blockIdx.x * BM;
  const int t = blockIdx.y;
  const int i = (blockIdx.z / B) * T + t;
  const int s0 = WINDOW ? starts[2 * i] : starts[i];
  const int s1 = WINDOW ? starts[2 * i + 1] : 0;
  const float* A_t = A + (size_t)i * R * K + m0;
  const float* dvox_t = dvox + ((size_t)blockIdx.z * T + t) * R * CH;
  int r0 = 0;

  float acc[4][8][4];
  mma_tile<false>(
      (R + BK - 1) / BK, [&](int kt) { r0 = kt * BK; },
      [&](int k, int m) -> const float* {
        return r0 + k < R && m0 + m < K ? A_t + (size_t)(r0 + k) * K + m
                                        : nullptr;
      },
      [&](int k) -> const float* {
        return r0 + k < R ? dvox_t + (size_t)(r0 + k) * CH : nullptr;
      },
      acc);
  float* img = dII + (size_t)blockIdx.z * pixels * CH;
  store_tile(
      acc,
      [&](int m) -> float* {
        return m0 + m < K
                   ? img + band_row<WINDOW>(m0 + m, s0, s1, Wp, ww) * CH
                   : nullptr;
      },
      add4);
}

template <class Kernel, class... Args>
inline cudaError_t launch_tile(Kernel kernel, dim3 grid, cudaStream_t s,
                               Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, SMEM_BYTES, s>>>(args...);
  return cudaGetLastError();
}

// Both passes of a forward launch. pixels = rows of one (n, b) image;
// WINDOW: K = wh*ww, Wp and ww as in band_row; flat: K = band, Wp = ww = 0.
// Kr (nl, C, n_out); vox the (N, B, T, nl*tile_v, C) scratch; out the
// scale's (N, B, rows_total, n_out) tiles, written at tile offset off_t.
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
  cudaError_t err = launch_tile(rig_vox_mma<WINDOW>, vox_grid(R, T, N, B), s,
                                ii, A, starts, vox, B, pixels, Wp, T, R, K, ww);
  if (err != cudaSuccess) return (int)err;
  err = launch_tile(rig_collapse_mma,
                    dim3((T * tile_v + BM - 1) / BM, 1, N * B), s, vox, Kr,
                    out, T, nl, tile_v, off_t, rows_total);
  return (int)err;
}

// All passes of a backward launch. pixels = rows of one (n, b) image;
// WINDOW: K = wh*ww, Wp and ww as in band_row; flat: K = band, Wp = ww = 0.
// KrT (nl, n_out, C); g the cotangent of the scale's tiles; vox the
// (N, B, T, nl*tile_v, C) scratch; ws the (DKR_MAX_SPLITS, nl, C, n_out)
// workspace of the dKr pass; dII and dKr are added to.
template <bool WINDOW>
inline int rig_bwd_launch(const float* ii, const float* A, const int* starts,
                          const float* KrT, const float* g, float* vox,
                          float* ws, float* dII, float* dKr, int N, int B,
                          int pixels, int Wp, int C, int T, int nl, int tile_v,
                          int K, int ww, int n_out, int off_t, int rows_total,
                          void* stream) {
  const int R = nl * tile_v;
  const int NB = N * B;
  if (C != CH || n_out != CH || K < 1 || K % (WINDOW ? 16 : 8) != 0 || T < 1 ||
      T > 65535 || NB < 1 || NB > 65535 || nl < 1 || tile_v < 1 ||
      (long long)NB * T * tile_v > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;

  err = launch_tile(rig_vox_mma<WINDOW>, vox_grid(R, T, N, B), s, ii, A,
                    starts, vox, B, pixels, Wp, T, R, K, ww);
  if (err != cudaSuccess) return (int)err;

  // nl*4 output tiles; as many depth chunks as fill the card's 132 SMs
  // twice (two CTAs an SM), at least one tile each
  const int NBT = NB * T;
  int splits = 264 / (nl * (CH / BM));
  splits = splits < 1 ? 1 : splits > DKR_MAX_SPLITS ? DKR_MAX_SPLITS : splits;
  const int per = (NBT + splits - 1) / splits;
  splits = (NBT + per - 1) / per;
  err = launch_tile(rig_dkr_mma, dim3(nl * (CH / BM), splits), s, vox, g, ws,
                    NBT, T, nl, tile_v, off_t, rows_total, per);
  if (err != cudaSuccess) return (int)err;
  const int n = nl * CH * CH;
  rig_dkr_reduce<<<(n / 4 + 255) / 256, 256, 0, s>>>(ws, dKr, n, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = launch_tile(rig_dvox_mma, dim3((T * tile_v + BM - 1) / BM, nl, NB), s,
                    g, KrT, vox, T, nl, tile_v, off_t, rows_total);
  if (err != cudaSuccess) return (int)err;

  err = launch_tile(rig_dii_mma<WINDOW>, dim3((K + BM - 1) / BM, T, NB), s, A,
                    starts, vox, dII, B, pixels, Wp, T, R, K, ww);
  return (int)err;
}

}  // namespace
