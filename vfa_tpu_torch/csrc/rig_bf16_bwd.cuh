// Tensor-core passes of the bf16 compiled-rig flat backward for NVIDIA
// Hopper (sm_90a) (rig_flat_bwd.cu: rig_flat_bwd_bf16, K5-bf16), on the
// wgmma bf16 tile of rig_bf16.cuh; the window backward (rig_window_bwd_bf16)
// runs on rig_ws.cuh. JAX's rounding points
// (vfa_tpu/ops/rig_pallas.py _bwd_kernel, _bwd_kernel_win_pipe,
// _bwd_kernel_win and _make_scale_op's VJP on bf16 features, A, Kr and
// cotangent):
//   pass 1: vox = A_tile @ band, bf16 products summed in fp32, NOT rounded;
//   pass 2: dKr_l += vox_l^T @ g, an fp32 operand times a bf16 one, summed in
//           fp32 (per depth chunk into a workspace, then added in a fixed
//           order, as the fp32 kernels do);
//   pass 3: dvox_l = g @ Kr_l^T, bf16 products summed in fp32, not rounded;
//   pass 4 (flat): dband = A_tile^T @ dvox, a bf16 operand times an fp32
//           one, summed in fp32, then added into the bf16 dII: each
//           element's old value plus its fp32 dband, rounded once to bf16,
//           by a compare-and-swap loop on 8 bytes (4 channels) -- the adds
//           of overlapping bands meet in the atomics' order, where the TPU
//           grid fixed one (the window backward's dII pass, rig_ws.cuh's
//           rig_wsdband + rig_dii_reduce, adds in a fixed order).
// The fp32 operand of passes 2 and 4 is kept as two bf16 planes, hi = x
// rounded to bf16 and lo = x - hi rounded to bf16 (16 significant bits, a
// residual below 2^-16 of x), and each product is two bf16 wgmma, lo first:
// Bop @ Aop_lo + Bop @ Aop_hi (pass 2) or Bop_lo @ Aop + Bop_hi @ Aop
// (pass 4). Passes 1 and 3 write their fp32 results as those planes
// straight away, into the same scratch bytes as the fp32 kernels' vox:
// pass 1 channel-major per tile (voxT[j][c][r], j = (n*B + b)*T + t, so
// that pass 2 reads it depth-contiguous, as wgmma's shared-memory operand
// wants it, without a transpose), pass 3 row-major (dvox[j][r][c], the
// register operand of pass 4). Pass 4's shared-memory operand is A read
// along its rows, [depth][pixel]: it is staged as it lies and rewritten
// transposed into wgmma's order once per slice (`prep`), as the fp32 tile
// does for its own strided operands.
// What bounds it on the H100 (SXM, 700 W): operations at the dense bf16
// rate, counted once per product whatever the split costs: twice the
// forward's. The split makes passes 2 and 4 two products each: 1.5 times
// the tensor-core work of a plain bf16 backward.
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): a batch-2 flat
// backward over the full MultiviewC rig cast to bf16 takes 44.8 ms against
// a 4.47 ms bound (PERF.md section 6).

#pragma once

#include "rig_bf16.cuh"
#include "rig_mma.cuh"   // DKR_CHAIN, DKR_MAX_SPLITS, rig_dkr_reduce: shared with fp32

namespace bft {
namespace {

constexpr int LDF = CH + 4;                // floats a row of the fp32 staging tile
constexpr int LDT = BM + 8;                // values a channel of the transposed tile

// fp32 x -> (hi, lo) bf16 with x ~= hi + lo, both rounded to nearest even.
__device__ __forceinline__ void split_bf16(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

template <int PA, int PB, bool A_TRANS>
__host__ __device__ constexpr int bwd_stage_bytes() {
  return PA * A_BYTES + PB * B_BYTES;
}

template <int PA, int PB, bool A_TRANS, int NSTAGE>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return NSTAGE * bwd_stage_bytes<PA, PB, A_TRANS>() + (A_TRANS ? 2 * A_BYTES : 0);
}

// One CTA's 64 x 256 tile of  D = sum of the products of Aop's PA parts and
// Bop's PB parts (PA == 1 or PB == 1), over nk slices of 32 depths, computed
// transposed as mma_tile does. NSTAGE >= 3 slices in flight.
//   A_TRANS false: a_src(p, m, k) -> part p of Aop[m0 + m][32*kt + k .. + 7]
//                  (8 depth-contiguous values), copied into wgmma's order;
//   A_TRANS true (PA == 1): a_src(k, m) -> Aop[m0 + m .. + 7][32*kt + k]
//                  (8 row-contiguous values of depth k), staged [k][m] and
//                  rewritten into wgmma's order by `prep` one slice ahead;
//   b_src(p, k) -> part p of Bop[32*kt + k][0 .. 255].
// Sources return a 16-byte aligned pointer or nullptr for zeros. acc as in
// mma_tile.
template <int PA, int PB, bool A_TRANS, int NSTAGE, class Seek, class ASrc,
          class BSrc>
__device__ __forceinline__ void mma_tile_split(int nk, Seek seek, ASrc a_src,
                                               BSrc b_src,
                                               float (&acc)[4][8][4]) {
  static_assert(PA == 1 || PB == 1, "one operand is split, not both");
  static_assert(!A_TRANS || PA == 1, "a transposed Aop is not split");
  static_assert(NSTAGE >= 3, "prep reads the slice after the one computed");
  constexpr int STAGE = bwd_stage_bytes<PA, PB, A_TRANS>();
  extern __shared__ __align__(128) unsigned char bsmem[];
  unsigned char* prep_buf = bsmem + NSTAGE * STAGE;   // [slice parity][A_BYTES]
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
    unsigned char* As = bsmem + (kt % NSTAGE) * STAGE;
    unsigned char* Bs = As + PA * A_BYTES;
    seek(kt);
#pragma unroll
    for (int p = 0; p < 2; ++p) {   // 256 quads of each part of Aop
      const int idx = tid + p * THREADS;
      if constexpr (A_TRANS) {
        const int k = idx >> 3;
        const int q = idx & 7;
        copy16(As + k * (BM * 2) + q * 16, a_src(k, 8 * q));
      } else {
        const int m = idx >> 2;
        const int q = idx & 3;
#pragma unroll
        for (int pa = 0; pa < PA; ++pa)
          copy16(As + pa * A_BYTES + ((m >> 3) * 4 + q) * 128 + (m & 7) * 16,
                 a_src(pa, m, 8 * q));
      }
    }
    const int r = tid >> 2;
#pragma unroll
    for (int pb = 0; pb < PB; ++pb) {
      const bf16* src = b_src(pb, r);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int c = ((tid & 3) + 4 * p) * 8;
        copy16(Bs + pb * B_BYTES + (r * LDB + c) * 2, src ? src + c : nullptr);
      }
    }
  };

  // A_TRANS: slice kt's staged [k][m] Aop into wgmma's order (8 depths of
  // one row a 16-byte quad) in the prep buffer of kt's parity.
  auto prep = [&](int kt) {
    const bf16* raw = reinterpret_cast<const bf16*>(bsmem + (kt % NSTAGE) * STAGE);
    unsigned char* dst = prep_buf + (kt & 1) * A_BYTES;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int idx = tid + p * THREADS;
      const int m = idx % BM;
      const int q = idx / BM;
      __align__(16) bf16 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = raw[(8 * q + i) * BM + m];
      *reinterpret_cast<uint4*>(dst + ((m >> 3) * 4 + q) * 128 + (m & 7) * 16) =
          *reinterpret_cast<const uint4*>(v);
    }
    // visible to wgmma's reads (the async proxy) after the next barrier
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };

  auto compute = [&](int kt) {
    const unsigned char* As = bsmem + (kt % NSTAGE) * STAGE;
    const unsigned char* Bs = As + PA * A_BYTES;
    const unsigned char* Aw = A_TRANS ? prep_buf + (kt & 1) * A_BYTES : As;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t a[PB][4][4];
      const int k = 16 * s + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int pb = 0; pb < PB; ++pb)
#pragma unroll
        for (int mb = 0; mb < 4; ++mb) {
          const int c = 64 * mb + 16 * warp + ((lane >> 3) & 1) * 8;
          ldsm_x4_trans(a[pb][mb], Bs + pb * B_BYTES + (k * LDB + c) * 2);
        }
      uint64_t d[PA];
#pragma unroll
      for (int pa = 0; pa < PA; ++pa)
        d[pa] = smem_desc(Aw + pa * A_BYTES + 256 * s, 128, 512);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
        // part 1 is the lo plane: the small product first
        if constexpr (PA == 2) wgmma_bf16(acc[mb], a[0][mb], d[1]);
        if constexpr (PB == 2) wgmma_bf16(acc[mb], a[1][mb], d[0]);
        wgmma_bf16(acc[mb], a[0][mb], d[0]);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    }
  };

  // Slice kt + NSTAGE - 1 is requested, and slice kt + 1 rewritten by prep,
  // after the barrier that ends the reading of what they overwrite (slice
  // kt - 1's stage and prep buffer, whose products every warp has waited for
  // at the end of its iteration). Each thread makes its landed copies
  // visible to wgmma's reads before the barrier.
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load(s);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  asm volatile("cp.async.wait_group %0;" ::"n"(NSTAGE - 2) : "memory");
  __syncthreads();
  if constexpr (A_TRANS) {
    if (nk > 0) prep(0);
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;" ::"n"(NSTAGE - 3) : "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (kt + NSTAGE - 1 < nk) load(kt + NSTAGE - 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    compute(kt);
    if constexpr (A_TRANS) {
      if (kt + 1 < nk) prep(kt + 1);   // while slice kt's products run
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[i][j][e])::"memory");
}

// f(row, channel, value) for each accumulator value of a CTA tile: row
// 8j + 2t + (e & 1), channel 64mb + 16 warp + g + 8 (e >> 1).
template <class F>
__device__ __forceinline__ void for_acc(const float (&acc)[4][8][4], F f) {
  const int lane = threadIdx.x & 31;
  const int cw = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int t = lane & 3;
#pragma unroll
  for (int mb = 0; mb < 4; ++mb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(8 * j + 2 * t + (e & 1), 64 * mb + cw + 8 * (e >> 1), acc[mb][j][e]);
}

// A tile split into (hi, lo) planes: channel-major (TRANS: plane[ch][row],
// written by col_ptr(p, ch) -> pointer to element (row m0, ch) of plane p,
// rows m0 .. m0 + 63 contiguous, with `rows` of them valid, a multiple of
// 8), or row-major (row_ptr(p, m) -> pointer to D[m0 + m][0] of plane p or
// nullptr). Through a staging copy in the ring's shared memory.
template <bool TRANS, class Ptr>
__device__ __forceinline__ void store_split(const float (&acc)[4][8][4],
                                            Ptr ptr, int rows) {
  extern __shared__ __align__(128) unsigned char bsmem[];
  bf16* D = reinterpret_cast<bf16*>(bsmem);
  constexpr int PLANE = TRANS ? CH * LDT : BM * LDD;
  __syncthreads();   // every warp is done reading the ring
  for_acc(acc, [&](int row, int ch, float v) {
    bf16 hi, lo;
    split_bf16(v, hi, lo);
    const int at = TRANS ? ch * LDT + row : row * LDD + ch;
    D[at] = hi;
    D[PLANE + at] = lo;
  });
  __syncthreads();
  if constexpr (TRANS) {
#pragma unroll 4
    for (int p = 0; p < 2 * CH * (BM / 8) / THREADS; ++p) {
      const int idx = threadIdx.x + p * THREADS;
      const int q = idx % (BM / 8);
      const int ch = (idx / (BM / 8)) % CH;
      const int pl = idx / (CH * BM / 8);
      if (8 * q < rows)
        *reinterpret_cast<uint4*>(ptr(pl, ch) + 8 * q) =
            *reinterpret_cast<const uint4*>(D + pl * PLANE + ch * LDT + 8 * q);
    }
  } else {
#pragma unroll 4
    for (int p = 0; p < 2 * BM * CH / 8 / THREADS; ++p) {
      const int idx = threadIdx.x + p * THREADS;
      const int c = (idx % (CH / 8)) * 8;
      const int m = (idx / (CH / 8)) % BM;
      const int pl = idx / (BM * CH / 8);
      bf16* dst = ptr(pl, m);
      if (dst)
        *reinterpret_cast<uint4*>(dst + c) =
            *reinterpret_cast<const uint4*>(D + pl * PLANE + m * LDD + c);
    }
  }
}

// A tile in fp32 through a [row][channel] staging copy, then 4 channels of a
// row at a time: put(row m, float4 v, c) for rows whose row_ok(m).
template <class RowOk, class Put>
__device__ __forceinline__ void store_f32(const float (&acc)[4][8][4],
                                          RowOk row_ok, Put put) {
  extern __shared__ __align__(128) unsigned char bsmem[];
  float* D = reinterpret_cast<float*>(bsmem);
  __syncthreads();   // every warp is done reading the ring
  for_acc(acc, [&](int row, int ch, float v) { D[row * LDF + ch] = v; });
  __syncthreads();
#pragma unroll 4
  for (int p = 0; p < BM * CH / 4 / THREADS; ++p) {
    const int idx = threadIdx.x + p * THREADS;
    const int c = (idx % (CH / 4)) * 4;
    const int m = idx / (CH / 4);
    if (row_ok(m))
      put(m, *reinterpret_cast<const float4*>(D + m * LDF + c), c);
  }
}

// dst[0 .. 3] (bf16, 8-byte aligned) += v, each sum taken in fp32 and
// rounded once to bf16; concurrent adds to the same 8 bytes retry.
__device__ __forceinline__ void add_bf16x4(bf16* dst, const float4& v) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(dst);
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(p);
  unsigned long long assumed;
  const float add[4] = {v.x, v.y, v.z, v.w};
  do {
    assumed = old;
    unsigned long long next = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = __uint_as_float((unsigned)(assumed >> (16 * i)) << 16);
      const unsigned short r = __bfloat16_as_ushort(__float2bfloat16_rn(a + add[i]));
      next |= (unsigned long long)r << (16 * i);
    }
    old = atomicCAS(p, assumed, next);
  } while (old != assumed);
}

// Pass 1: vox[n, b, t] = A[n, t] @ band(n, b, t), rows m0 .. m0 + 63, fp32
// as (hi, lo) planes of voxT (N*B*T, C, R), channel-major. grid vox_grid().
__global__ void __launch_bounds__(THREADS)
rig_bfbvox_mma(const bf16* __restrict__ ii, const bf16* __restrict__ A,
               const int* __restrict__ starts, bf16* __restrict__ voxT,
               size_t plane, int B, int pixels, int T, int R, int K) {
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
  bf16* dst0 = voxT + ((size_t)nb * T + t) * CH * R + m0;
  store_split<true>(
      acc, [&](int p, int ch) { return dst0 + p * plane + (size_t)ch * R; },
      R - m0);
}

// Pass 2: partial dKr as one (nl*C) x n_out product whose depth runs over
// the cells (n, b, t, v) of the bucket, Aop = vox_l^T from the voxT planes
// (depth-contiguous), Bop = g. grid (nl*C/BM, splits), as rig_dkr_mma
// (rig_mma.cuh), whose second stage rig_dkr_reduce adds the chunks; a chain
// of tensor-core sums ends after about DKR_CHAIN depths.
__global__ void __launch_bounds__(THREADS)
rig_bfdkr_mma(const bf16* __restrict__ voxT, size_t plane,
              const bf16* __restrict__ g, float* __restrict__ ws, int NBT,
              int T, int nl, int tile_v, int off_t, int rows_total, int per) {
  const int l = blockIdx.x / (CH / BM);
  const int c0 = (blockIdx.x % (CH / BM)) * BM;
  const int j0 = blockIdx.y * per;
  const int j1 = min(j0 + per, NBT);
  const int steps = (tile_v + BK - 1) / BK;
  const int chain = max(1, ::DKR_CHAIN / (steps * BK));   // tiles per chain
  const size_t R = (size_t)nl * tile_v;
  float* dst0 = ws + (((size_t)blockIdx.y * nl + l) * CH + c0) * CH;

  for (int ja = j0; ja < j1; ja += chain) {
    const bf16* vox_v = nullptr;   // voxT[tile j][c0][l*tile_v + v0]
    const bf16* g_v = nullptr;     // g[nb][(off_t + t)*tile_v + v0][0]
    int v0 = 0;
    float acc[4][8][4];
    mma_tile_split<2, 1, false, 4>(
        (min(ja + chain, j1) - ja) * steps,
        [&](int kt) {
          const int j = ja + kt / steps;
          v0 = (kt % steps) * BK;
          vox_v = voxT + ((size_t)j * CH + c0) * R + (size_t)l * tile_v + v0;
          g_v = g + ((size_t)(j / T) * rows_total +
                     (size_t)(off_t + j % T) * tile_v + v0) * CH;
        },
        [&](int p, int m, int k) -> const bf16* {
          return v0 + k < tile_v ? vox_v + p * plane + (size_t)m * R + k
                                 : nullptr;
        },
        [&](int p, int k) -> const bf16* {
          return v0 + k < tile_v ? g_v + (size_t)k * CH : nullptr;
        },
        acc);
    const bool first = ja == j0;
    store_f32(
        acc, [](int) { return true; },
        [&](int m, const float4& v, int c) {
          float4* d = reinterpret_cast<float4*>(dst0 + (size_t)m * CH + c);
          if (first) {
            *d = v;
          } else {
            float4 o = *d;
            o.x += v.x;
            o.y += v.y;
            o.z += v.z;
            o.w += v.w;
            *d = o;
          }
        });
  }
}

// Pass 3: dvox_l = g[n, b, cells] @ Kr[l]^T over all cells of the bucket, as
// (hi, lo) planes of dvox (N*B*T, R, C), row-major, over the voxT planes.
// grid (ceil(T*tile_v/BM), nl, N*B); depth n_out = 256.
__global__ void __launch_bounds__(THREADS)
rig_bfdvox_mma(const bf16* __restrict__ g, const bf16* __restrict__ KrT,
               bf16* __restrict__ dvox, size_t plane, int T, int nl,
               int tile_v, int off_t, int rows_total) {
  const int cells = T * tile_v;
  const int r0 = blockIdx.x * BM;
  const int l = blockIdx.y;
  const size_t R = (size_t)nl * tile_v;
  const bf16* g_nb = g + ((size_t)blockIdx.z * rows_total +
                          (size_t)off_t * tile_v) * CH;
  const bf16* KrT_l = KrT + (size_t)l * CH * CH;
  int k0 = 0;

  float acc[4][8][4];
  mma_tile(
      CH / BK, [&](int kt) { k0 = kt * BK; },
      [&](int m, int k) -> const bf16* {
        return r0 + m < cells ? g_nb + (size_t)(r0 + m) * CH + k0 + k : nullptr;
      },
      [&](int k) -> const bf16* { return KrT_l + (size_t)(k0 + k) * CH; },
      acc);
  bf16* dst0 = dvox + (size_t)blockIdx.z * T * R * CH;
  store_split<false>(
      acc,
      [&](int p, int m) -> bf16* {
        const int rr = r0 + m;
        if (rr >= cells) return nullptr;
        return dst0 + p * plane +
               ((size_t)(rr / tile_v) * R + (size_t)l * tile_v + rr % tile_v) * CH;
      },
      BM);
}

// Pass 4: dII[band(n, b, t)] += A[n, t]^T @ dvox[n, b, t], each element's
// sum rounded once to bf16. grid (ceil(K/BM), T, N*B); depth R in slices of
// 32 (the last one may be ragged: zeros past R).
__global__ void __launch_bounds__(THREADS)
rig_bfdii_mma(const bf16* __restrict__ A, const int* __restrict__ starts,
              const bf16* __restrict__ dvox, size_t plane,
              bf16* __restrict__ dII, int B, int pixels, int T, int R, int K) {
  const int m0 = blockIdx.x * BM;
  const int t = blockIdx.y;
  const int i = (blockIdx.z / B) * T + t;
  const int s0 = starts[i];
  const bf16* A_t = A + (size_t)i * R * K + m0;
  const bf16* dvox_t = dvox + ((size_t)blockIdx.z * T + t) * R * CH;
  int r0 = 0;

  float acc[4][8][4];
  mma_tile_split<1, 2, true, 3>(
      (R + BK - 1) / BK, [&](int kt) { r0 = kt * BK; },
      [&](int k, int m) -> const bf16* {
        return r0 + k < R && m0 + m < K ? A_t + (size_t)(r0 + k) * K + m
                                        : nullptr;
      },
      [&](int p, int k) -> const bf16* {
        return r0 + k < R ? dvox_t + p * plane + (size_t)(r0 + k) * CH
                          : nullptr;
      },
      acc);
  bf16* img = dII + (size_t)blockIdx.z * pixels * CH;
  store_f32(
      acc, [&](int m) { return m0 + m < K; },
      [&](int m, const float4& v, int c) {
        add_bf16x4(img + (size_t)(s0 + m0 + m) * CH + c, v);
      });
}

// Pass 2 of a flat bf16 backward launch: dKr into its workspace and added
// into dKr in a fixed order.
inline cudaError_t bwd_dkr(const bf16* g, const bf16* vox, float* ws,
                           float* dKr, int NB, int T, int nl, int tile_v,
                           int off_t, int rows_total, size_t plane,
                           cudaStream_t s) {
  // nl*4 output tiles; as many depth chunks as fill the card's 132 SMs
  // twice, at least one tile each
  const int NBT = NB * T;
  int splits = 264 / (nl * (CH / BM));
  splits = splits < 1 ? 1 : splits > ::DKR_MAX_SPLITS ? ::DKR_MAX_SPLITS : splits;
  const int per = (NBT + splits - 1) / splits;
  splits = (NBT + per - 1) / per;
  cudaError_t err = launch_smem(rig_bfdkr_mma, dim3(nl * (CH / BM), splits),
                                bwd_smem_bytes<2, 1, false, 4>(), s, vox,
                                plane, g, ws, NBT, T, nl, tile_v, off_t,
                                rows_total, per);
  if (err != cudaSuccess) return err;
  const int n = nl * CH * CH;
  ::rig_dkr_reduce<<<(n / 4 + 255) / 256, 256, 0, s>>>(ws, dKr, n, splits);
  return cudaGetLastError();
}

// All passes of a flat bf16 backward launch. pixels = rows of one (n, b)
// image, K = band. KrT (nl, n_out, C) bf16; g the scale's (N, B,
// rows_total, n_out) bf16 cotangent; vox the scratch, 2 * N*B*T*nl*tile_v*C
// bf16 (two planes); ws the (DKR_MAX_SPLITS, nl, C, n_out) fp32 workspace;
// dII (bf16) and dKr (fp32) are added to. tile_v must be a multiple of 8.
// Its dII pass adds by compare-and-swap (rig_bfdii_mma).
inline int rig_bwd_launch_flat(const bf16* ii, const bf16* A, const int* starts,
                               const bf16* KrT, const bf16* g, bf16* vox,
                               float* ws, bf16* dII, float* dKr, int N, int B,
                               int pixels, int C, int T, int nl, int tile_v,
                               int K, int n_out, int off_t, int rows_total,
                               void* stream) {
  const int R = nl * tile_v;
  const int NB = N * B;
  if (C != CH || n_out != CH || K < 1 || K % 8 != 0 || T < 1 || T > 65535 ||
      NB < 1 || NB > 65535 || nl < 1 || tile_v < 8 || tile_v % 8 != 0 ||
      (long long)NB * T * tile_v > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t plane = (size_t)NB * T * R * CH;
  cudaError_t err;

  err = launch_smem(rig_bfbvox_mma, vox_grid(R, T, N, B), SMEM_BYTES, s, ii, A,
                    starts, vox, plane, B, pixels, T, R, K);
  if (err != cudaSuccess) return (int)err;
  err = bwd_dkr(g, vox, ws, dKr, NB, T, nl, tile_v, off_t, rows_total, plane,
                s);
  if (err != cudaSuccess) return (int)err;
  err = launch_smem(rig_bfdvox_mma, dim3((T * tile_v + BM - 1) / BM, nl, NB),
                    SMEM_BYTES, s, g, KrT, vox, plane, T, nl, tile_v, off_t,
                    rows_total);
  if (err != cudaSuccess) return (int)err;
  err = launch_smem(rig_bfdii_mma, dim3((K + BM - 1) / BM, T, NB),
                    bwd_smem_bytes<1, 2, true, 3>(), s, A, starts,
                    (const bf16*)vox, plane, dII, B, pixels, T, R, K);
  return (int)err;
}

}  // namespace
}  // namespace bft
