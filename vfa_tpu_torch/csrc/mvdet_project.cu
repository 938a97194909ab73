// MVDet's projection on bf16 for NVIDIA Hopper (sm_90a): every camera's /8
// features straight into the world features, in one launch for every
// scene and camera. Serving only: nothing is saved for a backward.
//
// Replaces no TPU kernel (the JAX package has no MVDet). It replaces the
// library chain of vfa_tpu_torch/ops/projection.py::project_world_plain, a
// camera at a time: the features upsampled to the map size in fp32
// (F.interpolate, bilinear, align_corners=False), sampled at each cell's
// pixel position (F.grid_sample, bilinear, align_corners=True, zeros
// outside the map) and rounded into the bf16 world features. That chain
// writes and reads a 512-channel fp32 map of the map size a camera (8.5 GB
// at Wildtrack batch 32) and an fp32 temporary of the warp. Both maps are
// bilinear, so each cell's output is a weighted sum of source pixels of
// the /8 features:
//
//   for each (scene b, camera n, cell v, channel c):
//     (x, y) = the grid_sample coordinate of positions[n, v], unnormalised
//     for each warp tap (x0 + i, y0 + j), i, j in {0, 1}, inside the map:
//       for each of F.interpolate's 2 x 2 source taps (r, s) of that pixel:
//         weight[r, s] += wy_j * wx_i * lambda_r * lambda_s
//     out[b, n*C + c, v] = rnd(sum over (r, s) of weight[r, s] * feats[b, n, r, s, c])
//
// A row or column weight is summed over the taps that share its source
// index, so a cell has at most 3 x 3 source pixels (the map is at least the
// features' size: the wrapper refuses a smaller one). The sums are fp32
// and rounded once to bf16, as the chain rounds; their order differs from
// the chain's, so an output may differ from the chain's by one bf16 ulp,
// or, where the sum nearly cancels, by a few fp32 roundings of the
// features' size. A position that is not finite reads 0 on every tap
// (ops/projection.py::sample_grid).
//
// What bounds it on the H100 (SXM, 700 W): bytes. At Wildtrack batch 32
// (7 cameras, 512 x 90 x 160 features, a 120 x 360 grid) the features read
// once are 3.30 GB and the world features written 9.91 GB: 3.94 ms at
// 3.35 TB/s. The weights are at most 9 fused multiply-adds an output, and
// as many bf16 unpacks on the integer pipe.
//
// What the design does about it: a block takes CELLS neighbouring cells of
// one (scene, camera), and the blocks of one (scene, camera) are
// neighbours in launch order, so its 14.7 MB of features stay in the L2
// while its cells are made, and are read from device memory about once.
// The block's first CELLS threads work out each cell's (source pixel,
// weight) pairs once into shared memory, pixels of weight 0 left out. Then,
// SPAN channels a pass, each warp takes a cell at a time, a lane 8
// channels: a sum unrolled for the cell's tap count (the count is the
// warp's own), its 16-byte loads of each source pixel all issued first (a
// pixel's channels are contiguous: the trunk's output is channels-last),
// fp32 sums, a 16-byte store of the bf16 result into a [cell][channel]
// tile (16-byte chunks XOR-swizzled by the cell's group of 8, so that
// neither the stores nor the reads below conflict). Each thread
// then reads an 8 x 8 block of the tile, transposes it in registers and
// writes 8 channel rows of 8 cells as 16-byte streaming stores: each
// channel plane of the world features is written as contiguous 128-byte
// rows. A block whose cells all lie outside the map writes zeros only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CELLS = 64;               // cells a block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TAPS = 9;             // source pixels a cell: 3 rows x 3 columns
constexpr int VEC = 8;                  // channels a 16-byte vector
constexpr int SPAN = 32 * VEC;          // channels a pass: a warp's lanes
constexpr int CHUNKS = SPAN / VEC;      // 16-byte chunks of a tile row
constexpr int GROUPS = CELLS / VEC;     // groups of 8 cells a block

struct Args {
  const __nv_bfloat16* feats;           // (B, N, C, h8, w8), channels contiguous
  const float* positions;               // (N, L * W, 2) fp32
  __nv_bfloat16* out;                   // (B, K, L * W) bf16
  long long sb, sn, sh, sw;             // feats' strides in elements
  int N, C, h8, w8, h, w, K;
  long long LW;
  double sx, sy;                        // 2 / (w - 1), 2 / (h - 1)
  int vec;                              // LW % 8 == 0: rows of 8 cells are 16-byte aligned
};

// The source taps on one axis of a cell at unnormalised coordinate `u` on
// a map of `size` >= `in` pixels upsampled from `in`: grid_sample's two
// taps (floor(u) and floor(u) + 1, each inside [0, size - 1]), each
// through F.interpolate's two source taps, with PyTorch's index
// arithmetic. Both taps' source indices are the first one, first + 1 or
// first + 2 (a map pixel further on moves the source index by at most one).
// Returns that first index, or -1 if both taps lie outside; wt[s] is the
// weight of index first + s, 0 where none.
__device__ __forceinline__ int axis_taps(float u, int size, int in, float* wt) {
  const float f = floorf(u);
  const float scale = __fdiv_rn((float)in, (float)size);
  int first = -1;
#pragma unroll
  for (int s = 0; s < 3; ++s) wt[s] = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float t = f + (float)k;
    if (!(t >= 0.f && t <= (float)(size - 1))) continue;
    const float wk = k == 0 ? __fsub_rn(f + 1.f, u) : __fsub_rn(u, f);
    float src = __fmaf_rn(scale, t + 0.5f, -0.5f);
    if (src < 0.f) src = 0.f;
    const int i0 = (int)src;
    const int i1 = i0 + (i0 < in - 1 ? 1 : 0);
    const float l1 = __fsub_rn(src, (float)i0);
    const float l0 = __fsub_rn(1.f, l1);
    if (first < 0) first = i0;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (i0 - first == s) wt[s] = __fadd_rn(wt[s], __fmul_rn(wk, l0));
      if (i1 - first == s) wt[s] = __fadd_rn(wt[s], __fmul_rn(wk, l1));
    }
  }
  return first;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int m) {
  return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
}

// two fp32 values rounded to a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// acc[e] += w * channel e of the 8 bf16 channels in v (a bf16 is the high
// half of an fp32: the low channel of a word shifted up, the high masked)
__device__ __forceinline__ void fma8(float* acc, float w, const uint4& v) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const uint32_t x = word(v, m);
    acc[2 * m] = __fmaf_rn(w, __uint_as_float(x << 16), acc[2 * m]);
    acc[2 * m + 1] = __fmaf_rn(w, __uint_as_float(x & 0xffff0000u), acc[2 * m + 1]);
  }
}

struct Tap {
  int off;        // the source pixel's offset in the camera's features (elements)
  float w;        // its weight
};

// acc += the sum over a cell's NT taps of weight * the 8 channels at src +
// offset: all NT loads issued before the first product
template <int NT>
__device__ __forceinline__ void cell_sum(float* acc, const __nv_bfloat16* src, const Tap* taps) {
  uint4 x[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) x[j] = __ldg(reinterpret_cast<const uint4*>(src + taps[j].off));
#pragma unroll
  for (int j = 0; j < NT; ++j) fma8(acc, taps[j].w, x[j]);
}

// 8 cells of one channel row from dst on: a 16-byte streaming store where
// the row is aligned and whole, else the cells that lie in the grid
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const uint4& v, long long cells,
                                          bool vec) {
  if (vec && cells >= VEC) {
    __stcs(reinterpret_cast<uint4*>(dst), v);
    return;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (i < cells) dst[i] = __ushort_as_bfloat16((unsigned short)(word(v, i / 2) >> (16 * (i & 1))));
  }
}

// 4 blocks an SM: 64 registers, no spills (3 blocks: 72, 11 % slower)
__global__ void __launch_bounds__(THREADS, 4)
mvdet_project_kernel(Args a, long long runs) {
  __shared__ Tap taps[CELLS][MAX_TAPS];
  __shared__ int tap_n[CELLS];
  __shared__ uint4 tile[CELLS][CHUNKS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bn = blockIdx.x / runs;
  const long long v0 = (blockIdx.x % runs) * CELLS;
  const int n = (int)(bn % a.N);
  const long long b = bn / a.N;

  int mine = 0;
  if (tid < CELLS && v0 + tid < a.LW) {
    const float* p = a.positions + ((long long)n * a.LW + v0 + tid) * 2;
    // sample_grid: the grid coordinate in fp64, one rounding a step, then fp32;
    // grid_sample's unnormalising (align_corners=True) in fp32
    const float gx = (float)__dadd_rn(__dmul_rn((double)p[0], a.sx), -1.0);
    const float gy = (float)__dadd_rn(__dmul_rn((double)p[1], a.sy), -1.0);
    if (isfinite(gx) && isfinite(gy)) {
      const float ux = __fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), 0.5f), (float)(a.w - 1));
      const float uy = __fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), 0.5f), (float)(a.h - 1));
      float rw[3], cw[3];
      const int r0 = axis_taps(uy, a.h, a.h8, rw);
      const int c0 = r0 < 0 ? -1 : axis_taps(ux, a.w, a.w8, cw);
      if (c0 >= 0) {
        // the pixels of weight 0 add nothing to a sum of finite products: left out
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float wt = __fmul_rn(rw[i], cw[j]);
            if (wt != 0.f) {
              taps[tid][mine++] = {(int)((r0 + i) * a.sh + (c0 + j) * a.sw), wt};
            }
          }
        }
      }
    }
    tap_n[tid] = mine;
  } else if (tid < CELLS) {
    tap_n[tid] = 0;
  }
  const bool any = __syncthreads_or(mine > 0);

  const long long left = a.LW - v0;                 // cells of the block inside the grid
  __nv_bfloat16* plane = a.out + (b * a.K + (long long)n * a.C) * a.LW + v0;
  const bool vec = a.vec != 0;
  if (!any) {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < a.C * GROUPS; i += THREADS) {
      const int c = i / GROUPS, g = i % GROUPS;
      if (g * VEC < left) store_row(plane + c * a.LW + g * VEC, zero, left - g * VEC, vec);
    }
    return;
  }

  const __nv_bfloat16* img = a.feats + b * a.sb + (long long)n * a.sn;
  const int g = tid % GROUPS, kc = tid / GROUPS;    // the transpose's 8 x 8 block
  for (int c0 = 0; c0 < a.C; c0 += SPAN) {
    const __nv_bfloat16* src = img + c0 + lane * VEC;
    for (int k = warp; k < CELLS; k += WARPS) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
      // the tap count is the warp's own: one unrolled sum for each count
      switch (tap_n[k]) {
        case 1: cell_sum<1>(acc, src, taps[k]); break;
        case 2: cell_sum<2>(acc, src, taps[k]); break;
        case 3: cell_sum<3>(acc, src, taps[k]); break;
        case 4: cell_sum<4>(acc, src, taps[k]); break;
        case 5: cell_sum<5>(acc, src, taps[k]); break;
        case 6: cell_sum<6>(acc, src, taps[k]); break;
        case 7: cell_sum<7>(acc, src, taps[k]); break;
        case 8: cell_sum<8>(acc, src, taps[k]); break;
        case 9: cell_sum<9>(acc, src, taps[k]); break;
        default: break;           // no tap: zeros
      }
      uint4 r;
      r.x = pack(acc[0], acc[1]);
      r.y = pack(acc[2], acc[3]);
      r.z = pack(acc[4], acc[5]);
      r.w = pack(acc[6], acc[7]);
      tile[k][lane ^ ((k / VEC) & 7)] = r;
    }
    __syncthreads();
    // thread (g, kc): cells 8g .. 8g + 7, channels c0 + 8kc .. + 7; row j of
    // the output: channel j of each cell, taken from the words of x[r] that hold it
    uint4 x[VEC];
#pragma unroll
    for (int r = 0; r < VEC; ++r) x[r] = tile[g * VEC + r][kc ^ (g & 7)];
    if (g * VEC < left) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
        const int m = j / 2;
        const uint4 row = make_uint4(__byte_perm(word(x[0], m), word(x[1], m), sel),
                                     __byte_perm(word(x[2], m), word(x[3], m), sel),
                                     __byte_perm(word(x[4], m), word(x[5], m), sel),
                                     __byte_perm(word(x[6], m), word(x[7], m), sel));
        store_row(plane + (long long)(c0 + kc * VEC + j) * a.LW + g * VEC, row,
                  left - g * VEC, vec);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// feats (B, N, C, h8, w8) bf16 with strides sb, sn, 1, sh, sw (elements;
// each a multiple of 8, the pointer 16-byte aligned), C a multiple of 256;
// positions (N, L, W, 2) fp32 pixel positions on maps of h x w (h >= h8,
// w >= w8, both >= 2);
// out (B, K, L, W) bf16 with K >= N * C, channels [0, N * C) written.
// sx = 2 / (w - 1), sy = 2 / (h - 1) in fp64. Returns a cudaError_t.
extern "C" int mvdet_project_bf16(const void* feats, const void* positions, void* out,
                                  long long sb, long long sn, long long sh, long long sw,
                                  int B, int N, int C, int h8, int w8, int h, int w, int L,
                                  int W, int K, double sx, double sy, void* stream) {
  if (B < 0 || N < 1 || C < SPAN || C % SPAN || h8 < 1 || w8 < 1 || h < 2 || w < 2
      || h < h8 || w < w8 || L < 0 || W < 0 || K < N * C) {
    return (int)cudaErrorInvalidValue;
  }
  const long long LW = (long long)L * W;
  const long long runs = (LW + CELLS - 1) / CELLS;
  const long long blocks = (long long)B * N * runs;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a = {static_cast<const __nv_bfloat16*>(feats), static_cast<const float*>(positions),
            static_cast<__nv_bfloat16*>(out), sb, sn, sh, sw, N, C, h8, w8, h, w, K, LW,
            sx, sy, (int)(LW % VEC == 0)};
  mvdet_project_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, runs);
  return (int)cudaGetLastError();
}
