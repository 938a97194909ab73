// Backward of the fused stem tail GroupNorm(16) + ReLU + 3x3 / stride 2 /
// pad 1 max-pool for NVIDIA Hopper (sm_90a), fp32, NCHW.
//
// Replaces vfa_tpu/ops/stem.py::_b1_kernel and ::_b2_kernel (the two TPU
// Pallas kernels launched by _pallas_bwd) and their shared _recompute_dz.
// Nothing of the forward is stored but its input x and the GroupNorm's
// per-(image, group) mean and rstd: both kernels recompute
//
//     z  = a * x + b            a = rstd * scale, b = -a * mean + bias
//     av = relu(z)
//     dz[h, w] = sum of dy[oh, ow] over the pool windows (oh, ow) whose
//                FIRST maximum in row-major order is (h, w), if av > 0
//
// (padding never wins: it counts as -inf) and then
//   stem_bwd_stats (for _b1_kernel): per (image, channel) the four sums
//       sum dz*scale, sum dz*scale*xhat, sum dz*xhat, sum dz
//     with xhat = (x - mean) * rstd, into acc (M, 4, C);
//   stem_bwd_dx (for _b2_kernel):
//       dx = rstd * (dz * scale - c1 - xhat * c2)
//     with c1, c2 the per-(image, group) means of the first two sums,
//     reduced between the two launches by the caller.
//
// What bounds it on the H100 (SXM, 700 W): bytes. It is no matrix product;
// at the full MultiviewC stem (x (14, 64, 360, 640) fp32 at batch 2) x is
// 826 MB and is read by both kernels, dy (206 MB) likewise, dx (826 MB) is
// written once: 2.9 GB, 0.87 ms at 3.35 TB/s, against ~40 comparisons per
// pixel on the CUDA cores.
//
// Which pixel is a maximum, and whether it passes the ReLU, is decided on
// the recomputed z, so it must equal the forward's bit for bit: mean and
// rstd are the forward's own, and a, b, z are rounded as native_group_norm's
// CUDA kernel rounds them (a one product, b and z one fused multiply-add
// each).
//
// What the design does about it: NCHW makes every (image, channel) plane a
// plain 2D problem with scalar statistics. One CTA stages relu(z) of a
// 16 x 64 pixel tile plus its halo (1 pixel up and left, 2 down and right)
// in shared memory (x is read from device memory about 1.2 times, rows
// coalesced along W), finds once per pool window that touches the tile the
// position of its first maximum (9 reads per window; a pixel-by-pixel test
// would read ~18 per pixel, four times as many windows' worth), and then
// every thread sums, for its pixels, dy of the (at most 2 x 2) windows whose
// first maximum they are. The TPU kernels' (W/2, 2C) column pairing, lane
// rolls, halo strips and row-block size search are lane and VMEM
// workarounds and are not carried over; any H, W >= 1 is taken (an odd size
// pools to ceil).
// Both kernels run one CTA per tile, tiles of a plane next to each other in
// the grid so that neighbouring CTAs stream neighbouring columns of the
// same rows. stem_bwd_stats reduces a tile's two sums in the block and
// writes them to a (plane, tile) scratch; a second small kernel adds each
// plane's tiles in a fixed tree. Two stages, no atomics: the sums' order
// is the same from run to run (it is another order than the plain
// version's, so the two agree to fp32 rounding).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TH = 16;            // tile rows (even: tiles start on a window)
constexpr int TW = 64;            // tile columns (even)
constexpr int AH = TH + 3;        // staged rows: h0 - 1 .. h0 + TH + 1
constexpr int AW = TW + 3;
constexpr int WH = TH / 2 + 1;    // pool windows touching the tile
constexpr int WW = TW / 2 + 1;
constexpr int STEM_THREADS = 256; // TW x 4
constexpr int ROWS_PER_PASS = STEM_THREADS / TW;
constexpr int NPARAM = 8;         // floats per plane in `params`

// What a CTA keeps of one tile: relu(z) with the halo, and per pool window
// the position (0..8, row-major in the window) of its first maximum and
// its dy; position -1 marks a window outside the output.
struct Tile {
  float a[AH][AW + 1];
  float wdy[WH][WW];
  signed char warg[WH][WW];
};

// per-plane scalars: mean, rstd, scale, bias, c1, c2 packed by the caller,
// a and b derived here
struct Plane {
  float mean, rstd, scale, c1, c2, a, b;
};

__device__ __forceinline__ Plane load_plane(const float* __restrict__ params,
                                            int plane) {
  const float* p = params + (size_t)plane * NPARAM;
  const float a = p[1] * p[2];
  return Plane{p[0], p[1], p[2], p[4], p[5], a, fmaf(-a, p[0], p[3])};
}

// Stage the tile at (h0, w0): relu(z) with -inf outside the image (the
// pool's padding), then each window's first maximum. Ends synchronised.
__device__ __forceinline__ void stage_tile(const float* __restrict__ xp,
                                           const float* __restrict__ dyp,
                                           int H, int W, int OH, int OW,
                                           int h0, int w0, float ca, float cb,
                                           Tile& t) {
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  for (int r = ty; r < AH; r += ROWS_PER_PASS) {
    const int h = h0 - 1 + r;
    for (int c = tx; c < AW; c += TW) {
      const int w = w0 - 1 + c;
      float v = -INFINITY;
      if (h >= 0 && h < H && w >= 0 && w < W)
        v = fmaxf(fmaf(ca, xp[(size_t)h * W + w], cb), 0.f);
      t.a[r][c] = v;
    }
  }
  __syncthreads();
  // window (i, j) is output (h0/2 + i, w0/2 + j) and covers staged rows
  // 2i .. 2i+2, columns 2j .. 2j+2; strict > keeps the first maximum
  for (int k = threadIdx.x; k < WH * WW; k += STEM_THREADS) {
    const int i = k / WW, j = k % WW;
    const int oh = h0 / 2 + i, ow = w0 / 2 + j;
    int arg = -1;
    float d = 0.f;
    if (oh < OH && ow < OW) {
      float best = t.a[2 * i][2 * j];
      arg = 0;
#pragma unroll
      for (int q = 1; q < 9; ++q) {
        const float u = t.a[2 * i + q / 3][2 * j + q % 3];
        if (u > best) {
          best = u;
          arg = q;
        }
      }
      d = dyp[(size_t)oh * OW + ow];
    }
    t.warg[i][j] = (signed char)arg;
    t.wdy[i][j] = d;
  }
  __syncthreads();
}

// dz of the tile's pixel (r, c), 0 <= r < TH, 0 <= c < TW: dy of every
// window whose first maximum it is, if it passes the ReLU. Window o covers
// 2o-1 .. 2o+1, so an even coordinate lies in one window (at offset 1) and
// an odd one in two (offset 2 of the lower, 0 of the upper).
__device__ __forceinline__ float pixel_dz(const Tile& t, int r, int c) {
  if (!(t.a[r + 1][c + 1] > 0.f)) return 0.f;
  const int i = r >> 1, j = c >> 1;
  const int dr = 1 + (r & 1), dc = 1 + (c & 1);
  float dz = t.warg[i][j] == dr * 3 + dc ? t.wdy[i][j] : 0.f;
  if (c & 1) dz += t.warg[i][j + 1] == dr * 3 ? t.wdy[i][j + 1] : 0.f;
  if (r & 1) {
    dz += t.warg[i + 1][j] == dc ? t.wdy[i + 1][j] : 0.f;
    if (c & 1) dz += t.warg[i + 1][j + 1] == 0 ? t.wdy[i + 1][j + 1] : 0.f;
  }
  return dz;
}

// Sum v over the CTA in a fixed tree; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < (int)blockDim.x / 32; ++i) total += red[i];
  return total;
}

// Stage 1. grid (tiles_w * tiles_h, M*C): the tile's sum dz and sum
// dz*xhat into partial[plane][tile][0..1].
__global__ void __launch_bounds__(STEM_THREADS)
stem_bwd_stats_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                      const float* __restrict__ params,
                      float* __restrict__ partial, int H, int W, int OH, int OW,
                      int tiles_w) {
  __shared__ Tile tile;
  __shared__ float red[STEM_THREADS / 32];
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int plane = blockIdx.y;
  const Plane pl = load_plane(params, plane);
  const float* xp = x + (size_t)plane * H * W;
  const float* dyp = dy + (size_t)plane * OH * OW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;

  stage_tile(xp, dyp, H, W, OH, OW, h0, w0, pl.a, pl.b, tile);
  float s_dz = 0.f, s_dzx = 0.f;
#pragma unroll
  for (int r = ty; r < TH; r += ROWS_PER_PASS) {
    const int h = h0 + r, w = w0 + tx;
    if (h >= H || w >= W) continue;
    const float dz = pixel_dz(tile, r, tx);
    if (dz != 0.f) {
      s_dz += dz;
      s_dzx += dz * ((xp[(size_t)h * W + w] - pl.mean) * pl.rstd);
    }
  }
  s_dz = block_sum(s_dz, red);
  s_dzx = block_sum(s_dzx, red);
  if (threadIdx.x == 0) {
    float* out = partial + ((size_t)plane * gridDim.x + blockIdx.x) * 2;
    out[0] = s_dz;
    out[1] = s_dzx;
  }
}

// Stage 2. grid (M*C), 128 threads: add the plane's tiles and write the
// four sums of acc (M, 4, C).
__global__ void __launch_bounds__(128)
stem_bwd_stats_reduce_kernel(const float* __restrict__ partial,
                             const float* __restrict__ params,
                             float* __restrict__ acc, int C, int tiles) {
  __shared__ float red[128 / 32];
  const int plane = blockIdx.x;
  const float* p = partial + (size_t)plane * tiles * 2;
  float s_dz = 0.f, s_dzx = 0.f;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    s_dz += p[2 * t];
    s_dzx += p[2 * t + 1];
  }
  s_dz = block_sum(s_dz, red);
  s_dzx = block_sum(s_dzx, red);
  if (threadIdx.x == 0) {
    const float scale = params[(size_t)plane * NPARAM + 2];
    const int m = plane / C, c = plane % C;
    float* out = acc + (size_t)m * 4 * C + c;
    out[0 * C] = s_dz * scale;
    out[1 * C] = s_dzx * scale;
    out[2 * C] = s_dzx;
    out[3 * C] = s_dz;
  }
}

// grid (tiles_w * tiles_h, M*C): one CTA per tile.
__global__ void __launch_bounds__(STEM_THREADS)
stem_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                   const float* __restrict__ params, float* __restrict__ dx,
                   int H, int W, int OH, int OW, int tiles_w) {
  __shared__ Tile tile;
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int plane = blockIdx.y;
  const Plane pl = load_plane(params, plane);
  const float* xp = x + (size_t)plane * H * W;
  const float* dyp = dy + (size_t)plane * OH * OW;
  float* dxp = dx + (size_t)plane * H * W;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;

  stage_tile(xp, dyp, H, W, OH, OW, h0, w0, pl.a, pl.b, tile);
#pragma unroll
  for (int r = ty; r < TH; r += ROWS_PER_PASS) {
    const int h = h0 + r, w = w0 + tx;
    if (h >= H || w >= W) continue;
    const float dz = pixel_dz(tile, r, tx);
    const float xhat = (xp[(size_t)h * W + w] - pl.mean) * pl.rstd;
    dxp[(size_t)h * W + w] = pl.rstd * (dz * pl.scale - pl.c1 - xhat * pl.c2);
  }
}

inline bool stem_shapes_ok(int M, int C, int H, int W) {
  return M >= 1 && C >= 1 && H >= 1 && W >= 1 &&
         (long long)M * C <= 65535 &&
         (long long)H * W < (1LL << 31);
}

}  // namespace

// x (M, C, H, W) fp32; dy (M, C, OH, OW) fp32 with OH = (H - 1) / 2 + 1, OW
// likewise; params (M*C, 8) fp32 per plane (mean, rstd, scale, bias, c1,
// c2, unused, unused; c1 and c2 are not read here); partial scratch
// (M*C, ceil(H/16) * ceil(W/64), 2) fp32; acc (M, 4, C) fp32, written.
// All contiguous. Returns a cudaError_t (0 = both stages launched).
extern "C" int stem_bwd_stats_f32(const float* x, const float* dy,
                                  const float* params, float* partial,
                                  float* acc, int M, int C, int H, int W,
                                  void* stream) {
  if (!stem_shapes_ok(M, C, H, W)) return (int)cudaErrorInvalidValue;
  const int OH = (H - 1) / 2 + 1, OW = (W - 1) / 2 + 1;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(tiles_w * tiles_h, M * C);
  stem_bwd_stats_kernel<<<grid, STEM_THREADS, 0, s>>>(
      x, dy, params, partial, H, W, OH, OW, tiles_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stem_bwd_stats_reduce_kernel<<<M * C, 128, 0, s>>>(partial, params, acc, C,
                                                     tiles_w * tiles_h);
  return (int)cudaGetLastError();
}

// As stem_bwd_stats_f32, with c1, c2 filled in; dx (M, C, H, W) fp32,
// written.
extern "C" int stem_bwd_dx_f32(const float* x, const float* dy,
                               const float* params, float* dx, int M, int C,
                               int H, int W, void* stream) {
  if (!stem_shapes_ok(M, C, H, W)) return (int)cudaErrorInvalidValue;
  const int OH = (H - 1) / 2 + 1, OW = (W - 1) / 2 + 1;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  dim3 grid(tiles_w * tiles_h, M * C);
  stem_bwd_dx_kernel<<<grid, STEM_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, dy, params, dx, H, W, OH, OW, tiles_w);
  return (int)cudaGetLastError();
}
