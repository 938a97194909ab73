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
// written once: 1.03 GB (0.31 ms at 3.35 TB/s) for stem_bwd_stats, 1.86 GB
// (0.55 ms) for stem_bwd_dx. The window scans are a few tens of operations
// a pixel on the CUDA cores, close enough to the bytes that the instruction
// count decides whether the read-only stem_bwd_stats gets near its bound.
//
// Which pixel is a maximum, and whether it passes the ReLU, is decided on
// the recomputed z, so it must equal the forward's bit for bit: mean and
// rstd are the forward's own, and a, b, z are rounded as native_group_norm's
// CUDA kernel rounds them (a one product, b and z one fused multiply-add
// each), written with intrinsics so that no contraction rounds them
// otherwise.
//
// What the design does about it: every (image, channel) plane is a plain 2D
// problem with scalar statistics, and the work is cut into independent warp
// items. A warp takes one plane, a strip of STRIP pool-window rows and a
// 128-column segment, lane l owning the four columns c .. c+3, c = segment
// start + 4 l (its two pool windows ow = c/2, c/2 + 1; one 16-byte copy a
// row where the rows allow it), and walks the strip one window row (two
// pixel rows) at a time:
//   - a ring of STEM_STAGES row pairs (and dy's rows) in the warp's own
//     shared memory is filled by cp.async, so that several row pairs are in
//     flight while one is worked on without holding them in registers; the
//     warp waits on its own copies and syncs with __syncwarp only;
//   - the left neighbour column (c - 1) and, for stem_bwd_dx, the two right
//     ones (c + 4, c + 5) come from the neighbouring lanes by shuffle (lanes
//     0 and 31 copy them beside the segment);
//   - the odd pixel row shared by window rows oh and oh + 1 stays in
//     registers, so each x row is read once, plus one row above a strip
//     (and, for stem_bwd_dx, two below).
// stem_bwd_stats needs no dz of a pixel: sum dz is the sum of the dy that
// the windows give, and sum dz*xhat the sum of each window's dy times the
// xhat of its first maximum. A lane scans its own two windows, carrying the
// x of the maximum, adds dy and dy*xhat in registers over the strip,
// reduces both once across the warp at its end and writes the item's pair
// to a (plane, item) scratch; a second small kernel adds each plane's items
// in a fixed tree. Two stages, no atomics: the sums' order is the same from
// run to run (another order than the plain version's, so the two agree to
// fp32 rounding). stem_bwd_dx needs dz of each of its pixels: a lane also
// scans the next lane's first window (whose left column is its own last),
// so that every contribution to its four columns is its own, adds each
// window's dy to its maximum in row-major window order (as max_pool2d's
// backward does) and carries the odd row's dz to the next window row. Any
// H, W >= 1 is taken (an odd size pools to ceil): the 16-byte path needs
// W % 4 == 0 and aligned planes, the scalar path takes the rest.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Window rows of a warp item and row pairs in a warp's ring, chosen on the
// card (PERF.md, Findings): short strips keep the warps that run at one time
// on a compact stretch of x, whose halo rows then come from L2. STRIP must
// equal ops/stem.py::STRIP, which sizes stem_bwd_stats' scratch.
constexpr int STRIP = 5;
constexpr int STEM_STAGES = 4;
constexpr int SEG = 128;          // columns of a warp item: 32 lanes x 4
constexpr int STEM_WARPS = 4;     // warps (independent items) per CTA
// A ring stage: two pixel rows of RW floats (column c0 - 1 at 3, c0 .. c0 +
// 127 at 4 .., c0 + 128 and c0 + 129 at 132, 133; c0 the segment's first)
// and dy's window row (window c0 / 2 + j at j, 0 <= j <= 64).
constexpr int RW = 136;
constexpr int STAGE = 2 * RW + 72;
constexpr int NPARAM = 8;         // floats per plane in `params`
constexpr unsigned FULL = 0xffffffffu;

// per-plane scalars: mean, rstd, scale, bias, c1, c2 packed by the caller,
// a and b derived here
struct Plane {
  float mean, rstd, scale, c1, c2, a, b;
};

__device__ __forceinline__ Plane load_plane(const float* __restrict__ params,
                                            int plane) {
  const float* p = params + (size_t)plane * NPARAM;
  const float a = __fmul_rn(p[1], p[2]);
  return Plane{p[0], p[1], p[2], p[4], p[5], a, __fmaf_rn(-a, p[0], p[3])};
}

// In lanes where `active`: copy N bytes from src to shared dst without the
// registers, or zeros if !full (src is then not read, but is a valid
// address all the same).
template <int N>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool full, bool active = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? N : 0;
  if constexpr (N == 16)
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %3, 0;\n"
        "@p cp.async.cg.shared.global [%0], [%1], 16, %2; }\n" ::"r"(d),
        "l"(src), "r"(n), "r"((int)active));
  else
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %4, 0;\n"
        "@p cp.async.ca.shared.global [%0], [%1], %2, %3; }\n" ::"r"(d),
        "l"(src), "n"(N), "r"(n), "r"((int)active));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// What a lane copies and where, fixed for an item. Own columns c .. c+3;
// lane 0 also copies the left column (the 16-byte path: c-2 and c-1 to 2,
// 3; the scalar one c-1 to 3), lane 31, where `right`, the columns c+4,
// c+5 to 132, 133 and dy's window c/2 + 2 to 64. `lim`: +inf for the
// columns c-1 .. c+5 inside the image, -inf outside.
struct Lane {
  int lane, c, hoff;
  bool halo, halo_in, halo2_in, dy_in, dy2_in, dy_next, dy_next_in;
  float lim[7];
};

template <bool VEC>
__device__ __forceinline__ Lane lane_of(int lane, int c, int W, int OW,
                                        bool right) {
  Lane L;
  L.lane = lane;
  L.c = c;
  L.halo = lane == 0 || (right && lane == 31);
  L.halo_in = lane == 0 ? c > 0 : c + 4 < W;
  L.halo2_in = c + 5 < W;
  L.hoff = !L.halo_in ? 0 : lane == 0 ? (VEC ? -2 : -1) : 4;
  const int ow = c >> 1;
  L.dy_in = ow < OW;
  L.dy2_in = ow + 1 < OW;
  L.dy_next = right && lane == 31;
  L.dy_next_in = ow + 2 < OW;
#pragma unroll
  for (int j = 0; j < 7; ++j)
    L.lim[j] = c - 1 + j >= 0 && c - 1 + j < W ? INFINITY : -INFINITY;
  return L;
}

// Start the copies of pixel row h (zeros unless `in`) into the row buffer
// `dst`. `xs` points at the plane's row 0, column c (clamped into the row).
template <bool VEC>
__device__ __forceinline__ void fill_row(float* dst, const float* xs,
                                         const Lane& L, int h, bool in,
                                         int W) {
  const float* row = xs + (size_t)(in ? h : 0) * W;
  if (VEC) {  // W % 4 == 0: four columns are all inside or all outside
    cp_async<16>(dst + 4 + 4 * L.lane, row, in && L.c < W);
    cp_async<8>(dst + (L.lane == 0 ? 2 : 132), row + L.hoff, in && L.halo_in,
                L.halo);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool ok = L.c + k < W;
      cp_async<4>(dst + 4 + 4 * L.lane + k, ok ? row + k : row, in && ok);
    }
    cp_async<4>(dst + (L.lane == 0 ? 3 : 132), row + L.hoff, in && L.halo_in,
                L.halo);
    cp_async<4>(dst + 133, L.halo2_in ? row + 5 : row, in && L.halo2_in,
                L.halo && L.lane == 31);
  }
}

// Start the copies of window row oh into the ring stage `st`: pixel rows
// 2oh and 2oh + 1 and dy's row oh (`dys` at the plane's window c/2, clamped
// into the row), zeros outside the image and the output.
template <bool VEC>
__device__ __forceinline__ void fill_stage(float* st, const float* xs,
                                           const float* dys, const Lane& L,
                                           int oh, int H, int W, int OH,
                                           int OW) {
  fill_row<VEC>(st, xs, L, 2 * oh, 2 * oh < H, W);
  fill_row<VEC>(st + RW, xs, L, 2 * oh + 1, 2 * oh + 1 < H, W);
  const bool in = oh < OH;
  const float* row = dys + (size_t)(in ? oh : 0) * OW;
  float* dst = st + 2 * RW;
  if (VEC) {  // OW even: two windows are both inside or both outside
    cp_async<8>(dst + 2 * L.lane, row, in && L.dy_in);
  } else {
    cp_async<4>(dst + 2 * L.lane, row, in && L.dy_in);
    cp_async<4>(dst + 2 * L.lane + 1, L.dy2_in ? row + 1 : row, in && L.dy2_in);
  }
  cp_async<4>(dst + 64, L.dy_next_in ? row + 2 : row, in && L.dy_next_in,
              L.dy_next);
}

// The lane's view of one pixel row of a filled buffer: x and relu(z) of the
// N columns c-1 .. c-2+N (relu(z) -inf outside the image, the pool's
// padding; x 0 there).
template <int N>
struct Row {
  float x[N], v[N];
};

template <int N>
__device__ __forceinline__ Row<N> row_of(const float* row, const Lane& L,
                                         bool in, const Plane& pl) {
  const float4 own = *reinterpret_cast<const float4*>(row + 4 + 4 * L.lane);
  float left = __shfl_up_sync(FULL, own.w, 1);
  if (L.lane == 0) left = row[3];
  Row<N> out;
  out.x[0] = left;
  out.x[1] = own.x;
  out.x[2] = own.y;
  out.x[3] = own.z;
  out.x[4] = own.w;
  if constexpr (N == 7) {
    out.x[5] = __shfl_down_sync(FULL, own.x, 1);
    out.x[6] = __shfl_down_sync(FULL, own.y, 1);
    if (L.lane == 31) {
      out.x[5] = row[132];
      out.x[6] = row[133];
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    out.v[j] = in ? fminf(fmaxf(__fmaf_rn(pl.a, out.x[j], pl.b), 0.f), L.lim[j])
                  : -INFINITY;
  return out;
}

// The first maximum (row-major, strict >) of the window on columns s .. s+2
// of rows t, m, u: its value in `best`, its x in `xbest`, its position
// 0..8 returned.
template <int N>
__device__ __forceinline__ int first_max(const Row<N>& t, const Row<N>& m,
                                         const Row<N>& u, int s, float& best,
                                         float& xbest) {
  best = t.v[s];
  xbest = t.x[s];
  int arg = 0;
#pragma unroll
  for (int q = 1; q < 9; ++q) {
    const Row<N>& r = q < 3 ? t : q < 6 ? m : u;
    const int j = s + q % 3;
    if (r.v[j] > best) {
      best = r.v[j];
      xbest = r.x[j];
      arg = q;
    }
  }
  return arg;
}

// Start a warp item's copies: pixel row 2*oh0 - 1 into the second row of
// the ring's last slot (which the walk refills only after reading it), then
// the ring's first STEM_STAGES - 1 window rows (up to `last`); wait for the
// first. Returns that row as Row<N>.
template <bool VEC, int N>
__device__ __forceinline__ Row<N> start_walk(float* ring, const float* xs,
                                             const float* dys, const Lane& L,
                                             const Plane& pl, int H, int W,
                                             int OH, int OW, int oh0,
                                             int last) {
  float* top_row = ring + (STEM_STAGES - 1) * STAGE + RW;
  fill_row<VEC>(top_row, xs, L, 2 * oh0 - 1, oh0 > 0, W);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STEM_STAGES - 1; ++s) {
    if (oh0 + s <= last)
      fill_stage<VEC>(ring + s * STAGE, xs, dys, L, oh0 + s, H, W, OH, OW);
    cp_async_commit();
  }
  cp_async_wait<STEM_STAGES - 1>();
  __syncwarp();
  const Row<N> top = row_of<N>(top_row, L, oh0 > 0, pl);
  __syncwarp();
  return top;
}

// Wait for window row oh of the ring (slot `slot`) after starting the copies
// of window row oh + STEM_STAGES - 1 (if it is at most `last`) into the
// slot read before.
template <bool VEC>
__device__ __forceinline__ const float* next_stage(float* ring, int slot,
                                                   const float* xs,
                                                   const float* dys,
                                                   const Lane& L, int oh,
                                                   int last, int H, int W,
                                                   int OH, int OW) {
  if (oh + STEM_STAGES - 1 <= last)
    fill_stage<VEC>(ring + ((slot + STEM_STAGES - 1) % STEM_STAGES) * STAGE, xs,
                    dys, L, oh + STEM_STAGES - 1, H, W, OH, OW);
  cp_async_commit();
  cp_async_wait<STEM_STAGES - 1>();  // this lane's copies of window row oh
  __syncwarp();                      // and every other lane's
  return ring + slot * STAGE;
}

// One warp item of stem_bwd_stats: window rows oh0 .. oh1-1 of the plane,
// the lane's windows c/2 and c/2 + 1. Returns the lane's sum of the dy its
// windows give (.x) and of dy * xhat at each window's maximum (.y).
template <bool VEC>
__device__ __forceinline__ float2 stats_walk(const float* xs, const float* dys,
                                             float* ring, const Lane& L,
                                             const Plane& pl, int H, int W,
                                             int OH, int OW, int oh0,
                                             int oh1) {
  Row<5> top = start_walk<VEC, 5>(ring, xs, dys, L, pl, H, W, OH, OW, oh0,
                                  oh1 - 1);
  float2 s = make_float2(0.f, 0.f);
  for (int oh = oh0, slot = 0; oh < oh1; ++oh) {
    const float* st = next_stage<VEC>(ring, slot, xs, dys, L, oh, oh1 - 1, H,
                                      W, OH, OW);
    const Row<5> mid = row_of<5>(st, L, 2 * oh < H, pl);
    const Row<5> bot = row_of<5>(st + RW, L, 2 * oh + 1 < H, pl);
    const float2 d = *reinterpret_cast<const float2*>(st + 2 * RW + 2 * L.lane);
    __syncwarp();  // the slot is refilled by the next iteration
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      float best, xb;
      first_max(top, mid, bot, 2 * w, best, xb);
      const float g = best > 0.f ? (w ? d.y : d.x) : 0.f;
      s.x += g;
      s.y += g * ((xb - pl.mean) * pl.rstd);
    }
    top = bot;
    slot = (slot + 1) % STEM_STAGES;
  }
  return s;
}

// dx of the lane's four columns of pixel row h from their dz and x.
template <bool VEC>
__device__ __forceinline__ void store_dx(float* __restrict__ dxp,
                                         const Plane& pl, int h, int W, int c,
                                         const float dz[4], const float* x) {
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float xhat = (x[k] - pl.mean) * pl.rstd;
    v[k] = pl.rstd * (dz[k] * pl.scale - pl.c1 - xhat * pl.c2);
  }
  float* row = dxp + (size_t)h * W;
  if (VEC) {
    if (c < W)
      __stcs(reinterpret_cast<float4*>(row + c), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < W) __stcs(row + c + k, v[k]);
  }
}

// One warp item of stem_bwd_dx: dx of pixel rows 2*oh0 .. 2*oh1-1 of the
// plane, the lane's columns c .. c+3. Iteration oh works on the pixel rows
// 2oh-1 (carried), 2oh, 2oh+1 of window row oh: it adds the dy of the
// lane's three windows (its two and the next lane's first) to their
// maxima, finishes row 2oh-1 (if it is the strip's) and row 2oh, and
// carries row 2oh+1 with the dz it has so far; a last iteration oh = oh1
// only finishes row 2*oh1-1 (window row oh1 also covers it; the next strip
// computes that window row again).
template <bool VEC>
__device__ __forceinline__ void dx_walk(const float* xs, const float* dys,
                                        float* __restrict__ dxp, float* ring,
                                        const Lane& L, const Plane& pl, int H,
                                        int W, int OH, int OW, int oh0,
                                        int oh1) {
  Row<7> top = start_walk<VEC, 7>(ring, xs, dys, L, pl, H, W, OH, OW, oh0, oh1);
  float pend[4] = {0.f, 0.f, 0.f, 0.f};
  for (int oh = oh0, slot = 0; oh <= oh1; ++oh) {
    const float* st = next_stage<VEC>(ring, slot, xs, dys, L, oh, oh1, H, W,
                                      OH, OW);
    const Row<7> mid = row_of<7>(st, L, 2 * oh < H, pl);
    const Row<7> bot = row_of<7>(st + RW, L, 2 * oh + 1 < H, pl);
    const float2 d01 = *reinterpret_cast<const float2*>(st + 2 * RW + 2 * L.lane);
    const float d[3] = {d01.x, d01.y, st[2 * RW + 2 * L.lane + 2]};
    __syncwarp();  // the slot is refilled by the next iteration
    // add[dr][k]: dz of column c + k in the top (dr 0, starting from what
    // the window row above gave), middle and bottom pixel rows
    float add[3][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      add[0][k] = pend[k];
      add[1][k] = add[2][k] = 0.f;
    }
#pragma unroll
    for (int w = 0; w < 3; ++w) {  // the window on columns 2w .. 2w+2 of the 7
      float best, xb;
      const int arg = first_max(top, mid, bot, 2 * w, best, xb);
      const float g = best > 0.f ? d[w] : 0.f;
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const int k = 2 * w + q % 3 - 1;  // own column of position q
        if (k >= 0 && k < 4) add[q / 3][k] += arg == q ? g : 0.f;
      }
    }
    if (oh > oh0 && 2 * oh - 1 < H)
      store_dx<VEC>(dxp, pl, 2 * oh - 1, W, L.c, add[0], top.x + 1);
    if (oh == oh1) break;
    store_dx<VEC>(dxp, pl, 2 * oh, W, L.c, add[1], mid.x + 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) pend[k] = add[2][k];
    top = bot;
    slot = (slot + 1) % STEM_STAGES;
  }
}

// Which item a warp takes: items are numbered segment fastest, then strip,
// then plane, so that neighbouring warps stream neighbouring columns and
// rows of one plane.
struct Item {
  int plane, oh0, oh1, c;
};

__device__ __forceinline__ Item item_of(int item, int OH, int strips,
                                        int segs, int lane) {
  const int seg = item % segs;
  const int rest = item / segs;
  const int s = rest % strips;
  const int oh0 = s * STRIP;
  return Item{rest / strips, oh0, min(oh0 + STRIP, OH), seg * SEG + 4 * lane};
}

// The item's plane of x at row 0, column c, and of dy at window c/2, each
// clamped into its row (aligned for the 16-byte path).
template <bool VEC>
__device__ __forceinline__ void plane_ptrs(const float* x, const float* dy,
                                           const Item& w, int H, int W,
                                           int OH, int OW, const float*& xs,
                                           const float*& dys) {
  xs = x + (size_t)w.plane * H * W + min(w.c, W - (VEC ? 4 : 1));
  dys = dy + (size_t)w.plane * OH * OW + min(w.c >> 1, OW - (VEC ? 2 : 1));
}

// Stage 1: each warp item's sum dz and sum dz*xhat into partial[item][0..1]
// (items of one plane are contiguous). One warp an item.
template <bool VEC>
__global__ void __launch_bounds__(32 * STEM_WARPS)
stem_bwd_stats_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                      const float* __restrict__ params,
                      float* __restrict__ partial, int H, int W, int OH,
                      int OW, int strips, int segs, int items) {
  __shared__ __align__(16) float ring[STEM_WARPS][STEM_STAGES * STAGE];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int it = blockIdx.x * STEM_WARPS + warp;
  if (it >= items) return;
  const Item w = item_of(it, OH, strips, segs, lane);
  const Lane L = lane_of<VEC>(lane, w.c, W, OW, false);
  const Plane pl = load_plane(params, w.plane);
  const float *xs, *dys;
  plane_ptrs<VEC>(x, dy, w, H, W, OH, OW, xs, dys);
  float2 s = stats_walk<VEC>(xs, dys, ring[warp], L, pl, H, W, OH, OW, w.oh0,
                             w.oh1);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s.x += __shfl_xor_sync(FULL, s.x, off);
    s.y += __shfl_xor_sync(FULL, s.y, off);
  }
  if (lane == 0) reinterpret_cast<float2*>(partial)[it] = s;
}

// Sum v over the CTA in a fixed tree; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(FULL, v, off);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < (int)blockDim.x / 32; ++i) total += red[i];
  return total;
}

// Stage 2. grid (M*C), 128 threads: add the plane's items and write the
// four sums of acc (M, 4, C).
__global__ void __launch_bounds__(128)
stem_bwd_stats_reduce_kernel(const float* __restrict__ partial,
                             const float* __restrict__ params,
                             float* __restrict__ acc, int C, int per_plane) {
  __shared__ float red[128 / 32];
  const int plane = blockIdx.x;
  const float* p = partial + (size_t)plane * per_plane * 2;
  float s_dz = 0.f, s_dzx = 0.f;
  for (int t = threadIdx.x; t < per_plane; t += blockDim.x) {
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

template <bool VEC>
__global__ void __launch_bounds__(32 * STEM_WARPS)
stem_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                   const float* __restrict__ params, float* __restrict__ dx,
                   int H, int W, int OH, int OW, int strips, int segs,
                   int items) {
  __shared__ __align__(16) float ring[STEM_WARPS][STEM_STAGES * STAGE];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int it = blockIdx.x * STEM_WARPS + warp;
  if (it >= items) return;
  const Item w = item_of(it, OH, strips, segs, lane);
  const Lane L = lane_of<VEC>(lane, w.c, W, OW, true);
  const Plane pl = load_plane(params, w.plane);
  const float *xs, *dys;
  plane_ptrs<VEC>(x, dy, w, H, W, OH, OW, xs, dys);
  dx_walk<VEC>(xs, dys, dx + (size_t)w.plane * H * W, ring[warp], L, pl, H, W,
               OH, OW, w.oh0, w.oh1);
}

// The launch shape shared by both kernels: STRIP window rows a warp item,
// one warp an item.
struct Shape {
  int OH, OW, strips, segs, items, grid;
  bool ok, vec;
};

Shape shape_of(const void* x, const void* dy, const void* out_rows, int M,
               int C, int H, int W) {
  Shape s{};
  s.ok = M >= 1 && C >= 1 && H >= 1 && W >= 1 &&
         (long long)M * C <= 65535 && (long long)H * W < (1LL << 31);
  if (!s.ok) return s;
  s.OH = (H - 1) / 2 + 1;
  s.OW = (W - 1) / 2 + 1;
  s.strips = (s.OH + STRIP - 1) / STRIP;
  s.segs = (W + SEG - 1) / SEG;
  const long long items = (long long)M * C * s.strips * s.segs;
  s.ok = items < (1LL << 31) - STEM_WARPS;
  s.items = (int)items;
  s.grid = (s.items + STEM_WARPS - 1) / STEM_WARPS;
  // 16-byte rows: W % 4 == 0 (so OW is even) and every plane aligned
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out_rows);
  s.vec = W % 4 == 0 && bits % 16 == 0 &&
          reinterpret_cast<uintptr_t>(dy) % 8 == 0;
  return s;
}

}  // namespace

// x (M, C, H, W) fp32; dy (M, C, OH, OW) fp32 with OH = (H - 1) / 2 + 1, OW
// likewise; params (M*C, 8) fp32 per plane (mean, rstd, scale, bias, c1,
// c2, unused, unused; c1 and c2 are not read here); partial scratch
// (M*C, ceil(OH / 5) * ceil(W / 128), 2) fp32; acc (M, 4, C) fp32,
// written. All contiguous. Returns a cudaError_t (0 = both stages
// launched).
extern "C" int stem_bwd_stats_f32(const float* x, const float* dy,
                                  const float* params, float* partial,
                                  float* acc, int M, int C, int H, int W,
                                  void* stream) {
  const Shape s = shape_of(x, dy, x, M, C, H, W);
  if (!s.ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = s.vec ? stem_bwd_stats_kernel<true> : stem_bwd_stats_kernel<false>;
  kernel<<<s.grid, 32 * STEM_WARPS, 0, st>>>(x, dy, params, partial, H, W,
                                             s.OH, s.OW, s.strips, s.segs,
                                             s.items);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stem_bwd_stats_reduce_kernel<<<M * C, 128, 0, st>>>(partial, params, acc, C,
                                                      s.strips * s.segs);
  return (int)cudaGetLastError();
}

// As stem_bwd_stats_f32, with c1, c2 filled in; dx (M, C, H, W) fp32,
// written.
extern "C" int stem_bwd_dx_f32(const float* x, const float* dy,
                               const float* params, float* dx, int M, int C,
                               int H, int W, void* stream) {
  const Shape s = shape_of(x, dy, dx, M, C, H, W);
  if (!s.ok) return (int)cudaErrorInvalidValue;
  auto kernel = s.vec ? stem_bwd_dx_kernel<true> : stem_bwd_dx_kernel<false>;
  kernel<<<s.grid, 32 * STEM_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dy, params, dx, H, W, s.OH, s.OW, s.strips, s.segs, s.items);
  return (int)cudaGetLastError();
}
