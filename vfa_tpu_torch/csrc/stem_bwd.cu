// Backward of the fused stem tail GroupNorm(16) + ReLU + 3x3 / stride 2 /
// pad 1 max-pool for NVIDIA Hopper (sm_90a), NCHW, fp32 and bf16 (x, dy and
// dx in the element type; the statistics, the sums and the arithmetic fp32).
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
// CUDA kernel rounds them (a one product, z one fused multiply-add, b one
// fused multiply-add on bf16 and a product and an add on fp32; see
// load_plane), written with intrinsics so that no contraction rounds them
// otherwise.
//
// What the design does about it: every (image, channel) plane is a plain 2D
// problem with scalar statistics, and the work is cut into independent warp
// items. fp32: a warp takes one plane, a strip of STRIP pool-window rows and
// a 128-column segment, lane l owning the four columns c .. c+3, c = segment
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
//
// bf16 (stem_bwd_stats_bf16, stem_bwd_dx_bf16; the bf16 instances of
// _b1_kernel / _b2_kernel): z is rounded to bf16 as the forward stored it,
// before the ReLU and every comparison, and a pixel's dz rounds where
// _recompute_dz rounds `da` on bf16: the two window rows that meet on an
// odd pixel row are added and rounded (per window column), then the two
// window columns that meet on an odd pixel column. Half the bytes of fp32
// make the per-pixel walk, not the copies, the limit (PR 9's fp32-shaped
// walk took 0.67 ms for either kernel), so both bf16 kernels share one walk
// of their own, bf_walk, built to spend few instructions a pixel:
//   - a lane holds 8 columns (16-byte copies; 8-byte ones where W % 8 ==
//     4), a warp item 240 columns: lanes 1 .. 30 own them, lanes 0 and 31
//     load the 8 columns on either side and only lend their left key and
//     their first window, so every lane runs the same code;
//   - each pixel gets one 32-bit key: its z rounded to bf16 in the high
//     half (cvt.rn.bf16x2.f32, two pixels at once), and in the low half a
//     payload that falls in row-major order within every window (payload
//     = BF_PAY - (r * BF_RW + k) for the window row's pixel row r = 0, 1, 2
//     and ring column k). The first maximum of a window is then the
//     integer maximum of its 9 keys, taken as the maximum of each row's 3
//     (shared by the two window rows that meet on an odd row) and then of
//     the 3 rows; a window passes the ReLU iff its key's high half is > 0
//     (the window's dy is kept, else 0), so relu(z) is never formed, and
//     the padding is key 0;
//   - the winners' payloads and gradients are packed in bf16 pairs, and a
//     pixel takes a window's gradient where the winner's payload equals its
//     own: set.eq.bf16x2 gives 1.0 or 0.0 and fma.rn.bf16x2 adds g times
//     that to the pixel's sum, rounded once. Two bf16 values added in fp32
//     and then rounded give the bits of their exact sum rounded once, so
//     each step is the rounding _recompute_dz does: an even pixel row takes
//     its 1 (even column) or 2 (odd column) candidate windows, an odd row
//     the vertical pairs of window rows l-1 and l, rounded, then their sum
//     (add.bf16x2);
//   - the walk gives each pixel row's dz to a sink once: stem_bwd_stats_bf16
//     adds dz and dz*(x - mean) in fp32 (times rstd at the end),
//     stem_bwd_dx_bf16 writes dx. The window sums of the fp32 kernel would
//     need a correction at every pixel that two windows pick: two windows
//     side by side share 3 of their 15 pixels, so on independent z they pick
//     the same pixel 3 times in 15 (more on tied input), and corrections
//     that no branch skips cost what routing every pixel costs.
// Ownership: a warp item owns the pixel rows 2*oh0 .. 2*oh1-1 of its strip
// and the columns of its lanes 1 .. 30. Its last window row's bottom row
// is shared with the next strip's first window row, which the item
// computes again (its winners only) to finish that row; the next item
// starts below it. The column shared by a segment's last window and the
// next segment's first is finished by lane 30, with lane 31's first window.
// Measured (tools/exp_stem_grid.py --dtype bfloat16; NVIDIA H100 80GB HBM3,
// 700 W) at (14, 64, 360, 640): stem_bwd_stats_bf16 0.245 ms (63 % of its
// 0.154 ms bound; PR 9's walk 0.664), stem_bwd_dx_bf16 0.313 ms (89 % of
// 0.277 ms; 0.690); PERF.md has chip_smoke.py's readings.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Window rows of a warp item and row pairs in a warp's ring, chosen on the
// card (PERF.md, Findings): short strips keep the warps that run at one time
// on a compact stretch of x, whose halo rows then come from L2. STRIP and
// SEG must equal ops/stem.py::ITEM[float32], which sizes stem_bwd_stats'
// scratch (the launch refuses another count).
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

using bf16 = __nv_bfloat16;

// Four consecutive floats.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// per-plane scalars: mean, rstd, scale, bias, c1, c2 packed by the caller,
// a and b derived here. b as native_group_norm's CUDA kernel rounds it for
// x's type: on fp32 a product and an add, each rounded
// (tools/probe_gn_stats.py --candidates: 0 of 206,438,400 elements of z
// differ that way, 435,583 with one fused multiply-add); on bf16 one fused
// multiply-add.
struct Plane {
  float mean, rstd, scale, c1, c2, a, b;
};

template <class T>
__device__ __forceinline__ Plane load_plane(const float* __restrict__ params,
                                            int plane) {
  const float* p = params + (size_t)plane * NPARAM;
  const float a = __fmul_rn(p[1], p[2]);
  const float b = std::is_same_v<T, float>
                      ? __fadd_rn(__fmul_rn(-a, p[0]), p[3])
                      : __fmaf_rn(-a, p[0], p[3]);
  return Plane{p[0], p[1], p[2], p[4], p[5], a, b};
}

// In lanes where `active`: copy N bytes from src to shared dst without the
// registers, or zeros if !full (src is then not read, but is a valid
// address all the same). 16-byte copies bypass L1 unless L1.
template <int N, bool L1 = false>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool full, bool active = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? N : 0;
  if constexpr (N == 16 && !L1)
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

// ------------------------------------------------------------------ fp32 --

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
                                         const Lane& L, int h, bool in, int W) {
  const float* row = xs + (size_t)(in ? h : 0) * W;
  if constexpr (VEC) {  // W % 4 == 0: four columns are all inside or all outside
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
  if constexpr (VEC) {  // OW even: two windows are both inside or both outside
    cp_async<8>(dst + 2 * L.lane, row, in && L.dy_in);
  } else {
    cp_async<4>(dst + 2 * L.lane, row, in && L.dy_in);
    cp_async<4>(dst + 2 * L.lane + 1, L.dy2_in ? row + 1 : row, in && L.dy2_in);
  }
  // window c/2 + 2
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
  const float4 own = load4(row + 4 + 4 * L.lane);
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

// One warp item of stem_bwd_stats on fp32: window rows oh0 .. oh1-1 of the
// plane, the lane's windows c/2 and c/2 + 1. Returns the lane's sum of the
// dy its windows give (.x) and of dy * xhat at each window's maximum (.y).
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
    const float2 d = load2(st + 2 * RW + 2 * L.lane);
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

// One warp item's dz, pixel row by pixel row: rows 2*oh0 .. 2*oh1-1 of the
// plane, the lane's columns c .. c+3, handed to sink(h, dz, x) (dz and x of
// the four columns; the sink skips columns past W). Iteration oh works on
// the pixel rows 2oh-1 (carried), 2oh, 2oh+1 of window row oh: it adds the
// dy of the lane's three windows (its two and the next lane's first) to
// their maxima, finishes row 2oh-1 (if it is the strip's) and row 2oh, and
// carries row 2oh+1 with the dz it has so far; a last iteration oh = oh1
// only finishes row 2*oh1-1 (window row oh1 also covers it; the next strip
// computes that window row again). A pixel's gradient is kept in two parts,
// from the pool window on its left (or the only one, in an even column) and
// from the one on its right, added in this order.
template <bool VEC, class Sink>
__device__ __forceinline__ void dz_walk(const float* xs, const float* dys,
                                        float* ring, const Lane& L,
                                        const Plane& pl, int H, int W, int OH,
                                        int OW, int oh0, int oh1, Sink sink) {
  Row<7> top = start_walk<VEC, 7>(ring, xs, dys, L, pl, H, W, OH, OW, oh0, oh1);
  float pend[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int oh = oh0, slot = 0; oh <= oh1; ++oh) {
    const float* st = next_stage<VEC>(ring, slot, xs, dys, L, oh, oh1, H, W,
                                      OH, OW);
    const Row<7> mid = row_of<7>(st, L, 2 * oh < H, pl);
    const Row<7> bot = row_of<7>(st + RW, L, 2 * oh + 1 < H, pl);
    const float2 d01 = load2(st + 2 * RW + 2 * L.lane);
    const float d[3] = {d01.x, d01.y, st[2 * RW + 2 * L.lane + 2]};
    __syncwarp();  // the slot is refilled by the next iteration
    // add[side][dr][k]: this window row's dy to column c + k of its top
    // (dr 0), middle and bottom pixel rows, from the window on the left of
    // the column (side 0; in an even column the only one) or on its right
    float add[2][3][4];
#pragma unroll
    for (int side = 0; side < 2; ++side)
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int k = 0; k < 4; ++k) add[side][dr][k] = 0.f;
#pragma unroll
    for (int w = 0; w < 3; ++w) {  // the window on columns 2w .. 2w+2 of the 7
      float best, xb;
      const int arg = first_max(top, mid, bot, 2 * w, best, xb);
      const float g = best > 0.f ? d[w] : 0.f;
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const int k = 2 * w + q % 3 - 1;  // own column of position q
        if (k >= 0 && k < 4) add[q % 3 == 0][q / 3][k] += arg == q ? g : 0.f;
      }
    }
    float dz[4];
    if (oh > oh0 && 2 * oh - 1 < H) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dz[k] = (pend[0][k] + add[0][0][k]) + (pend[1][k] + add[1][0][k]);
      sink(2 * oh - 1, dz, top.x + 1);
    }
    if (oh == oh1) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dz[k] = add[0][1][k] + add[1][1][k];
      pend[0][k] = add[0][2][k];
      pend[1][k] = add[1][2][k];
    }
    sink(2 * oh, dz, mid.x + 1);
    top = bot;
    slot = (slot + 1) % STEM_STAGES;
  }
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
  if constexpr (VEC) {
    if (c < W)
      __stcs(reinterpret_cast<float4*>(row + c), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < W) __stcs(row + c + k, v[k]);
  }
}

// Which item a warp takes: items are numbered segment fastest, then strip,
// then plane, so that neighbouring warps stream neighbouring columns and
// rows of one plane. `strip` window rows and `seg` columns an item.
struct Item {
  int plane, oh0, oh1, seg;
};

__device__ __forceinline__ Item item_of(int item, int OH, int strips,
                                        int segs, int strip) {
  const int seg = item % segs;
  const int rest = item / segs;
  const int oh0 = rest % strips * strip;
  return Item{rest / strips, oh0, min(oh0 + strip, OH), seg};
}

// Stage 1 on fp32: each warp item's sum dz and sum dz*xhat into
// partial[item][0..1] (items of one plane are contiguous). One warp an
// item: each window's dy added up at its maximum.
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
  const Item w = item_of(it, OH, strips, segs, STRIP);
  const int c = w.seg * SEG + 4 * lane;
  const Plane pl = load_plane<float>(params, w.plane);
  // the plane at row 0, column c, and dy at window c/2, each clamped into
  // its row (aligned for the 16-byte path)
  const float* xs = x + (size_t)w.plane * H * W + min(c, W - (VEC ? 4 : 1));
  const float* dys = dy + (size_t)w.plane * OH * OW + min(c >> 1, OW - (VEC ? 2 : 1));
  const Lane L = lane_of<VEC>(lane, c, W, OW, false);
  float2 s = stats_walk<VEC>(xs, dys, ring[warp], L, pl, H, W, OH, OW, w.oh0,
                             w.oh1);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s.x += __shfl_xor_sync(FULL, s.x, off);
    s.y += __shfl_xor_sync(FULL, s.y, off);
  }
  if (lane == 0) reinterpret_cast<float2*>(partial)[it] = s;
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
  const Item w = item_of(it, OH, strips, segs, STRIP);
  const int c = w.seg * SEG + 4 * lane;
  const Lane L = lane_of<VEC>(lane, c, W, OW, true);
  const Plane pl = load_plane<float>(params, w.plane);
  const float* xs = x + (size_t)w.plane * H * W + min(c, W - (VEC ? 4 : 1));
  const float* dys = dy + (size_t)w.plane * OH * OW + min(c >> 1, OW - (VEC ? 2 : 1));
  float* dxp = dx + (size_t)w.plane * H * W;
  dz_walk<VEC>(xs, dys, ring[warp], L, pl, H, W, OH, OW, w.oh0, w.oh1,
               [&](int h, const float dz[4], const float* xv) {
                 store_dx<VEC>(dxp, pl, h, W, L.c, dz, xv);
               });
}

// ------------------------------------------------------------------ bf16 --

// Window rows of a warp item, per kernel, and window rows in a warp's ring,
// chosen with tools/exp_stem_grid.py --dtype bfloat16 (PERF.md, Findings):
// the stats kernel, read-only and bound by its instructions, gains from
// long strips (one window row in BF_STATS_STRIP + 1 is computed twice), the
// dx kernel from short ones. BF_STATS_STRIP and BF_SEG must equal
// ops/stem.py::ITEM[bfloat16] (the launch refuses another scratch count).
constexpr int BF_STATS_STRIP = 30;
constexpr int BF_DX_STRIP = 6;
constexpr int BF_STAGES = 4;
constexpr int BF_OWNERS = 30;             // lanes 1 .. 30 own 8 columns each
constexpr int BF_SEG = 8 * BF_OWNERS;     // columns of a warp item
constexpr int BF_RW = 8 * 32;             // a ring row: 8 columns a lane
// A ring stage: pixel rows 2oh and 2oh + 1 (lane l's columns at 8 l) and
// dy's window row oh (lane l's 4 windows at 4 l).
constexpr int BF_STAGE = 2 * BF_RW + 4 * 32;
// Key payloads: BF_PAY - (r * BF_RW + k) for pixel row r = 0, 1, 2 of a
// window row and ring column k, kept between 0x3d01 and 0x4200 so that as
// bf16 numbers they are normal, positive and equal only where the bits are
// (set.eq.bf16x2 compares them); window row oh's bottom row is oh + 1's
// top: BF_ROW2 on both halves of a payload pair, 2 * BF_RW on a key's.
constexpr unsigned BF_PAY = 0x4000;
constexpr unsigned BF_PAIR = 0x10001u;
constexpr unsigned BF_ROW2 = 2 * BF_RW * BF_PAIR;

// What a lane loads and where it sits, fixed for an item: its 8 columns
// c .. c+7 (c = segment start + 8 (lane - 1): lane 0's lie left of the
// segment, lane 31's right of it), the payload pair of columns c, c+1 in a
// top row, and `lmask` 0 where the column left of c is the padding.
struct BfLane {
  int lane, c;
  unsigned pp0, lmask;
  bool owner;
};

__device__ __forceinline__ BfLane bf_lane_of(int lane, int seg, int W) {
  BfLane L;
  L.lane = lane;
  L.c = seg * BF_SEG + 8 * (lane - 1);
  const unsigned k = 8 * lane;
  L.pp0 = ((BF_PAY - k - 1) << 16) | (BF_PAY - k);
  L.lmask = seg == 0 && lane == 1 ? 0u : FULL;
  L.owner = lane >= 1 && lane <= BF_OWNERS && L.c < W;
  return L;
}

// Start the copies of pixel row h (zeros unless `in`) of the lane's 8
// columns into dst; `xs` is the plane's row 0. WIDE: one 16-byte copy (W %
// 8 == 0: all 8 columns inside or all outside), through L1, where the
// warps of a CTA (neighbouring segments) find their halo lanes' columns;
// else two 8-byte ones (W % 4 == 0, where the row's last 4 columns may be
// the lane's first 4).
template <bool WIDE>
__device__ __forceinline__ void bf_fill_x(bf16* dst, const bf16* xs, int h,
                                          bool in, int c, int W) {
  const bf16* row = xs + (size_t)(in ? h : 0) * W;
  const bool in0 = in && c >= 0 && c < W;
  if constexpr (WIDE) {
    cp_async<16, true>(dst, in0 ? row + c : xs, in0);
  } else {
    const bool in1 = in && c >= 0 && c + 4 < W;
    cp_async<8>(dst, in0 ? row + c : xs, in0);
    cp_async<8>(dst + 4, in1 ? row + c + 4 : xs, in1);
  }
}

// Start the copies of window row oh into the ring stage `st`: pixel rows
// 2oh and 2oh + 1 and the lane's 4 windows c/2 .. c/2 + 3 of dy's row oh
// (OW even: a pair of windows is inside or outside together).
template <bool WIDE>
__device__ __forceinline__ void bf_fill_stage(bf16* st, const bf16* xs,
                                              const bf16* dys, const BfLane& L,
                                              int oh, int H, int W, int OH,
                                              int OW) {
  bf_fill_x<WIDE>(st + 8 * L.lane, xs, 2 * oh, 2 * oh < H, L.c, W);
  bf_fill_x<WIDE>(st + BF_RW + 8 * L.lane, xs, 2 * oh + 1, 2 * oh + 1 < H, L.c, W);
  const bool in = oh < OH && L.c >= 0;
  const int ow = L.c >> 1;
  const bf16* row = dys + (size_t)(oh < OH ? oh : 0) * OW;
  bf16* dst = st + 2 * BF_RW + 4 * L.lane;
  if constexpr (WIDE) {  // OW % 4 == 0
    cp_async<8>(dst, in && ow < OW ? row + ow : dys, in && ow < OW);
  } else {
    cp_async<4>(dst, in && ow < OW ? row + ow : dys, in && ow < OW);
    cp_async<4>(dst + 2, in && ow + 2 < OW ? row + ow + 2 : dys, in && ow + 2 < OW);
  }
}

// bf16 pair (lo, hi) of two floats, each rounded to nearest even
__device__ __forceinline__ unsigned bf_pack(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ float bf_lo(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

// Of one pixel row (the lane's 4 words of bf16 pairs, payload pair `pp` of
// columns c, c+1): the key of each column, and the greatest key of each of
// the lane's windows in this row (hk[j]: columns c+2j-1 .. c+2j+1, the
// left one from the lane before); 0 where the row is outside the image.
__device__ __forceinline__ void bf_row_max(const uint4& w, unsigned pp,
                                           const BfLane& L, const Plane& pl,
                                           bool in, int hk[4]) {
  const unsigned xw[4] = {w.x, w.y, w.z, w.w};
  int ke[4], ko[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned z = bf_pack(__fmaf_rn(pl.a, bf_lo(xw[j]), pl.b),
                               __fmaf_rn(pl.a, bf_hi(xw[j]), pl.b));
    const unsigned p = pp - 2 * j * BF_PAIR;
    ke[j] = (int)__byte_perm(z, p, 0x1054);   // z.lo : p.lo
    ko[j] = (int)__byte_perm(z, p, 0x3276);   // z.hi : p.hi
  }
  const int left = __shfl_up_sync(FULL, ko[3], 1) & (int)L.lmask;
  hk[0] = max(max(left, ke[0]), ko[0]);
#pragma unroll
  for (int j = 1; j < 4; ++j) hk[j] = max(max(ko[j - 1], ke[j]), ko[j]);
  if (!in) {
#pragma unroll
    for (int j = 0; j < 4; ++j) hk[j] = 0;
  }
}

// a + g where the pixel payloads `pp` equal the window's winner `wp`, per
// half of the bf16 pairs, each sum rounded once to bf16
__device__ __forceinline__ unsigned bf_pick(unsigned pp, unsigned wp,
                                            unsigned g, unsigned a) {
  unsigned m, d;
  asm("set.eq.bf16x2.bf16x2 %0, %1, %2;" : "=r"(m) : "r"(pp), "r"(wp));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(m), "r"(g), "r"(a));
  return d;
}

// The winners of a window row's lane windows, packed in bf16 pairs: the
// payloads and gradients of windows (0, 1) and (2, 3), and the next lane's
// first window (payload low, gradient high). g is dy where the window
// passes the ReLU, else 0.
struct BfWin {
  unsigned p01, p23, g01, g23, next;
};

__device__ __forceinline__ unsigned bf_dup(unsigned v, bool hi) {
  return __byte_perm(v, 0, hi ? 0x3232 : 0x1010);
}

// window j's payload and gradient, each held twice in a pair
__device__ __forceinline__ unsigned bf_wp(const BfWin& w, int j) {
  return j == 4 ? bf_dup(w.next, false) : bf_dup(j < 2 ? w.p01 : w.p23, j % 2);
}
__device__ __forceinline__ unsigned bf_g(const BfWin& w, int j) {
  return j == 4 ? bf_dup(w.next, true) : bf_dup(j < 2 ? w.g01 : w.g23, j % 2);
}

// The lane's 4 windows of window row oh from its rows' greatest keys (top
// row in the frame of window row oh - 1), and the next lane's first.
__device__ __forceinline__ BfWin bf_winners(const int hkt[4], const int hkm[4],
                                            const int hkb[4], const uint2& dy) {
  int vk[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) vk[j] = max(max(hkt[j] + 2 * BF_RW, hkm[j]), hkb[j]);
  unsigned gp[2], pp[2];
  const unsigned dyw[2] = {dy.x, dy.y};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pp[h] = __byte_perm(vk[2 * h], vk[2 * h + 1], 0x5410);
    const unsigned v = __byte_perm(vk[2 * h], vk[2 * h + 1], 0x7632);
    unsigned m;
    asm("set.gt.bf16x2.bf16x2 %0, %1, %2;" : "=r"(m) : "r"(v), "r"(0u));
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(gp[h]) : "r"(m), "r"(dyw[h]), "r"(0u));
  }
  const unsigned next = __shfl_down_sync(FULL, __byte_perm(pp[0], gp[0], 0x5410), 1);
  return BfWin{pp[0], pp[1], gp[0], gp[1], next};
}

// One warp item's dz on bf16, a pixel row at a time: rows 2*oh0 ..
// 2*oh1-1 of the plane, the lane's 8 columns, handed to sink(h, dz, x) as
// 4 words of bf16 pairs each (every lane calls it; the sink keeps its
// owners' columns). Iteration oh works on window row oh (pixel rows 2oh-1,
// carried, 2oh and 2oh+1 from the ring): it finds the winners, finishes
// row 2oh-1 (if it is the strip's: with window row oh - 1's winners) and
// row 2oh; a last iteration oh = oh1 finds window row oh1's winners only,
// to finish row 2*oh1-1.
template <bool WIDE, class Sink>
__device__ __forceinline__ void bf_walk(const bf16* xs, const bf16* dys,
                                        bf16* ring, const BfLane& L,
                                        const Plane& pl, int H, int W, int OH,
                                        int OW, int oh0, int oh1, Sink sink) {
  // pixel row 2*oh0 - 1 into the second row of the ring's last slot (which
  // the walk refills only after reading it), then the ring's first
  // BF_STAGES - 1 window rows
  bf16* top_row = ring + (BF_STAGES - 1) * BF_STAGE + BF_RW;
  bf_fill_x<WIDE>(top_row + 8 * L.lane, xs, 2 * oh0 - 1, oh0 > 0, L.c, W);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < BF_STAGES - 1; ++s) {
    if (oh0 + s <= oh1)
      bf_fill_stage<WIDE>(ring + s * BF_STAGE, xs, dys, L, oh0 + s, H, W, OH, OW);
    cp_async_commit();
  }
  cp_async_wait<BF_STAGES - 1>();
  __syncwarp();
  uint4 xt = *reinterpret_cast<const uint4*>(top_row + 8 * L.lane);
  int hkt[4];  // as window row oh0 - 1's bottom row
  bf_row_max(xt, L.pp0 - BF_ROW2, L, pl, oh0 > 0, hkt);
  __syncwarp();
  // window row oh - 1's winners, their payloads in window row oh's frame
  BfWin prev{0u, 0u, 0u, 0u, 0u};
  for (int oh = oh0, slot = 0; oh <= oh1; ++oh) {
    if (oh + BF_STAGES - 1 <= oh1)
      bf_fill_stage<WIDE>(ring + ((slot + BF_STAGES - 1) % BF_STAGES) * BF_STAGE,
                          xs, dys, L, oh + BF_STAGES - 1, H, W, OH, OW);
    cp_async_commit();
    cp_async_wait<BF_STAGES - 1>();  // this lane's copies of window row oh
    __syncwarp();                    // and every other lane's
    const bf16* st = ring + slot * BF_STAGE;
    const uint4 xm = *reinterpret_cast<const uint4*>(st + 8 * L.lane);
    const uint4 xb = *reinterpret_cast<const uint4*>(st + BF_RW + 8 * L.lane);
    const uint2 d = *reinterpret_cast<const uint2*>(st + 2 * BF_RW + 4 * L.lane);
    __syncwarp();  // the slot is refilled by the next iteration
    int hkm[4], hkb[4];
    bf_row_max(xm, L.pp0 - BF_RW * BF_PAIR, L, pl, 2 * oh < H, hkm);
    bf_row_max(xb, L.pp0 - BF_ROW2, L, pl, 2 * oh + 1 < H, hkb);
    const BfWin win = bf_winners(hkt, hkm, hkb, d);
    unsigned dz[4];
    if (oh > oh0 && 2 * oh - 1 < H) {
      // row 2oh-1: per window column, window row oh-1's bottom and oh's top
      // added and rounded; then the odd column's two window columns
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned p = L.pp0 - 2 * j * BF_PAIR;
        const unsigned v = bf_pick(p, bf_wp(prev, j), bf_g(prev, j),
                                   bf_pick(p, bf_wp(win, j), bf_g(win, j), 0u));
        const unsigned u = bf_pick(p, bf_wp(prev, j + 1), bf_g(prev, j + 1),
                                   bf_pick(p, bf_wp(win, j + 1), bf_g(win, j + 1), 0u));
        asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(dz[j]) : "r"(v), "r"(u));
      }
      sink(2 * oh - 1, dz, xt);
    }
    if (oh == oh1) break;
    if (2 * oh < H) {  // row 2oh: window j, and j + 1 in the odd column
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned p = L.pp0 - (BF_RW + 2 * j) * BF_PAIR;
        dz[j] = bf_pick(p, bf_wp(win, j + 1), bf_g(win, j + 1),
                        bf_pick(p, bf_wp(win, j), bf_g(win, j), 0u));
      }
      sink(2 * oh, dz, xm);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) hkt[j] = hkb[j];
    // window row oh's bottom row is oh + 1's top
    prev = BfWin{win.p01 + BF_ROW2, win.p23 + BF_ROW2, win.g01, win.g23,
                 win.next + 2 * BF_RW};
    xt = xb;
    slot = (slot + 1) % BF_STAGES;
  }
}

// Stage 1 on bf16: each warp item's sum dz and sum dz*xhat over its owned
// pixels into partial[item][0..1].
template <bool WIDE>
__global__ void __launch_bounds__(32 * STEM_WARPS)
stem_bwd_stats_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                           const float* __restrict__ params,
                           float* __restrict__ partial, int H, int W, int OH,
                           int OW, int strips, int segs, int items) {
  __shared__ __align__(16) bf16 ring[STEM_WARPS][BF_STAGES * BF_STAGE];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int it = blockIdx.x * STEM_WARPS + warp;
  if (it >= items) return;
  const Item w = item_of(it, OH, strips, segs, BF_STATS_STRIP);
  const BfLane L = bf_lane_of(lane, w.seg, W);
  const Plane pl = load_plane<bf16>(params, w.plane);
  float s_dz = 0.f, s_dzx = 0.f;  // sum dz, sum dz * (x - mean)
  bf_walk<WIDE>(x + (size_t)w.plane * H * W, dy + (size_t)w.plane * OH * OW,
                ring[warp], L, pl, H, W, OH, OW, w.oh0, w.oh1,
                [&](int, const unsigned dz[4], uint4 xw) {
                  const unsigned xv[4] = {xw.x, xw.y, xw.z, xw.w};
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    s_dz += bf_lo(dz[j]);
                    s_dz += bf_hi(dz[j]);
                    s_dzx = fmaf(bf_lo(dz[j]), bf_lo(xv[j]) - pl.mean, s_dzx);
                    s_dzx = fmaf(bf_hi(dz[j]), bf_hi(xv[j]) - pl.mean, s_dzx);
                  }
                });
  // the halo lanes' columns (and those past W, where dz and x are 0) are
  // other items'
  float2 s = L.owner ? make_float2(s_dz, s_dzx * pl.rstd) : make_float2(0.f, 0.f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s.x += __shfl_xor_sync(FULL, s.x, off);
    s.y += __shfl_xor_sync(FULL, s.y, off);
  }
  if (lane == 0) reinterpret_cast<float2*>(partial)[it] = s;
}

template <bool WIDE>
__global__ void __launch_bounds__(32 * STEM_WARPS)
stem_bwd_dx_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                        const float* __restrict__ params, bf16* __restrict__ dx,
                        int H, int W, int OH, int OW, int strips, int segs,
                        int items) {
  __shared__ __align__(16) bf16 ring[STEM_WARPS][BF_STAGES * BF_STAGE];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int it = blockIdx.x * STEM_WARPS + warp;
  if (it >= items) return;
  const Item w = item_of(it, OH, strips, segs, BF_DX_STRIP);
  const BfLane L = bf_lane_of(lane, w.seg, W);
  const Plane pl = load_plane<bf16>(params, w.plane);
  bf16* dxp = dx + (size_t)w.plane * H * W;
  bf_walk<WIDE>(x + (size_t)w.plane * H * W, dy + (size_t)w.plane * OH * OW,
                ring[warp], L, pl, H, W, OH, OW, w.oh0, w.oh1,
                [&](int h, const unsigned dz[4], uint4 xw) {
                  if (!L.owner) return;
                  const unsigned xv[4] = {xw.x, xw.y, xw.z, xw.w};
                  unsigned out[4];
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    float v[2];
#pragma unroll
                    for (int k = 0; k < 2; ++k) {
                      const float xf = k ? bf_hi(xv[j]) : bf_lo(xv[j]);
                      const float dzf = k ? bf_hi(dz[j]) : bf_lo(dz[j]);
                      const float xhat = (xf - pl.mean) * pl.rstd;
                      v[k] = pl.rstd * (dzf * pl.scale - pl.c1 - xhat * pl.c2);
                    }
                    out[j] = bf_pack(v[0], v[1]);
                  }
                  bf16* row = dxp + (size_t)h * W + L.c;
                  if constexpr (WIDE) {
                    __stcs(reinterpret_cast<uint4*>(row),
                           make_uint4(out[0], out[1], out[2], out[3]));
                  } else {
                    __stcs(reinterpret_cast<uint2*>(row), make_uint2(out[0], out[1]));
                    if (L.c + 4 < W)
                      __stcs(reinterpret_cast<uint2*>(row + 4), make_uint2(out[2], out[3]));
                  }
                });
}

// ---------------------------------------------------------------- shared --

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

// The launch shape shared by the kernels of one dtype: `strip` window rows
// and `seg` columns a warp item, one warp an item.
struct Shape {
  int OH, OW, strips, segs, items, grid;
  bool ok;
};

Shape shape_of(int M, int C, int H, int W, int strip, int seg) {
  Shape s{};
  s.ok = M >= 1 && C >= 1 && H >= 1 && W >= 1 &&
         (long long)M * C <= 65535 && (long long)H * W < (1LL << 31);
  if (!s.ok) return s;
  s.OH = (H - 1) / 2 + 1;
  s.OW = (W - 1) / 2 + 1;
  s.strips = (s.OH + strip - 1) / strip;
  s.segs = (W + seg - 1) / seg;
  const long long items = (long long)M * C * s.strips * s.segs;
  s.ok = items < (1LL << 31) - STEM_WARPS;
  s.items = (int)items;
  s.grid = (s.items + STEM_WARPS - 1) / STEM_WARPS;
  return s;
}

// Whole rows of `cols` columns: W % cols == 0 and every plane of x and of
// the output (out_rows) aligned to `cols` elements, of dy to cols / 2.
bool rows_of(const void* x, const void* dy, const void* out_rows, int W,
             int cols, int elem) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out_rows);
  return W % cols == 0 && bits % (cols * elem) == 0 &&
         reinterpret_cast<uintptr_t>(dy) % (cols / 2 * elem) == 0;
}

int reduce_launch(const float* partial, const float* params, float* acc,
                  int M, int C, const Shape& s, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stem_bwd_stats_reduce_kernel<<<M * C, 128, 0, st>>>(partial, params, acc, C,
                                                      s.strips * s.segs);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, C, H, W) fp32; dy (M, C, OH, OW) fp32 with OH = (H - 1) / 2 + 1, OW
// likewise; params (M*C, 8) fp32 per plane (mean, rstd, scale, bias, c1,
// c2, unused, unused; c1 and c2 are not read here); partial scratch
// (M*C, per_plane, 2) fp32 with per_plane = ceil(OH / 5) * ceil(W / 128)
// (cudaErrorInvalidValue for another count); acc (M, 4, C) fp32, written.
// All contiguous. Returns a cudaError_t (0 = both stages launched).
extern "C" int stem_bwd_stats_f32(const float* x, const float* dy,
                                  const float* params, float* partial,
                                  float* acc, int M, int C, int H, int W,
                                  int per_plane, void* stream) {
  const Shape s = shape_of(M, C, H, W, STRIP, SEG);
  if (!s.ok || per_plane != s.strips * s.segs) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = rows_of(x, dy, x, W, 4, 4) ? stem_bwd_stats_kernel<true>
                                           : stem_bwd_stats_kernel<false>;
  kernel<<<s.grid, 32 * STEM_WARPS, 0, st>>>(x, dy, params, partial, H, W,
                                             s.OH, s.OW, s.strips, s.segs,
                                             s.items);
  return reduce_launch(partial, params, acc, M, C, s, st);
}

// As stem_bwd_stats_f32, with c1, c2 filled in; dx (M, C, H, W) fp32,
// written.
extern "C" int stem_bwd_dx_f32(const float* x, const float* dy,
                               const float* params, float* dx, int M, int C,
                               int H, int W, void* stream) {
  const Shape s = shape_of(M, C, H, W, STRIP, SEG);
  if (!s.ok) return (int)cudaErrorInvalidValue;
  auto kernel = rows_of(x, dy, dx, W, 4, 4) ? stem_bwd_dx_kernel<true>
                                            : stem_bwd_dx_kernel<false>;
  kernel<<<s.grid, 32 * STEM_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dy, params, dx, H, W, s.OH, s.OW, s.strips, s.segs, s.items);
  return (int)cudaGetLastError();
}

// The bf16 variants: x, dy and dx bf16, params, partial and acc fp32; W a
// multiple of 4 and planes 8-byte aligned (dy's 4-byte), else
// cudaErrorInvalidValue; the 16-byte copies where W % 8 == 0 and planes are
// 16-byte aligned (dy's 8-byte). partial: per_plane = ceil(OH /
// BF_STATS_STRIP) * ceil(W / BF_SEG). z is rounded to bf16 before the ReLU and every
// comparison, dz where JAX rounds it, the sums and dx are fp32 and dx is
// rounded once.
extern "C" int stem_bwd_stats_bf16(const void* x, const void* dy,
                                   const float* params, float* partial,
                                   float* acc, int M, int C, int H, int W,
                                   int per_plane, void* stream) {
  const Shape s = shape_of(M, C, H, W, BF_STATS_STRIP, BF_SEG);
  if (!s.ok || per_plane != s.strips * s.segs || !rows_of(x, dy, x, W, 4, 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = rows_of(x, dy, x, W, 8, 2) ? stem_bwd_stats_bf16_kernel<true>
                                           : stem_bwd_stats_bf16_kernel<false>;
  kernel<<<s.grid, 32 * STEM_WARPS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), params,
      partial, H, W, s.OH, s.OW, s.strips, s.segs, s.items);
  return reduce_launch(partial, params, acc, M, C, s, st);
}

extern "C" int stem_bwd_dx_bf16(const void* x, const void* dy,
                                const float* params, void* dx, int M, int C,
                                int H, int W, void* stream) {
  const Shape s = shape_of(M, C, H, W, BF_DX_STRIP, BF_SEG);
  if (!s.ok || !rows_of(x, dy, dx, W, 4, 2)) return (int)cudaErrorInvalidValue;
  auto kernel = rows_of(x, dy, dx, W, 8, 2) ? stem_bwd_dx_bf16_kernel<true>
                                            : stem_bwd_dx_bf16_kernel<false>;
  kernel<<<s.grid, 32 * STEM_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), params,
      static_cast<bf16*>(dx), H, W, s.OH, s.OW, s.strips, s.segs, s.items);
  return (int)cudaGetLastError();
}
