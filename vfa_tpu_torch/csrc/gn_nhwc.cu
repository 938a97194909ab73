// GroupNorm on channels-last bf16 for NVIDIA Hopper (sm_90a), each norm
// with what follows it in VFANet's ResNet backbone, in two passes: the
// statistics, then the apply pass with its epilogue. Serving only: nothing
// is saved for a backward.
//
// Replaces no TPU kernel: the JAX package leaves the backbone's norms to
// XLA. It replaces the library chain of vfa_tpu_torch/ops/group_norm.py::
// group_norm_act_plain on bf16 CUDA tensors: native_group_norm (which
// first copies a channels-last input to NCHW, reads it once for the
// moments, then writes a*x + b in an unvectorised pass), then the ReLU,
// the residual add or the stem's max-pool, each a pass of its own, with
// cuDNN converting every NCHW activation in and out of each convolution.
//
//   stats:  x (M, H, W, C) -> per (image m, group g) the mean and
//           rstd = rsqrt(var + eps) in fp32 (biased variance)
//   apply:  mean, rstd rounded to bf16 (native_group_norm on a bf16 CUDA
//           tensor rounds them so before use), then per (m, c)
//           a = rstd * gamma[c]          (one product)
//           b = -a * mean + beta[c]      (one fused multiply-add)
//           z = bf16(a * x + b)          (one fused multiply-add, one rounding)
//           and the epilogue: none; relu(z); relu(bf16(z + identity));
//           or max_pool(relu(z), 3, stride 2, pad 1).
//
// The roundings are the library's (ops/stem.py::recompute_z, F3), so fed
// the same bf16 statistics the apply pass gives the library chain's bits.
// relu(v) is the library's clamp: v if v is NaN, else fmaxf(v, 0). The
// pool keeps a window's first maximum, NaN winning, as max_pool2d does.
//
// What bounds it on the H100 (SXM, 700 W): bytes. The statistics read x
// once; the apply pass reads x (and the identity) once and writes its
// output once; the stem's writes only the pooled quarter.
//
// What the design does about it: every load and store is 16 bytes, 8
// channels of one pixel; C / 8 threads cover a pixel, and a block of 256
// threads walks a contiguous run of one image's pixels, so each thread
// keeps the same 8 channels throughout: the apply pass computes its 8
// (a, b) pairs once. The statistics take a per-thread shift (the thread's
// first value of each group), fp32 shifted sums over at most 256 values,
// then Chan's merge of (count, mean, M2) across the block's threads, and
// across the image's blocks in a second, small kernel: no E[x^2] - E[x]^2
// over a whole group. The stem's pool reads the 9 taps of an output pixel
// (clamped into the map, so a tap outside repeats one inside), keeps the
// elementwise bf16 maximum and minimum of x with NaN passing (2 packed
// instructions a tap for 8 channels), and normalises only those: z is
// monotone in x for a fixed sign of a, so the window's largest z is z of
// the largest x or of the smallest. Where that largest z is not above 0,
// every relu(z) is a zero and max_pool2d keeps the first one, relu of the
// window's first tap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                  // channels a 16-byte vector
constexpr int STATS_ITEMS = 32;         // vectors a thread in the statistics pass
constexpr int APPLY_ITEMS = 8;          // vectors a thread in the apply pass
constexpr int POOL_ITEMS = 2;           // output vectors a thread in the pool pass
constexpr int UNROLL = 8;               // loads in flight a thread

struct Moments {
  float n, mean, m2;
};

// Chan's merge of b into a.
__device__ __forceinline__ void merge(Moments& a, const Moments& b) {
  if (b.n == 0.f) return;
  if (a.n == 0.f) {
    a = b;
    return;
  }
  const float n = a.n + b.n;
  const float w = __fdiv_rn(b.n, n);
  const float d = b.mean - a.mean;
  a.mean = __fmaf_rn(d, w, a.mean);
  a.m2 = a.m2 + b.m2 + d * d * a.n * w;
  a.n = n;
}

__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// a, b hold bf16 values exactly: their high halves are the bf16 bits
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (__float_as_uint(a) >> 16) | (__float_as_uint(b) & 0xffff0000u);
}

__device__ __forceinline__ uint4 pack(const float* f) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

__device__ __forceinline__ float rnd(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

// Statistics, first kernel: block (m, p) takes vectors [p, p + 1) *
// THREADS * STATS_ITEMS of image m; NG groups a thread (2 for 4 channels
// a group, else 1) -> part[((m * P + p) * G + g) * 3 + (n, mean, M2)].
template <int NG>
__global__ void __launch_bounds__(THREADS)
gn_stats_partial(const uint4* __restrict__ x, float* __restrict__ part, long long vpi, int S,
                 int G, int CPG, int P) {
  constexpr int PER = VEC / NG;         // channels of a group in a vector
  __shared__ float sh_n[THREADS * 2], sh_mean[THREADS * 2], sh_m2[THREADS * 2];
  const int m = (int)(blockIdx.x / (unsigned)P), p = (int)(blockIdx.x % (unsigned)P);
  const int t = threadIdx.x, s = t % S;
  const long long v0 = (long long)p * (THREADS * STATS_ITEMS);
  const long long vend = min(v0 + (long long)THREADS * STATS_ITEMS, vpi);
  const uint4* xm = x + (long long)m * vpi;
  float K[NG], s1[NG], s2[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) K[j] = s1[j] = s2[j] = 0.f;
  int cnt = 0;
  if (v0 + t < vend) {
    float f[VEC];
    unpack(__ldg(xm + v0 + t), f);
#pragma unroll
    for (int j = 0; j < NG; ++j) K[j] = f[j * PER];
  }
  for (long long v = v0 + t; v < vend; v += (long long)THREADS * UNROLL) {
    uint4 u[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long vk = v + (long long)k * THREADS;
      u[k] = vk < vend ? __ldg(xm + vk) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (v + (long long)k * THREADS < vend) {
        float f[VEC];
        unpack(u[k], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int j = e / PER;
          const float d = f[e] - K[j];
          s1[j] += d;
          s2[j] = __fmaf_rn(d, d, s2[j]);
        }
        ++cnt;
      }
    }
  }
  const int NK = THREADS * NG / G;      // entries a group in the block
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    Moments mo = {0.f, 0.f, 0.f};
    if (cnt) {
      const float n = (float)(cnt * PER);
      const float q = __fdiv_rn(s1[j], n);
      mo = {n, K[j] + q, fmaxf(s2[j] - s1[j] * q, 0.f)};
    }
    const int g = NG == 2 ? 2 * s + j : s * VEC / CPG;
    const int k = NG == 2 ? t / S : (s % (CPG / VEC)) * (THREADS / S) + t / S;
    sh_n[g * NK + k] = mo.n;
    sh_mean[g * NK + k] = mo.mean;
    sh_m2[g * NK + k] = mo.m2;
  }
  __syncthreads();
  for (int g = t; g < G; g += THREADS) {  // G reaches 512: 2048 channels, 4 a group
    Moments acc = {0.f, 0.f, 0.f};
    for (int k = 0; k < NK; ++k) {
      merge(acc, {sh_n[g * NK + k], sh_mean[g * NK + k], sh_m2[g * NK + k]});
    }
    float* e = part + (((long long)m * P + p) * G + g) * 3;
    e[0] = acc.n;
    e[1] = acc.mean;
    e[2] = acc.m2;
  }
}

// Statistics, second kernel: a warp per (m, g) merges its P partials ->
// stats[(m * G + g) * 2 + (mean, rstd)], fp32.
__global__ void __launch_bounds__(THREADS)
gn_stats_final(const float* __restrict__ part, float* __restrict__ stats, int P, int G, int MG,
               float eps) {
  const int idx = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= MG) return;
  const int m = idx / G, g = idx - m * G;
  Moments acc = {0.f, 0.f, 0.f};
  for (int p = lane; p < P; p += 32) {
    const float* e = part + (((long long)m * P + p) * G + g) * 3;
    merge(acc, {e[0], e[1], e[2]});
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Moments b = {__shfl_xor_sync(0xffffffffu, acc.n, o),
                       __shfl_xor_sync(0xffffffffu, acc.mean, o),
                       __shfl_xor_sync(0xffffffffu, acc.m2, o)};
    merge(acc, b);
  }
  if (lane == 0) {
    const float var = acc.n > 0.f ? __fdiv_rn(acc.m2, acc.n) : 0.f;
    stats[2 * idx] = acc.mean;
    stats[2 * idx + 1] = rsqrtf(var + eps);
  }
}

// The 8 channels s * 8 .. + 7 of image m: a and b as native_group_norm
// makes them from bf16 statistics.
__device__ __forceinline__ void affine(const float* __restrict__ stats,
                                       const __nv_bfloat16* __restrict__ gamma,
                                       const __nv_bfloat16* __restrict__ beta, int m, int s,
                                       int G, int CPG, float* a, float* b) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int c = s * VEC + e;
    const float* st = stats + ((long long)m * G + c / CPG) * 2;
    const float mean = rnd(st[0]), rstd = rnd(st[1]);
    a[e] = __fmul_rn(rstd, __bfloat162float(gamma[c]));
    b[e] = __fmaf_rn(-a[e], mean, __bfloat162float(beta[c]));
  }
}

// Apply: MODE 0 z, 1 relu(z), 2 relu(bf16(z + identity)). Block (m, p)
// takes vectors [p, p + 1) * THREADS * APPLY_ITEMS of image m.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
gn_apply(const uint4* __restrict__ x, const uint4* __restrict__ id, uint4* __restrict__ out,
         const float* __restrict__ stats, const __nv_bfloat16* __restrict__ gamma,
         const __nv_bfloat16* __restrict__ beta, long long vpi, int S, int G, int CPG, int P) {
  const int m = (int)(blockIdx.x / (unsigned)P), p = (int)(blockIdx.x % (unsigned)P);
  const int t = threadIdx.x;
  float a[VEC], b[VEC];
  affine(stats, gamma, beta, m, t % S, G, CPG, a, b);
  const long long base = (long long)m * vpi;
  const long long v0 = (long long)p * (THREADS * APPLY_ITEMS);
  const long long vend = min(v0 + (long long)THREADS * APPLY_ITEMS, vpi);
  for (long long v = v0 + t; v < vend; v += (long long)THREADS * UNROLL) {
    uint4 u[UNROLL], r[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long vk = v + (long long)k * THREADS;
      u[k] = vk < vend ? __ldg(x + base + vk) : make_uint4(0u, 0u, 0u, 0u);
      if (MODE == 2) r[k] = vk < vend ? __ldg(id + base + vk) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long vk = v + (long long)k * THREADS;
      if (vk >= vend) continue;
      float f[VEC], q[VEC];
      unpack(u[k], f);
      if (MODE == 2) unpack(r[k], q);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float z = rnd(__fmaf_rn(a[e], f[e], b[e]));
        f[e] = MODE == 0 ? z : MODE == 1 ? relu(z) : relu(rnd(__fadd_rn(z, q[e])));
      }
      out[base + vk] = pack(f);
    }
  }
}

__device__ __forceinline__ uint4 nan_max(const uint4& a, const uint4& b, bool larger) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 r;
  __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) pr[i] = larger ? __hmax2_nan(pa[i], pb[i]) : __hmin2_nan(pa[i], pb[i]);
  return r;
}

// Apply with ReLU and the 3 x 3 / stride 2 / pad 1 max-pool: out (M, Ho,
// Wo, C). Block (m, p) takes output vectors [p, p + 1) * THREADS *
// POOL_ITEMS of image m.
__global__ void __launch_bounds__(THREADS)
gn_apply_relu_pool(const uint4* __restrict__ x, uint4* __restrict__ out,
                   const float* __restrict__ stats, const __nv_bfloat16* __restrict__ gamma,
                   const __nv_bfloat16* __restrict__ beta, int H, int W, int Ho, int Wo, int S,
                   int G, int CPG, int P) {
  const int m = (int)(blockIdx.x / (unsigned)P), p = (int)(blockIdx.x % (unsigned)P);
  const int t = threadIdx.x, s = t % S;
  float a[VEC], b[VEC];
  affine(stats, gamma, beta, m, s, G, CPG, a, b);
  const long long vpo = (long long)Ho * Wo * S;
  const uint4* xm = x + (long long)m * H * W * S;
#pragma unroll 1
  for (int k = 0; k < POOL_ITEMS; ++k) {
    const long long o = (long long)p * (THREADS * POOL_ITEMS) + (long long)k * THREADS + t;
    if (o >= vpo) break;
    const long long pix = o / S;
    const int ho = (int)(pix / Wo), wo = (int)(pix - (long long)ho * Wo);
    uint4 u[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int h = min(max(2 * ho - 1 + i, 0), H - 1);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int w = min(max(2 * wo - 1 + j, 0), W - 1);
        u[3 * i + j] = __ldg(xm + ((long long)h * W + w) * S + s);
      }
    }
    uint4 hi = u[0], lo = u[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) {
      hi = nan_max(hi, u[i], true);
      lo = nan_max(lo, u[i], false);
    }
    float fh[VEC], fl[VEC], f0[VEC];
    unpack(hi, fh);
    unpack(lo, fl);
    unpack(u[0], f0);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float zh = rnd(__fmaf_rn(a[e], fh[e], b[e]));
      const float zl = rnd(__fmaf_rn(a[e], fl[e], b[e]));
      const float mz = (zl > zh || isnan(zl)) ? zl : zh;
      fh[e] = (mz > 0.f || isnan(mz)) ? mz : relu(rnd(__fmaf_rn(a[e], f0[e], b[e])));
    }
    out[(long long)m * vpo + o] = pack(fh);
  }
}

// Blocks an image in the statistics' first kernel: the wrapper sizes the
// partials (M, P, G, 3) fp32 by it (ops/group_norm.py::stats_blocks).
int stats_blocks(long long HW, int C) {
  const long long vpi = HW * (C / VEC);
  return (int)((vpi + THREADS * STATS_ITEMS - 1) / (THREADS * STATS_ITEMS));
}

bool shape_ok(int M, long long HW, int C, int G) {
  if (M < 0 || HW < 1 || C < VEC || C % VEC || G < 1 || C % G) return false;
  const int S = C / VEC, CPG = C / G;
  return THREADS % S == 0 && (CPG == VEC / 2 || CPG % VEC == 0);
}

}  // namespace

// The one entry. x (M, H, W, C) bf16, channels contiguous, 16-byte
// aligned, C a multiple of 8 with C / 8 dividing 256, C / G 4 or a
// multiple of 8; stats (M, G, 2) fp32: mean, rsqrt(var + eps). With part,
// (M, P, G, 3) fp32 scratch for P = stats_blocks(H * W, C), the statistics
// pass writes stats; without it stats is read as given. With out, the apply
// pass: gamma, beta (C) bf16; mode 0: out = z, 1: relu(z), 2: relu(bf16(z +
// identity)) with identity (M, H, W, C) bf16, 3: the 3 x 3 / stride 2 / pad
// 1 max-pool of relu(z), out (M, (H - 1) / 2 + 1, (W - 1) / 2 + 1, C); else
// out (M, H, W, C); each 16-byte aligned. Returns a cudaError_t.
extern "C" int gn_nhwc_bf16(const void* x, const void* identity, void* out, void* part,
                            void* stats, const void* gamma, const void* beta, int M, int H,
                            int W, int C, int G, int P, int mode, double eps, void* stream) {
  const long long HW = (long long)H * W;
  if (!shape_ok(M, HW, C, G) || H < 1 || W < 1 || stats == nullptr
      || (long long)M * G > 0x7fffffffLL
      || (part != nullptr && P != stats_blocks(HW, C))
      || (out != nullptr && (mode < 0 || mode > 3 || (mode == 2 && identity == nullptr)))) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return (int)cudaSuccess;
  const int S = C / VEC, CPG = C / G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  float* sv = static_cast<float*>(stats);
  if (part != nullptr) {
    const long long blocks = (long long)M * P;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    float* pp = static_cast<float*>(part);
    if (CPG == VEC / 2) {
      gn_stats_partial<2><<<(unsigned)blocks, THREADS, 0, st>>>(xv, pp, HW * S, S, G, CPG, P);
    } else {
      gn_stats_partial<1><<<(unsigned)blocks, THREADS, 0, st>>>(xv, pp, HW * S, S, G, CPG, P);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int MG = M * G, warps = THREADS / 32;
    gn_stats_final<<<(MG + warps - 1) / warps, THREADS, 0, st>>>(pp, sv, P, G, MG, (float)eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (out == nullptr) return (int)cudaSuccess;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long vecs = mode == 3 ? (long long)Ho * Wo * S : HW * S;
  const long long span = (long long)THREADS * (mode == 3 ? POOL_ITEMS : APPLY_ITEMS);
  const long long Pa = (vecs + span - 1) / span;
  const long long blocks = (long long)M * Pa;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const uint4* iv = static_cast<const uint4*>(identity);
  uint4* ov = static_cast<uint4*>(out);
  const __nv_bfloat16* gv = static_cast<const __nv_bfloat16*>(gamma);
  const __nv_bfloat16* bv = static_cast<const __nv_bfloat16*>(beta);
  const unsigned nb = (unsigned)blocks;
  switch (mode) {
    case 0: gn_apply<0><<<nb, THREADS, 0, st>>>(xv, iv, ov, sv, gv, bv, vecs, S, G, CPG, (int)Pa); break;
    case 1: gn_apply<1><<<nb, THREADS, 0, st>>>(xv, iv, ov, sv, gv, bv, vecs, S, G, CPG, (int)Pa); break;
    case 2: gn_apply<2><<<nb, THREADS, 0, st>>>(xv, iv, ov, sv, gv, bv, vecs, S, G, CPG, (int)Pa); break;
    default:
      gn_apply_relu_pool<<<nb, THREADS, 0, st>>>(xv, ov, sv, gv, bv, H, W, Ho, Wo, S, G, CPG,
                                                 (int)Pa);
  }
  return (int)cudaGetLastError();
}
