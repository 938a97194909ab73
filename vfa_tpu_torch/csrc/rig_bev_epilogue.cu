// The rig sampling's epilogue on bf16 for NVIDIA Hopper (sm_90a): the
// tiles of every scale, in the rig's tile order, to the BEV features in one
// launch. Serving only: nothing is saved for a backward.
//
// Replaces vfa_tpu/ops/rig_pallas.py::_bev_unpermute (an XLA gather, not
// a Pallas kernel) and the bias, ReLU and camera sum after it on the
// no-grad bf16 path: the port's per-scale chain
// vfa_tpu_torch/ops/rig.py::rig_epilogue and VFANet.sampling's fp32 adds
// over scales and final cast. That chain writes the whole (N, B, V2d, 256) map four times a scale (the
// gather, + bias, ReLU, the fp32 copy) before its camera sum. This kernel
// reads each gathered tile row once and writes each BEV row once, with
// the chain's roundings (ops/rig.py::rig_bev_sum is its plain version):
//
//   for each (scene b, cell v, channel c):
//     total = 0
//     for each scale s, in order:
//       acc = 0
//       for each camera n, in order:
//         x = rnd(tiles_s[n, b, inv_perm_s[n, v], c] + bias_s[c])   (rnd: to bf16)
//         acc = acc + max(x, 0)                                       (fp32)
//       total = total + acc                                           (fp32)
//     out[b, v, c] = rnd(total)
//
// What bounds it on the H100 (SXM, 700 W): bytes. No multiply at all; per
// (b, v) S N gathered rows of 512 bytes and one 512-byte row written. At
// Wildtrack batch 32 (N 7, V2d 43,200, 3 scales) 14.9 GB read and 0.71 GB
// written, 4.7 ms at 3.35 TB/s.
//
// What the design does about it: one warp a (scene, cell), 8 channels a
// lane, so that each gathered row is one 16-byte load of each of the 32
// lanes on consecutive addresses. Lanes 0 .. N-1 read the cell's N
// inv_perm entries of a scale and a shuffle hands each to every lane; the
// lanes then issue all the scale's gathered loads (up to GROUP in flight
// a lane) before the first add, so each warp keeps N loads in flight. Every
// add is an explicit round-to-nearest intrinsic (no fused multiply-add can
// form; there is no multiply), in camera order, then scale order: the same
// bits as the plain version on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SCALES = 3;
constexpr int WARPS = 8;      // (scene, cell) items a block
constexpr int LANE_CH = 8;    // channels a lane: one 16-byte load
constexpr int ROW_VEC = 32;   // 16-byte vectors a 256-channel row
constexpr int GROUP = 8;      // gathered loads in flight a lane

struct Scale {
  const uint4* tiles;          // (N, B, rows, 256) bf16
  const long long* inv_perm;   // (N, V2d) int64
  const uint4* bias;           // (256) bf16
  long long rows;
};

struct Scales {
  Scale s[MAX_SCALES];
};

__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < LANE_CH / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__global__ void __launch_bounds__(32 * WARPS)
rig_bev_epilogue_kernel(Scales sc, int S, int N, int B, int V2d,
                        uint4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long items = (long long)B * V2d;
  const long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= items) return;
  const long long b = item / V2d, v = item % V2d;
  float total[LANE_CH];
#pragma unroll
  for (int i = 0; i < LANE_CH; ++i) total[i] = 0.f;
#pragma unroll
  for (int s = 0; s < MAX_SCALES; ++s) {
    if (s >= S) break;
    const Scale p = sc.s[s];
    float bias[LANE_CH];
    unpack(__ldg(p.bias + lane), bias);
    const long long mine = lane < N ? __ldg(p.inv_perm + (long long)lane * V2d + v) : 0;
    float acc[LANE_CH];
#pragma unroll
    for (int i = 0; i < LANE_CH; ++i) acc[i] = 0.f;
    for (int n0 = 0; n0 < N; n0 += GROUP) {
      uint4 row[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int n = n0 + g;
        const long long r = __shfl_sync(0xffffffffu, mine, n & 31);
        if (n < N) {
          row[g] = __ldg(p.tiles + (((long long)n * B + b) * p.rows + r) * ROW_VEC + lane);
        }
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        if (n0 + g < N) {
          float x[LANE_CH];
          unpack(row[g], x);
#pragma unroll
          for (int i = 0; i < LANE_CH; ++i) {
            const float y = __bfloat162float(__float2bfloat16_rn(__fadd_rn(x[i], bias[i])));
            acc[i] = __fadd_rn(acc[i], y < 0.f ? 0.f : y);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < LANE_CH; ++i) total[i] = __fadd_rn(total[i], acc[i]);
  }
  uint4 res;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int i = 0; i < LANE_CH / 2; ++i) {
    h[i] = __floats2bfloat162_rn(total[2 * i], total[2 * i + 1]);
  }
  out[item * ROW_VEC + lane] = res;
}

}  // namespace

// tiles[s] (N, B, rows[s], 256) bf16, inv_perm[s] (N, V2d) int64 with
// entries in [0, rows[s]), bias[s] (256) bf16, for S <= 3 scales (host
// arrays of S entries; every device pointer 16-byte aligned); out (B, V2d,
// 256) bf16, written. N <= 32. Returns a cudaError_t.
extern "C" int rig_bev_epilogue_bf16(void* const* tiles, void* const* inv_perm,
                                     void* const* bias, const long long* rows,
                                     int S, void* out, int N, int B, int V2d,
                                     void* stream) {
  if (S < 1 || S > MAX_SCALES || N < 1 || N > 32 || B < 0 || V2d < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Scales sc = {};
  for (int s = 0; s < S; ++s) {
    if (rows[s] < 1) return (int)cudaErrorInvalidValue;
    sc.s[s] = {static_cast<const uint4*>(tiles[s]),
               static_cast<const long long*>(inv_perm[s]),
               static_cast<const uint4*>(bias[s]), rows[s]};
  }
  const long long items = (long long)B * V2d;
  if (items == 0) return (int)cudaSuccess;
  const long long blocks = (items + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rig_bev_epilogue_kernel<<<(unsigned)blocks, 32 * WARPS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      sc, S, N, B, V2d, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}
