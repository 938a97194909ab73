// The warp-specialised bf16 tile of the rig kernels for NVIDIA Hopper
// (sm_90a), window and flat layout, and the kernels written on it:
//   rig_wsvox       vox[n, b, t] = A[n, t] @ band(n, b, t), fp32 sums, over
//                   every bucket of a scale in one launch, the band a 2D
//                   window or a flat band of contiguous pixels: pass 1 of
//                   the bf16 forwards (rig_window_fwd_bf16, K1-bf16;
//                   rig_flat_fwd_bf16, K4-bf16; vox rounded to bf16) and of
//                   the bf16 backwards (rig_window_bwd_bf16, K2-bf16 /
//                   K3-bf16; rig_flat_bwd_bf16, K5-bf16; vox kept as hi + lo
//                   planes);
//   rig_wscollapse  out = sum_l vox_l @ Kr_l over every bucket of a scale:
//                   pass 2 of K1-bf16 and K4-bf16;
//   rig_wsdkr       dKr_l += vox_l^T @ g per depth chunk (added by
//                   rig_mma.cuh's rig_dkr_reduce): pass 2 of the backwards;
//   rig_wsdvox      dvox_l = g @ Kr_l^T: pass 3 of the backwards;
//   rig_wsdband     each band's fp32 A^T @ dvox (per layer where JAX's
//                   window backward is serial; never for a flat band) into a
//                   scratch, and then
//   rig_dii_reduce  (no tensor cores) dII += those in a fixed order, no
//                   atomics: pass 4 of the backwards.
// They replace vfa_tpu/ops/rig_pallas.py::_kernel_win, _kernel and the
// backwards _bwd_kernel_win_pipe / _bwd_kernel_win / _bwd_kernel on bf16
// inputs, with JAX's rounding points (rig_pallas.py:58-72, 177-191,
// 311-336, 416-425, 477-502).
//
// What bounds them on the H100 (SXM, 700 W): operations at the dense bf16
// rate (989.4 TFLOP/s). A 128-row item of rig_wsvox does 128 * 256 * 2
// operations per byte of its 64-deep band slice; rig_wsdband reads each
// tile's dvox once per 128 band positions (from L2 after the first), and
// the scratch round trip of rig_dii_reduce is bytes (a flat band covers a
// pixel 13-23 times on average at the full MultiviewC rig, a window fewer).
//
// The tile (the hopper-kernels guide's shape). A CTA of three warpgroups:
//   - warpgroups 0 and 1, the consumers (setmaxnreg 224): rows 0-63 and
//     64-127 of a 128-row item, each one wgmma.mma_async m64n256k16 per 16
//     depths, sharing the stage's B operand (the band slice, Kr's or dvox's
//     rows); fp32 sums in 128 registers a thread;
//   - warpgroup 2, the producer (setmaxnreg 56): one thread keeps TMA loads
//     in flight into a ring of NSTAGE stages, each guarded by a full and an
//     empty mbarrier; the tensor maps are encoded on the host for each
//     launch and passed in the kernel's parameters.
// ptxas still compiles the consumers to the 168 registers of a 384-thread
// launch bound (a CTA of 288 threads, one producer warp and no setmaxnreg,
// put three warps on one of the SM's four register partitions, 168 again),
// so every epilogue goes through shared memory and keeps no second copy of
// the sums in registers.
// rig_wsvox's stage is 64 depths: A's 128 rows x 64 depths, K-major, one
// 3D TMA box (K, R, N*T) with 128-byte swizzle (rows past R and depths past
// K come as zeros); and the band's 64 pixels x 256 channels, MN-major
// (channels contiguous), for wgmma's transposed B operand. A window's
// pixels are not contiguous in the image, but 16 neighbouring depths are:
// the window width is a multiple of 16 and so is every slice origin. A flat
// band is a window of one row over an image of one row (start + k, start a
// multiple of 8, the band a multiple of 8): every 16 depths are contiguous,
// and a band that is 8 (mod 16) takes its last segment whole, 8 depths
// past the band that meet A's zeros there against real, finite rows of the
// padded features (or TMA's zeros past the buffer's end). Each 16-depth
// segment is 4 TMA boxes of 16 pixels x 64 channels (one per 64-channel
// block, 128 bytes a pixel with 128-byte swizzle) from a 2D map over the
// features (256 channels, every pixel of every image; TMA's coordinates
// need no alignment), and the segment is one wgmma's depth (a ragged last
// stage repeats its last segment against A's zero depths past K). Each
// consumer keeps one stage's products in flight and frees the stage before
// it.
// The CTAs are persistent: one per SM, each walking the items i =
// blockIdx.x + j * gridDim.x in order (rig_wsvox: bucket, camera, tile,
// 128-row block, scene, the scene innermost so that the B CTAs reading one
// A block run together and share it through L2). The producer runs ahead
// into the next item while the consumers store the last one, and the
// shared-memory attribute is set once per kernel.
// Measured (chip_smoke.py, tools/prof_bf16_window.py; NVIDIA H100 80GB
// HBM3, 700 W): see PERF.md section 6.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rig_mma.cuh"   // DKR_CHAIN, DKR_MAX_SPLITS, rig_dkr_reduce

namespace wsb {
namespace {

using bf16 = __nv_bfloat16;

constexpr int CH = 256;          // channels: C == n_out == 256
constexpr int BM = 128;          // rows per item: two consumer warpgroups
constexpr int BK = 64;           // depths per stage
constexpr int SEG = 16;          // depths per segment (one wgmma)
constexpr int NSTAGE = 4;
constexpr int A_STAGE = BM * BK * 2;        // 16 KB
constexpr int B_BOX = SEG * 64 * 2;         // 2 KB: 16 pixels x 64 channels
constexpr int B_SEG = 4 * B_BOX;            // 8 KB: a segment's 256 channels
constexpr int B_STAGE = (BK / SEG) * B_SEG; // 32 KB
constexpr int STAGE = A_STAGE + B_STAGE;    // 48 KB, 1024-byte aligned
constexpr int THREADS = 384;   // two consumer warpgroups + the producer's
constexpr int PRODUCER = 256;  // the thread that issues every TMA load
constexpr int STAGING = 4096;                // epilogue bytes a consumer warp
constexpr int LDS = 72;                     // bf16 a staged row of 64 channels
constexpr int SMEM_BYTES = NSTAGE * STAGE + 8 * STAGING + 2 * NSTAGE * 8 + 1024;
constexpr int MAX_BUCKETS = 16;
constexpr int EPI_BF16 = 0;
constexpr int EPI_SPLIT = 1;
static_assert(STAGE % 1024 == 0 && A_STAGE % 1024 == 0, "swizzle atoms");

// Everything a launch needs, passed by value (kernel parameter space, where
// TMA reads its tensor maps).
struct alignas(64) VoxParams {
  CUtensorMap a_map[MAX_BUCKETS];   // A_b as (K, R, N*T_b), box (64, 128, 1)
  CUtensorMap band;                 // features as (256, N*B*Hp*Wp), box (64, 16)
  const int* starts[MAX_BUCKETS];   // (N, T_b, 2) window origins or (N, T_b) band starts
  bf16* out[MAX_BUCKETS];           // the bucket's vox scratch
  int item0[MAX_BUCKETS + 1];       // first item of each bucket
  int T[MAX_BUCKETS];
  int K[MAX_BUCKETS];
  int ww[MAX_BUCKETS];
  int nbuckets, B, Hp, Wp, R, rblocks;
  int flat;                         // flat bands: Hp == 1, starts (N, T_b)
  size_t plane;                     // EPI_SPLIT: elements of one plane
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, int c3,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1. A (K-major):
// the 8-row groups 1024 bytes apart, the leading offset unused (16), a
// 16-deep step 32 bytes on inside the 128-byte rows. The band (MN-major):
// leading offset B_BOX between 64-channel blocks, stride 1024 between
// groups of 8 pixels.
__device__ __forceinline__ uint64_t desc128(const void* p, uint32_t lbo,
                                           uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// d (64 x 256, fp32) (+)= a (64 x 16) @ b (16 x 256, MN-major), both from
// shared memory, a K-major (TRANS_A 0) or MN-major (1); `accumulate` 0
// overwrites d.
template <int TRANS_A = 0>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_A)
      : "memory");
}

// An item's place: bucket, camera-tile i = n*T + t, 128-row block, scene.
struct Item {
  int bk, n, t, rb, b;
};

__device__ __forceinline__ Item item_at(const VoxParams& p, int item) {
  int bk = 0;
  while (bk + 1 < p.nbuckets && item >= p.item0[bk + 1]) ++bk;
  int rest = item - p.item0[bk];
  Item it;
  it.bk = bk;
  it.b = rest % p.B;
  rest /= p.B;
  it.rb = rest % p.rblocks;
  rest /= p.rblocks;
  it.t = rest % p.T[bk];
  it.n = rest / p.T[bk];
  return it;
}

// The consumer's epilogue: accumulator element e of thread (warp w of the
// warpgroup, lane l) is row 16w + l/4 + 8*((e/2)&1), channel 8*(e/4) +
// 2*(l%4) + (e&1) of its 64 x 256 block. Each warp writes its 16 rows
// through its own STAGING bytes of shared memory, so that every store to
// device memory is a whole 16-byte quad of a row or of a channel's rows:
//   EPI_BF16: vox rounded to bf16 in the registers, staged 64 channels at
//             a time as [row][channel] (LDS apart, conflict-free), rows of
//             (N, B, T, R, C): row_ptr(r) -> row r of the warp's 16 or null;
//   EPI_SPLIT: vox unrounded as bf16 hi + lo planes (`plane` elements
//             apart), channel-major (N*B*T, C, R): staged in fp32 32
//             channels at a time as [channel][row] (17 floats apart), split
//             while stored: row_ptr(ch, half) -> rows 8*half .. + 7 of
//             channel ch in plane 0, or null;
//   EPI_ROWS: hi + lo planes, row-major: staged in fp32 32 channels at a
//             time as [row][channel] (36 floats apart): row_ptr(r) -> plane
//             0's row r, or null.
// The split variants move the unrounded sums out first and split them
// four or eight at a time, so that the registers hold no second copy of
// the block (ptxas gives the consumers 168 registers).
constexpr int EPI_ROWS = 2;

__device__ __forceinline__ void split8(const float* f, uint4& hi, uint4& lo) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&hi);
  __nv_bfloat162* l = reinterpret_cast<__nv_bfloat162*>(&lo);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h[i]);
    l[i] = __floats2bfloat162_rn(f[2 * i] - hf.x, f[2 * i + 1] - hf.y);
  }
}

template <int EPI, class RowPtr>
__device__ __forceinline__ void store_block(const float (&acc)[128], bf16* sb,
                                            RowPtr row_ptr, size_t plane) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (EPI == EPI_BF16) {
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) {
      __syncwarp();
#pragma unroll
      for (int qq = 0; qq < 8; ++qq)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 8 * cb + qq;
          *reinterpret_cast<__nv_bfloat162*>(sb + (g + 8 * h) * LDS + 8 * qq +
                                             2 * t) =
              __floats2bfloat162_rn(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
        }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 4; ++k) {   // 16 rows x 8 quads
        const int idx = lane + 32 * k;
        const int row = idx >> 3, c16 = idx & 7;
        bf16* dst = row_ptr(row);
        if (dst)
          *reinterpret_cast<uint4*>(dst + 64 * cb + 8 * c16) =
              *reinterpret_cast<const uint4*>(sb + row * LDS + 8 * c16);
      }
    }
  } else {
    float* sf = reinterpret_cast<float*>(sb);
#pragma unroll
    for (int ck = 0; ck < 8; ++ck) {   // 32 channels at a time
      __syncwarp();
#pragma unroll
      for (int qq = 0; qq < 4; ++qq)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[4 * (4 * ck + qq) + 2 * h + e];
            const int row = g + 8 * h, ch = 8 * qq + 2 * t + e;
            if constexpr (EPI == EPI_SPLIT)
              sf[ch * 17 + row] = v;
            else
              sf[row * 36 + ch] = v;
          }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 2; ++k) {   // 64 units of 8 values a warp
        const int u = lane + 32 * k;
        float f[8];
        bf16* dst;
        if constexpr (EPI == EPI_SPLIT) {
          const int ch = u >> 1, half = u & 1;
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] = sf[ch * 17 + 8 * half + i];
          dst = row_ptr(32 * ck + ch, half);
        } else {
          const int row = u >> 2, c8 = u & 3;
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] = sf[row * 36 + 8 * c8 + i];
          dst = row_ptr(row);
          if (dst) dst += 32 * ck + 8 * c8;
        }
        if (dst) {
          uint4 hi, lo;
          split8(f, hi, lo);
          *reinterpret_cast<uint4*>(dst) = hi;
          *reinterpret_cast<uint4*>(dst + plane) = lo;
        }
      }
    }
  }
}

// A consumer's 64 x 256 fp32 sums as rows of fp32: row_ptr(r) -> row r of
// the warp's 16 (or null). Staged 32 channels at a time as [row][channel]
// (36 floats apart), then 32 bytes of a row a lane.
template <class RowPtr>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[128],
                                               float* sf, RowPtr row_ptr) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ck = 0; ck < 8; ++ck) {
    __syncwarp();
#pragma unroll
    for (int qq = 0; qq < 4; ++qq)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(sf + (g + 8 * h) * 36 + 8 * qq + 2 * t) =
            make_float2(acc[4 * (4 * ck + qq) + 2 * h],
                        acc[4 * (4 * ck + qq) + 2 * h + 1]);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 2; ++k) {   // 16 rows x 4 groups of 8
      const int u = lane + 32 * k;
      const int row = u >> 2, c8 = u & 3;
      float* dst = row_ptr(row);
      if (dst) {
        float4* o = reinterpret_cast<float4*>(dst + 32 * ck + 8 * c8);
        const float4* i4 = reinterpret_cast<const float4*>(sf + row * 36 + 8 * c8);
        o[0] = i4[0];
        o[1] = i4[1];
      }
    }
  }
}

// EPI_BF16 / EPI_SPLIT of one vox item's 64 rows row0 .. row0 + 63.
template <int EPI>
__device__ __forceinline__ void store_vox(const VoxParams& p, const Item& it,
                                          int row0, const float (&acc)[128],
                                          bf16* sb) {
  const int rw = row0 + 16 * ((threadIdx.x >> 5) & 3);   // the warp's rows
  const size_t j = (size_t)(it.n * p.B + it.b) * p.T[it.bk] + it.t;
  bf16* out = p.out[it.bk];
  if constexpr (EPI == EPI_BF16) {
    store_block<EPI>(acc, sb, [&](int row) -> bf16* {
      return rw + row < p.R ? out + (j * p.R + rw + row) * CH : nullptr;
    }, 0);
  } else {
    store_block<EPI>(acc, sb, [&](int ch, int half) -> bf16* {
      return rw + 8 * half < p.R ? out + (j * CH + ch) * p.R + rw + 8 * half
                                 : nullptr;
    }, p.plane);
  }
}

template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
rig_wsvox(const __grid_constant__ VoxParams p, int items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + NSTAGE * STAGE + 8 * STAGING);
  uint64_t* empty = full + NSTAGE;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    if (threadIdx.x == PRODUCER) {
      int stage = 0, phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Item it = item_at(p, item);
        const int K = p.K[it.bk], ww = p.ww[it.bk];
        const int i = it.n * p.T[it.bk] + it.t;
        const int* st = p.starts[it.bk];
        const int ry = p.flat ? 0 : st[2 * i];
        const int rx = p.flat ? st[i] : st[2 * i + 1];
        const int img = (it.n * p.B + it.b) * p.Hp;
        for (int k0 = 0; k0 < K; k0 += BK) {
          // a flat band's last segment may hold 8 depths: taken whole
          const int nseg = (min(BK, K - k0) + SEG - 1) / SEG;
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* As = smem + stage * STAGE;
          unsigned char* Bs = As + A_STAGE;
          mbar_expect_tx(&full[stage], STAGE);
          tma_3d(As, &p.a_map[it.bk], k0, it.rb * BM, i, &full[stage]);
          // a ragged last stage repeats its last segment: A's depths past K
          // come as zeros, so the repeat adds nothing, and every stage is
          // four wgmma
#pragma unroll
          for (int s = 0; s < BK / SEG; ++s) {
            const int k = k0 + min(s, nseg - 1) * SEG;
            const int wy = p.flat ? 0 : k / ww;
            const int pix = (img + ry + wy) * p.Wp + rx + (k - wy * ww);
#pragma unroll
            for (int cb = 0; cb < 4; ++cb)
              tma_2d(Bs + s * B_SEG + cb * B_BOX, &p.band, 64 * cb, pix,
                     &full[stage]);
          }
          if (++stage == NSTAGE) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    const int c = wg;   // rows 64c .. 64c + 63 of each item
    const bool leader = (threadIdx.x & 31) == 0;
    int stage = 0, phase = 0;
    float acc[128];
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item it = item_at(p, item);
      const int K = p.K[it.bk];
      int prev = -1;   // the stage whose products may still run
      for (int k0 = 0; k0 < K; k0 += BK) {
        mbar_wait(&full[stage], phase);
        const unsigned char* As = smem + stage * STAGE + c * (64 * 128);
        const unsigned char* Bs = smem + stage * STAGE + A_STAGE;
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int s = 0; s < BK / SEG; ++s)
          wgmma_256(acc, desc128(As + 32 * s, 16, 1024),
                    desc128(Bs + s * B_SEG, B_BOX, 1024), (k0 | s) != 0);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        // one group stays in flight: the stage before this one is read
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == NSTAGE) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      if (leader) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int e = 0; e < 128; ++e) asm volatile("" : "+f"(acc[e])::"memory");
      store_vox<EPI>(p, it, it.rb * BM + 64 * c, acc,
                     reinterpret_cast<bf16*>(smem + NSTAGE * STAGE +
                                             (threadIdx.x / 32) * STAGING));
    }
  }
}

// ---- the dII pass of the bf16 backwards ----
//
// dII[n, b, band(n, t)] += A[n, t]^T @ dvox[n, b, t] for every tile t of a
// bucket (a window, or a flat band: a window of one row), in a fixed order
// and without atomics, in two kernels:
//   rig_wsdband, tile-stationary: an item is 128 band positions k0 ..
//     k0 + 127 of one tile and scene, the two consumer warpgroups 64 each
//     (the M of a wgmma m64n256k16); it writes its positions' fp32
//     A^T dvox, 256 channels, to a scratch (N*B, T, L, K, 256), L = 1 or,
//     where JAX's window backward is serial, nl: one product per layer.
//     The depth runs layer by layer in DK-row stages: A's rows, a 4D TMA
//     box (64, DK, 1, 1) over A as (K, tile_v, nl, N*T) with 128-byte
//     swizzle, 128 contiguous bytes a row (wgmma's MN-major, transposed A
//     operand; positions past K and rows past the layer come as zeros),
//     and dvox's DK rows (hi and lo planes, 256 channels), 2D TMA boxes of
//     64 channels, MN-major B: acc += A^T dvox_lo + A^T dvox_hi. The items
//     of one (tile, scene) run one after another, the position block
//     innermost, so that its dvox is read from device memory once and then
//     from L2;
//   rig_dii_reduce, output-stationary and memory-bound: a warp owns one
//     (pixel, scene) of dII (8 channels a lane), reads it once, walks the
//     pixel's adds (ops/rig.window_dii_index, flat_dii_index: (tile, band
//     position) in tile order, layer by layer inside a tile where serial;
//     buckets launch in order, so a scale's adds run in JAX's grid order,
//     bucket, camera, tile, scene), adds each
//     scratch row in fp32 with one rounding to bf16, and writes it once.
// (An output-stationary single pass, each 8 x 16 pixel block walking the
// tiles whose window meets it, re-read each tile's dvox from device memory
// for every block: 16.7-17.3 ms of the 30 ms batch-2 backward, PERF.md.)

constexpr int DK = 32;                      // rows a stage
constexpr int D_BOX = DK * 64 * 2;          // 4 KB: DK rows x 64 values
constexpr int D_STAGE = 2 * D_BOX + 8 * D_BOX;   // A's 128 positions, 2 x 4 of dvox
constexpr int D_NSTAGE = 4;
constexpr int D_SMEM = D_NSTAGE * D_STAGE + 8 * STAGING + 2 * D_NSTAGE * 8 + 1024;
static_assert(D_STAGE % 1024 == 0, "swizzle atoms");

struct alignas(64) DbandParams {
  CUtensorMap a_map;       // A as (K, tile_v, nl, N*T), box (64, DK, 1, 1)
  CUtensorMap d_map[2];    // dvox planes (hi, lo) as (256, N*B*T*R)
  float* scratch;          // (N*B, T, L, K, 256)
  int B, T, nl, tile_v, R, K, kblocks, serial;
};

__global__ void __launch_bounds__(THREADS, 1)
rig_wsdband(const __grid_constant__ DbandParams p, int items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + D_NSTAGE * D_STAGE +
                                               8 * STAGING);
  uint64_t* empty = full + D_NSTAGE;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < D_NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int slices = (p.tile_v + DK - 1) / DK;
  // item = ((n*T + t)*B + b)*kblocks + kb
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    if (threadIdx.x == PRODUCER) {
      int stage = 0, phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int kb = item % p.kblocks;
        const int b = (item / p.kblocks) % p.B;
        const int i = item / (p.kblocks * p.B);
        const int drow = ((i / p.T * p.B + b) * p.T + i % p.T) * p.R;
        for (int l = 0; l < p.nl; ++l)
          for (int v = 0; v < slices; ++v) {
            mbar_wait(&empty[stage], phase ^ 1);
            unsigned char* st = smem + stage * D_STAGE;
            mbar_expect_tx(&full[stage], D_STAGE);
#pragma unroll
            for (int c = 0; c < 2; ++c)
              tma_4d(st + c * D_BOX, &p.a_map, 128 * kb + 64 * c, v * DK, l, i,
                     &full[stage]);
#pragma unroll
            for (int pl = 0; pl < 2; ++pl)
#pragma unroll
              for (int cb = 0; cb < 4; ++cb)
                tma_2d(st + (2 + 4 * pl + cb) * D_BOX, &p.d_map[pl], 64 * cb,
                       drow + l * p.tile_v + v * DK, &full[stage]);
            if (++stage == D_NSTAGE) {
              stage = 0;
              phase ^= 1;
            }
          }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    const int c = wg;   // positions 64c .. 64c + 63 of each item
    const bool leader = (threadIdx.x & 31) == 0;
    float* sf = reinterpret_cast<float*>(smem + D_NSTAGE * D_STAGE +
                                         (threadIdx.x / 32) * STAGING);
    const int L = p.serial ? p.nl : 1;
    int stage = 0, phase = 0;
    float acc[128];
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int kb = item % p.kblocks;
      const int b = (item / p.kblocks) % p.B;
      const int i = item / (p.kblocks * p.B);
      const int kw = 128 * kb + 64 * c + 16 * ((threadIdx.x >> 5) & 3);
      int prev = -1;
      for (int l = 0; l < p.nl; ++l) {
        for (int v = 0; v < slices; ++v) {
          mbar_wait(&full[stage], phase);
          const unsigned char* st = smem + stage * D_STAGE;
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int s = 0; s < DK / 16; ++s) {
            const uint64_t a = desc128(st + c * D_BOX + 2048 * s, D_BOX, 1024);
            // the lo plane first: the small product
            wgmma_256<1>(acc, a, desc128(st + 6 * D_BOX + 2048 * s, D_BOX, 1024),
                         v > 0 || s > 0 || (l > 0 && !p.serial));
            wgmma_256<1>(acc, a, desc128(st + 2 * D_BOX + 2048 * s, D_BOX, 1024),
                         1);
          }
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
          prev = stage;
          if (++stage == D_NSTAGE) {
            stage = 0;
            phase ^= 1;
          }
        }
        if (!(p.serial || l == p.nl - 1)) continue;
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        if (leader) mbar_arrive(&empty[prev]);
        prev = -1;
        // rows k of (n*B + b, t, layer) of the scratch, fp32
        const int n = i / p.T, t = i % p.T;
        float* rows = p.scratch +
                      ((((size_t)(n * p.B + b) * p.T + t) * L + (p.serial ? l : 0)) *
                       p.K) * CH;
        store_rows_f32(acc, sf, [&](int row) -> float* {
          return kw + row < p.K ? rows + (size_t)(kw + row) * CH : nullptr;
        });
      }
    }
  }
}

// dII of one bucket from its scratch: a warp a (pixel, scene), pixel j of
// the index (camera, row * Wp + column; a flat band's row is 0) with
// adds[ptr[j] .. ptr[j+1]) of (tile, band position); grid
// (ceil(n_pixels / 8), B), 256 threads.
__global__ void __launch_bounds__(256)
rig_dii_reduce(const float* __restrict__ scratch, bf16* __restrict__ dII,
               const int* __restrict__ pixels, const int* __restrict__ ptr,
               const int* __restrict__ adds, int n_pixels, int B, int HW,
               int T, int L, int K) {
  const int j = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (j >= n_pixels) return;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int nb = pixels[2 * j] * B + b;
  uint4* d = reinterpret_cast<uint4*>(dII + ((size_t)nb * HW + pixels[2 * j + 1]) *
                                                CH + 8 * lane);
  uint4 u = *d;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  const int e1 = ptr[j + 1];
  for (int e = ptr[j]; e < e1; ++e) {
    const float* src = scratch + (((size_t)nb * T + adds[2 * e]) * L * K +
                                  adds[2 * e + 1]) * CH + 8 * lane;
    for (int l = 0; l < L; ++l, src += (size_t)K * CH) {
      const float4 f0 = reinterpret_cast<const float4*>(src)[0];
      const float4 f1 = reinterpret_cast<const float4*>(src)[1];
      const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 o = __bfloat1622float2(h[q]);
        h[q] = __floats2bfloat162_rn(o.x + f[2 * q], o.y + f[2 * q + 1]);
      }
    }
  }
  *d = u;
}

// ---- the dKr pass of the bf16 window backward ----
//
// dKr_l += vox_l^T @ g over every cell (n, b, t, v) of a bucket: an item is
// one layer, 128 channels (64 a consumer warpgroup) and a chunk of the
// (n, b, t) tiles (a depth split); a stage is 64 cells of one tile: both
// vox planes' rows of the item's channels (4D TMA boxes (64, 1, 128, 1)
// over voxT as (tile_v, nl, C, N*B*T), K-major; cells past tile_v come as
// zeros) and g's 64 rows (MN-major): acc += vox_lo^T g + vox_hi^T g. A
// chain of tensor-core sums ends after about `chain` tiles, as the fp32
// kernels' does, and is added into the item's rows of the workspace ws
// (splits, nl, C, n_out) by plain loads and stores (the rows are the
// item's alone); rig_dkr_reduce (rig_mma.cuh) then adds the splits into
// dKr in a fixed order.

constexpr int K_NSTAGE = 3;
constexpr int K_STAGE = 2 * A_STAGE + B_STAGE;   // vox hi, lo; g
constexpr int K_SMEM = K_NSTAGE * K_STAGE + 2 * K_NSTAGE * 8 + 1024;

struct alignas(64) DkrParams {
  CUtensorMap v_map[2];   // voxT planes (hi, lo) as (tile_v, nl, C, N*B*T)
  CUtensorMap g_map;      // g as (n_out, N*B*rows_total), box (64, 64)
  float* ws;              // (splits, nl, C, n_out)
  int T, nl, tile_v, off_t, rows_total, NBT, per, vsteps, chain;
};

__global__ void __launch_bounds__(THREADS, 1)
rig_wsdkr(const __grid_constant__ DkrParams p, int items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K_NSTAGE * K_STAGE);
  uint64_t* empty = full + K_NSTAGE;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < K_NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // item = (z * nl + l) * 2 + channel block
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    if (threadIdx.x == PRODUCER) {
      int stage = 0, phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int cb2 = item & 1, l = (item >> 1) % p.nl, z = (item >> 1) / p.nl;
        const int j1 = min((z + 1) * p.per, p.NBT);
        for (int j = z * p.per; j < j1; ++j) {
          const int grow = (j / p.T) * p.rows_total +
                           (p.off_t + j % p.T) * p.tile_v;
          for (int vs = 0; vs < p.vsteps; ++vs) {
            mbar_wait(&empty[stage], phase ^ 1);
            unsigned char* st = smem + stage * K_STAGE;
            mbar_expect_tx(&full[stage], K_STAGE);
#pragma unroll
            for (int pl = 0; pl < 2; ++pl)
              tma_4d(st + pl * A_STAGE, &p.v_map[pl], 64 * vs, l, 128 * cb2, j,
                     &full[stage]);
#pragma unroll
            for (int cb = 0; cb < 4; ++cb)
              tma_2d(st + 2 * A_STAGE + cb * (BK * 128), &p.g_map, 64 * cb,
                     grow + 64 * vs, &full[stage]);
            if (++stage == K_NSTAGE) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    const int c = wg;
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    int stage = 0, phase = 0;
    float acc[128];
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int cb2 = item & 1, l = (item >> 1) % p.nl, z = (item >> 1) / p.nl;
      const int j0 = z * p.per, j1 = min(j0 + p.per, p.NBT);
      // rows 16w + lane/4 (+ 8) of this warpgroup's 64 channels
      float* rows = p.ws + (((size_t)z * p.nl + l) * CH + 128 * cb2 + 64 * c +
                            16 * w + (lane >> 2)) * CH + 2 * (lane & 3);
      for (int ja = j0; ja < j1; ja += p.chain) {
        const int jb = min(ja + p.chain, j1);
        int prev = -1;
        for (int j = ja; j < jb; ++j)
          for (int vs = 0; vs < p.vsteps; ++vs) {
            mbar_wait(&full[stage], phase);
            const unsigned char* st = smem + stage * K_STAGE;
            asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
            for (int s = 0; s < BK / SEG; ++s) {
              const uint64_t b = desc128(st + 2 * A_STAGE + 2048 * s, BK * 128, 1024);
              // the lo plane first: the small product
              wgmma_256(acc, desc128(st + A_STAGE + c * 8192 + 32 * s, 16, 1024),
                        b, j > ja || vs > 0 || s > 0);
              wgmma_256(acc, desc128(st + c * 8192 + 32 * s, 16, 1024), b, 1);
            }
            asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
            if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
            prev = stage;
            if (++stage == K_NSTAGE) {
              stage = 0;
              phase ^= 1;
            }
          }
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        if (lane == 0) mbar_arrive(&empty[prev]);
        // the chain into the item's rows of ws: stored by the first chain,
        // added by the others
        const bool first = ja == j0;
#pragma unroll
        for (int q = 0; q < 32; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* d = reinterpret_cast<float2*>(rows + (size_t)8 * h * CH + 8 * q);
            float2 v = make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
            if (!first) {
              const float2 o = *d;
              v.x += o.x;
              v.y += o.y;
            }
            *d = v;
          }
      }
    }
  }
}

// ---- the dvox pass of the bf16 window backward ----
//
// dvox_l = g[n, b, cells] @ Kr[l]^T for every cell (t, v) of a bucket and
// every layer, fp32 sums stored as bf16 hi + lo planes, row-major (N*B*T,
// R, C) at row t*R + l*tile_v + v: JAX's unrounded dvox
// (rig_pallas.py:311-336). An item is 128 cells of one (n, b) image and one
// layer; depth n_out = 256 in 4 stages. A: 128 rows of g, K-major (TMA box
// (64, 128) over g as (256, N*B*rows_total); rows past the bucket's cells
// are read and not stored); B: 64 rows of KrT_l, MN-major (4 boxes of 64
// channels over KrT as (256, nl*256)).

struct alignas(64) DvoxParams {
  CUtensorMap g_map;
  CUtensorMap k_map;
  bf16* dvox;
  size_t plane;
  int T, tile_v, nl, R, off_t, rows_total, cells, cblocks;
};

__global__ void __launch_bounds__(THREADS, 1)
rig_wsdvox(const __grid_constant__ DvoxParams p, int items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + NSTAGE * STAGE + 8 * STAGING);
  uint64_t* empty = full + NSTAGE;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    if (threadIdx.x == PRODUCER) {
      int stage = 0, phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int cblk = item % p.cblocks;
        const int l = (item / p.cblocks) % p.nl;
        const int nb = item / (p.cblocks * p.nl);
        const int grow = nb * p.rows_total + p.off_t * p.tile_v + cblk * BM;
        for (int k0 = 0; k0 < CH; k0 += BK) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* As = smem + stage * STAGE;
          mbar_expect_tx(&full[stage], STAGE);
          tma_2d(As, &p.g_map, k0, grow, &full[stage]);
#pragma unroll
          for (int cb = 0; cb < 4; ++cb)
            tma_2d(As + A_STAGE + cb * (BK * 128), &p.k_map, 64 * cb,
                   l * CH + k0, &full[stage]);
          if (++stage == NSTAGE) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    const int c = wg;
    const bool leader = (threadIdx.x & 31) == 0;
    bf16* sb = reinterpret_cast<bf16*>(smem + NSTAGE * STAGE +
                                       (threadIdx.x / 32) * STAGING);
    int stage = 0, phase = 0;
    float acc[128];
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int cblk = item % p.cblocks;
      const int l = (item / p.cblocks) % p.nl;
      const int nb = item / (p.cblocks * p.nl);
      int prev = -1;
      for (int k0 = 0; k0 < CH; k0 += BK) {
        mbar_wait(&full[stage], phase);
        const unsigned char* As = smem + stage * STAGE + c * (64 * 128);
        const unsigned char* Bs = smem + stage * STAGE + A_STAGE;
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int s = 0; s < BK / SEG; ++s)
          wgmma_256(acc, desc128(As + 32 * s, 16, 1024),
                    desc128(Bs + s * 2048, BK * 128, 1024), (k0 | s) != 0);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == NSTAGE) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      if (leader) mbar_arrive(&empty[prev]);
      const int rw = cblk * BM + 64 * c + 16 * ((threadIdx.x >> 5) & 3);
      store_block<EPI_ROWS>(acc, sb, [&](int row) -> bf16* {
        const int rr = rw + row;
        if (rr >= p.cells) return nullptr;
        return p.dvox + (((size_t)nb * p.T + rr / p.tile_v) * p.R +
                         (size_t)l * p.tile_v + rr % p.tile_v) * CH;
      }, p.plane);
    }
  }
}

// ---- the collapse of the bf16 window forward ----
//
// out[n, b, (off_t + t)*tile_v + v] = sum_l vox[n, b, t][l*tile_v + v] @
// Kr[l] over every cell of every bucket of a scale, one chain of depth
// nl*C in fp32, rounded to bf16 (JAX's _kernel_win, rig_pallas.py:177-191).
// A cell group is 64 cells (t, v0 .. v0 + 63) of one (n, b) image; an item
// is two consecutive groups, one a consumer warpgroup, which share the
// stage's Kr rows (the B operand, the same for every cell). A stage is 64
// depths of one layer: each group's vox rows, a 4D TMA box (64, 64, 1, 1)
// over its bucket's vox as (C, tile_v, nl, N*B*T) (cells past tile_v come
// as zeros), and Kr's 64 rows, MN-major.

struct alignas(64) CollapseParams {
  CUtensorMap v_map[MAX_BUCKETS];   // vox_b as (C, tile_v, nl, N*B*T_b)
  CUtensorMap k_map;                // Kr as (n_out, nl*C), box (64, 64)
  bf16* out;                        // (N, B, rows_total, n_out)
  int item0[MAX_BUCKETS + 1];
  int T[MAX_BUCKETS];
  int off_t[MAX_BUCKETS];
  int nbuckets, B, nl, tile_v, rows_total, groups;   // groups: per tile
};

struct Group {
  int bk, nb, t, v0;   // nb == N*B: no group (the second of an odd count)
};

__device__ __forceinline__ Group group_at(const CollapseParams& p, int item,
                                          int c) {
  int bk = 0;
  while (bk + 1 < p.nbuckets && item >= p.item0[bk + 1]) ++bk;
  const int gi = 2 * (item - p.item0[bk]) + c;
  const int per_nb = p.T[bk] * p.groups;
  Group g;
  g.bk = bk;
  g.nb = gi / per_nb;
  g.t = (gi % per_nb) / p.groups;
  g.v0 = 64 * (gi % p.groups);
  return g;
}

__global__ void __launch_bounds__(THREADS, 1)
rig_wscollapse(const __grid_constant__ CollapseParams p, int items, int NB) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + NSTAGE * STAGE + 8 * STAGING);
  uint64_t* empty = full + NSTAGE;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int depth = p.nl * CH;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    if (threadIdx.x == PRODUCER) {
      int stage = 0, phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Group gr[2] = {group_at(p, item, 0), group_at(p, item, 1)};
        const bool ok[2] = {gr[0].nb < NB, gr[1].nb < NB};
        for (int k0 = 0; k0 < depth; k0 += BK) {
          const int l = k0 / CH;
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* As = smem + stage * STAGE;
          mbar_expect_tx(&full[stage],
                         B_STAGE + (ok[0] + ok[1]) * (A_STAGE / 2));
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (ok[c])
              tma_4d(As + c * (A_STAGE / 2), &p.v_map[gr[c].bk], k0 % CH,
                     gr[c].v0, l, gr[c].nb * p.T[gr[c].bk] + gr[c].t,
                     &full[stage]);
#pragma unroll
          for (int cb = 0; cb < 4; ++cb)
            tma_2d(As + A_STAGE + cb * (BK * 128), &p.k_map, 64 * cb, k0,
                   &full[stage]);
          if (++stage == NSTAGE) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    const int c = wg;
    const bool leader = (threadIdx.x & 31) == 0;
    bf16* sb = reinterpret_cast<bf16*>(smem + NSTAGE * STAGE +
                                       (threadIdx.x / 32) * STAGING);
    int stage = 0, phase = 0;
    float acc[128];
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Group gr = group_at(p, item, c);
      const bool ok = gr.nb < NB;
      int prev = -1;
      for (int k0 = 0; k0 < depth; k0 += BK) {
        mbar_wait(&full[stage], phase);
        if (ok) {
          const unsigned char* As = smem + stage * STAGE + c * (A_STAGE / 2);
          const unsigned char* Bs = smem + stage * STAGE + A_STAGE;
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int s = 0; s < BK / SEG; ++s)
            wgmma_256(acc, desc128(As + 32 * s, 16, 1024),
                      desc128(Bs + s * 2048, BK * 128, 1024), (k0 | s) != 0);
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        }
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == NSTAGE) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      if (leader) mbar_arrive(&empty[prev]);
      if (!ok) continue;
      const int vw = gr.v0 + 16 * ((threadIdx.x >> 5) & 3);
      bf16* row0 = p.out + ((size_t)gr.nb * p.rows_total +
                            (size_t)(p.off_t[gr.bk] + gr.t) * p.tile_v) * CH;
      store_block<EPI_BF16>(acc, sb, [&](int row) -> bf16* {
        return vw + row < p.tile_v ? row0 + (size_t)(vw + row) * CH : nullptr;
      }, 0);
    }
  }
}

// ---- host side ----

inline cudaError_t encode_map(
    CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
    const uint64_t* strides, const uint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const uint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}


// Fill the parameters of one launch over `nb` buckets of one scale and
// launch it. ii (N, B, Hp, Wp, 256) bf16; per bucket A[bk] (N, T, R, K),
// starts[bk] (N, T, 2) window origins with window width ww[bk] (K a multiple
// of 16), or, with ww null, (N, T) flat band starts into ii as (N, B, 1,
// Wp) (K a multiple of 8); out[bk] its scratch. EPI_SPLIT: plane = elements
// of one plane of a single bucket (nb must be 1).
template <int EPI>
inline int ws_vox_launch(const bf16* ii, const bf16* const* A,
                         const int* const* starts, bf16* const* out,
                         const int* T, const int* K, const int* ww, int nb,
                         int N, int B, int Hp, int Wp, int R, size_t plane,
                         cudaStream_t s) {
  const bool flat = ww == nullptr;
  if (nb < 1 || nb > MAX_BUCKETS || R < 1 || N < 1 || B < 1 ||
      (EPI == EPI_SPLIT && nb != 1) || (flat && Hp != 1))
    return (int)cudaErrorInvalidValue;
  VoxParams p{};   // copied into the launch by value
  const uint64_t pixels = (uint64_t)N * B * Hp * Wp;
  {
    const uint64_t dims[2] = {CH, pixels};
    const uint64_t strides[1] = {CH * 2};
    const uint32_t box[2] = {64, SEG};
    cudaError_t e = encode_map(&p.band, ii, 2, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
  }
  long long items = 0;
  p.rblocks = (R + BM - 1) / BM;
  for (int bk = 0; bk < nb; ++bk) {
    if (T[bk] < 1 || (flat ? K[bk] < 8 || K[bk] % 8
                           : K[bk] < SEG || K[bk] % SEG || ww[bk] % SEG))
      return (int)cudaErrorInvalidValue;
    const uint64_t dims[3] = {(uint64_t)K[bk], (uint64_t)R,
                              (uint64_t)N * T[bk]};
    const uint64_t strides[2] = {(uint64_t)K[bk] * 2, (uint64_t)R * K[bk] * 2};
    const uint32_t box[3] = {BK, BM, 1};
    cudaError_t e = encode_map(&p.a_map[bk], A[bk], 3, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
    p.starts[bk] = starts[bk];
    p.out[bk] = out[bk];
    p.T[bk] = T[bk];
    p.K[bk] = K[bk];
    p.ww[bk] = flat ? 0 : ww[bk];
    p.item0[bk] = (int)items;
    items += (long long)N * T[bk] * p.rblocks * B;
  }
  if (items > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  p.item0[nb] = (int)items;
  p.nbuckets = nb;
  p.B = B;
  p.Hp = Hp;
  p.Wp = Wp;
  p.R = R;
  p.flat = flat;
  p.plane = plane;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        rig_wsvox<EPI_BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rig_wsvox<EPI_SPLIT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int grid = (int)(items < num_sms() ? items : num_sms());
  rig_wsvox<EPI><<<grid, THREADS, SMEM_BYTES, s>>>(p, (int)items);
  return (int)cudaGetLastError();
}

// The dII pass of one bucket: A (N, T, nl*tile_v, K) bf16 (K a multiple
// of 8: its rows' 2*K bytes a multiple of 16, as TMA needs); dvox the two
// planes (plane elements apart) of (N*B*T, R, 256); scratch fp32 (N*B, T,
// L, K, 256), L = serial ? nl : 1 (positions past K are neither written nor
// read); dII (N, B, Hp, Wp, 256) bf16, added to in the order of the index
// (n_pixels pixels, their adds).
inline int ws_dii_launch(const bf16* A, const bf16* dvox, size_t plane,
                         float* scratch, bf16* dII, const int* pixels,
                         const int* ptr, const int* adds, int n_pixels,
                         int serial, int N, int B, int Hp, int Wp, int T,
                         int nl, int tile_v, int K, cudaStream_t s) {
  if (n_pixels < 1 || K < 8 || K % 8 || tile_v < 1 || nl < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  DbandParams p{};
  const int R = nl * tile_v;
  {
    const uint64_t dims[4] = {(uint64_t)K, (uint64_t)tile_v, (uint64_t)nl,
                              (uint64_t)N * T};
    const uint64_t strides[3] = {(uint64_t)K * 2, (uint64_t)tile_v * K * 2,
                                 (uint64_t)R * K * 2};
    const uint32_t box[4] = {64, DK, 1, 1};
    cudaError_t e = encode_map(&p.a_map, A, 4, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
  }
  for (int pl = 0; pl < 2; ++pl) {
    const uint64_t dims[2] = {CH, (uint64_t)N * B * T * R};
    const uint64_t strides[1] = {CH * 2};
    const uint32_t box[2] = {64, DK};
    cudaError_t e = encode_map(&p.d_map[pl], dvox + pl * plane, 2, dims,
                               strides, box);
    if (e != cudaSuccess) return (int)e;
  }
  p.scratch = scratch;
  p.B = B;
  p.T = T;
  p.nl = nl;
  p.tile_v = tile_v;
  p.R = R;
  p.K = K;
  p.kblocks = (K + 127) / 128;
  p.serial = serial;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        rig_wsdband, cudaFuncAttributeMaxDynamicSharedMemorySize, D_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const long long items = (long long)N * T * B * p.kblocks;
  if (items > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < num_sms() ? items : num_sms());
  rig_wsdband<<<grid, THREADS, D_SMEM, s>>>(p, (int)items);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rig_dii_reduce<<<dim3((n_pixels + 7) / 8, B), 256, 0, s>>>(
      scratch, dII, pixels, ptr, adds, n_pixels, B, Hp * Wp, T,
      serial ? nl : 1, K);
  return (int)cudaGetLastError();
}

// The dKr pass's first stage for one bucket: voxT the two planes (plane
// elements apart) of (N*B*T, C, nl*tile_v); g the scale's (N, B,
// rows_total, 256) cotangent; ws (splits, nl, 256, 256) fp32. Returns the
// number of splits in *splits for rig_dkr_reduce.
inline int ws_dkr_launch(const bf16* voxT, size_t plane, const bf16* g,
                         float* ws, int NB, int T, int nl, int tile_v,
                         int off_t, int rows_total, int max_splits,
                         int max_chain, int* splits, cudaStream_t s) {
  if (NB < 1 || T < 1 || nl < 1 || tile_v < 8 || tile_v % 8)
    return (int)cudaErrorInvalidValue;
  DkrParams p{};
  const int R = nl * tile_v;
  const int NBT = NB * T;
  for (int pl = 0; pl < 2; ++pl) {
    const uint64_t dims[4] = {(uint64_t)tile_v, (uint64_t)nl, CH, (uint64_t)NBT};
    const uint64_t strides[3] = {(uint64_t)tile_v * 2, (uint64_t)R * 2,
                                 (uint64_t)CH * R * 2};
    const uint32_t box[4] = {64, 1, 128, 1};
    cudaError_t e = encode_map(&p.v_map[pl], voxT + pl * plane, 4, dims,
                               strides, box);
    if (e != cudaSuccess) return (int)e;
  }
  {
    const uint64_t dims[2] = {CH, (uint64_t)NB * rows_total};
    const uint64_t strides[1] = {CH * 2};
    const uint32_t box[2] = {64, 64};
    cudaError_t e = encode_map(&p.g_map, g, 2, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
  }
  // as many depth chunks as fill the card, at least one tile each
  int z = num_sms() / (2 * nl);
  z = z < 1 ? 1 : z > max_splits ? max_splits : z;
  p.per = (NBT + z - 1) / z;
  *splits = (NBT + p.per - 1) / p.per;
  p.ws = ws;
  p.T = T;
  p.nl = nl;
  p.tile_v = tile_v;
  p.off_t = off_t;
  p.rows_total = rows_total;
  p.NBT = NBT;
  p.vsteps = (tile_v + 63) / 64;
  p.chain = max_chain / (64 * p.vsteps) > 1 ? max_chain / (64 * p.vsteps) : 1;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        rig_wsdkr, cudaFuncAttributeMaxDynamicSharedMemorySize, K_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int items = *splits * nl * 2;
  rig_wsdkr<<<items < num_sms() ? items : num_sms(), THREADS, K_SMEM, s>>>(
      p, items);
  return (int)cudaGetLastError();
}

// The dvox pass of one bucket: g the scale's (N, B, rows_total, 256)
// cotangent, KrT (nl, 256, 256) (Kr with its last two axes swapped), dvox
// the two planes of (N*B*T, nl*tile_v, 256), plane elements apart.
inline int ws_dvox_launch(const bf16* g, const bf16* KrT, bf16* dvox,
                          size_t plane, int NB, int T, int nl, int tile_v,
                          int off_t, int rows_total, cudaStream_t s) {
  if (NB < 1 || T < 1 || nl < 1 || tile_v < 1) return (int)cudaErrorInvalidValue;
  DvoxParams p{};
  {
    const uint64_t dims[2] = {CH, (uint64_t)NB * rows_total};
    const uint64_t strides[1] = {CH * 2};
    const uint32_t box[2] = {BK, BM};
    cudaError_t e = encode_map(&p.g_map, g, 2, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
  }
  {
    const uint64_t dims[2] = {CH, (uint64_t)nl * CH};
    const uint64_t strides[1] = {CH * 2};
    const uint32_t box[2] = {64, BK};
    cudaError_t e = encode_map(&p.k_map, KrT, 2, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
  }
  p.dvox = dvox;
  p.plane = plane;
  p.T = T;
  p.tile_v = tile_v;
  p.nl = nl;
  p.R = nl * tile_v;
  p.off_t = off_t;
  p.rows_total = rows_total;
  p.cells = T * tile_v;
  p.cblocks = (p.cells + BM - 1) / BM;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        rig_wsdvox, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const long long items = (long long)NB * nl * p.cblocks;
  if (items > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < num_sms() ? items : num_sms());
  rig_wsdvox<<<grid, THREADS, SMEM_BYTES, s>>>(p, (int)items);
  return (int)cudaGetLastError();
}

// The collapse of `nb` buckets of one scale in one launch: vox[bk] (N, B,
// T[bk], nl*tile_v, 256) bf16, Kr (nl, 256, 256) bf16, out the scale's (N,
// B, rows_total, 256) bf16 tiles, bucket bk's rows at off_t[bk]*tile_v.
inline int ws_collapse_launch(bf16* const* vox, const int* T, const int* off_t,
                              int nb, const bf16* Kr, bf16* out, int N, int B,
                              int nl, int tile_v, int rows_total,
                              cudaStream_t s) {
  if (nb < 1 || nb > MAX_BUCKETS || nl < 1 || tile_v < 1)
    return (int)cudaErrorInvalidValue;
  CollapseParams p{};
  const int NB = N * B;
  p.groups = (tile_v + 63) / 64;
  long long items = 0;
  for (int bk = 0; bk < nb; ++bk) {
    const uint64_t dims[4] = {CH, (uint64_t)tile_v, (uint64_t)nl,
                              (uint64_t)NB * T[bk]};
    const uint64_t strides[3] = {CH * 2, (uint64_t)tile_v * CH * 2,
                                 (uint64_t)nl * tile_v * CH * 2};
    const uint32_t box[4] = {BK, 64, 1, 1};
    cudaError_t e = encode_map(&p.v_map[bk], vox[bk], 4, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
    p.T[bk] = T[bk];
    p.off_t[bk] = off_t[bk];
    p.item0[bk] = (int)items;
    items += ((long long)NB * T[bk] * p.groups + 1) / 2;
  }
  if (items > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  p.item0[nb] = (int)items;
  {
    const uint64_t dims[2] = {CH, (uint64_t)nl * CH};
    const uint64_t strides[1] = {CH * 2};
    const uint32_t box[2] = {64, BK};
    cudaError_t e = encode_map(&p.k_map, Kr, 2, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
  }
  p.out = out;
  p.nbuckets = nb;
  p.B = B;
  p.nl = nl;
  p.tile_v = tile_v;
  p.rows_total = rows_total;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        rig_wscollapse, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int grid = (int)(items < num_sms() ? items : num_sms());
  rig_wscollapse<<<grid, THREADS, SMEM_BYTES, s>>>(p, (int)items, NB);
  return (int)cudaGetLastError();
}


// ---- the bf16 forward and backward of a rig, on this tile ----

// The forward of `nb` buckets of one scale (K1-bf16, K4-bf16), one launch of
// each pass for all of them: ii (N, B, Hp, Wp, 256) bf16 (a flat rig: Hp 1,
// Wp the padded band buffer's pixels); per bucket A[bk], starts[bk], T[bk],
// K[bk], off_t[bk] and, for windows, ww[bk] (null: flat bands; see
// ws_vox_launch); the buckets' vox scratches one after another in `vox`,
// (N, B, T[bk], nl*tile_v, 256) each; Kr (nl, 256, 256); out the scale's
// (N, B, rows_total, 256) tiles. vox = A @ band summed in fp32 and rounded
// to bf16, then the collapse summed in fp32 and rounded to bf16.
inline int ws_fwd_launch(const bf16* ii, const bf16* const* A,
                         const int* const* starts, const int* T, const int* K,
                         const int* ww, const int* off_t, int nb,
                         const bf16* Kr, bf16* vox, bf16* out, int N, int B,
                         int Hp, int Wp, int nl, int tile_v, int rows_total,
                         cudaStream_t s) {
  const int R = nl * tile_v;
  if (nb < 1 || nb > MAX_BUCKETS || R < 1) return (int)cudaErrorInvalidValue;
  bf16* outs[MAX_BUCKETS];
  size_t at = 0;
  for (int bk = 0; bk < nb; ++bk) {
    outs[bk] = vox + at;
    at += (size_t)N * B * T[bk] * R * CH;
  }
  int err = ws_vox_launch<EPI_BF16>(ii, A, starts, outs, T, K, ww, nb, N, B,
                                    Hp, Wp, R, 0, s);
  if (err != 0) return err;
  return ws_collapse_launch(outs, T, off_t, nb, Kr, out, N, B, nl, tile_v,
                            rows_total, s);
}

// The backward of one bucket (K2-bf16 / K3-bf16, K5-bf16), five launches:
// ii and A as ws_fwd_launch (ww 0: flat bands); KrT (nl, 256, 256), Kr with
// its last two axes swapped; g the scale's (N, B, rows_total, 256)
// cotangent; vox the (N*B*T, nl*tile_v, 256) fp32 scratch as two bf16
// planes (vox hi + lo, then dvox over it); ws (DKR_MAX_SPLITS, nl, 256, 256)
// fp32; dKr (nl, 256, 256) fp32 and dII (N, B, Hp, Wp, 256) bf16, added to;
// scratch (N*B, T, serial ? nl : 1, K, 256) fp32; the dII order index
// (pixels, ptr, adds, n_pixels). JAX's rounding points on bf16 inputs: vox,
// dvox and dKr fp32, dII rounded once per band add (serial == 0) or once
// per layer of each window (serial == 1).
inline int ws_bwd_launch(const bf16* ii, const bf16* A, const int* starts,
                         const bf16* KrT, const bf16* g, bf16* vox, float* ws,
                         bf16* dII, float* dKr, float* scratch,
                         const int* pixels, const int* ptr, const int* adds,
                         int n_pixels, int serial, int N, int B, int Hp,
                         int Wp, int T, int nl, int tile_v, int K, int ww,
                         int off_t, int rows_total, cudaStream_t s) {
  const int R = nl * tile_v;
  const int NB = N * B;
  if (T < 1 || NB < 1 || NB > 65535 || B > 65535 || nl < 1 || tile_v < 8 ||
      tile_v % 8 != 0 || n_pixels < 1 ||
      (long long)NB * T * tile_v > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)NB * T * R * CH;
  int err = ws_vox_launch<EPI_SPLIT>(ii, &A, &starts, &vox, &T, &K,
                                     ww ? &ww : nullptr, 1, N, B, Hp, Wp, R,
                                     plane, s);
  if (err != 0) return err;
  int splits = 0;
  err = ws_dkr_launch(vox, plane, g, ws, NB, T, nl, tile_v, off_t, rows_total,
                      ::DKR_MAX_SPLITS, ::DKR_CHAIN, &splits, s);
  if (err != 0) return err;
  const int n = nl * CH * CH;
  ::rig_dkr_reduce<<<(n / 4 + 255) / 256, 256, 0, s>>>(ws, dKr, n, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  err = ws_dvox_launch(g, KrT, vox, plane, NB, T, nl, tile_v, off_t,
                       rows_total, s);
  if (err != 0) return err;
  return ws_dii_launch(A, vox, plane, scratch, dII, pixels, ptr, adds,
                       n_pixels, serial, N, B, Hp, Wp, T, nl, tile_v, K, s);
}

}  // namespace
}  // namespace wsb
