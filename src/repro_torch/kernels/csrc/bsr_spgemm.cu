// Block-sparse (BSR x BSR) SpGEMM numeric phase for sm_90a.
//
// Replaces: bsr_spgemm_blocks (src/repro/kernels/bsr_spgemm.py), whose
// pallas_call walked a grid (nc_pad, u_max) with scalar-prefetched slot
// tables and an f32 VMEM accumulator per C block: for every C block e,
// out[e] = sum over u of A_blk[a_slots[e, u]] @ B_blk[b_slots[e, u]], steps
// whose A slot is the zero sentinel (index nbl_a, the appended all-zero
// block) skipped.
//
// Bound on this card: bytes for the 8 x 8 blocks the chunked backend stages
// (2 bs^3 flops against 2 bs^2 inputs read per contributor pair: 1,024
// operations per 512 bytes at bs = 8). The slot tables are mostly sentinel
// (the chunked backend pads every row to u_max steps and the grid to nc_pad
// rows), so the work is to touch only the live steps, and to have the next
// step's blocks in flight while one is multiplied.
//
// One warp owns one C block. It reads the block's slot row once, coalesced
// (lane u reads step u, in passes of 32 steps), marks the live steps with a
// ballot (a step is live when its A slot is not the sentinel, wherever in
// the row it stands; with skip_zero = 0 every step is live) and walks only
// those, in step order. An all-sentinel row writes its zero tile.
// Paths, by block size and operands:
//   async:   f32 blocks of 8, 16 or 32 at 16-byte aligned addresses; each
//            live step's A and B blocks are copied to a per-warp ring in
//            shared memory by 16-byte cp.async (a bs = 8 pair is 512 bytes,
//            one copy a lane), kStages - 1 steps ahead of the multiply;
//   tile:    other operands of those sizes (bf16, or unaligned f32); each
//            step's blocks are loaded, widened to f32 and stored to shared
//            memory by the warp before its multiply;
//   generic: any other size in 1..32, staged as tile, one output element a
//            lane and round.
// The tile paths keep a bs/8 x bs/4 sub-tile of the output a lane in f32
// registers (1 x 2 at bs = 8), read A rows as float4 and B row pieces as
// float2 / float4 from shared memory. Sums are f32 FMAs over k in order, the
// steps in order, so an f32 result matches the plain f32 version to
// rounding. No tensor cores: f32 parity forbids TF32, and the bs = 8 f32
// work is bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kSmemBudget = 48 * 1024;   // per block, without an opt-in

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes from global to shared, cached in L1 too: the warps of a block
// walk neighbouring C blocks of one block row, which share A blocks
__device__ __forceinline__ void cp_async16_ca(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(tc::smem_addr(dst)),
               "l"(src));
}

// steps of a warp's ring on the async path, by block size (a pair is
// 2 bs^2 floats: 512 bytes at bs = 8, 8 KB at bs = 32)
__host__ __device__ constexpr int ring_stages(int bs, bool async) {
  return !async ? 1 : bs == 32 ? 2 : bs == 16 ? 3 : 4;
}

// The output tile of one C block, a lane's share in f32 registers. BS > 0:
// rows i0 .. i0 + R - 1, columns j0 .. j0 + C - 1 of a BS x BS tile
// (8 row groups x 4 column groups of lanes). BS == 0: elements lane + 32 t.
template <int BS>
struct Tile {
  static constexpr int R = BS / 8, C = BS / 4;
  float acc[R][C];
  int i0, j0;

  __device__ Tile(int lane, int) : i0((lane / 4) * R), j0((lane % 4) * C) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  // acc += A B for one staged pair (A then B, row-major, f32)
  __device__ void mac(const float* a, const float* b) {
#pragma unroll
    for (int k = 0; k < BS; k += 4) {
      float av[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(a + (i0 + r) * BS + k);
        av[r][0] = v.x, av[r][1] = v.y, av[r][2] = v.z, av[r][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[C];
        const float* row = b + (k + kk) * BS + j0;
        if constexpr (C == 2) {
          const float2 v = *reinterpret_cast<const float2*>(row);
          bv[0] = v.x, bv[1] = v.y;
        } else {
#pragma unroll
          for (int c = 0; c < C; c += 4) {
            const float4 v = *reinterpret_cast<const float4*>(row + c);
            bv[c] = v.x, bv[c + 1] = v.y, bv[c + 2] = v.z, bv[c + 3] = v.w;
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) acc[r][c] = fmaf(av[r][kk], bv[c], acc[r][c]);
      }
    }
  }

  __device__ void store(float* out) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* row = out + (i0 + r) * BS + j0;
      if constexpr (C == 2) {
        *reinterpret_cast<float2*>(row) = make_float2(acc[r][0], acc[r][1]);
      } else {
#pragma unroll
        for (int c = 0; c < C; c += 4)
          *reinterpret_cast<float4*>(row + c) =
              make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
      }
    }
  }
};

template <>
struct Tile<0> {
  float acc[32];   // element lane + 32 t of the tile (bs <= 32: t < 32)
  int lane, bs;

  __device__ Tile(int lane_, int bs_) : lane(lane_), bs(bs_) {
#pragma unroll
    for (int t = 0; t < 32; ++t) acc[t] = 0.f;
  }

  __device__ void mac(const float* a, const float* b) {
    const int tile = bs * bs;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int o = lane + kWarp * t;
      if (o < tile) {
        const int i = o / bs, j = o - i * bs;
        float s = acc[t];
        for (int k = 0; k < bs; ++k) s = fmaf(a[i * bs + k], b[k * bs + j], s);
        acc[t] = s;
      }
    }
  }

  __device__ void store(float* out) const {
#pragma unroll
    for (int t = 0; t < 32; ++t)
      if (lane + kWarp * t < bs * bs) out[lane + kWarp * t] = acc[t];
  }
};

template <int BS, typename T, bool kAsync>
__global__ void bsr_spgemm_kernel(const T* __restrict__ a_blocks,
                                  const T* __restrict__ b_blocks,
                                  const int* __restrict__ a_slots,
                                  const int* __restrict__ b_slots, float* out,
                                  int nc_pad, int u_max, int bs_rt, int a_zero,
                                  int skip_zero) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStages = ring_stages(BS, kAsync);
  const int bs = BS > 0 ? BS : bs_rt;
  const int tile = bs * bs;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const long long e = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (e >= nc_pad) return;   // warp-uniform
  float* ring = smem + (size_t)warp * kStages * 2 * tile;
  const int* as = a_slots + e * u_max;
  const int* bsl = b_slots + e * u_max;
  Tile<BS> acc(lane, bs);

  for (int u0 = 0; u0 < u_max; u0 += kWarp) {
    const bool in_row = u0 + lane < u_max;
    const int sa = in_row ? as[u0 + lane] : a_zero;
    const int sb = in_row ? bsl[u0 + lane] : 0;
    const unsigned live = __ballot_sync(kFull, in_row && (!skip_zero || sa != a_zero));
    if constexpr (kAsync) {
      // stage the next live step (taken from `pending`) into ring slot
      // `issued` % kStages; a group is committed even when none is left
      unsigned pending = live;
      int issued = 0;
      auto issue = [&]() {
        if (pending) {
          const int src = __ffs(pending) - 1;
          pending &= pending - 1;
          const long long ka = __shfl_sync(kFull, sa, src), kb = __shfl_sync(kFull, sb, src);
          float* dst = ring + (issued % kStages) * 2 * tile;
          const float* ga = reinterpret_cast<const float*>(a_blocks) + ka * tile;
          const float* gb = reinterpret_cast<const float*>(b_blocks) + kb * tile;
          for (int c = lane; c < tile / 2; c += kWarp) {   // 2 tile / 4 chunks
            const int q = c < tile / 4 ? c : c - tile / 4;
            cp_async16_ca(dst + 4 * c, (c < tile / 4 ? ga : gb) + 4 * q);
          }
        }
        ++issued;
        tc::cp_async_commit();
      };
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) issue();
      int step = 0;
      for (unsigned rem = live; rem; rem &= rem - 1, ++step) {
        tc::cp_async_wait<kStages - 2>();
        __syncwarp();   // every lane's copies of this step have landed
        issue();        // into the slot the previous step used
        const float* buf = ring + (step % kStages) * 2 * tile;
        acc.mac(buf, buf + tile);
      }
      tc::cp_async_wait<0>();
      __syncwarp();     // the next pass refills the ring
    } else {
      for (unsigned rem = live; rem; rem &= rem - 1) {
        const int src = __ffs(rem) - 1;
        const long long ka = __shfl_sync(kFull, sa, src), kb = __shfl_sync(kFull, sb, src);
        for (int c = lane; c < 2 * tile; c += kWarp)
          ring[c] = widen(c < tile ? a_blocks[ka * tile + c] : b_blocks[kb * tile + c - tile]);
        __syncwarp();
        acc.mac(ring, ring + tile);
        __syncwarp();   // before the next step overwrites the pair
      }
    }
  }
  acc.store(out + e * tile);
}

template <int BS, typename T, bool kAsync>
int launch(const void* a_blocks, const void* b_blocks, const int* a_slots,
           const int* b_slots, float* out, int nc_pad, int u_max, int bs,
           int a_zero, int skip_zero, cudaStream_t stream) {
  const size_t per_warp = (size_t)ring_stages(BS, kAsync) * 2 * bs * bs * sizeof(float);
  const int warps = (int)(per_warp * kMaxWarpsPerBlock <= (size_t)kSmemBudget
                              ? kMaxWarpsPerBlock
                              : (size_t)kSmemBudget / per_warp);
  const unsigned blocks = (unsigned)((nc_pad + warps - 1) / warps);
  bsr_spgemm_kernel<BS, T, kAsync><<<blocks, warps * kWarp, warps * per_warp, stream>>>(
      static_cast<const T*>(a_blocks), static_cast<const T*>(b_blocks), a_slots, b_slots,
      out, nc_pad, u_max, bs, a_zero, skip_zero);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sized(const void* a_blocks, const void* b_blocks, const int* a_slots,
                 const int* b_slots, float* out, int nc_pad, int u_max, int bs,
                 int a_zero, int skip_zero, bool async, cudaStream_t s) {
#define BSR_LAUNCH(BS, ASYNC)                                                        \
  launch<BS, T, ASYNC>(a_blocks, b_blocks, a_slots, b_slots, out, nc_pad, u_max, bs, \
                       a_zero, skip_zero, s)
  if constexpr (sizeof(T) == sizeof(float)) {
    if (async) {
      if (bs == 8) return BSR_LAUNCH(8, true);
      if (bs == 16) return BSR_LAUNCH(16, true);
      if (bs == 32) return BSR_LAUNCH(32, true);
    }
  }
  if (bs == 8) return BSR_LAUNCH(8, false);
  if (bs == 16) return BSR_LAUNCH(16, false);
  if (bs == 32) return BSR_LAUNCH(32, false);
  return BSR_LAUNCH(0, false);
#undef BSR_LAUNCH
}

}  // namespace

// dtype: 0 = float32 blocks, 1 = bfloat16 blocks; out is float32.
extern "C" int bsr_spgemm_launch(const void* a_blocks, const void* b_blocks,
                                 const int* a_slots, const int* b_slots,
                                 float* out, int nc_pad, int u_max, int bs,
                                 int a_zero, int skip_zero, int dtype,
                                 void* stream) {
  if (bs < 1 || bs > 32 || u_max < 0) return (int)cudaErrorInvalidValue;
  if (nc_pad == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)a_blocks | (uintptr_t)b_blocks) % 16 == 0;
  if (dtype == 1)
    return launch_sized<__nv_bfloat16>(a_blocks, b_blocks, a_slots, b_slots, out, nc_pad,
                                       u_max, bs, a_zero, skip_zero, false, s);
  return launch_sized<float>(a_blocks, b_blocks, a_slots, b_slots, out, nc_pad, u_max, bs,
                             a_zero, skip_zero, aligned, s);
}

extern "C" const char* bsr_spgemm_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
