// Block-sparse times dense (BSR x dense) SpMM for sm_90a.
//
// Replaces: bsr_spmm_blocks (src/repro/kernels/bsr_spmm.py:67), whose
// pallas_call walked a grid (mb, nf / bn, U) with scalar-prefetched slot
// and block-column tables: Y[i-block, tile] = sum over u of
// A_blk[a_slots[i, u]] @ X[a_cols[i, u] * bs : + bs, tile], in an f32 VMEM
// accumulator written once per output tile.
//
// Bound on this card. At brick3d n=48 as BSR with bs = 8 (322,624 blocks,
// 23.3 a block row, u_max 27) by X of 110,592 x 128 f32 the function does
// 5.29 GFLOP: 0.0789 ms at the f32 FMA peak. Reading A, X and the tables
// once and writing Y once moves 199 MB: 0.059 ms of HBM. So operations bound
// it, with bytes close behind. The first port (the generic kernel below)
// took 2.43 ms, 30.8x the bound: a 1,024-thread block per block row and
// column tile did 8 FMAs a thread between two barriers per step, nothing
// prefetched, and pulled an X slab (bs x 128, 4 KB in f32) through L2 once
// per A block that names it: 322,624 slabs, 1.32 GB.
//
// The group path. A block of G warps owns G consecutive block rows; warp w
// owns block row g G + w across a 128-column tile, and a lane holds a
// bs x 4 tile of its output in f32 registers (32 sums at bs = 8, 64 at
// bs = 16), written once as float4. The block walks the union of its rows'
// block columns and stages each distinct X slab in shared memory once for
// all the warps whose row names it. The slab and the step's A blocks (each
// warp its own) come by cp.async into a ring of kStages stages, issued
// kStages - 1 steps ahead, with one __syncthreads a step. A warp whose row
// does not name the staged column skips the step's arithmetic; one that
// does adds bs x bs x 4 FMAs a lane, reading its A rows as broadcast float4
// and the slab as one float4 a lane and row (conflict-free). bf16 inputs
// are staged in bf16 and widened at use.
//   G trades X traffic for idle warps: a larger group stages fewer slabs
// (G = 2: 201,640 slabs, 0.83 GB; 8: 107,352, 0.44 GB), but at each step
// only the warps whose row names the column work (1.6 of 2; 3.0 of 8) while
// the rest hold registers at the barrier. Measured on the H100 from G = 1 to
// 12 (bsr_spmm_variant_ablation.py builds each from this file), G = 2 is
// fastest: kGroupWarps.
//   The walk merges the rows' own slot and column tables: lanes 0 .. G-1 of
// every warp follow one row each, and a step takes the smallest head column
// (a warp min) and advances the rows that hold it. Every live entry becomes
// a head once, so any order, sentinels anywhere and repeated columns stay
// right; for rows in column order (bsr_spmm_symbolic's) the steps are the
// sorted union. No table is built for it.
// Sums: per output element, f32 FMAs over k in order within a block, the
// row's blocks in walk order (ascending column).
//
// The generic path keeps the first port for every other shape: any bs in
// 1..32, any tile width bn, unaligned X. One block of bs x tc threads per
// (block row, column tile) walks u, staging the A block and the X slab in
// shared memory between two barriers; each thread keeps one output
// element's f32 sum. Steps on the zero-sentinel slot are skipped (the TPU
// kernel multiplied the all-zero block, which adds nothing).

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileCols = 128;        // output columns of a group block: 4 a lane
constexpr int kGroupWarps = 2;        // G: block rows (warps) of a group block
constexpr int kStages = 3;            // cp.async ring stages
constexpr int kGroupThreads = kGroupWarps * kWarp;
constexpr int kNone = INT_MAX;        // a finished row's head column

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive values, widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(tc::bf16_lo(v.x), tc::bf16_hi(v.x), tc::bf16_lo(v.y), tc::bf16_hi(v.y));
}

// four consecutive values from global to shared (16 bytes of f32, 8 of
// bf16), or zeros when !valid (the source is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  tc::cp_async16(tc::smem_addr(dst), src, valid);
}
__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(tc::smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

// one block an SM is all the bound asks: with the thread count alone ptxas
// held the bs 4 bf16 instance to 64 registers and spilled
template <int BS, typename T>
__global__ void __launch_bounds__(kGroupThreads, 1)
bsr_spmm_group_kernel(const T* __restrict__ a_blocks, const T* __restrict__ x,
                      const int* __restrict__ a_cols, const int* __restrict__ a_slots,
                      float* __restrict__ y, int mb, int u_max, int nf, int a_zero) {
  constexpr int kA = BS * BS;             // values of an A block
  constexpr int kX = BS * kTileCols;      // values of an X slab
  constexpr int G = kGroupWarps;
  constexpr int stage_vals = kX + G * kA; // [X slab][A block of each warp]
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int group = blockIdx.x;
  const int col0 = blockIdx.y * kTileCols;
  T* ring = reinterpret_cast<T*>(smem);
  int* live = reinterpret_cast<int*>(smem + (size_t)kStages * stage_vals * sizeof(T));

  // the walk's state: lane l < G follows row group G + l (its position and
  // head entry)
  int pos = 0, head_col = kNone, head_slot = a_zero;
  const long long mrow = (long long)group * G + lane;
  const int* mcols = a_cols + mrow * u_max;
  const int* mslots = a_slots + mrow * u_max;
  auto advance = [&]() {   // the first live entry at or after pos
    head_col = kNone;
    for (; pos < u_max; ++pos) {
      const int s = __ldg(mslots + pos);
      if (s != a_zero) {
        head_slot = s;
        head_col = __ldg(mcols + pos);
        return;
      }
    }
  };
  if (lane < G && mrow < mb) advance();

  // the next step's block column and this warp's A slot, in walk order
  auto next = [&](int& col, int& slot) -> bool {
    const int c = __reduce_min_sync(kFull, head_col);
    if (c == kNone) return false;
    const bool mine = head_col == c;
    slot = __shfl_sync(kFull, mine ? head_slot : a_zero, warp);
    col = c;
    if (mine) {
      ++pos;
      advance();
    }
    return true;
  };

  // copy the next step's X slab (all threads) and each warp's A block into
  // stage issued % kStages, and commit a group (empty past the last step)
  int issued = 0;
  bool more = true;
  auto issue = [&]() {
    int col = 0, slot = a_zero;
    if (more && next(col, slot)) {
      const int s = issued % kStages;
      T* st = ring + s * stage_vals;
      const long long xrow0 = (long long)col * BS;
      for (int c = threadIdx.x; c < BS * kWarp; c += kGroupThreads) {
        const int k = c / kWarp, q = c % kWarp;   // slab row k, columns 4q .. 4q + 3
        const int gc = col0 + 4 * q;
        const bool ok = gc < nf;
        cp_async4(st + k * kTileCols + 4 * q, ok ? x + (xrow0 + k) * nf + gc : x, ok);
      }
      if (lane == 0) live[s * G + warp] = slot;
      if (slot != a_zero) {
        const T* src = a_blocks + (long long)slot * kA;
        T* dst = st + kX + warp * kA;
        for (int c = lane; c < kA / 4; c += kWarp) cp_async4(dst + 4 * c, src + 4 * c, true);
      }
      ++issued;
    } else {
      more = false;
    }
    tc::cp_async_commit();
  };

  float acc[BS][4];
#pragma unroll
  for (int r = 0; r < BS; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  for (int j = 0; j < kStages - 1; ++j) issue();
  for (int j = 0; j < issued; ++j) {
    tc::cp_async_wait<kStages - 2>();   // this thread's copies of step j landed
    __syncthreads();                    // everyone's, and step j - 1's stage is free
    issue();
    const int s = j % kStages;
    if (live[s * G + warp] == a_zero) continue;   // this warp's row skips the column
    const T* xs = ring + s * stage_vals;
    const T* as = xs + kX + warp * kA;
#pragma unroll
    for (int k0 = 0; k0 < BS; k0 += 4) {
      float4 xv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) xv[kk] = load4(xs + (k0 + kk) * kTileCols + 4 * lane);
#pragma unroll
      for (int r = 0; r < BS; ++r) {
        const float4 av = load4(as + r * BS + k0);
        const float a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[r][0] = fmaf(a[kk], xv[kk].x, acc[r][0]);
          acc[r][1] = fmaf(a[kk], xv[kk].y, acc[r][1]);
          acc[r][2] = fmaf(a[kk], xv[kk].z, acc[r][2]);
          acc[r][3] = fmaf(a[kk], xv[kk].w, acc[r][3]);
        }
      }
    }
  }

  const long long row = (long long)group * G + warp;
  const int gc = col0 + 4 * lane;
  if (row < mb && gc < nf) {
#pragma unroll
    for (int r = 0; r < BS; ++r)
      *reinterpret_cast<float4*>(y + (row * BS + r) * nf + gc) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

template <int BS, typename T>
int launch_group(const void* a_blocks, const void* x, const int* a_cols, const int* a_slots,
                 float* y, int mb, int u_max, int nf, int a_zero, cudaStream_t stream) {
  const int n_groups = (mb + kGroupWarps - 1) / kGroupWarps;
  if (n_groups == 0 || nf == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)kStages * ((BS * kTileCols + kGroupWarps * BS * BS) * sizeof(T) +
                                         kGroupWarps * sizeof(int));
  static size_t smem_allowed = 48 * 1024;
  auto kernel = bsr_spmm_group_kernel<BS, T>;
  if (smem > smem_allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const dim3 grid((unsigned)n_groups, (unsigned)((nf + kTileCols - 1) / kTileCols));
  kernel<<<grid, kGroupThreads, smem, stream>>>(static_cast<const T*>(a_blocks),
                                               static_cast<const T*>(x), a_cols, a_slots, y,
                                               mb, u_max, nf, a_zero);
  return (int)cudaGetLastError();
}

template <typename T>
int group_by_bs(int bs, const void* a_blocks, const void* x, const int* a_cols,
                const int* a_slots, float* y, int mb, int u_max, int nf, int a_zero,
                cudaStream_t s) {
  switch (bs) {
    case 4:
      return launch_group<4, T>(a_blocks, x, a_cols, a_slots, y, mb, u_max, nf, a_zero, s);
    case 8:
      return launch_group<8, T>(a_blocks, x, a_cols, a_slots, y, mb, u_max, nf, a_zero, s);
    case 16:
      return launch_group<16, T>(a_blocks, x, a_cols, a_slots, y, mb, u_max, nf, a_zero, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
__global__ void bsr_spmm_kernel(const T* a_blocks, const T* x,
                                const int* a_slots, const int* a_cols,
                                float* y, int u_max, int bs, int nf, int bn,
                                int a_zero) {
  extern __shared__ __align__(16) float sh[];
  const int tc = blockDim.x;
  float* a_s = sh;             // [bs, bs]
  float* x_s = sh + bs * bs;   // [bs, tc]
  const int i_blk = blockIdx.x;
  const int col0 = blockIdx.y * bn + blockIdx.z * tc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * tc + tx, n_threads = tc * bs;
  const int jx = col0 + tx;
  const int tile_end = min(blockIdx.y * bn + bn, nf);
  const long long tile = (long long)bs * bs;
  float acc = 0.f;
  for (int u = 0; u < u_max; ++u) {
    const int slot = a_slots[(long long)i_blk * u_max + u];
    if (slot == a_zero) continue;   // uniform across the block
    const long long xrow0 = (long long)a_cols[(long long)i_blk * u_max + u] * bs;
    for (int t = tid; t < bs * bs; t += n_threads) a_s[t] = widen(a_blocks[slot * tile + t]);
    for (int t = tid; t < bs * tc; t += n_threads) {
      const int k = t / tc, c = col0 + t % tc;
      x_s[t] = c < tile_end ? widen(x[(xrow0 + k) * nf + c]) : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < bs; ++k) acc = fmaf(a_s[ty * bs + k], x_s[k * tc + tx], acc);
    __syncthreads();
  }
  if (jx < tile_end) y[((long long)i_blk * bs + ty) * nf + jx] = acc;
}

template <typename T>
int launch(const void* a_blocks, const void* x, const int* a_slots,
           const int* a_cols, float* y, int mb, int u_max, int bs, int nf,
           int bn, int a_zero, cudaStream_t stream) {
  if (mb == 0 || nf == 0) return (int)cudaGetLastError();
  int tc = bn;
  while (tc * bs > 1024 && tc > 1) tc = (tc + 1) / 2;
  const dim3 grid((unsigned)mb, (unsigned)((nf + bn - 1) / bn),
                  (unsigned)((bn + tc - 1) / tc));
  const dim3 threads(tc, bs);
  const size_t smem = (size_t)(bs * bs + bs * tc) * sizeof(float);
  bsr_spmm_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a_blocks), static_cast<const T*>(x), a_slots,
      a_cols, y, u_max, bs, nf, bn, a_zero);
  return (int)cudaGetLastError();
}

}  // namespace

// The generic path. dtype: 0 = float32 blocks and X, 1 = bfloat16; Y is
// float32.
extern "C" int bsr_spmm_launch(const void* a_blocks, const void* x,
                               const int* a_slots, const int* a_cols, float* y,
                               int mb, int u_max, int bs, int nf, int bn,
                               int a_zero, int dtype, void* stream) {
  if (bs < 1 || bs > 32 || bn < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(a_blocks, x, a_slots, a_cols, y, mb, u_max,
                                 bs, nf, bn, a_zero, s);
  return launch<float>(a_blocks, x, a_slots, a_cols, y, mb, u_max, bs, nf, bn,
                       a_zero, s);
}

extern "C" const char* bsr_spmm_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The group path: blocks of kGroupWarps warps (`warps` must name it) over
// 128-column tiles, bs 4, 8 or 16, nf a multiple of 4, X and the blocks on
// 16 bytes; a_cols and a_slots are the [mb, u_max] tables.
extern "C" int bsr_spmm_group_launch(const void* a_blocks, const void* x, const int* a_cols,
                                     const int* a_slots, float* y, int mb, int u_max,
                                     int warps, int bs, int nf, int a_zero, int dtype,
                                     void* stream) {
  if (warps != kGroupWarps || nf % 4 || u_max < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return group_by_bs<__nv_bfloat16>(bs, a_blocks, x, a_cols, a_slots, y, mb, u_max, nf,
                                      a_zero, s);
  return group_by_bs<float>(bs, a_blocks, x, a_cols, a_slots, y, mb, u_max, nf, a_zero, s);
}

extern "C" const char* bsr_spmm_group_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
