// Ragged grouped GEMM (MoE expert compute) for sm_90a: y[t] = x[t] @ w[g(t)].
//
// Replaces: grouped_matmul_padded (src/repro/kernels/grouped_matmul.py:41),
// whose pallas_call walked a grid (T_pad / bt, N / bn, K / bk) with the K
// axis sequential: tokens sorted by group and each group padded to a
// multiple of bt, the tile's group id scalar-prefetched, the bk x bn chunk
// of w[g] streamed HBM -> VMEM at every step and an f32 accumulator in VMEM
// written once per output tile. Here the K axis is a loop inside the block,
// and a group needs no padding: the rows are cut into segments, segment s
// being rows [seg_rows[s], seg_rows[s + 1]) of x and y, all of group
// seg_group[s] (s itself when seg_group is null). The padded layout of the
// TPU kernel is the special case of one segment per bt-row tile. y rows
// outside every segment are not written.
//
// Layouts: x [T, K] and w [E, K, N] row-major (N-major w, as the
// reference), f32 or bf16 (both the same); y [T, N] in f32 or bf16 (the
// "tile" and "small" routes take bf16 x and w and write bf16 y only);
// seg_rows int64 [n_seg + 1], ascending; seg_group int32 [n_seg] or null.
// Every sum is f32 and y is rounded once to its type; offsets are 64-bit
// (at the serve run's prefill x holds about 124k rows of 2,048).
//
// Bound on this card: at decode (a few rows an expert) the weight bytes,
// each touched expert's K x N read once (about 118 MB a product in bf16 at
// the serve batch); at prefill (thousands of rows an expert) the
// operations, 2 T K N, against the bf16 tensor cores' 989 TFLOP/s. Three
// routes; the wrapper picks one from what the host knows (the dtypes, K and
// N modulo 8, the operands' alignment, T), each launch a route of its own:
//
// "tile" (bf16 in and out, many rows an expert): a block owns a 128 x 256
// tile of y in one segment, computed by wgmma.mma_async m64n256k16 (bf16 operands,
// f32 accumulators in registers; a bf16 x bf16 product is exact in f32):
// two warpgroups of 64 rows each, 128 accumulators a thread. K is walked in
// steps of 64 through a ring of four shared-memory stages of 48 KB (x
// 128 x 64, w 64 x 256), filled by 16-byte cp.async copies two steps ahead
// while one wgmma group runs behind the current one. Both operands sit in
// wgmma's 128-byte-swizzled layouts: x K-major (128-byte rows of 64 k), w
// as stored, N-major (four panels of 64 columns, 128-byte rows of one k
// each) and read with the B transpose flag, so no K-major copy of the
// weights is made. Rows of a tile past its segment's end, columns past N
// and k past K are zero-filled by the copies (their sources are not read),
// and those rows are never stored.
//
// "small" (bf16 in and out, a few rows an expert: decode): the operands
// are swapped, y^T[N-slab, rows] = w[g]^T x[rows]^T on mma.sync.m16n8k16, the expert's
// columns on the 16-row side (ldmatrix.trans of w rows) and up to 8 rows of
// x on the n = 8 side. A block owns one segment and one 128-column slab of
// w[g]; it streams the K x 128 slab through a four-stage cp.async ring (16
// KB of weights a stage, three stages in flight, two blocks an SM) and
// multiplies it with up to 32 rows of the segment at once (four chunks of
// 8); a longer segment is walked in passes of 32 rows, so the route is
// right for any grouping. Blocks of empty segments exit at once; at decode
// the 28 experts the tokens choose times 8 (w1, w3) or 16 (w2) slabs fill
// the 132 SMs. At the OLMoE decode step (16 layers x w1, w3, w2; 64 rows
// over 28 experts) this route takes 4.9% less time than "tile" on an H100
// 80GB HBM3 at 700 W (gmm_route_ablation.py: 24 alternated steps each).
//
// "fma" (f32 operands; bf16 operands with an f32 output, or with K or N
// not a multiple of 8, or misaligned): f32 FMAs, by one of two tilings the
// host picks from T with the small route's threshold (512 rows), each on
// 4-element cp.async chunks where K and N are multiples of 4 and x and w
// start on a chunk, else copied element by element:
//
// - rows-few (decode: 64 rows over some 28 experts, 1 to 8 rows each):
//   bound by the bytes of the touched experts' weights. A block of 8
//   warps owns one segment and one 128-column slab of w[g] and streams the
//   slab once through a four-stage cp.async ring, each warp owning 4 of a
//   stage's 32 k rows and copying what it multiplies, so that the warps
//   wait on nothing but their own copies; the segment's rows go in passes
//   of 8 against the streamed slab, and the warps' partial sums are added
//   in a fixed order through shared memory (no atomics). Blocks of empty
//   segments exit at once. At the served decode product (224 blocks, two
//   an SM: one wave) this reads the weights at about 2.8 TB/s on an H100
//   80GB HBM3 at 700 W, where 64-column slabs (448 blocks) are 18% slower
//   (PERF.md, f32_variant_ablation.py).
// - tile (prefill: thousands of rows an expert): bound by the operations
//   against the f32 FMA rate. A block of 512 threads holds a 128 x 256
//   tile of y in registers (8 x 8 a thread, as four 4 x 4 quarters 64 rows
//   and 128 columns apart, so that a warp's shared-memory reads are
//   contiguous 16-byte vectors) within 128 registers, one block an SM; K
//   is walked in steps of 16, w's rows by cp.async two steps ahead into a
//   three-stage ring, x's by 16-byte loads one step ahead, stored
//   transposed after the current step, and the fragments of step kk + 1
//   read while step kk's 64 FMAs run. On the same card, 128 x 128 tiles
//   (two blocks an SM) are 4% slower, K steps of 8 or 32 slower still (32
//   spills at 128 x 128). Rows of a tile past its segment's end are
//   neither loaded nor computed: a warp whose rows all lie past the end
//   skips the products.
//
// "tile" and the fma route's tile tiling: each block finds its tile itself
// (warp 0 scans the segments' tile counts, 32 at a time), so the grid can be sized by an
// upper bound (ceil(T / 128) + segments) that the host knows without
// reading the segments back: blocks past the real tile count exit at once.
// Consecutive blocks take consecutive row tiles of the same column tile, so
// the tiles of one expert read its weight slab from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

constexpr int BM = 128;   // rows of y a block of the tile routes owns

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Warp 0's search for a block's tile: the t-th BM-row tile over the
// segments, in order. Writes the tile's first row, its rows (at most BM)
// and its group, or group -1 past the real tiles.
__device__ void find_tile(const long long* __restrict__ seg_rows,
                          const int* __restrict__ seg_group, int n_seg, long long t,
                          int lane, long long* s_row0, int* s_rows, int* s_group) {
  long long before = 0;     // tiles of the segments already passed
  int seg = -1;
  long long sub = 0;
  for (int base = 0; base < n_seg; base += 32) {
    const int s = base + lane;
    long long tiles = 0;
    if (s < n_seg) {
      const long long len = seg_rows[s + 1] - seg_rows[s];
      tiles = len > 0 ? (len + BM - 1) / BM : 0;
    }
    long long incl = tiles;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const long long total = __shfl_sync(0xffffffffu, incl, 31);
    if (t < before + total) {   // uniform over the warp
      const int hit = __ffs(__ballot_sync(0xffffffffu, t < before + incl)) - 1;
      const long long incl_hit = __shfl_sync(0xffffffffu, incl, hit);
      const long long tiles_hit = __shfl_sync(0xffffffffu, tiles, hit);
      seg = base + hit;
      sub = t - (before + incl_hit - tiles_hit);
      break;
    }
    before += total;
  }
  if (lane == 0) {
    *s_group = -1;
    if (seg >= 0) {
      const long long r0 = seg_rows[seg] + sub * BM;
      const long long r1 = seg_rows[seg + 1];
      *s_row0 = r0;
      *s_rows = (int)(r1 - r0 < BM ? r1 - r0 : BM);
      *s_group = seg_group != nullptr ? seg_group[seg] : seg;
    }
  }
}

// ---- route "fma" -----------------------------------------------------------

namespace ffma {

// 4 consecutive elements at p (aligned to 4 elements), widened to f32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(tc::bf16_lo(u.x), tc::bf16_hi(u.x), tc::bf16_lo(u.y), tc::bf16_hi(u.y));
}

// the 4-element chunk at src into shared dst by cp.async (16 bytes of f32,
// 8 of bf16), or zeros when !valid (src is then not read)
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src, bool valid) {
  if constexpr (sizeof(T) == 4) {
    tc::cp_async16(tc::smem_addr(dst), src, valid);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(tc::smem_addr(dst)),
                 "l"(src), "r"(valid ? 8 : 0));
  }
}

// the first n (0..4) elements at src into dst, zeros after: the element
// copy of operands that are not chunk-aligned
template <typename T>
__device__ __forceinline__ void copy4(T* dst, const T* src, int n) {
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = e < n ? src[e] : T(0.f);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// -- the rows-few tiling (the note at the top) ------------------------------
//
// Warp v owns k rows 4 v .. 4 v + 3 of every 32-deep stage; lane l of it
// the 4 columns 4 (l % (BN / 4)) of its k rows l / (BN / 4) + SUB i. A
// thread sums RC rows x 4 columns over its k in stage order; the lanes
// sharing a column (BN = 64: l and l + 16) and then the warps 0..7 are
// added in that order.

#ifndef GMM_FMA_FEW_BN
#define GMM_FMA_FEW_BN 128
#endif

namespace few {

constexpr int BN = GMM_FMA_FEW_BN;   // columns of a block's slab (64 or 128)
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int KW = 4;               // k rows of a stage a warp owns (one chunk of x)
constexpr int BK = KW * WARPS;      // k rows a stage
constexpr int RC = 8;               // rows of the segment a pass
constexpr int STAGES = 4;
constexpr int LPR = BN / 4;         // lanes over one k row of the slab
constexpr int SUB = 32 / LPR;       // k rows a warp covers at once
constexpr int KT = KW / SUB;        // k rows a thread owns a stage
constexpr int WARP_ELEMS = KW * BN + RC * KW;   // a warp's part of a stage
constexpr int STAGE_ELEMS = WARPS * WARP_ELEMS;
static_assert(BN == 64 || BN == 128, "the slab is 64 or 128 columns");

template <typename Tin>
constexpr size_t smem_bytes() {
  const size_t ring = (size_t)STAGES * STAGE_ELEMS * sizeof(Tin);
  const size_t red = (size_t)WARPS * RC * BN * sizeof(float);
  return ring > red ? ring : red;
}

template <typename Tin, typename Tout, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    grouped_matmul_rows_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                               Tout* __restrict__ y, const long long* __restrict__ seg_rows,
                               const int* __restrict__ seg_group, int K, int N, int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tin* ring = reinterpret_cast<Tin*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw);   // [WARPS][RC][BN], after the ring
  const int seg = blockIdx.x;
  const long long r_begin = seg_rows[seg], r_end = seg_rows[seg + 1];
  const int g = seg_group != nullptr ? seg_group[seg] : seg;
  if (r_end <= r_begin || g < 0 || g >= E) return;   // uniform over the block
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int sub = lane / LPR, cq = lane % LPR;
  const int col0 = blockIdx.y * BN, c = col0 + 4 * cq;
  const Tin* W = w + (long long)g * K * N;
  const int nk = (K + BK - 1) / BK;

  for (long long p0 = r_begin; p0 < r_end; p0 += RC) {
    const int nrows = (int)(r_end - p0 < RC ? r_end - p0 : RC);
    auto load = [&](int kt) {
      Tin* wst = ring + (kt % STAGES) * STAGE_ELEMS + warp * WARP_ELEMS;
      const int kb = kt * BK + warp * KW;
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        const int kr = sub + SUB * i, k = kb + kr;
        if constexpr (VEC) {
          const bool valid = k < K && c < N;
          cp_async4(wst + kr * BN + 4 * cq, W + (valid ? (long long)k * N + c : 0), valid);
        } else {
          const int n = k < K ? max(0, min(4, N - c)) : 0;
          copy4(wst + kr * BN + 4 * cq, W + (n > 0 ? (long long)k * N + c : 0), n);
        }
      }
      if (lane < RC) {
        Tin* xst = wst + KW * BN + lane * KW;
        const Tin* src = x + (p0 + lane) * K + kb;
        if constexpr (VEC) {
          const bool valid = lane < nrows && kb < K;
          cp_async4(xst, valid ? src : x, valid);
        } else {
          const int n = lane < nrows ? max(0, min(4, K - kb)) : 0;
          copy4(xst, n > 0 ? src : x, n);
        }
      }
    };

    float acc[RC][4];
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(s);
      tc::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      tc::cp_async_wait<STAGES - 2>();   // step kt has landed (this thread's copies)
      __syncwarp();                      // the warp's x chunks; step kt - 1 is read
      if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
      tc::cp_async_commit();
      const Tin* wst = ring + (kt % STAGES) * STAGE_ELEMS + warp * WARP_ELEMS;
      const Tin* xst = wst + KW * BN;
      float4 wv[KT];
#pragma unroll
      for (int i = 0; i < KT; ++i) wv[i] = ld4(wst + (sub + SUB * i) * BN + 4 * cq);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (r < nrows) {   // uniform over the block
          const float4 xv = ld4(xst + r * KW);
#pragma unroll
          for (int i = 0; i < KT; ++i) {
            const float a = SUB == 1 ? comp(xv, i) : comp(xv, sub + SUB * i);
            acc[r][0] = fmaf(a, wv[i].x, acc[r][0]);
            acc[r][1] = fmaf(a, wv[i].y, acc[r][1]);
            acc[r][2] = fmaf(a, wv[i].z, acc[r][2]);
            acc[r][3] = fmaf(a, wv[i].w, acc[r][3]);
          }
        }
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();   // every warp is done with the ring: it holds the partial sums now

    // the lanes sharing a column (BN = 64: lane and lane + 16), then the warps
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (SUB == 2) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
    if (sub == 0) {
#pragma unroll
      for (int r = 0; r < RC; ++r)
        if (r < nrows)
          *reinterpret_cast<float4*>(red + (warp * RC + r) * BN + 4 * cq) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();
    for (int e = tid; e < nrows * BN; e += THREADS) {
      const int r = e / BN, col = col0 + e % BN;
      float sum = red[r * BN + e % BN];
#pragma unroll
      for (int v = 1; v < WARPS; ++v) sum += red[(v * RC + r) * BN + e % BN];
      if (col < N) put(y + (p0 + r) * N + col, sum);
    }
    __syncthreads();   // the next pass refills the ring
  }
}

}  // namespace few

// -- the tile tiling (the note at the top) -----------------------------------
//
// THREADS = 16 (BN / 8) threads; thread (ty, tx) holds rows 4 ty + (0..3)
// and 64 + 4 ty + (0..3), columns 4 tx + (0..3) and BN / 2 + 4 tx + (0..3).
// One __syncthreads a K step.

#ifndef GMM_FMA_BK
#define GMM_FMA_BK 16
#endif
#ifndef GMM_FMA_BN
#define GMM_FMA_BN 256
#endif

namespace tiled {

constexpr int BK = GMM_FMA_BK, BN = GMM_FMA_BN;
constexpr int TX = BN / 8;                  // threads across a tile's columns
constexpr int THREADS = 16 * TX;            // 256 or 512
constexpr int WSTAGES = 3;
constexpr int XS = BM + 4;                  // padded row of the x stage (floats)
constexpr int XCH = BM * BK / 4;            // 4-element chunks of x a step
constexpr int XQ = (XCH + THREADS - 1) / THREADS;   // x chunks a thread a step
constexpr int WCH = BK * BN / 4;            // 4-element chunks of w a step
constexpr int WQ = (WCH + THREADS - 1) / THREADS;
constexpr int ROWS_PER_WARP = 32 / TX * 4;  // rows of each 64-row half a warp holds
static_assert(BN == 128 || BN == 256, "the tile is 128 or 256 columns");
static_assert(BK % 4 == 0, "BK is a multiple of the 4-element chunk");

template <typename Tin>
constexpr size_t smem_bytes() {
  return (size_t)2 * BK * XS * sizeof(float) + (size_t)WSTAGES * BK * BN * sizeof(Tin);
}

template <typename Tin, typename Tout, bool VEC>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
    grouped_matmul_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                          Tout* __restrict__ y, const long long* __restrict__ seg_rows,
                          const int* __restrict__ seg_group, int n_seg, int K, int N,
                          int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);          // [2][BK][XS]: x^T
  Tin* ws = reinterpret_cast<Tin*>(xs + 2 * BK * XS);      // [WSTAGES][BK][BN]
  __shared__ long long s_row0;
  __shared__ int s_rows, s_group;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (warp == 0)
    find_tile(seg_rows, seg_group, n_seg, blockIdx.x, lane, &s_row0, &s_rows, &s_group);
  __syncthreads();
  const int g = s_group;
  if (g < 0 || g >= E) return;   // past the real tiles (uniform over the block)
  const long long row0 = s_row0;
  const int rows = s_rows;
  const int col0 = blockIdx.y * BN;
  const Tin* X = x + row0 * K;
  const Tin* W = w + (long long)g * K * N;
  const int nk = (K + BK - 1) / BK;

  // w: chunk i is k row i / (BN / 4), columns 4 (i % (BN / 4)) + (0..3)
  auto load_w = [&](int kt) {
    Tin* st = ws + (kt % WSTAGES) * BK * BN;
#pragma unroll
    for (int q = 0; q < WQ; ++q) {
      const int i = tid + q * THREADS;
      if (WCH % THREADS != 0 && i >= WCH) break;
      const int kr = i / (BN / 4), cq = i % (BN / 4);
      const int k = kt * BK + kr, c = col0 + 4 * cq;
      if constexpr (VEC) {
        const bool valid = k < K && c < N;
        cp_async4(st + kr * BN + 4 * cq, W + (valid ? (long long)k * N + c : 0), valid);
      } else {
        const int n = k < K ? max(0, min(4, N - c)) : 0;
        copy4(st + kr * BN + 4 * cq, W + (n > 0 ? (long long)k * N + c : 0), n);
      }
    }
  };
  // x: chunk i is row i / (BK / 4), k 4 (i % (BK / 4)) + (0..3), held in
  // registers in its own type until it is stored
  Tin xr[XQ][4];
  auto load_x = [&](int kt) {
#pragma unroll
    for (int q = 0; q < XQ; ++q) {
      const int i = tid + q * THREADS;
      if (XCH % THREADS != 0 && i >= XCH) break;
      const int r = i / (BK / 4), k = kt * BK + 4 * (i % (BK / 4));
      if constexpr (VEC) {
        if (r < rows && k < K) {
          using V = typename std::conditional<sizeof(Tin) == 4, float4, uint2>::type;
          *reinterpret_cast<V*>(xr[q]) = *reinterpret_cast<const V*>(X + (long long)r * K + k);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) xr[q][e] = Tin(0.f);
        }
      } else {
        const int n = r < rows ? max(0, min(4, K - k)) : 0;
        copy4(xr[q], X + (n > 0 ? (long long)r * K + k : 0), n);
      }
    }
  };
  auto store_x = [&](int buf) {
#pragma unroll
    for (int q = 0; q < XQ; ++q) {
      const int i = tid + q * THREADS;
      if (XCH % THREADS != 0 && i >= XCH) break;
      const int r = i / (BK / 4), kk = 4 * (i % (BK / 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(buf * BK + kk + e) * XS + r] = widen(xr[q][e]);
    }
  };

  // this thread's outputs: rows ty * 4 + (0..3) and 64 + ty * 4 + (0..3),
  // columns tx * 4 + (0..3) and BN / 2 + tx * 4 + (0..3)
  const int tx = tid % TX, ty = tid / TX;
  const bool live = warp * ROWS_PER_WARP < rows;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_w(0);
  tc::cp_async_commit();
  if (nk > 1) load_w(1);
  tc::cp_async_commit();
  load_x(0);
  store_x(0);
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<1>();   // step kt's w has landed (this thread's copies)
    __syncthreads();          // everyone's w and x of step kt; step kt - 1 is read
    if (kt + 2 < nk) load_w(kt + 2);   // into step kt - 1's stage
    tc::cp_async_commit();
    const bool more = kt + 1 < nk;
    if (more) load_x(kt + 1);
    if (live) {
      const float* xb = xs + (kt & 1) * BK * XS;
      const Tin* wb = ws + (kt % WSTAGES) * BK * BN;
      float a[2][8], b[2][8];
      auto frag = [&](int kk, float (&af)[8], float (&bf)[8]) {
        const float4 a0 = *reinterpret_cast<const float4*>(xb + kk * XS + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(xb + kk * XS + 64 + ty * 4);
        const float4 b0 = ld4(wb + kk * BN + tx * 4);
        const float4 b1 = ld4(wb + kk * BN + BN / 2 + tx * 4);
        af[0] = a0.x; af[1] = a0.y; af[2] = a0.z; af[3] = a0.w;
        af[4] = a1.x; af[5] = a1.y; af[6] = a1.z; af[7] = a1.w;
        bf[0] = b0.x; bf[1] = b0.y; bf[2] = b0.z; bf[3] = b0.w;
        bf[4] = b1.x; bf[5] = b1.y; bf[6] = b1.z; bf[7] = b1.w;
      };
      frag(0, a[0], b[0]);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        if (kk + 1 < BK) frag(kk + 1, a[(kk + 1) & 1], b[(kk + 1) & 1]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[kk & 1][i], b[kk & 1][j], acc[i][j]);
      }
    }
    if (more) store_x((kt + 1) & 1);
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + i % 4;
    if (r >= rows) continue;
    Tout* out = y + (row0 + r) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? 0 : BN / 2) + tx * 4 + j % 4;
      if (c < N) put(out + c, acc[i][j]);
    }
  }
}

}  // namespace tiled

}  // namespace ffma

// ---- route "tile": bf16 on wgmma --------------------------------------------

namespace tile {

constexpr int BN = 256, BK = 64, STAGES = 4, THREADS = 256;
constexpr int NACC = BN / 2;                            // accumulators a thread
constexpr int PANEL_BYTES = BK * 128;                   // w: 64 k rows x 64 columns
constexpr int A_BYTES = BM * BK * 2;                    // x: 128 rows x 64 k, 16 KB
constexpr int STAGE_BYTES = A_BYTES + BN / 64 * PANEL_BYTES;   // 48 KB
constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 1024;   // + alignment

// a wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), the 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// the two operands' layouts: x's K-major tile has 8-row groups of 1,024
// bytes (its leading offset is unused); w's N-major tile has 8-k groups of
// 1,024 bytes and its 64-column panels PANEL_BYTES apart
constexpr uint32_t A_LBO = 16, A_SBO = 1024;
constexpr uint32_t B_LBO = PANEL_BYTES, B_SBO = 1024;

// d += A B over one k16 step: A 64 x 16 (K-major, from desc_a), B 16 x 256
// (N-major, from desc_b: the transpose flag), bf16, f32 accumulators; d[j]
// of a thread is row 16 (warp % 4) + lane / 4 + 8 ((j / 2) % 2), column
// 8 (j / 4) + 2 (lane % 4) + j % 2 of the warpgroup's 64 x 256 tile
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared memory written by the copies, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across a wgmma wait
__device__ __forceinline__ void fence_regs(float (&d)[NACC]) {
#pragma unroll
  for (int j = 0; j < NACC; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

__global__ void __launch_bounds__(THREADS)
    gmm_tile_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, const long long* __restrict__ seg_rows,
                    const int* __restrict__ seg_group, int n_seg, int K, int N, int E) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ long long s_row0;
  __shared__ int s_rows, s_group;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (warp == 0)
    find_tile(seg_rows, seg_group, n_seg, blockIdx.x, lane, &s_row0, &s_rows, &s_group);
  __syncthreads();
  const int g = s_group;
  if (g < 0 || g >= E) return;   // past the real tiles (uniform over the block)
  const long long row0 = s_row0;
  const int rows = s_rows;
  const int col0 = blockIdx.y * BN;
  const __nv_bfloat16* W = w + (long long)g * K * N;
  // the swizzle repeats every 1,024 bytes: align the ring to it
  const uint32_t ring = (tc::smem_addr(smem_raw) + 1023u) & ~1023u;
  const int nk = (K + BK - 1) / BK;

  auto load = [&](int kt) {
    const uint32_t a_st = ring + (kt % STAGES) * STAGE_BYTES, b_st = a_st + A_BYTES;
    const int k0 = kt * BK;
    for (int i = tid; i < BM * 8; i += THREADS) {      // x: 128 rows x 8 chunks
      const int r = i / 8, c = i % 8, kc = k0 + c * 8;
      const bool valid = r < rows && kc < K;   // the segment's rows only
      tc::cp_async16(a_st + r * 128 + (tc::swz(r, c) << 4),
                     x + (valid ? (row0 + r) * K + kc : 0), valid);
    }
    for (int i = tid; i < BK * BN / 8; i += THREADS) {   // w: 64 k rows x BN / 8 chunks
      const int kr = i / (BN / 8), c = i % (BN / 8), kk = k0 + kr, n = col0 + c * 8;
      const bool valid = kk < K && n < N;
      tc::cp_async16(b_st + (c / 8) * PANEL_BYTES + kr * 128 + (tc::swz(kr, c % 8) << 4),
                     W + (valid ? (long long)kk * N + n : 0), valid);
    }
  };

  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
  fence_regs(acc);
  const int wg = warp / 4;   // rows 64 wg .. 64 wg + 63 of the tile
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nk) load(s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<STAGES - 3>();   // step kt has landed (this thread's copies)
    fence_async_shared();
    __syncthreads();                   // everyone's copies; step kt - 2's wgmma is done
    if (kt + STAGES - 2 < nk) load(kt + STAGES - 2);   // into step kt - 2's stage
    tc::cp_async_commit();
    const uint32_t a_st = ring + (kt % STAGES) * STAGE_BYTES;
    const uint32_t b_st = a_st + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16(acc, desc(a_st + wg * 64 * 128 + kk * 32, A_LBO, A_SBO),
                       desc(b_st + kk * 16 * 128, B_LBO, B_SBO));
    wgmma_commit();
    wgmma_wait<1>();   // step kt - 1's group is done; step kt's may run on
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int rbase = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rbase + 8 * h;
    if (r >= rows) continue;
    __nv_bfloat16* out = y + (row0 + r) * N;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int c = col0 + 8 * n + 2 * (lane % 4);
      if (c < N)
        *reinterpret_cast<uint32_t*>(out + c) =
            tc::pack_bf16(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
    }
  }
}

}  // namespace tile

// ---- route "small": bf16 on mma.sync, operands swapped ----------------------

namespace small_rows {

constexpr int BN = 128, BK = 64, RC = 32, STAGES = 4, THREADS = 128;
constexpr int NCH = RC / 8;             // chunks of 8 rows a pass
constexpr int W_BYTES = BK * BN * 2;     // 64 k rows of 256 bytes, 16 KB
constexpr int X_BYTES = RC * BK * 2;     // RC rows of 128 bytes
constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES;

__global__ void __launch_bounds__(THREADS)
    gmm_small_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ y, const long long* __restrict__ seg_rows,
                     const int* __restrict__ seg_group, int K, int N, int E) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int seg = blockIdx.x;
  const long long r_begin = seg_rows[seg], r_end = seg_rows[seg + 1];
  const int g = seg_group != nullptr ? seg_group[seg] : seg;
  if (r_end <= r_begin || g < 0 || g >= E) return;   // uniform over the block
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int col0 = blockIdx.y * BN;
  const __nv_bfloat16* W = w + (long long)g * K * N;
  const uint32_t ring = tc::smem_addr(smem_raw);
  const int nk = (K + BK - 1) / BK;

  // passes of up to RC rows of the segment against the whole K x BN slab
  for (long long p0 = r_begin; p0 < r_end; p0 += RC) {
    const int nrows = (int)(r_end - p0 < RC ? r_end - p0 : RC);
    const int nch = (nrows + 7) / 8;   // chunks of 8 rows (uniform)
    auto load = [&](int kt) {
      const uint32_t w_st = ring + (kt % STAGES) * STAGE_BYTES, x_st = w_st + W_BYTES;
      const int k0 = kt * BK;
      for (int i = tid; i < BK * 16; i += THREADS) {   // w: 64 k rows x 16 chunks
        const int kr = i / 16, c = i % 16, kk = k0 + kr, n = col0 + c * 8;
        const bool valid = kk < K && n < N;
        tc::cp_async16(w_st + kr * 256 + (tc::swz(kr, c) << 4),
                       W + (valid ? (long long)kk * N + n : 0), valid);
      }
      for (int i = tid; i < nch * 64; i += THREADS) {  // x: 8 nch rows x 8 chunks
        const int r = i / 8, c = i % 8, kc = k0 + c * 8;
        const bool valid = r < nrows && kc < K;
        tc::cp_async16(x_st + r * 128 + (tc::swz(r, c) << 4),
                       x + (valid ? (p0 + r) * K + kc : 0), valid);
      }
    };

    // acc[ch][mt]: y columns col0 + 32 warp + 16 mt + (0..15), rows 8 ch + (0..7)
    float acc[NCH][2][4];
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ch][mt][e] = 0.f;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(s);
      tc::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      tc::cp_async_wait<STAGES - 2>();   // step kt has landed (this thread's copies)
      __syncthreads();                   // everyone's; step kt - 1's stage is free
      if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
      tc::cp_async_commit();
      const uint32_t w_st = ring + (kt % STAGES) * STAGE_BYTES, x_st = w_st + W_BYTES;
#pragma unroll
      for (int kp = 0; kp < BK / 32; ++kp) {
        // B fragments of 32 k: rows 8 ch + lane % 8, chunk 4 kp + lane / 8
        uint32_t xb[NCH][4];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          if (ch < nch) {
            const int r = ch * 8 + lane % 8, c = kp * 4 + lane / 8;
            tc::ldsm_x4(xb[ch], x_st + r * 128 + (tc::swz(r, c) << 4));
          }
        }
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          const int kk = kp * 2 + s2;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            // A = w^T: matrix i is k rows + 8 (i >> 1), columns + 8 (i & 1)
            const int i = lane / 8, kr = kk * 16 + (i >> 1) * 8 + lane % 8;
            const int c = warp * 4 + mt * 2 + (i & 1);
            uint32_t af[4];
            tc::ldsm_x4_t(af, w_st + kr * 256 + (tc::swz(kr, c) << 4));
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch)
              if (ch < nch) tc::mma_bf16(acc[ch][mt], af, xb[ch][2 * s2], xb[ch][2 * s2 + 1]);
          }
        }
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();   // the next pass refills the stages

    // acc[ch][mt][e]: column col0 + 32 warp + 16 mt + lane / 4 + 8 (e / 2),
    // row p0 + 8 ch + 2 (lane % 4) + e % 2
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      if (ch >= nch) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = ch * 8 + 2 * (lane % 4) + (e & 1);
          const int c = col0 + warp * 32 + mt * 16 + lane / 4 + 8 * (e >> 1);
          if (r < nrows && c < N) y[(p0 + r) * N + c] = __float2bfloat16_rn(acc[ch][mt][e]);
        }
    }
  }
}

}  // namespace small_rows

// ---- launch -----------------------------------------------------------------

template <typename Tin, typename Tout, bool VEC>
int launch_rows_few(const void* x, const void* w, void* y, const long long* seg_rows,
                    const int* seg_group, int n_seg, int K, int N, int E,
                    cudaStream_t stream) {
  using namespace ffma::few;
  constexpr size_t smem = smem_bytes<Tin>();
  static const cudaError_t attr =
      tc::allow_smem(grouped_matmul_rows_kernel<Tin, Tout, VEC>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)n_seg, (unsigned)((N + BN - 1) / BN));
  grouped_matmul_rows_kernel<Tin, Tout, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w), static_cast<Tout*>(y),
      seg_rows, seg_group, K, N, E);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout, bool VEC>
int launch_tiled(const void* x, const void* w, void* y, const long long* seg_rows,
                 const int* seg_group, int n_seg, int n_tiles, int K, int N, int E,
                 cudaStream_t stream) {
  using namespace ffma::tiled;
  constexpr size_t smem = smem_bytes<Tin>();
  static const cudaError_t attr = tc::allow_smem(grouped_matmul_kernel<Tin, Tout, VEC>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)n_tiles, (unsigned)((N + BN - 1) / BN));
  grouped_matmul_kernel<Tin, Tout, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w), static_cast<Tout*>(y),
      seg_rows, seg_group, n_seg, K, N, E);
  return (int)cudaGetLastError();
}

// the fma route: the rows-few or the tile tiling, each on 4-element chunks
// (cp.async) where K and N are multiples of 4 and x and w start on a chunk
// boundary, else element by element
template <typename Tin, typename Tout>
int launch_fma(const void* x, const void* w, void* y, const long long* seg_rows,
               const int* seg_group, int n_seg, int n_tiles, int K, int N, int E,
               bool rows_few, cudaStream_t stream) {
  const uintptr_t chunk = 4 * sizeof(Tin);
  const bool vec = K % 4 == 0 && N % 4 == 0 && (uintptr_t)x % chunk == 0 &&
                   (uintptr_t)w % chunk == 0;
  if (rows_few)
    return vec ? launch_rows_few<Tin, Tout, true>(x, w, y, seg_rows, seg_group, n_seg, K, N,
                                                  E, stream)
               : launch_rows_few<Tin, Tout, false>(x, w, y, seg_rows, seg_group, n_seg, K,
                                                   N, E, stream);
  return vec ? launch_tiled<Tin, Tout, true>(x, w, y, seg_rows, seg_group, n_seg, n_tiles, K,
                                             N, E, stream)
             : launch_tiled<Tin, Tout, false>(x, w, y, seg_rows, seg_group, n_seg, n_tiles,
                                              K, N, E, stream);
}

int launch_tile(const void* x, const void* w, void* y, const long long* seg_rows,
                const int* seg_group, int n_seg, int n_tiles, int K, int N, int E,
                cudaStream_t stream) {
  using bf = __nv_bfloat16;
  static const cudaError_t attr = tc::allow_smem(tile::gmm_tile_kernel, tile::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)n_tiles, (unsigned)((N + tile::BN - 1) / tile::BN));
  tile::gmm_tile_kernel<<<grid, tile::THREADS, tile::SMEM, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(w), static_cast<bf*>(y), seg_rows,
      seg_group, n_seg, K, N, E);
  return (int)cudaGetLastError();
}

int launch_small(const void* x, const void* w, void* y, const long long* seg_rows,
                 const int* seg_group, int n_seg, int K, int N, int E, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  static const cudaError_t attr = tc::allow_smem(small_rows::gmm_small_kernel, small_rows::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)n_seg, (unsigned)((N + small_rows::BN - 1) / small_rows::BN));
  small_rows::gmm_small_kernel<<<grid, small_rows::THREADS, small_rows::SMEM, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(w), static_cast<bf*>(y), seg_rows,
      seg_group, K, N, E);
  return (int)cudaGetLastError();
}

}  // namespace

// n_tiles: the grid's row tiles (routes fma and tile), at least the
// segments' real 128-row tiles. in_dtype (x and w) and out_dtype (y): 0 =
// float32, 1 = bfloat16. route: 0 = fma by its tile tiling, 3 = fma by its
// rows-few tiling (any dtypes), 1 = tile, 2 = small (both: bf16 in and out,
// K and N multiples of 8, x and w 16-byte aligned).
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* y,
                                     const long long* seg_rows, const int* seg_group,
                                     int n_seg, int n_tiles, int K, int N, int E,
                                     int in_dtype, int out_dtype, int route,
                                     void* stream) {
  if (n_seg < 0 || n_tiles < 0 || K < 0 || N < 0 || E < 1 || route < 0 || route > 3 ||
      ((route == 1 || route == 2) &&
       (in_dtype != 1 || out_dtype != 1 || K % 8 != 0 || N % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  if (n_seg == 0 || n_tiles == 0 || N == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1)
    return launch_tile(x, w, y, seg_rows, seg_group, n_seg, n_tiles, K, N, E, s);
  if (route == 2) return launch_small(x, w, y, seg_rows, seg_group, n_seg, K, N, E, s);
  const bool few = route == 3;
  if (in_dtype == 1) {
    if (out_dtype == 1)
      return launch_fma<__nv_bfloat16, __nv_bfloat16>(x, w, y, seg_rows, seg_group, n_seg,
                                                      n_tiles, K, N, E, few, s);
    return launch_fma<__nv_bfloat16, float>(x, w, y, seg_rows, seg_group, n_seg, n_tiles,
                                            K, N, E, few, s);
  }
  if (out_dtype == 1)
    return launch_fma<float, __nv_bfloat16>(x, w, y, seg_rows, seg_group, n_seg, n_tiles, K,
                                            N, E, few, s);
  return launch_fma<float, float>(x, w, y, seg_rows, seg_group, n_seg, n_tiles, K, N, E,
                                  few, s);
}

extern "C" const char* grouped_matmul_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
