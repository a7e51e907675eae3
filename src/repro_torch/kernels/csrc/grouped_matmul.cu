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
// seg_group[s] (s itself when seg_group is null). Each block owns one BM-row
// tile of one segment and one BN-column tile of y; it finds its segment
// itself (warp 0 scans the segments' tile counts, 32 at a time), so the
// grid can be sized by an upper bound (ceil(T / BM) + segments) that the
// host knows without reading the segments back: blocks past the real tile
// count exit at once. The padded layout of the TPU kernel is the special
// case of one segment per bt-row tile. Rows of a tile past its segment's end
// are neither loaded nor computed: a warp whose rows all lie past the end
// skips the products (at decode a tile holds one to eight rows of 128), and
// y rows outside every segment are not written.
//
// Layouts: x [T, K] and w [E, K, N] row-major, f32 or bf16 (both the same);
// y [T, N] in f32 or bf16; seg_rows int64 [n_seg + 1], ascending; seg_group
// int32 [n_seg] or null. Products are f32 FMAs (exact for bf16 operands),
// summed in f32 along K in order, and rounded once to y's type. Offsets are
// 64-bit: at the serve run's prefill x holds about 124k rows of 2,048.
//
// Bound on this card: at decode (tens of rows an expert) the weight bytes
// (each touched expert's K x N read once, about 4 MB in bf16); at prefill
// (thousands of rows an expert) the operations, 2 T K N, against the bf16
// tensor cores' 989 TFLOP/s. What the design does: a block of 256 threads
// holds a 128 x 128 tile of y in registers (8 x 8 a thread, as two 4 x 4
// quarters 64 rows and 64 columns apart, so that the shared-memory reads of
// a warp are contiguous 16-byte vectors) and walks K in steps of 16 through
// two shared-memory stages, the next step's loads held in registers (in
// their own type) while the current one is computed. The products are f32
// FMAs, not the tensor cores: mma / wgmma with bf16 operands, and TMA or
// cp.async stages, are the redesign. At decode each block streams its
// weight slab with one step of loads in flight, far from the byte rate;
// more loads in flight (deeper stages, or smaller tiles for few rows) is
// the redesign there. Consecutive blocks take consecutive row tiles of the
// same column tile, so the tiles of one expert read its weight slab from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;
constexpr int XS = BM + 4;                      // padded row of the x stage
constexpr int X_LOADS = BM * BK / THREADS;      // 8 x elements a thread a step
constexpr int W_LOADS = BK * BN / THREADS;      // 8 w elements a thread a step

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
    grouped_matmul_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                          Tout* __restrict__ y, const long long* __restrict__ seg_rows,
                          const int* __restrict__ seg_group, int n_seg, int K, int N,
                          int E) {
  __shared__ __align__(16) float xs[2][BK][XS];   // x tile, transposed: [k][row]
  __shared__ __align__(16) float ws[2][BK][BN];   // w tile: [k][col]
  __shared__ long long s_row0;
  __shared__ int s_rows, s_group;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (warp == 0) {
    // this block's tile: the t-th BM-row tile over the segments, in order
    const long long t = blockIdx.x;
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
      s_group = -1;
      if (seg >= 0) {
        const long long r0 = seg_rows[seg] + sub * BM;
        const long long r1 = seg_rows[seg + 1];
        s_row0 = r0;
        s_rows = (int)(r1 - r0 < BM ? r1 - r0 : BM);
        s_group = seg_group != nullptr ? seg_group[seg] : seg;
      }
    }
  }
  __syncthreads();
  const int g = s_group;
  if (g < 0 || g >= E) return;   // past the real tiles (uniform over the block)
  const long long row0 = s_row0;
  const int rows = s_rows;
  const int col0 = blockIdx.y * BN;
  const Tin* X = x + row0 * K;
  const Tin* W = w + (long long)g * K * N;

  // global -> register loads: x as 2 rows x 16 k a warp (k fastest), w as
  // 32 consecutive columns of one k a warp
  const int xk = tid % BK, xr = tid / BK;      // rows xr + 16 i
  const int wc = tid % BN, wk = tid / BN;      // k rows wk + 2 i
  // the loaded values stay in their own type until they are staged, so
  // that nothing waits on the loads before the current step's products
  Tin xreg[X_LOADS], wreg[W_LOADS];
  const Tin zero = Tin(0.f);
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < X_LOADS; ++i) {
      const int r = xr + 16 * i, k = k0 + xk;
      xreg[i] = (r < rows && k < K) ? X[(long long)r * K + k] : zero;
    }
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const int k = k0 + wk + 2 * i, c = col0 + wc;
      wreg[i] = (k < K && c < N) ? W[(long long)k * N + c] : zero;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < X_LOADS; ++i) xs[buf][xk][xr + 16 * i] = widen(xreg[i]);
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) ws[buf][wk + 2 * i][wc] = widen(wreg[i]);
  };

  // this thread's outputs: rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
  // columns tx*4 + {0..3} and 64 + tx*4 + {0..3}; warp w holds rows
  // [8w, 8w + 8) and [64 + 8w, 64 + 8w + 8)
  const int tx = tid % 16, ty = tid / 16;
  const bool live = warp * 8 < rows;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  stage(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);
    if (live) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], b[8];
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xs[buf][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ws[buf][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ws[buf][kk][64 + tx * 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + i % 4;
    if (r >= rows) continue;
    Tout* out = y + (row0 + r) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? 0 : 64) + tx * 4 + j % 4;
      if (c < N) put(out + c, acc[i][j]);
    }
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, const void* w, void* y, const long long* seg_rows,
           const int* seg_group, int n_seg, int n_tiles, int K, int N, int E,
           cudaStream_t stream) {
  const dim3 grid((unsigned)n_tiles, (unsigned)((N + BN - 1) / BN));
  grouped_matmul_kernel<Tin, Tout><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w), static_cast<Tout*>(y),
      seg_rows, seg_group, n_seg, K, N, E);
  return (int)cudaGetLastError();
}

}  // namespace

// n_tiles: the grid's row tiles, at least the segments' real BM-row tiles.
// in_dtype (x and w) and out_dtype (y): 0 = float32, 1 = bfloat16.
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* y,
                                     const long long* seg_rows, const int* seg_group,
                                     int n_seg, int n_tiles, int K, int N, int E,
                                     int in_dtype, int out_dtype, void* stream) {
  if (n_seg < 0 || n_tiles < 0 || K < 0 || N < 0 || E < 1) return (int)cudaErrorInvalidValue;
  if (n_seg == 0 || n_tiles == 0 || N == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == 1) {
    if (out_dtype == 1)
      return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, seg_rows, seg_group, n_seg,
                                                  n_tiles, K, N, E, s);
    return launch<__nv_bfloat16, float>(x, w, y, seg_rows, seg_group, n_seg, n_tiles,
                                        K, N, E, s);
  }
  if (out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, y, seg_rows, seg_group, n_seg, n_tiles, K,
                                        N, E, s);
  return launch<float, float>(x, w, y, seg_rows, seg_group, n_seg, n_tiles, K, N, E, s);
}

extern "C" const char* grouped_matmul_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
