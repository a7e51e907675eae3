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
// not a multiple of 8, or misaligned): f32 FMAs. A block of 256 threads
// holds a 128 x 128 tile of y in registers (8 x 8 a thread,
// as two 4 x 4 quarters 64 rows and 64 columns apart, so that the
// shared-memory reads of a warp are contiguous 16-byte vectors) and walks K
// in steps of 16 through two shared-memory stages, the next step's loads
// held in registers (in their own type) while the current one is computed.
// Rows of a tile past its segment's end are neither loaded nor computed: a
// warp whose rows all lie past the end skips the products.
//
// "tile" and "fma": each block finds its tile itself (warp 0 scans the
// segments' tile counts, 32 at a time), so the grid can be sized by an
// upper bound (ceil(T / 128) + segments) that the host knows without
// reading the segments back: blocks past the real tile count exit at once.
// Consecutive blocks take consecutive row tiles of the same column tile, so
// the tiles of one expert read its weight slab from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;
constexpr int XS = BM + 4;                      // padded row of the x stage
constexpr int X_LOADS = BM * BK / THREADS;      // 8 x elements a thread a step
constexpr int W_LOADS = BK * BN / THREADS;      // 8 w elements a thread a step

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

template <typename Tin, typename Tout>
int launch_fma(const void* x, const void* w, void* y, const long long* seg_rows,
               const int* seg_group, int n_seg, int n_tiles, int K, int N, int E,
               cudaStream_t stream) {
  const dim3 grid((unsigned)n_tiles, (unsigned)((N + BN - 1) / BN));
  grouped_matmul_kernel<Tin, Tout><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w), static_cast<Tout*>(y),
      seg_rows, seg_group, n_seg, K, N, E);
  return (int)cudaGetLastError();
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
// float32, 1 = bfloat16. route: 0 = fma (any dtypes), 1 = tile, 2 = small
// (both: bf16 in and out, K and N multiples of 8, x and w 16-byte aligned).
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* y,
                                     const long long* seg_rows, const int* seg_group,
                                     int n_seg, int n_tiles, int K, int N, int E,
                                     int in_dtype, int out_dtype, int route,
                                     void* stream) {
  if (n_seg < 0 || n_tiles < 0 || K < 0 || N < 0 || E < 1 || route < 0 || route > 2 ||
      (route > 0 && (in_dtype != 1 || out_dtype != 1 || K % 8 != 0 || N % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  if (n_seg == 0 || n_tiles == 0 || N == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1)
    return launch_tile(x, w, y, seg_rows, seg_group, n_seg, n_tiles, K, N, E, s);
  if (route == 2) return launch_small(x, w, y, seg_rows, seg_group, n_seg, K, N, E, s);
  if (in_dtype == 1) {
    if (out_dtype == 1)
      return launch_fma<__nv_bfloat16, __nv_bfloat16>(x, w, y, seg_rows, seg_group, n_seg,
                                                      n_tiles, K, N, E, s);
    return launch_fma<__nv_bfloat16, float>(x, w, y, seg_rows, seg_group, n_seg, n_tiles,
                                            K, N, E, s);
  }
  if (out_dtype == 1)
    return launch_fma<float, __nv_bfloat16>(x, w, y, seg_rows, seg_group, n_seg, n_tiles, K,
                                            N, E, s);
  return launch_fma<float, float>(x, w, y, seg_rows, seg_group, n_seg, n_tiles, K, N, E, s);
}

extern "C" const char* grouped_matmul_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
