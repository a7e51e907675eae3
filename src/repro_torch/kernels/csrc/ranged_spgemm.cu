// Dense-slab ranged multiply-add for sm_90a.
//
// Replaces: ranged_spgemm_stream (src/repro/kernels/ranged_spgemm.py, body
// _kernel): C[b,i] = sum_j A[b,i][:, r0_j:r0_j+span] @ B_slab[b,j] + C0[b,i],
// with the A strip (chunk1) or the B chunk (chunk2) stationary while the
// other operand streams through a two-slot VMEM buffer on the TPU.
//
// Bound on this card: operations. A strip of R rows against a slab of span
// rows and n columns is 2*R*span*n flops on 4*(R*span + span*n + 2*R*n)
// bytes, far above the ~20 flops per byte where float32 outside the tensor
// cores (67 TFLOP/s) meets HBM3 (3.35 TB/s). The products stay in full
// float32 FMAs (no tensor cores, no TF32) so results agree with the f32
// reference, and every tile is computed, zero or not, as the dense
// function is.
//
// Design: a block of 256 threads owns a 128 x 128 tile of C[b,i]; eight
// warps of 32 x 64, each thread an 8 x 8 register tile (two 4-row by two
// 4-column pieces, 16 and 32 apart, so its shared-memory reads are float4s
// that a warp takes without bank conflicts). The span is walked in slices of
// BK = 16 through two shared-memory buffers: while the threads multiply slice
// k from one, slice k + 1 is in flight to the other (one __syncthreads a
// slice). A is stored k-major (As[k][m], rows padded to 132 floats), so its
// loads are transposed through registers: each thread reads 4 consecutive k
// of a row and writes them to 4 rows of As, the 32 lanes of a warp on 32
// different banks. B lands in Bs[k][n] as it lies in memory.
//
// Two paths, chosen by the wrapper (ranged_spgemm.py::choose_path) and
// checked by the C entry:
//   vec:    A, B, C0 and out 16-byte aligned, k_pad, span, n and every r0_j
//           multiples of 4: A and C by float4 loads, B by 16-byte cp.async
//           (zero-filled past span or n);
//   scalar: anything else (k_pad 42,043 and span 9,275 occur): the same
//           tiles by masked 4-byte loads through registers.
//
// Order: for each chunk j the block sums its partial product from zero in
// k order and then writes C = base + partial, where base is C0 for the first
// chunk and the tile it wrote for the chunk before. chunk1 is one launch with
// the chunk loop inside the block; chunk2 one launch per chunk over every
// strip. Both perform the same float operations in the same order, so they
// agree bit for bit (the reference's grouping: c0 + partial_0, then
// += partial_j).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;
constexpr int AS = BM + 4;   // As row stride: the transposing stores hit 32 banks
static_assert(BK % 8 == 0, "the staging takes 8 k a pass");

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
ranged_dense_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* cin, float* out, const int* __restrict__ r0s,
                    int n_ac, int strip_rows, int k_pad, int n_b, int span,
                    int n, int j_begin, int j_end) {
  __shared__ __align__(16) float As[2][BK][AS];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm0 = (warp / 2) * 32, wn0 = (warp % 2) * 64;   // the warp's tile
  const int lm = lane / 8, ln = lane % 8;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const long long strip = blockIdx.z;
  const long long batch = strip / n_ac;
  const float* A = a + strip * strip_rows * (long long)k_pad;
  const float* C_in = cin + strip * strip_rows * (long long)n;
  float* C_out = out + strip * strip_rows * (long long)n;

  // staging: A row a_row, k a_kq + 8 l + {0..3}; B row b_k + 8 l, columns
  // b_nq + {0..3} (l < BK / 8)
  const int a_row = (tid / 32) * 16 + tid % 16;
  const int a_kq = ((tid % 32) / 16) * 4;
  const int b_k = tid / 32, b_nq = (tid % 32) * 4;
  const bool a_ok = row0 + a_row < strip_rows;
  const float* a_src = A + (long long)(a_ok ? row0 + a_row : 0) * k_pad;
  const int b_col = col0 + b_nq;

  for (int j = j_begin; j < j_end; ++j) {
    const int r0 = r0s[j];
    const float* slab = b + (batch * n_b + j) * (long long)span * n;
    float areg[BK / 8][4], breg[BK / 8][4];

    auto load = [&](int k0, int buf) {   // slice k0 to registers (A; B on scalar) or Bs
#pragma unroll
      for (int l = 0; l < BK / 8; ++l) {
        const int kk = k0 + a_kq + 8 * l;
        if (VEC) {
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (a_ok && kk < span) x = *reinterpret_cast<const float4*>(a_src + r0 + kk);
          areg[l][0] = x.x;
          areg[l][1] = x.y;
          areg[l][2] = x.z;
          areg[l][3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            areg[l][e] = (a_ok && kk + e < span) ? a_src[r0 + kk + e] : 0.f;
        }
        const int kr = k0 + b_k + 8 * l;
        const float* src = slab + (long long)kr * n + b_col;
        if (VEC) {
          const bool valid = kr < span && b_col < n;
          tc::cp_async16(tc::smem_addr(&Bs[buf][b_k + 8 * l][b_nq]), valid ? src : slab, valid);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            breg[l][e] = (kr < span && b_col + e < n) ? src[e] : 0.f;
        }
      }
      if (VEC) tc::cp_async_commit();
    };
    auto store = [&](int buf) {   // the registers of a loaded slice to As (and Bs)
#pragma unroll
      for (int l = 0; l < BK / 8; ++l) {
#pragma unroll
        for (int e = 0; e < 4; ++e) As[buf][a_kq + 8 * l + e][a_row] = areg[l][e];
        if (!VEC)
          *reinterpret_cast<float4*>(&Bs[buf][b_k + 8 * l][b_nq]) =
              make_float4(breg[l][0], breg[l][1], breg[l][2], breg[l][3]);
      }
      if (VEC) tc::cp_async_wait<0>();
    };

    float part[8][8];
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int q = 0; q < 8; ++q) part[m][q] = 0.f;

    const int n_tiles = (span + BK - 1) / BK;
    load(0, 0);
    store(0);
    __syncthreads();
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int cur = kt & 1;
      const bool more = kt + 1 < n_tiles;
      if (more) load((kt + 1) * BK, cur ^ 1);
#pragma unroll 4   // full unrolling hoists every fragment load: 199 registers, one block an SM
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][wm0 + lm * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][wm0 + 16 + lm * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][wn0 + ln * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][wn0 + 32 + ln * 4]);
        const float af[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bf[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int q = 0; q < 8; ++q) part[m][q] = fmaf(af[m], bf[q], part[m][q]);
      }
      if (more) store(cur ^ 1);
      __syncthreads();
    }

    // C = base + partial: base is C0 for the first chunk of this launch,
    // else the tile this thread wrote for the chunk before
    const float* base = j == j_begin ? C_in : C_out;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int row = row0 + wm0 + (m / 4) * 16 + lm * 4 + m % 4;
      if (row >= strip_rows) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + wn0 + h * 32 + ln * 4;
        const long long off = (long long)row * n + col;
        if (VEC) {
          if (col < n) {
            float4 c = *reinterpret_cast<const float4*>(base + off);
            c.x += part[m][4 * h];
            c.y += part[m][4 * h + 1];
            c.z += part[m][4 * h + 2];
            c.w += part[m][4 * h + 3];
            *reinterpret_cast<float4*>(C_out + off) = c;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < n) C_out[off + e] = base[off + e] + part[m][4 * h + e];
        }
      }
    }
  }
}

template <bool VEC>
void run(const float* a, const float* b, const float* c0, const int* r0s, float* out,
         dim3 grid, int n_ac, int strip_rows, int k_pad, int n_b, int span, int n,
         int order, cudaStream_t s) {
  if (order == 1) {
    ranged_dense_kernel<VEC><<<grid, THREADS, 0, s>>>(a, b, c0, out, r0s, n_ac, strip_rows,
                                                      k_pad, n_b, span, n, 0, n_b);
  } else {
    for (int j = 0; j < n_b; ++j)
      ranged_dense_kernel<VEC><<<grid, THREADS, 0, s>>>(a, b, j == 0 ? c0 : out, out, r0s,
                                                        n_ac, strip_rows, k_pad, n_b, span,
                                                        n, j, j + 1);
  }
}

}  // namespace

// order: 1 = chunk1 (strips outer, one launch), 2 = chunk2 (chunks outer).
// vec: 1 takes the float4 / cp.async path, which needs 16-byte aligned
// operands and k_pad, span, n (and, the caller's promise, every r0s[j])
// multiples of 4; the entry refuses vec = 1 on anything else.
extern "C" int ranged_spgemm_launch(const float* a, const float* b,
                                    const float* c0, const int* r0s, float* out,
                                    int batch, int n_ac, int strip_rows,
                                    int k_pad, int n_b, int span, int n,
                                    int order, int vec, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (strip_rows + BM - 1) / BM, batch * n_ac);
  if (vec) {
    const uintptr_t ptrs = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c0 | (uintptr_t)out;
    if (ptrs % 16 || k_pad % 4 || span % 4 || n % 4) return (int)cudaErrorInvalidValue;
  }
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    run<true>(a, b, c0, r0s, out, grid, n_ac, strip_rows, k_pad, n_b, span, n, order, s);
  else
    run<false>(a, b, c0, r0s, out, grid, n_ac, strip_rows, k_pad, n_b, span, n, order, s);
  return (int)cudaGetLastError();
}

extern "C" const char* ranged_spgemm_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
