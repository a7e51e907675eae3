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
// float32 FMAs — no tensor cores, no TF32 — so results agree with the f32
// reference.
//
// Design: a block of 256 threads owns a 64x64 tile of C[b,i] and keeps it in
// registers (4x4 per thread), initialised from C0. The TPU's sequential grid
// axis becomes a loop: for each chunk j it walks the span in steps of 16,
// staging the A tile (columns r0_j + k) and the slab tile in shared memory,
// sums the chunk's partial product from zero and adds it to the tile, the
// reference's grouping (c0 + partial_0, then += partial_j). Ragged row,
// column and span edges are masked; A columns at or past k_pad read as zero.
// chunk1 is one launch with the chunk loop inside the block; chunk2 is one
// launch per chunk over every strip, the C tile going back to global memory
// between launches. Both orders perform the same float operations in the same
// order, so they agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
ranged_dense_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* cin, float* out, const int* __restrict__ r0s,
                    int n_ac, int strip_rows, int k_pad, int n_b, int span,
                    int n, int j_begin, int j_end) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const long long strip = blockIdx.z;
  const long long batch = strip / n_ac;
  const float* A = a + strip * strip_rows * (long long)k_pad;
  const float* C_in = cin + strip * strip_rows * (long long)n;
  float* C_out = out + strip * strip_rows * (long long)n;

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int row = row0 + ty * TM + m, col = col0 + tx * TN + q;
      acc[m][q] = (row < strip_rows && col < n) ? C_in[(long long)row * n + col] : 0.f;
    }
  }

  for (int j = j_begin; j < j_end; ++j) {
    const int r0 = r0s[j];
    const float* slab = b + (batch * n_b + j) * span * (long long)n;
    float part[TM][TN];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int q = 0; q < TN; ++q) part[m][q] = 0.f;

    for (int k0 = 0; k0 < span; k0 += BK) {
#pragma unroll
      for (int l = 0; l < (BM * BK) / THREADS; ++l) {
        const int idx = tid + l * THREADS;
        const int rr = idx / BK, kk = idx % BK;
        const int row = row0 + rr, kcol = r0 + k0 + kk;
        As[kk][rr] = (row < strip_rows && k0 + kk < span && kcol < k_pad)
                         ? A[(long long)row * k_pad + kcol]
                         : 0.f;
      }
#pragma unroll
      for (int l = 0; l < (BN * BK) / THREADS; ++l) {
        const int idx = tid + l * THREADS;
        const int kk = idx / BN, cc = idx % BN;
        const int krow = k0 + kk, col = col0 + cc;
        Bs[kk][cc] = (krow < span && col < n) ? slab[(long long)krow * n + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float af[TM], bf[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) af[m] = As[kk][ty * TM + m];
#pragma unroll
        for (int q = 0; q < TN; ++q) bf[q] = Bs[kk][tx * TN + q];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int q = 0; q < TN; ++q) part[m][q] = fmaf(af[m], bf[q], part[m][q]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int q = 0; q < TN; ++q) acc[m][q] += part[m][q];
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int row = row0 + ty * TM + m, col = col0 + tx * TN + q;
      if (row < strip_rows && col < n) C_out[(long long)row * n + col] = acc[m][q];
    }
  }
}

}  // namespace

// order: 1 = chunk1 (strips outer, one launch), 2 = chunk2 (chunks outer).
extern "C" int ranged_spgemm_launch(const float* a, const float* b,
                                    const float* c0, const int* r0s, float* out,
                                    int batch, int n_ac, int strip_rows,
                                    int k_pad, int n_b, int span, int n,
                                    int order, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (strip_rows + BM - 1) / BM, batch * n_ac);
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 1) {
    ranged_dense_kernel<<<grid, THREADS, 0, s>>>(a, b, c0, out, r0s, n_ac,
                                                 strip_rows, k_pad, n_b, span,
                                                 n, 0, n_b);
  } else {
    for (int j = 0; j < n_b; ++j)
      ranged_dense_kernel<<<grid, THREADS, 0, s>>>(a, b, j == 0 ? c0 : out, out,
                                                   r0s, n_ac, strip_rows, k_pad,
                                                   n_b, span, n, j, j + 1);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ranged_spgemm_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
