// Shared skeleton of the two CSR-output accumulators (ESC and hash).
//
// Replaces the streaming schedule of sparse_accum_spgemm_stream
// (src/repro/kernels/sparse_accum_spgemm.py), which both Pallas merges ride:
// per (strip, chunk) step the TPU kernel merged a whole strip at once in VMEM.
// Rows are independent, so here one warp owns one strip row, and the merge
// (ESC sort-compress or hash table) is a template parameter.
//
// Launch structure, by streaming order:
//   chunk1 (A/C stationary): one launch; each warp loops over all B chunks
//     with its row's accumulator resident in shared memory;
//   chunk2 (B chunk stationary): one launch per chunk over every strip row;
//     between launches a row's accumulator lives in a global per-row slab
//     (a partial row is a subset of the final row, so the slab of
//     `row_cap` slots never overflows when the symbolic caps are right).
// Then a hand-written block scan of the per-row counts writes each strip's
// indptr, and a copy pass compacts the slabs into the CSR at capacity c_cap
// with a zero tail, the reference's layout.
//
// Bound: the products read B rows gathered by A's columns and the strip CSR
// is written once; the work is a few hundred bytes per row, so the kernels
// are bound by memory traffic and by the latency of the dependent loads
// (A row -> B row pointers -> B entries). One warp per row keeps enough rows
// in flight to cover that latency; the accumulator never leaves shared
// memory within a launch.
//
// Any capacity violation (more entries than row_cap, work_cap or c_cap, or a
// probe that finds no slot) is clamped so no write leaves its buffer, and it
// sets *overflow, which the wrapper turns into an exception.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace csr_accum {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int* a_ip;    // [batch, n_ac, strip_rows + 1]
  const int* a_ix;    // [batch, n_ac, a_cap]
  const float* a_d;
  const int* b_ip;    // [batch, n_b, chunk_rows + 1]
  const int* b_ix;    // [batch, n_b, chunk_cap]
  const float* b_d;
  const int* c0_ip;   // [batch, n_ac, strip_rows + 1]
  const int* c0_ix;   // [batch, n_ac, c_cap]
  const float* c0_d;
  const int* r0s;     // [n_b] global row range of each B chunk
  const int* r1s;
  int* slab_cols;     // [rows, row_cap] per-row accumulator between launches
  float* slab_vals;
  int* slab_cnt;      // [rows]
  int* out_ip;        // [batch, n_ac, strip_rows + 1]
  int* out_ix;        // [batch, n_ac, c_cap]
  float* out_d;
  int* overflow;      // [1]
  int batch, n_ac, n_b, strip_rows, chunk_rows;
  int a_cap, chunk_cap, c_cap, a_mrn, b_mrn;
  int row_cap;        // slots per row: accumulator (ESC) or table (hash)
  int work_cap;       // ESC sort workspace per warp (power of two); unused by hash
  int smem_per_warp;  // bytes
};

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__device__ __forceinline__ unsigned lanemask_lt(int lane) {
  return (1u << lane) - 1u;
}

__device__ __forceinline__ void flag_overflow(const Params& p) {
  atomicOr(p.overflow, 1);
}

__device__ __forceinline__ int next_pow2(int v) {
  int n = 1;
  while (n < v) n <<= 1;
  return n;
}

// In-place ascending bitonic sort of n2 (a power of two) keys by one warp.
template <class Key, class Swap>
__device__ void warp_bitonic(Key* keys, int n2, int lane, Swap swap_extra) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int t = lane; t < n2; t += kWarp) {
        int u = t ^ jj;
        if (u > t) {
          bool ascending = (t & k) == 0;
          Key x = keys[t], y = keys[u];
          if ((x > y) == ascending) {
            keys[t] = y;
            keys[u] = x;
            swap_extra(t, u);
          }
        }
      }
      __syncwarp();
    }
  }
}

// Walk the in-range products of one A row against B chunk j, in the
// reference's order: A entries in entry order, each one's B row in order.
// emit(pos, col, val) receives the product's position in that order.
template <class Emit>
__device__ int for_each_product(const Params& p, const int* a_ix,
                                const float* a_d, int a_start, int a_end,
                                const int* b_ip, const int* b_ix,
                                const float* b_d, int r0, int r1, int lane,
                                Emit emit) {
  int total = 0;
  for (int base = a_start; base < a_end; base += kWarp) {
    int e = base + lane;
    int cnt = 0, b_start = 0;
    float a_val = 0.f;
    if (e < a_end) {
      int col = a_ix[e];
      if (col >= r0 && col < r1) {
        int b_row = min(max(col - r0, 0), p.chunk_rows - 1);
        b_start = b_ip[b_row];
        cnt = max(min(b_ip[b_row + 1] - b_start, p.b_mrn), 0);
        a_val = a_d[e];
      }
    }
    int incl = warp_incl_scan(cnt, lane);
    int excl = incl - cnt;
    for (int jj = 0; jj < cnt; ++jj) {
      int src = min(b_start + jj, p.chunk_cap - 1);
      emit(total + excl + jj, b_ix[src], a_val * b_d[src]);
    }
    total += __shfl_sync(kFull, incl, kWarp - 1);
  }
  return total;
}

// One warp per strip row: load the accumulator (C0 on the first chunk, the
// slab afterwards), merge chunks [j_begin, j_end), store the row to the slab.
template <class Merge>
__global__ void accum_rows_kernel(Params p, int j_begin, int j_end) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long rows = (long long)p.batch * p.n_ac * p.strip_rows;
  const long long g = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (g >= rows) return;  // warp-uniform
  const long long strip = g / p.strip_rows;
  const int r = (int)(g % p.strip_rows);
  const long long b = strip / p.n_ac;

  Merge m(smem + (size_t)warp * p.smem_per_warp, p);
  m.clear(lane);
  if (j_begin == 0) {
    const int* ip = p.c0_ip + strip * (p.strip_rows + 1);
    int s = min(ip[r], p.c_cap), e = min(ip[r + 1], p.c_cap);
    m.load(p, p.c0_ix + strip * p.c_cap + s, p.c0_d + strip * p.c_cap + s,
           max(e - s, 0), lane);
  } else {
    m.load(p, p.slab_cols + g * p.row_cap, p.slab_vals + g * p.row_cap,
           p.slab_cnt[g], lane);
  }
  const int* a_ip = p.a_ip + strip * (p.strip_rows + 1);
  const int* a_ix = p.a_ix + strip * p.a_cap;
  const float* a_d = p.a_d + strip * p.a_cap;
  const int a_start = min(a_ip[r], p.a_cap), a_end = min(a_ip[r + 1], p.a_cap);
  for (int j = j_begin; j < j_end; ++j) {
    const long long chunk = b * p.n_b + j;
    m.merge(p, a_ix, a_d, a_start, a_end, p.b_ip + chunk * (p.chunk_rows + 1),
            p.b_ix + chunk * p.chunk_cap, p.b_d + chunk * p.chunk_cap,
            p.r0s[j], p.r1s[j], lane);
  }
  p.slab_cnt[g] = m.store(p, p.slab_cols + g * p.row_cap,
                          p.slab_vals + g * p.row_cap, lane);
}

// One block per strip: exclusive scan of the row counts into indptr, then
// the zero tail past the strip's nnz.
__global__ void scan_rows_kernel(Params p) {
  __shared__ int warp_sums[kWarp];
  __shared__ int tile_total;
  const long long strip = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int* cnt = p.slab_cnt + strip * p.strip_rows;
  int* ip = p.out_ip + strip * (p.strip_rows + 1);
  int carry = 0;
  for (int base = 0; base < p.strip_rows; base += blockDim.x) {
    int r = base + tid;
    int v = r < p.strip_rows ? cnt[r] : 0;
    int incl = warp_incl_scan(v, lane);
    if (lane == kWarp - 1) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int ws = lane < n_warps ? warp_sums[lane] : 0;
      int ws_incl = warp_incl_scan(ws, lane);
      if (lane < n_warps) warp_sums[lane] = ws_incl - ws;
      if (lane == n_warps - 1) tile_total = ws_incl;
    }
    __syncthreads();
    if (r < p.strip_rows) ip[r] = carry + warp_sums[warp] + incl - v;
    carry += tile_total;
    __syncthreads();
  }
  if (tid == 0) {
    ip[p.strip_rows] = carry;
    if (carry > p.c_cap) flag_overflow(p);
  }
  for (int t = min(carry, p.c_cap) + tid; t < p.c_cap; t += blockDim.x) {
    p.out_ix[strip * p.c_cap + t] = 0;
    p.out_d[strip * p.c_cap + t] = 0.f;
  }
}

// One warp per row: copy the row's slab entries to their CSR positions.
__global__ void copy_rows_kernel(Params p) {
  const int lane = threadIdx.x % kWarp;
  const long long rows = (long long)p.batch * p.n_ac * p.strip_rows;
  const long long g =
      (long long)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (g >= rows) return;
  const long long strip = g / p.strip_rows;
  const int r = (int)(g % p.strip_rows);
  const int dst0 = p.out_ip[strip * (p.strip_rows + 1) + r];
  const int n = p.slab_cnt[g];
  for (int t = lane; t < n; t += kWarp) {
    int d = dst0 + t;
    if (d < p.c_cap) {
      p.out_ix[strip * p.c_cap + d] = p.slab_cols[g * p.row_cap + t];
      p.out_d[strip * p.c_cap + d] = p.slab_vals[g * p.row_cap + t];
    }
  }
}

template <class Merge>
int launch(const Params& p, int warps_per_block, int order,
           cudaStream_t stream) {
  const long long rows = (long long)p.batch * p.n_ac * p.strip_rows;
  const int strips = p.batch * p.n_ac;
  if (strips == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)warps_per_block * p.smem_per_warp;
  cudaError_t err = cudaFuncSetAttribute(
      accum_rows_kernel<Merge>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    const unsigned blocks =
        (unsigned)((rows + warps_per_block - 1) / warps_per_block);
    const unsigned threads = warps_per_block * kWarp;
    if (order == 1) {  // chunk1: accumulator resident across all chunks
      accum_rows_kernel<Merge><<<blocks, threads, smem, stream>>>(p, 0, p.n_b);
    } else {  // chunk2: one launch per stationary chunk
      for (int j = 0; j < p.n_b; ++j)
        accum_rows_kernel<Merge><<<blocks, threads, smem, stream>>>(p, j, j + 1);
    }
  }
  scan_rows_kernel<<<strips, 256, 0, stream>>>(p);
  if (rows > 0)
    copy_rows_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace csr_accum

// The C entry point both accumulator libraries export, under their own name.
#define CSR_ACCUM_ENTRY(NAME, MERGE)                                         \
  extern "C" int NAME(                                                       \
      const int* a_ip, const int* a_ix, const float* a_d, const int* b_ip,  \
      const int* b_ix, const float* b_d, const int* c0_ip, const int* c0_ix, \
      const float* c0_d, const int* r0s, const int* r1s, int* slab_cols,    \
      float* slab_vals, int* slab_cnt, int* out_ip, int* out_ix,            \
      float* out_d, int* overflow, int batch, int n_ac, int n_b,            \
      int strip_rows, int chunk_rows, int a_cap, int chunk_cap, int c_cap,  \
      int a_mrn, int b_mrn, int row_cap, int work_cap, int smem_per_warp,   \
      int warps_per_block, int order, void* stream) {                       \
    csr_accum::Params p{a_ip,      a_ix,      a_d,      b_ip,    b_ix,      \
                        b_d,       c0_ip,     c0_ix,    c0_d,    r0s,       \
                        r1s,       slab_cols, slab_vals, slab_cnt, out_ip,  \
                        out_ix,    out_d,     overflow, batch,   n_ac,      \
                        n_b,       strip_rows, chunk_rows, a_cap, chunk_cap, \
                        c_cap,     a_mrn,     b_mrn,    row_cap, work_cap,  \
                        smem_per_warp};                                      \
    return csr_accum::launch<MERGE>(p, warps_per_block, order,             \
                                    (cudaStream_t)stream);                   \
  }                                                                          \
  extern "C" const char* NAME##_error_string(int e) {                       \
    return cudaGetErrorString((cudaError_t)e);                               \
  }
