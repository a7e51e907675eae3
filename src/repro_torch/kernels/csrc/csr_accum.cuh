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
// indptr (one block a strip, eight rows a thread), and a copy pass compacts
// the slabs into the CSR at capacity c_cap with a zero tail, the
// reference's layout.
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

// The load-balanced expand the merges share: one batch of up to 32 of a
// row's A entries, one a lane, with the warp's exclusive scan of their
// in-range product counts. Lane l then takes products l, l + 32, ... of the
// batch (locate), so neighbouring lanes read neighbouring entries of one B
// row, and no lane walks a long B row alone. A product's index in the
// batch is its place in the reference's order (A entries in order, each
// one's B row in order).
struct Batch {
  int b_start;   // this lane's entry: the first entry of its B row
  float a_val;
  int excl;      // products of the batch before this lane's entry
  int total;     // products of the batch
};

__device__ __forceinline__ Batch load_batch(const Params& p, const int* a_ix,
                                            const float* a_d, int e, int a_end,
                                            const int* b_ip, int r0, int r1,
                                            int lane) {
  Batch bt{0, 0.f, 0, 0};
  int cnt = 0;
  if (e < a_end) {
    const int col = a_ix[e];
    if (col >= r0 && col < r1) {
      const int b_row = min(max(col - r0, 0), p.chunk_rows - 1);
      bt.b_start = b_ip[b_row];
      cnt = max(min(b_ip[b_row + 1] - bt.b_start, p.b_mrn), 0);
      bt.a_val = a_d[e];
    }
  }
  const int incl = warp_incl_scan(cnt, lane);
  bt.excl = incl - cnt;
  bt.total = __shfl_sync(kFull, incl, kWarp - 1);
  return bt;
}

// Product q of the batch: its A entry is the last lane whose exclusive scan
// is <= q, found by a binary search over the lanes; its B entry (src) is
// q - excl into that entry's B row, and a the entry's value. src = -1 when
// q is outside [0, total). Every lane of the warp calls it; the caller
// loads the B entries, all of a lane's at once.
__device__ __forceinline__ void locate(const Params& p, const Batch& bt, int q, int& src,
                                       float& a) {
  int lo = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    if (__shfl_sync(kFull, bt.excl, lo + s) <= q) lo += s;
  const int excl = __shfl_sync(kFull, bt.excl, lo);
  const int start = __shfl_sync(kFull, bt.b_start, lo);
  a = __shfl_sync(kFull, bt.a_val, lo);
  src = q < 0 || q >= bt.total ? -1 : min(start + q - excl, p.chunk_cap - 1);
}

// Ascending bitonic sort of 32 K keys held K a lane, key r of a lane at
// index lane * K + r.
template <int K, class Key>
__device__ __forceinline__ void bitonic_regs(Key (&key)[K], int lane) {
#pragma unroll
  for (int k = 2; k <= K * kWarp; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < K) {   // both keys of a pair in this lane
#pragma unroll
        for (int r = 0; r < K; ++r) {
          if ((r & j) == 0) {
            const bool up = ((lane * K + r) & k) == 0;
            const Key x = key[r], y = key[r | j];
            const bool swap = (x > y) == up;
            key[r] = swap ? y : x;
            key[r | j] = swap ? x : y;
          }
        }
      } else {       // the partner is register r of lane ^ (j / K)
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int i = lane * K + r;
          const Key y = __shfl_xor_sync(kFull, key[r], j / K);
          const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
          key[r] = keep_min ? (y < key[r] ? y : key[r]) : (y > key[r] ? y : key[r]);
        }
      }
    }
  }
}

// bitonic_regs with a value carried beside each key. Keys that tie may
// end in either order with their values (distinct keys never tie).
template <int K, class Key, class Val>
__device__ __forceinline__ void bitonic_regs_kv(Key (&key)[K], Val (&val)[K], int lane) {
#pragma unroll
  for (int k = 2; k <= K * kWarp; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < K) {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          if ((r & j) == 0) {
            const bool up = ((lane * K + r) & k) == 0;
            const Key x = key[r], y = key[r | j];
            const Val xv = val[r], yv = val[r | j];
            const bool swap = (x > y) == up;
            key[r] = swap ? y : x;
            key[r | j] = swap ? x : y;
            val[r] = swap ? yv : xv;
            val[r | j] = swap ? xv : yv;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int i = lane * K + r;
          const Key y = __shfl_xor_sync(kFull, key[r], j / K);
          const Val yv = __shfl_xor_sync(kFull, val[r], j / K);
          const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
          const bool take = keep_min ? y < key[r] : y > key[r];
          key[r] = take ? y : key[r];
          val[r] = take ? yv : val[r];
        }
      }
    }
  }
}

// One warp per strip row: load the accumulator (C0 on the first chunk, the
// slab afterwards), merge chunks [j_begin, j_end), store the row to the slab.
// A merge asks for Merge::kMinBlocksPerSM blocks of kMaxAccumThreads an SM,
// which caps its registers.
constexpr int kMaxAccumThreads = 8 * kWarp;

template <class Merge>
__global__ void __launch_bounds__(kMaxAccumThreads, Merge::kMinBlocksPerSM)
    accum_rows_kernel(Params p, int j_begin, int j_end) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int rows = p.batch * p.n_ac * p.strip_rows;   // < 2^31 (launch checks)
  const int g = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (g >= rows) return;  // warp-uniform
  const int strip = g / p.strip_rows;
  const int r = g - strip * p.strip_rows;
  const int b = strip / p.n_ac;

  Merge m(smem + (size_t)warp * p.smem_per_warp, p);
  m.clear(lane);
  if (j_begin == 0) {
    const int* ip = p.c0_ip + (long long)strip * (p.strip_rows + 1);
    int s = min(ip[r], p.c_cap), e = min(ip[r + 1], p.c_cap);
    m.load(p, p.c0_ix + (long long)strip * p.c_cap + s,
           p.c0_d + (long long)strip * p.c_cap + s, max(e - s, 0), lane);
  } else {
    m.load(p, p.slab_cols + (long long)g * p.row_cap,
           p.slab_vals + (long long)g * p.row_cap, p.slab_cnt[g], lane);
  }
  const int* a_ip = p.a_ip + (long long)strip * (p.strip_rows + 1);
  const int* a_ix = p.a_ix + (long long)strip * p.a_cap;
  const float* a_d = p.a_d + (long long)strip * p.a_cap;
  const int a_start = min(a_ip[r], p.a_cap), a_end = min(a_ip[r + 1], p.a_cap);
  for (int j = j_begin; j < j_end; ++j) {
    const long long chunk = (long long)b * p.n_b + j;
    m.merge(p, a_ix, a_d, a_start, a_end, p.b_ip + chunk * (p.chunk_rows + 1),
            p.b_ix + chunk * p.chunk_cap, p.b_d + chunk * p.chunk_cap,
            p.r0s[j], p.r1s[j], lane);
  }
  p.slab_cnt[g] = m.store(p, p.slab_cols + (long long)g * p.row_cap,
                          p.slab_vals + (long long)g * p.row_cap, lane);
}

// One block per strip: exclusive scan of the row counts into indptr. A
// thread takes kScanRows consecutive rows, so a strip of tens of thousands
// of rows takes a few block-wide steps (the scan is a chain of dependent
// steps on one SM per strip). The zero tail is the copy pass's: written by
// this one block, the mostly empty tail of a strip of padding rows (megabytes
// at the main path's shapes) took the most of the scan's time.
constexpr int kScanThreads = 1024;
constexpr int kScanRows = 8;

__global__ void scan_rows_kernel(Params p) {
  __shared__ int warp_sums[kWarp];
  __shared__ int tile_total;
  const long long strip = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int n_warps = blockDim.x / kWarp;   // <= 32
  const int* cnt = p.slab_cnt + strip * p.strip_rows;
  int* ip = p.out_ip + strip * (p.strip_rows + 1);
  int carry = 0;
  for (int base = 0; base < p.strip_rows; base += blockDim.x * kScanRows) {
    const int r0 = base + tid * kScanRows;
    int v[kScanRows];
    int sum = 0;
#pragma unroll
    for (int t = 0; t < kScanRows; ++t) {
      v[t] = r0 + t < p.strip_rows ? cnt[r0 + t] : 0;
      sum += v[t];
    }
    const int incl = warp_incl_scan(sum, lane);
    if (lane == kWarp - 1) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int ws = lane < n_warps ? warp_sums[lane] : 0;
      int ws_incl = warp_incl_scan(ws, lane);
      if (lane < n_warps) warp_sums[lane] = ws_incl - ws;
      if (lane == n_warps - 1) tile_total = ws_incl;
    }
    __syncthreads();
    int run = carry + warp_sums[warp] + incl - sum;
#pragma unroll
    for (int t = 0; t < kScanRows; ++t) {
      if (r0 + t < p.strip_rows) ip[r0 + t] = run;
      run += v[t];
    }
    carry += tile_total;
    __syncthreads();
  }
  if (tid == 0) {
    ip[p.strip_rows] = carry;
    if (carry > p.c_cap) flag_overflow(p);
  }
}

// Half a warp per row, rows in a grid-stride loop (two rows in flight a
// warp): copy the row's slab entries to their CSR positions. Then the
// grid's threads zero every strip's tail past its nnz.
constexpr int kCopyThreads = 256;
constexpr int kCopyBlocks = 2048;

__global__ void copy_rows_kernel(Params p) {
  const int half = threadIdx.x % kWarp / 16, hl = threadIdx.x % 16;
  const int rows = p.batch * p.n_ac * p.strip_rows;
  const int halves = gridDim.x * (blockDim.x / 16);
  for (int g = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp * 2 + half; g < rows;
       g += halves) {
    const int strip = g / p.strip_rows;
    const int r = g - strip * p.strip_rows;
    const int dst0 = p.out_ip[(long long)strip * (p.strip_rows + 1) + r];
    const int n = p.slab_cnt[g];
    for (int t = hl; t < n; t += 16) {
      const int d = dst0 + t;
      if (d < p.c_cap) {
        p.out_ix[(long long)strip * p.c_cap + d] = p.slab_cols[(long long)g * p.row_cap + t];
        p.out_d[(long long)strip * p.c_cap + d] = p.slab_vals[(long long)g * p.row_cap + t];
      }
    }
  }
  const int threads = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  for (int strip = 0; strip < p.batch * p.n_ac; ++strip) {
    const int nnz = p.out_ip[(long long)strip * (p.strip_rows + 1) + p.strip_rows];
    int* ix = p.out_ix + (long long)strip * p.c_cap;
    float* d = p.out_d + (long long)strip * p.c_cap;
    for (int t = max(min(nnz, p.c_cap), 0) + tid; t < p.c_cap; t += threads) {
      ix[t] = 0;
      d[t] = 0.f;
    }
  }
}

template <class Merge>
int launch(const Params& p, int warps_per_block, int order,
           cudaStream_t stream) {
  const long long rows = (long long)p.batch * p.n_ac * p.strip_rows;
  const int strips = p.batch * p.n_ac;
  if (rows >= (1ll << 31)) return (int)cudaErrorInvalidValue;   // rows are int
  if (strips == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)warps_per_block * p.smem_per_warp;
  // the kernel's dynamic shared memory limit, raised only when a call needs
  // more than the largest earlier one (one setting per merge)
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        accum_rows_kernel<Merge>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
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
  scan_rows_kernel<<<strips, kScanThreads, 0, stream>>>(p);
  const long long copy_blocks = (rows * 16 + kCopyThreads - 1) / kCopyThreads;
  copy_rows_kernel<<<(unsigned)(copy_blocks < 1 ? 1 : copy_blocks > kCopyBlocks
                                                          ? kCopyBlocks : copy_blocks),
                     kCopyThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace csr_accum

// The C entry point both accumulator libraries export, under their own
// name: LAUNCH(params, warps_per_block, order, stream) launches the call
// (csr_accum::launch of a merge, or a choice among several).
#define CSR_ACCUM_ENTRY_FN(NAME, LAUNCH)                                     \
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
    return LAUNCH(p, warps_per_block, order, (cudaStream_t)stream);         \
  }                                                                          \
  extern "C" const char* NAME##_error_string(int e) {                       \
    return cudaGetErrorString((cudaError_t)e);                               \
  }

#define CSR_ACCUM_ENTRY(NAME, MERGE) CSR_ACCUM_ENTRY_FN(NAME, csr_accum::launch<MERGE>)
