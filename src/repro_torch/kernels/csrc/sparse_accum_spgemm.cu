// ESC (expand-sort-compress) CSR-output ranged SpGEMM for sm_90a.
//
// Replaces: sparse_accum_spgemm_stream (src/repro/kernels/sparse_accum_spgemm.py)
// with its default merge, spgemm_ranged_impl (src/repro/core/kkmem.py): per
// step C = A[:, r0:r1] x B_chunk + C_prev, where the TPU kernel expanded the
// in-range products of a whole strip, appended C_prev, did a stable two-key
// sort and compressed duplicates in VMEM.
//
// Bound on this card: memory traffic and load latency (see csr_accum.cuh);
// the arithmetic is one multiply per product. The strip-wide sort becomes a
// row-wise one: each warp expands its row's products into shared memory
// (positions in the reference's order), appends the row's accumulator,
// bitonic-sorts 64-bit (column, position) keys, which makes the sort stable,
// and compresses each run of equal columns by summing in sorted order from
// 0.0f — the reference's summation order, so a key whose products sum to
// zero stays an entry, as in the reference. The workspace per warp is
// next_pow2(a_max_row_nnz * b_max_row_nnz + row_cap) keys; the wrapper
// refuses shapes whose workspace does not fit shared memory.

#include "csr_accum.cuh"

namespace {

using csr_accum::Params;
using csr_accum::kWarp;
using csr_accum::kFull;

struct EscMerge {
  unsigned long long* keys;  // [work_cap] (column << 32) | position
  float* wvals;              // [work_cap] value by position
  int* acc_cols;             // [row_cap] compressed, column-sorted row
  float* acc_vals;           // [row_cap]
  int acc_n;

  __device__ EscMerge(unsigned char* base, const Params& p) : acc_n(0) {
    keys = reinterpret_cast<unsigned long long*>(base);
    wvals = reinterpret_cast<float*>(keys + p.work_cap);
    acc_cols = reinterpret_cast<int*>(wvals + p.work_cap);
    acc_vals = reinterpret_cast<float*>(acc_cols + p.row_cap);
  }

  __device__ void clear(int) { acc_n = 0; }

  // Raw entries (unsorted, duplicates allowed): the next merge sorts them.
  __device__ void load(const Params& p, const int* cols, const float* vals,
                       int n, int lane) {
    if (n > p.row_cap) {
      if (lane == 0) csr_accum::flag_overflow(p);
      n = p.row_cap;
    }
    for (int t = lane; t < n; t += kWarp) {
      acc_cols[t] = cols[t];
      acc_vals[t] = vals[t];
    }
    acc_n = n;
    __syncwarp();
  }

  __device__ void merge(const Params& p, const int* a_ix, const float* a_d,
                        int a_start, int a_end, const int* b_ip,
                        const int* b_ix, const float* b_d, int r0, int r1,
                        int lane) {
    const int cap = p.work_cap;
    unsigned long long* k = keys;
    float* w = wvals;
    bool over = false;
    int n_prod = csr_accum::for_each_product(
        p, a_ix, a_d, a_start, a_end, b_ip, b_ix, b_d, r0, r1, lane,
        [&](int pos, int col, float val) {
          if (pos < cap) {
            k[pos] = ((unsigned long long)(unsigned)col << 32) | (unsigned)pos;
            w[pos] = val;
          } else {
            over = true;
          }
        });
    int n = n_prod + acc_n;
    if (n > cap) {
      over = true;
      n = cap;
    }
    for (int t = lane; t < acc_n; t += kWarp) {
      int pos = n_prod + t;
      if (pos < cap) {
        k[pos] = ((unsigned long long)(unsigned)acc_cols[t] << 32) |
                 (unsigned)pos;
        w[pos] = acc_vals[t];
      }
    }
    if (__any_sync(kFull, over) && lane == 0) csr_accum::flag_overflow(p);
    if (n == 0) {
      acc_n = 0;
      __syncwarp();
      return;
    }
    const int n2 = csr_accum::next_pow2(n);
    for (int t = n + lane; t < n2; t += kWarp) k[t] = ~0ull;
    __syncwarp();
    csr_accum::warp_bitonic(k, n2, lane, [](int, int) {});

    // compress: one lane per run of equal columns sums it in sorted order
    int out_n = 0;
    bool out_over = false;
    for (int base = 0; base < n; base += kWarp) {
      int t = base + lane;
      bool head = false;
      unsigned col = 0;
      if (t < n) {
        col = (unsigned)(k[t] >> 32);
        head = t == 0 || (unsigned)(k[t - 1] >> 32) != col;
      }
      unsigned heads = __ballot_sync(kFull, head);
      if (head) {
        int seg = out_n + __popc(heads & csr_accum::lanemask_lt(lane));
        float s = 0.f;
        for (int u = t; u < n && (unsigned)(k[u] >> 32) == col; ++u)
          s += w[(unsigned)(k[u] & 0xffffffffull)];
        if (seg < p.row_cap) {
          acc_cols[seg] = (int)col;
          acc_vals[seg] = s;
        } else {
          out_over = true;
        }
      }
      out_n += __popc(heads);
    }
    if (__any_sync(kFull, out_over) && lane == 0) csr_accum::flag_overflow(p);
    acc_n = min(out_n, p.row_cap);
    __syncwarp();
  }

  __device__ int store(const Params&, int* cols, float* vals, int lane) {
    for (int t = lane; t < acc_n; t += kWarp) {
      cols[t] = acc_cols[t];
      vals[t] = acc_vals[t];
    }
    return acc_n;
  }
};

}  // namespace

CSR_ACCUM_ENTRY(sparse_accum_launch, EscMerge)
