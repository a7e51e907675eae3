// Hash-accumulated CSR-output ranged SpGEMM for sm_90a.
//
// Replaces: hash_accum_spgemm_stream with its merge hash_merge_impl
// (src/repro/kernels/hash_accum_spgemm.py), run by the TPU inside the
// sparse_accum_spgemm_stream pallas_call: per strip row a linear-probing
// table of T = hash_table_slots(c_max_row_nnz) slots, Knuth's
// multiplicative hash masked by T - 1, probes bounded by T
// (probe_step_bound), extraction sorted by column.
//
// Bound on this card: memory traffic and load latency (see csr_accum.cuh);
// each product costs one shared-memory probe chain. One warp owns a row and
// its table of T int32 keys (EMPTY = -1) and f32 values in shared memory;
// the lanes insert their products concurrently, claiming keys with
// atomicCAS and adding values with atomicAdd, so the summation order
// changes from run to run (the structure does not). The hash is
// (uint32)col * 2654435769u & (T - 1), the reference's wrapped int32
// col * -1640531527. In the chunk1 order the table stays resident across
// all chunks of the row instead of being rebuilt from C_prev at every chunk
// as the reference does; the set of keys and the sums are the same. In the
// chunk2 order each launch rebuilds the table from the row's slab.
// Extraction bitonic-sorts the table (EMPTY sorts last) and writes the
// occupied prefix, column-sorted like the ESC merge.

#include "csr_accum.cuh"

namespace {

using csr_accum::Params;
using csr_accum::kWarp;
using csr_accum::kFull;

constexpr int kEmpty = -1;
constexpr unsigned kKnuth = 2654435769u;

struct HashMerge {
  static constexpr int kMinBlocksPerSM = 1;
  int* keys;     // [T]
  float* vals;   // [T]
  int table;     // T, a power of two

  __device__ HashMerge(unsigned char* base, const Params& p) : table(p.row_cap) {
    keys = reinterpret_cast<int*>(base);
    vals = reinterpret_cast<float*>(keys + p.row_cap);
  }

  __device__ void clear(int lane) {
    for (int t = lane; t < table; t += kWarp) {
      keys[t] = kEmpty;
      vals[t] = 0.f;
    }
    __syncwarp();
  }

  // Insert-or-accumulate; the probe visits each slot at most once
  // (probe_step_bound(T) == T steps). Returns false when the table is full.
  __device__ bool insert(int col, float val) {
    const unsigned mask = (unsigned)table - 1u;
    unsigned slot = ((unsigned)col * kKnuth) & mask;
    for (int step = 0; step < table; ++step) {
      int k = atomicCAS(&keys[slot], kEmpty, col);
      if (k == kEmpty || k == col) {
        atomicAdd(&vals[slot], val);
        return true;
      }
      slot = (slot + 1u) & mask;
    }
    return false;
  }

  __device__ void load(const Params& p, const int* cols, const float* v,
                       int n, int lane) {
    bool ok = true;
    for (int t = lane; t < n; t += kWarp) ok &= insert(cols[t], v[t]);
    if (!__all_sync(kFull, ok) && lane == 0) csr_accum::flag_overflow(p);
    __syncwarp();
  }

  __device__ void merge(const Params& p, const int* a_ix, const float* a_d,
                        int a_start, int a_end, const int* b_ip,
                        const int* b_ix, const float* b_d, int r0, int r1,
                        int lane) {
    bool ok = true;
    csr_accum::for_each_product(
        p, a_ix, a_d, a_start, a_end, b_ip, b_ix, b_d, r0, r1, lane,
        [&](int, int col, float val) { ok &= insert(col, val); });
    if (!__all_sync(kFull, ok) && lane == 0) csr_accum::flag_overflow(p);
    __syncwarp();
  }

  __device__ int store(const Params&, int* cols, float* out_vals, int lane) {
    unsigned* ukeys = reinterpret_cast<unsigned*>(keys);  // EMPTY -> UINT_MAX
    float* v = vals;
    csr_accum::warp_bitonic(ukeys, table, lane, [v](int t, int u) {
      float x = v[t];
      v[t] = v[u];
      v[u] = x;
    });
    int count = 0;
    for (int base = 0; base < table; base += kWarp) {
      int t = base + lane;
      bool used = t < table && keys[t] != kEmpty;
      count += __popc(__ballot_sync(kFull, used));
      if (used) {
        cols[t] = keys[t];
        out_vals[t] = vals[t];
      }
    }
    return count;
  }
};

}  // namespace

CSR_ACCUM_ENTRY(hash_accum_launch, HashMerge)
