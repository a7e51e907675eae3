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
// its table of T int32 keys (EMPTY = -1) and f32 values in shared memory.
// A row is a chain of dependent loads (A row, B row pointers, B entries),
// so the merge needs many warps an SM and few instructions between the
// loads: the kernel is built for the largest extraction class its table
// can hold (HashMerge<kMaxK>, chosen by T at launch), so a table of at most
// 32 slots, the main path's, carries no code for wider classes and runs at
// 32 registers, 64 warps an SM (40 registers at 64 slots, 64 above).
// Per merge step (one row, one chunk):
//   expand:  the load-balanced expand of csr_accum.cuh (load_batch /
//            locate): lane l takes products l, l + 32, ... of a batch of 32
//            A entries, so neighbouring lanes read neighbouring entries of
//            one B row;
//   insert:  the probe reads a slot first: a slot holding the key takes an
//            atomicAdd, only an empty slot an atomicCAS (a slot's key goes
//            from EMPTY to a column once and never changes again, so a
//            non-empty read is final); the summation order changes from
//            run to run (the structure does not). A probe starts at the top
//            log2(T) bits of h = (uint32)col * 2654435769u, Knuth's
//            multiplicative hash, and visits each slot at most once. The
//            reference starts at h & (T - 1): those low bits are col's low
//            bits times an odd constant, so columns a multiple of T apart
//            share a start (a 3-D stencil's planes: 576 = 18 x 32 at brick3d
//            n=48, three of a row's 27 columns on every start slot). The
//            output is sorted by column, so it does not depend on where a
//            key sits.
// In the chunk1 order the table stays resident across all chunks of the
// row instead of being rebuilt from C_prev at every chunk as the reference
// does; the set of keys and the sums are the same. In the chunk2 order each
// launch rebuilds the table from the row's slab.
//
// Extraction sorts the row's n occupied slots by column (the keys are
// distinct columns, so the order is unambiguous) and writes them, the
// column-sorted row of the ESC merge. The class follows n, uniform across
// the warp (the wrapper's extract_class): n <= 32, 64 or 128 sort in
// registers, 1, 2 or 4 keys a lane with the value carried beside each key
// (bitonic_regs_kv); a table wider than the class is first compacted in
// place to its occupied slots. More keys compact and sort in shared memory
// (warp_bitonic over next_pow2(n) slots).

#include "csr_accum.cuh"

namespace {

using csr_accum::Batch;
using csr_accum::Params;
using csr_accum::kFull;
using csr_accum::kWarp;
using csr_accum::load_batch;
using csr_accum::locate;

constexpr int kEmpty = -1;
constexpr unsigned kKnuth = 2654435769u;

// kMaxK: the largest register class the table holds (1, 2 or 4 keys a lane:
// T <= 32, 64, 128), or 0 for a wider table, which also sorts in shared
// memory; the blocks an SM it asks for cap its registers at 32, 40 or 64.
template <int kMaxK>
struct HashMerge {
  static constexpr int kMinBlocksPerSM = kMaxK == 1 ? 8 : kMaxK == 2 ? 6 : 4;
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

  // Insert-or-accumulate, reading each slot before any atomic; the probe
  // visits each slot at most once (probe_step_bound(T) == T steps).
  // Returns false when the table is full.
  __device__ bool insert(int col, float val) {
    const volatile int* seen = keys;
    const unsigned mask = (unsigned)table - 1u;
    unsigned slot = __umulhi((unsigned)col * kKnuth, (unsigned)table);   // top log2(T) bits
    for (int step = 0; step < table; ++step) {
      int k = seen[slot];
      if (k == kEmpty) k = atomicCAS(&keys[slot], kEmpty, col);
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
    for (int base = a_start; base < a_end; base += kWarp) {
      const Batch bt = load_batch(p, a_ix, a_d, base + lane, a_end, b_ip, r0, r1, lane);
      for (int q0 = 0; q0 < bt.total; q0 += kWarp) {
        int src;
        float a;
        locate(p, bt, q0 + lane, src, a);
        if (src >= 0) ok &= insert(b_ix[src], a * b_d[src]);
      }
    }
    if (!__all_sync(kFull, ok) && lane == 0) csr_accum::flag_overflow(p);
    __syncwarp();
  }

  __device__ int store(const Params&, int* cols, float* out_vals, int lane) {
    int n = 0;   // occupied slots, warp-uniform
    for (int base = 0; base < table; base += kWarp) {
      const int t = base + lane;
      n += __popc(__ballot_sync(kFull, t < table && keys[t] != kEmpty));
    }
    if (n == 0) return 0;
    if (n <= kWarp) {
      store_regs<1>(cols, out_vals, n, lane);
    } else if constexpr (kMaxK != 1) {
      if (n <= 2 * kWarp) {
        store_regs<2>(cols, out_vals, n, lane);
      } else if constexpr (kMaxK != 2) {
        if (n <= 4 * kWarp) store_regs<4>(cols, out_vals, n, lane);
        else if constexpr (kMaxK == 0) store_shared(cols, out_vals, n, lane);
      }
    }
    return n;
  }

 private:
  // Move the occupied slots, in slot order, to [0, n): a round reads its 32
  // slots before any lane writes, and every write lands at or below the
  // slot it came from, so no unread slot is overwritten.
  __device__ void compact(int lane) {
    int base = 0;
    for (int b0 = 0; b0 < table; b0 += kWarp) {
      const int t = b0 + lane;
      const int k = t < table ? keys[t] : kEmpty;
      const float v = t < table ? vals[t] : 0.f;
      const unsigned used = __ballot_sync(kFull, k != kEmpty);
      __syncwarp();
      if (k != kEmpty) {
        const int c = base + __popc(used & csr_accum::lanemask_lt(lane));
        keys[c] = k;
        vals[c] = v;
      }
      __syncwarp();
      base += __popc(used);
    }
  }

  // n <= 32 K keys: the table (or its compacted slots) into K registers a
  // lane, EMPTY (UINT_MAX) past them, sorted with the values beside them;
  // sorted index lane * K + r below n is output entry lane * K + r.
  template <int K>
  __device__ void store_regs(int* cols, float* out_vals, int n, int lane) {
    int live = table;
    if (table > K * kWarp) {
      compact(lane);
      live = n;
    }
    unsigned key[K];
    float val[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int t = r * kWarp + lane;
      key[r] = t < live ? (unsigned)keys[t] : ~0u;
      val[r] = t < live ? vals[t] : 0.f;
    }
    csr_accum::bitonic_regs_kv<K>(key, val, lane);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int i = lane * K + r;
      if (i < n) {
        cols[i] = (int)key[r];
        out_vals[i] = val[r];
      }
    }
  }

  // n > 128 keys: compact, pad to a power of two with EMPTY, sort in shared
  // memory, write the first n.
  __device__ void store_shared(int* cols, float* out_vals, int n, int lane) {
    compact(lane);
    const int n2 = csr_accum::next_pow2(n);   // <= T
    for (int t = n + lane; t < n2; t += kWarp) {
      keys[t] = kEmpty;
      vals[t] = 0.f;
    }
    __syncwarp();
    unsigned* ukeys = reinterpret_cast<unsigned*>(keys);  // EMPTY -> UINT_MAX
    float* v = vals;
    csr_accum::warp_bitonic(ukeys, n2, lane, [v](int t, int u) {
      float x = v[t];
      v[t] = v[u];
      v[u] = x;
    });
    for (int t = lane; t < n; t += kWarp) {
      cols[t] = keys[t];
      out_vals[t] = vals[t];
    }
  }
};

// The kernel for the table: T = row_cap slots hold at most T keys.
int launch_hash(const Params& p, int warps_per_block, int order, cudaStream_t stream) {
  if (p.row_cap <= kWarp)
    return csr_accum::launch<HashMerge<1>>(p, warps_per_block, order, stream);
  if (p.row_cap <= 2 * kWarp)
    return csr_accum::launch<HashMerge<2>>(p, warps_per_block, order, stream);
  if (p.row_cap <= 4 * kWarp)
    return csr_accum::launch<HashMerge<4>>(p, warps_per_block, order, stream);
  return csr_accum::launch<HashMerge<0>>(p, warps_per_block, order, stream);
}

}  // namespace

CSR_ACCUM_ENTRY_FN(hash_accum_launch, launch_hash)
