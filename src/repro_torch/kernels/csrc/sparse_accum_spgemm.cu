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
// row-wise one; a warp's row is a chain of dependent loads, so the kernel
// needs many warps an SM (32: at most 64 registers a thread) and few
// instructions between the loads: the sort and compress run in registers
// wherever the row allows. Per merge step (one row, one chunk):
//   expand:   the row's in-range products, load-balanced: the warp scans
//             the product counts of 32 A entries at a time, and lane l takes
//             products l, l + 32, ... of the batch, finding its A entry by a
//             binary search of that scan, so neighbouring lanes read
//             neighbouring entries of one B row. A product's position is its
//             index in the reference's order (A entries in order, each one's
//             B row in order); the accumulator's entries (C_prev, or the
//             row so far) follow the products. Values go to shared memory by
//             position.
//   sort:     keys (column << pos_bits) | position, pos_bits = bits(work_cap
//             - 1), unique, so the sort is stable by column. The step's key
//             count n and largest column pick the class (the wrapper's
//             sort_class): n <= 32, 64 or 128 keys whose columns fit a 32-bit
//             key beside the position (the wrapper's key_bits) sort in
//             registers, 1, 2 or 4 a lane, by a bitonic network over index
//             lane * K + r: stages whose stride is below K compare-swap
//             inside a lane, wider ones exchange with lane ^ (stride / K) by
//             __shfl_xor_sync. Wider columns ("wide") and more keys
//             ("shared") take 64-bit keys (column << 32 | position) in shared
//             memory, sorted there (warp_bitonic). A class of 8 keys a lane
//             would cost the kernel more registers than its 64 (spills).
//   compress: one lane per run of equal columns sums its values in sorted
//             order from 0.0f — the reference's summation order, so a key
//             whose products sum to zero stays an entry, as in the
//             reference. After the register sort the runs are read from the
//             registers (compress_regs), otherwise from shared memory.
// The workspace per warp is work_cap = next_pow2(a_max_row_nnz *
// b_max_row_nnz + row_cap) 64-bit keys and f32 values; the wrapper refuses
// shapes whose workspace does not fit shared memory.

#include "csr_accum.cuh"

namespace {

using csr_accum::Params;
using csr_accum::kWarp;
using csr_accum::kFull;

// One batch of up to 32 of the row's A entries, one a lane, with the warp's
// exclusive scan of their in-range product counts.
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
  const int incl = csr_accum::warp_incl_scan(cnt, lane);
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

struct EscMerge {
  static constexpr int kMinBlocksPerSM = 4;   // 32 warps an SM: at most 64 registers
  // the warp's workspace: keys, then the rest at offsets from the caps
  // (kept out of registers)
  unsigned long long* keys;  // [work_cap] 64-bit keys
  int acc_n;

  __device__ EscMerge(unsigned char* base, const Params&)
      : keys(reinterpret_cast<unsigned long long*>(base)), acc_n(0) {}

  // [work_cap] values by position
  __device__ float* wvals(const Params& p) const {
    return reinterpret_cast<float*>(keys + p.work_cap);
  }
  // [row_cap] the compressed, column-sorted row
  __device__ int* acc_cols(const Params& p) const {
    return reinterpret_cast<int*>(wvals(p) + p.work_cap);
  }
  __device__ float* acc_vals(const Params& p) const {
    return reinterpret_cast<float*>(acc_cols(p) + p.row_cap);
  }
  // bits(work_cap - 1)
  __device__ static int pos_bits(const Params& p) {
    return p.work_cap > 1 ? 32 - __clz(p.work_cap - 1) : 0;
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
      acc_cols(p)[t] = cols[t];
      acc_vals(p)[t] = vals[t];
    }
    acc_n = n;
    __syncwarp();
  }

  __device__ void merge(const Params& p, const int* a_ix, const float* a_d,
                        int a_start, int a_end, const int* b_ip,
                        const int* b_ix, const float* b_d, int r0, int r1,
                        int lane) {
    const Batch first = load_batch(p, a_ix, a_d, a_start + lane, a_end, b_ip, r0, r1, lane);
    int n_prod = first.total;
    for (int base = a_start + kWarp; base < a_end; base += kWarp)
      n_prod += load_batch(p, a_ix, a_d, base + lane, a_end, b_ip, r0, r1, lane).total;
    const int n = n_prod + acc_n;   // warp-uniform
    if (n > p.work_cap) {           // the caps are wrong: keep the row, report
      if (lane == 0) csr_accum::flag_overflow(p);
      return;
    }
    const Step s{&p, a_ix, a_d, a_start, a_end, b_ip, b_ix, b_d, r0, r1, lane, n_prod, n};
    if (n == 0) return;
    if (n <= 32) sort_in_registers<1>(s, first);
    else if (n <= 64) sort_in_registers<2>(s, first);
    else if (n <= 128) sort_in_registers<4>(s, first);
    else sort_in_shared(s, first);
  }

  __device__ int store(const Params& p, int* cols, float* vals, int lane) {
    for (int t = lane; t < acc_n; t += kWarp) {
      cols[t] = acc_cols(p)[t];
      vals[t] = acc_vals(p)[t];
    }
    return acc_n;
  }

 private:
  // the operands of one merge step
  struct Step {
    const Params* p;
    const int* a_ix;
    const float* a_d;
    int a_start, a_end;
    const int* b_ip;
    const int* b_ix;
    const float* b_d;
    int r0, r1, lane, n_prod, n;
  };

  __device__ Batch batch_at(const Step& s, const Batch& first, int base) const {
    return base == s.a_start ? first
                             : load_batch(*s.p, s.a_ix, s.a_d, base + s.lane, s.a_end,
                                          s.b_ip, s.r0, s.r1, s.lane);
  }

  template <int K>
  __device__ void sort_in_registers(const Step& s, const Batch& first) {
    const int lane = s.lane;
    unsigned cols[K];   // column of position r * 32 + lane (n and past: unused)
    unsigned top = 0;   // the lane's largest column
    int off = 0;        // products of the batches before this one
    for (int base = s.a_start; base < s.a_end; base += kWarp) {
      const Batch bt = batch_at(s, first, base);
      int src[K];
      float a[K];
#pragma unroll
      for (int r = 0; r < K; ++r) {
        src[r] = -1;
        if (r * kWarp < off + bt.total && (r + 1) * kWarp > off)   // warp-uniform
          locate(*s.p, bt, r * kWarp + lane - off, src[r], a[r]);
      }
#pragma unroll
      for (int r = 0; r < K; ++r) {
        if (src[r] >= 0) {
          cols[r] = (unsigned)s.b_ix[src[r]];
          wvals(*s.p)[r * kWarp + lane] = a[r] * s.b_d[src[r]];
          top = max(top, cols[r]);
        }
      }
      off += bt.total;
    }
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int pos = r * kWarp + lane;
      if (pos >= s.n_prod && pos < s.n) {
        cols[r] = (unsigned)acc_cols(*s.p)[pos - s.n_prod];
        wvals(*s.p)[pos] = acc_vals(*s.p)[pos - s.n_prod];
        top = max(top, cols[r]);
      }
    }
    top = __reduce_max_sync(kFull, top);
    __syncwarp();   // values by position written, the accumulator read
    if ((unsigned long long)top < (1ull << (32 - pos_bits(*s.p))))
      sort_keys<K>(s, cols);
    else
      sort_wide<K>(s, cols);
  }

  template <int K>
  __device__ void sort_keys(const Step& s, const unsigned (&cols)[K]) {
    const int lane = s.lane;
    unsigned key[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int pos = r * kWarp + lane;
      key[r] = pos < s.n ? (cols[r] << pos_bits(*s.p)) | (unsigned)pos : ~0u;
    }
    bitonic_regs<K>(key, lane);
    compress_regs<K>(*s.p, key, s.n, pos_bits(*s.p), lane);
  }

  // Columns too wide for a 32-bit key beside the position: 64-bit keys,
  // from the registers to shared memory, sorted there (a rare case: it
  // keeps 64-bit keys, and their registers, out of the register sort).
  template <int K>
  __device__ void sort_wide(const Step& s, const unsigned (&cols)[K]) {
    unsigned long long* k = keys;
    const int n2 = csr_accum::next_pow2(s.n);   // <= 32 K
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int pos = r * kWarp + s.lane;
      if (pos < n2)
        k[pos] = pos < s.n ? ((unsigned long long)cols[r] << 32) | (unsigned)pos : ~0ull;
    }
    __syncwarp();
    csr_accum::warp_bitonic(k, n2, s.lane, [](int, int) {});
    compress(*s.p, k, s.n, 32, s.lane);
  }

  // The compress straight from the sorted registers: key r of a lane is
  // sorted index lane * K + r. A run's head starts its segment (the warp's
  // scan of head counts numbers them); its values are summed in order from
  // 0.0f. A run that starts in an earlier lane takes that lane's running sum
  // as its start: lanes pass their trailing sums up the warp until every
  // lane that continues a run has its carry (a run spanning m lanes takes m
  // exchanges). The lane where a run ends writes it.
  template <int K>
  __device__ void compress_regs(const Params& p, const unsigned (&key)[K], int n, int shift,
                                int lane) {
    const unsigned pos_mask = (1u << shift) - 1;
    const int live = min(max(n - lane * K, 0), K);   // this lane's keys below n
    float v[K];
#pragma unroll
    for (int r = 0; r < K; ++r) v[r] = r < live ? wvals(p)[(int)(key[r] & pos_mask)] : 0.f;
    // bit r: key r starts a run
    const unsigned prev = __shfl_up_sync(kFull, key[K - 1] >> shift, 1);
    unsigned hm = live > 0 && (lane == 0 || prev != key[0] >> shift);
#pragma unroll
    for (int r = 1; r < K; ++r)
      hm |= (unsigned)(r < live && key[r] >> shift != key[r - 1] >> shift) << r;
    const int heads = __popc(hm);
    const int incl = csr_accum::warp_incl_scan(heads, lane);
    const int out_n = __shfl_sync(kFull, incl, kWarp - 1);
    const bool next_starts =
        __shfl_down_sync(kFull, (hm & 1u) || live == 0, 1) || lane == kWarp - 1;
    // the lane's trailing run from its last head (ready now), or, with no
    // head, the carry plus all its values (ready once the carry comes)
    float trail = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r)
      if (r < live) trail = ((hm >> r) & 1u ? 0.f : trail) + v[r];
    int trail_seg = incl - 1;
    bool ready = heads > 0 || live == 0;
    bool need = live > 0 && !(hm & 1u);
    const int lead_keys = hm ? __ffs(hm) - 1 : live;   // keys of the carried run
    float lead = 0.f;      // the carried run's sum through this lane's keys
    int lead_seg = 0;
    while (__any_sync(kFull, need)) {
      const float c = __shfl_up_sync(kFull, trail, 1);
      const int cs = __shfl_up_sync(kFull, trail_seg, 1);
      const bool cr = __shfl_up_sync(kFull, ready, 1);
      if (need && cr) {
        lead = c;
#pragma unroll
        for (int r = 0; r < K; ++r)
          if (r < lead_keys) lead += v[r];
        lead_seg = cs;
        need = false;
        if (heads == 0) {
          trail = lead;
          trail_seg = cs;
          ready = true;
        }
      }
    }
    // write each run that ends in this lane
    bool over = false;
    float sum = lead;
    int seg = lead_seg, next_seg = incl - heads;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if ((hm >> r) & 1u) {
        sum = 0.f;
        seg = next_seg++;
      }
      if (r >= lead_keys) sum += v[r];   // the carried run's keys are in lead
      const bool ends = r < live && (r + 1 < K ? r + 1 == live || (hm >> (r + 1)) & 1u
                                               : next_starts);
      if (ends) {
        if (seg < p.row_cap) {
          acc_cols(p)[seg] = (int)(key[r] >> shift);
          acc_vals(p)[seg] = sum;
        } else {
          over = true;
        }
      }
    }
    if (__any_sync(kFull, over) && lane == 0) csr_accum::flag_overflow(p);
    acc_n = min(out_n, p.row_cap);
    __syncwarp();
  }

  __device__ void sort_in_shared(const Step& s, const Batch& first) {
    const int lane = s.lane;
    unsigned long long* k = keys;
    int off = 0;
    for (int base = s.a_start; base < s.a_end; base += kWarp) {
      const Batch bt = batch_at(s, first, base);
      for (int q0 = 0; q0 < bt.total; q0 += kWarp) {
        int src;
        float a;
        locate(*s.p, bt, q0 + lane, src, a);
        if (src >= 0) {
          const int pos = off + q0 + lane;
          k[pos] = ((unsigned long long)(unsigned)s.b_ix[src] << 32) | (unsigned)pos;
          wvals(*s.p)[pos] = a * s.b_d[src];
        }
      }
      off += bt.total;
    }
    for (int t = lane; t < acc_n; t += kWarp) {
      const int pos = s.n_prod + t;
      k[pos] = ((unsigned long long)(unsigned)acc_cols(*s.p)[t] << 32) | (unsigned)pos;
      wvals(*s.p)[pos] = acc_vals(*s.p)[t];
    }
    const int n2 = csr_accum::next_pow2(s.n);
    for (int t = s.n + lane; t < n2; t += kWarp) k[t] = ~0ull;
    __syncwarp();
    csr_accum::warp_bitonic(k, n2, lane, [](int, int) {});
    compress(*s.p, k, s.n, 32, lane);
  }

  // one lane per run of equal columns sums it in sorted order from 0.0f
  template <class Key>
  __device__ void compress(const Params& p, const Key* k, int n, int shift, int lane) {
    const Key pos_mask = ((Key)1 << shift) - 1;
    int out_n = 0;
    bool out_over = false;
    for (int base = 0; base < n; base += kWarp) {
      const int t = base + lane;
      bool head = false;
      Key col = 0;
      if (t < n) {
        col = k[t] >> shift;
        head = t == 0 || (k[t - 1] >> shift) != col;
      }
      const unsigned heads = __ballot_sync(kFull, head);
      if (head) {
        const int seg = out_n + __popc(heads & csr_accum::lanemask_lt(lane));
        float sum = 0.f;
        for (int u = t; u < n; ++u) {
          const Key ku = k[u];
          if ((ku >> shift) != col) break;
          sum += wvals(p)[(int)(ku & pos_mask)];
        }
        if (seg < p.row_cap) {
          acc_cols(p)[seg] = (int)col;
          acc_vals(p)[seg] = sum;
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
};

}  // namespace

CSR_ACCUM_ENTRY(sparse_accum_launch, EscMerge)
