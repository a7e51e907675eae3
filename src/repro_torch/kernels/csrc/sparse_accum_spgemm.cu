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
// The workspace per warp is work_cap 64-bit keys and f32 values:
// next_pow2(a_max_row_nnz * b_max_row_nnz + row_cap) where that fits shared
// memory (every step then takes this, the shared route), else the next
// power of two of the largest step that fits (the wrapper's
// esc_launch_plan, from each step's exact key count).
//
// The global route takes the steps whose keys do not fit a block's shared
// memory (rows of thousands of products: L x L of an RMAT graph). One block
// of kGlobalThreads threads merges one (row, chunk) step in a workspace in
// global memory, its slots placed by the wrapper (an exclusive scan of the
// global steps' sort slots, next_pow2 of each step's keys):
//   expand:   the block scans the product counts of
//             kGlobalThreads A entries at a time in shared memory and each
//             thread takes products t, t + kGlobalThreads, ... of the tile,
//             finding its A entry by a binary search of the scan; keys
//             (column << 32) | position, values by position, the
//             accumulator's entries (C_prev at the first chunk, else the
//             row's slab) after the products;
//   sort:     a bitonic network over the step's next_pow2(n) slots in
//             global memory, one __syncthreads a stage (the slots stay in
//             the 50 MB L2 at the sizes it takes);
//   compress: the block scans the run heads tile by tile; a head's thread
//             sums its run in sorted order from 0.0f (the shared route's,
//             and the reference's, summation order) and writes the row's
//             slab.
// A call with global steps launches chunk by chunk: the shared merge over
// the rows whose step fits (Params::skip marks the others), then the
// global merge over that chunk's global steps; a row's accumulator passes
// between them, and between chunks, in its slab.

#include "csr_accum.cuh"

namespace {

using csr_accum::Batch;
using csr_accum::Params;
using csr_accum::bitonic_regs;
using csr_accum::kFull;
using csr_accum::kWarp;
using csr_accum::load_batch;
using csr_accum::locate;

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

// -- the global route ------------------------------------------------------

constexpr int kGlobalThreads = 512;
constexpr int kGlobalWarps = kGlobalThreads / kWarp;

struct GlobalSteps {
  const int* rows;              // [items] the step's global row, chunk-major
  const long long* offsets;     // [items + 1] the step's sort slots in the workspace
  unsigned long long* keys;     // workspace keys
  float* vals;                  // workspace values, by position
};

// Exclusive scan of v over the block (x) and the block's sum (y). Every
// thread calls it; it ends with a barrier, so scratch may be reused.
__device__ __forceinline__ int2 block_excl_scan(int v, int* scratch) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int incl = csr_accum::warp_incl_scan(v, lane);
  if (lane == kWarp - 1) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kGlobalWarps ? scratch[lane] : 0;
    const int w_incl = csr_accum::warp_incl_scan(w, lane);
    if (lane < kGlobalWarps) scratch[lane] = w_incl - w;
    if (lane == kGlobalWarps - 1) scratch[kWarp] = w_incl;
  }
  __syncthreads();
  const int2 out = make_int2(scratch[warp] + incl - v, scratch[kWarp]);
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kGlobalThreads)
    esc_global_kernel(Params p, GlobalSteps w, int item0, int j) {
  __shared__ int s_excl[kGlobalThreads];
  __shared__ int s_start[kGlobalThreads];
  __shared__ float s_aval[kGlobalThreads];
  __shared__ int s_scan[kWarp + 1];
  const int tid = threadIdx.x;
  const int item = item0 + blockIdx.x;
  const int g = w.rows[item];
  const long long base = w.offsets[item];
  const long long cap = w.offsets[item + 1] - base;   // a power of two
  unsigned long long* keys = w.keys + base;
  float* vals = w.vals + base;
  const int strip = g / p.strip_rows;
  const int r = g - strip * p.strip_rows;
  const int b = strip / p.n_ac;
  int* out_c = p.slab_cols + (long long)g * p.row_cap;
  float* out_v = p.slab_vals + (long long)g * p.row_cap;

  // the accumulator: C_prev's row at the first chunk, else the row's slab
  const int* acc_c;
  const float* acc_v;
  int acc_n;
  if (j == 0) {
    const int* ip = p.c0_ip + (long long)strip * (p.strip_rows + 1);
    const int s = min(ip[r], p.c_cap), e = min(ip[r + 1], p.c_cap);
    acc_c = p.c0_ix + (long long)strip * p.c_cap + s;
    acc_v = p.c0_d + (long long)strip * p.c_cap + s;
    acc_n = max(e - s, 0);
  } else {
    acc_c = out_c;
    acc_v = out_v;
    acc_n = p.slab_cnt[g];
  }
  if (acc_n > p.row_cap) {
    if (tid == 0) csr_accum::flag_overflow(p);
    acc_n = p.row_cap;
  }

  // expand the row's in-range products of chunk j, in the reference's order
  const int* a_ip = p.a_ip + (long long)strip * (p.strip_rows + 1);
  const int* a_ix = p.a_ix + (long long)strip * p.a_cap;
  const float* a_d = p.a_d + (long long)strip * p.a_cap;
  const int a_start = min(a_ip[r], p.a_cap), a_end = min(a_ip[r + 1], p.a_cap);
  const long long chunk = (long long)b * p.n_b + j;
  const int* b_ip = p.b_ip + chunk * (p.chunk_rows + 1);
  const int* b_ix = p.b_ix + chunk * p.chunk_cap;
  const float* b_d = p.b_d + chunk * p.chunk_cap;
  const int r0 = p.r0s[j], r1 = p.r1s[j];
  int n_prod = 0;   // <= the step's keys (the wrapper holds them to 2^30)
  for (int tile = a_start; tile < a_end; tile += kGlobalThreads) {
    const int e = tile + tid;
    int cnt = 0, start = 0;
    float a = 0.f;
    if (e < a_end) {
      const int col = a_ix[e];
      if (col >= r0 && col < r1) {
        const int b_row = min(max(col - r0, 0), p.chunk_rows - 1);
        start = b_ip[b_row];
        cnt = max(min(b_ip[b_row + 1] - start, p.b_mrn), 0);
        a = a_d[e];
      }
    }
    const int2 scan = block_excl_scan(cnt, s_scan);
    const int total = scan.y;
    s_excl[tid] = scan.x;
    s_start[tid] = start;
    s_aval[tid] = a;
    __syncthreads();
    for (int q = tid; q < total; q += kGlobalThreads) {
      // the entry of product q: the last whose exclusive scan is <= q
      int lo = 0;
      for (int s = kGlobalThreads / 2; s > 0; s >>= 1)
        if (s_excl[lo + s] <= q) lo += s;
      const long long pos = n_prod + q;
      if (pos < cap) {
        const int src = min(s_start[lo] + q - s_excl[lo], p.chunk_cap - 1);
        keys[pos] = ((unsigned long long)(unsigned)b_ix[src] << 32) | (unsigned long long)pos;
        vals[pos] = s_aval[lo] * b_d[src];
      }
    }
    n_prod += total;
    __syncthreads();
  }
  const long long n = n_prod + acc_n;
  if (n > cap) {   // the wrapper's count was wrong: report, leave the row empty
    if (tid == 0) {
      csr_accum::flag_overflow(p);
      p.slab_cnt[g] = 0;
    }
    return;
  }
  for (int t = tid; t < acc_n; t += kGlobalThreads) {
    const long long pos = n_prod + t;
    keys[pos] = ((unsigned long long)(unsigned)acc_c[t] << 32) | (unsigned long long)pos;
    vals[pos] = acc_v[t];
  }
  const int n2 = csr_accum::next_pow2((int)n);   // <= cap
  for (int t = (int)n + tid; t < n2; t += kGlobalThreads) keys[t] = ~0ull;
  __syncthreads();

  // bitonic sort of the n2 slots, pair i of a stage at (t, t | jj)
  for (int k = 2; k <= n2; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int i = tid; i < n2 / 2; i += kGlobalThreads) {
        const int t = ((i & ~(jj - 1)) << 1) | (i & (jj - 1));
        const int u = t | jj;
        const bool ascending = (t & k) == 0;
        const unsigned long long x = keys[t], y = keys[u];
        if ((x > y) == ascending) {
          keys[t] = y;
          keys[u] = x;
        }
      }
      __syncthreads();
    }
  }

  // compress: one thread per run of equal columns, in sorted order from 0.0f
  int out_n = 0;
  bool over = false;
  for (int tile = 0; tile < n; tile += kGlobalThreads) {
    const int t = tile + tid;
    bool head = false;
    unsigned col = 0;
    if (t < n) {
      col = (unsigned)(keys[t] >> 32);
      head = t == 0 || (unsigned)(keys[t - 1] >> 32) != col;
    }
    const int2 scan = block_excl_scan(head ? 1 : 0, s_scan);
    const int seg = out_n + scan.x;
    if (head) {
      float sum = 0.f;
      for (int u = t; u < n; ++u) {
        const unsigned long long ku = keys[u];
        if ((unsigned)(ku >> 32) != col) break;
        sum += vals[(unsigned)ku];
      }
      if (seg < p.row_cap) {
        out_c[seg] = (int)col;
        out_v[seg] = sum;
      } else {
        over = true;
      }
    }
    out_n += scan.y;
  }
  if (over) csr_accum::flag_overflow(p);
  if (tid == 0) p.slab_cnt[g] = min(out_n, p.row_cap);
}

// A call without global steps (host_plan null) is the skeleton's launch.
// Otherwise chunk by chunk: the shared merge where the chunk has shared
// steps, then the global merge over its global steps. host_plan is a host
// array: the chunks' first items (n_b + 1), then whether each chunk has
// shared steps (n_b).
int esc_launch(Params p, int warps_per_block, int order, const GlobalSteps& w,
               const int* host_plan, cudaStream_t stream) {
  if (host_plan == nullptr) {
    p.skip = nullptr;
    return csr_accum::launch<EscMerge>(p, warps_per_block, order, stream);
  }
  const long long rows = (long long)p.batch * p.n_ac * p.strip_rows;
  if (rows >= (1ll << 31) || rows == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps_per_block * p.smem_per_warp;
  if (int err = csr_accum::allow_smem<EscMerge>(smem)) return err;
  const unsigned blocks = (unsigned)((rows + warps_per_block - 1) / warps_per_block);
  for (int j = 0; j < p.n_b; ++j) {
    if (host_plan[p.n_b + 1 + j])
      csr_accum::accum_rows_kernel<EscMerge>
          <<<blocks, warps_per_block * kWarp, smem, stream>>>(p, j, j + 1);
    const int items = host_plan[j + 1] - host_plan[j];
    if (items > 0)
      esc_global_kernel<<<items, kGlobalThreads, 0, stream>>>(p, w, host_plan[j], j);
  }
  csr_accum::finish(p, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// The skeleton's entry (CSR_ACCUM_ENTRY_FN) with the global route's
// operands after the common pointers: skip [n_b, rows], the global steps'
// rows and offsets, the workspace's keys and values, and host_plan (a host
// array, see esc_launch); all null for a call without global steps.
extern "C" int sparse_accum_launch(
    const int* a_ip, const int* a_ix, const float* a_d, const int* b_ip, const int* b_ix,
    const float* b_d, const int* c0_ip, const int* c0_ix, const float* c0_d, const int* r0s,
    const int* r1s, int* slab_cols, float* slab_vals, int* slab_cnt, int* out_ip,
    int* out_ix, float* out_d, int* overflow, const unsigned char* skip,
    const int* g_rows, const long long* g_offsets, unsigned long long* ws_keys,
    float* ws_vals, const int* host_plan, int batch, int n_ac, int n_b, int strip_rows,
    int chunk_rows, int a_cap, int chunk_cap, int c_cap, int a_mrn, int b_mrn, int row_cap,
    int work_cap, int smem_per_warp, int warps_per_block, int order, void* stream) {
  csr_accum::Params p{a_ip,      a_ix,      a_d,      b_ip,       b_ix,       b_d,
                      c0_ip,     c0_ix,     c0_d,     r0s,        r1s,        slab_cols,
                      slab_vals, slab_cnt,  out_ip,   out_ix,     out_d,      overflow,
                      batch,     n_ac,      n_b,      strip_rows, chunk_rows, a_cap,
                      chunk_cap, c_cap,     a_mrn,    b_mrn,      row_cap,    work_cap,
                      smem_per_warp, skip};
  const GlobalSteps w{g_rows, g_offsets, ws_keys, ws_vals};
  return esc_launch(p, warps_per_block, order, w, host_plan, (cudaStream_t)stream);
}

extern "C" const char* sparse_accum_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
