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
// Where the launch-wide workspace, next_pow2(a_max_row_nnz * b_max_row_nnz
// + row_cap) keys and the row's accumulator, fits a block's shared memory,
// every step takes it (the shared route): one warp a row, the skeleton's
// launch.
//
// Otherwise the wrapper has counted every step's keys (esc_launch_plan) and
// the call is classed: each chunk launches, for each step class that has
// steps there, one kernel over that class's rows only (a compacted list,
// built on the card); an empty step launches nothing (slab_cnt is zeroed
// once, which is its result). Shared memory comes from the class's own keys
// W (a step's accumulator never holds more entries than its keys):
//   warp classes (esc_warp_kernel): a warp a step, EscMerge at work_cap W
//             with min(row_cap, W) accumulator slots, so up to 8 warps a
//             block and several blocks an SM (the register sorts: a warp's
//             shared-memory sort of a few hundred keys takes several times a
//             block's, so the larger steps take block classes);
//   block classes (esc_block_kernel): a block a step: the expand over tiles
//             of blockDim A entries (a block scan of their product counts,
//             a binary search of it per product), the accumulator read
//             from C_prev or the slab straight into the sort slots, a
//             bitonic sort of next_pow2(n) keys in shared memory by every
//             thread (a barrier a sub-stage), and the compress: the block
//             scans the run heads, a head's thread sums its run in sorted
//             order from 0.0f and writes the slab. Keys are (column <<
//             bits(W - 1)) | position in 32 bits where the call's columns
//             fit beside the position (the wrapper's key_bits, as the warp
//             classes pack them), which halves the sort's shared-memory
//             traffic, else (column << 32) | position;
//   global (esc_global_kernel): steps past the last class's keys, a block a
//             step, in a workspace in global memory placed by the wrapper
//             (an exclusive scan of the steps' next powers of two): the same
//             expand (32-bit keys where the columns fit beside the call's
//             largest global step's positions), then the bitonic sort in
//             tiles of the last class's size: each tile sorted in shared
//             memory, and for each wider
//             stage only the sub-stages of stride at least a tile as passes
//             over global memory, the rest on each tile in shared memory
//             (load, sub-stages, store); then the same compress.
// A row's accumulator passes between chunks in its slab.

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

// -- the classed launch -----------------------------------------------------

// most threads of a block-class or global block (a power of two; the
// wrapper's BLOCK_THREADS)
constexpr int kBlockThreads = 1024;

// One warp a step of a warp class: q is the call's Params with the class's
// work_cap, accumulator slots (row_cap) and smem_per_warp; the slabs keep the
// call's row_cap as their stride.
__global__ void __launch_bounds__(csr_accum::kMaxAccumThreads, EscMerge::kMinBlocksPerSM)
    esc_warp_kernel(Params q, const int* rows, int items, int j, int slab_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int item = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (item >= items) return;   // warp-uniform
  const int g = rows[item];
  const int strip = g / q.strip_rows;
  const int r = g - strip * q.strip_rows;
  const int b = strip / q.n_ac;
  int* slab_c = q.slab_cols + (long long)g * slab_stride;
  float* slab_v = q.slab_vals + (long long)g * slab_stride;
  EscMerge m(smem + (size_t)warp * q.smem_per_warp, q);
  m.clear(lane);
  if (j == 0) {
    const int* ip = q.c0_ip + (long long)strip * (q.strip_rows + 1);
    const int s = min(ip[r], q.c_cap), e = min(ip[r + 1], q.c_cap);
    m.load(q, q.c0_ix + (long long)strip * q.c_cap + s,
           q.c0_d + (long long)strip * q.c_cap + s, max(e - s, 0), lane);
  } else {
    m.load(q, slab_c, slab_v, q.slab_cnt[g], lane);
  }
  const int* a_ip = q.a_ip + (long long)strip * (q.strip_rows + 1);
  const int a_start = min(a_ip[r], q.a_cap), a_end = min(a_ip[r + 1], q.a_cap);
  const long long chunk = (long long)b * q.n_b + j;
  m.merge(q, q.a_ix + (long long)strip * q.a_cap, q.a_d + (long long)strip * q.a_cap,
          a_start, a_end, q.b_ip + chunk * (q.chunk_rows + 1), q.b_ix + chunk * q.chunk_cap,
          q.b_d + chunk * q.chunk_cap, q.r0s[j], q.r1s[j], lane);
  q.slab_cnt[g] = m.store(q, slab_c, slab_v, lane);
}

// The expand's scratch: a tile's product counts scanned, B row starts and A
// values (the block and global kernels' static shared memory).
struct ExpandScratch {
  int excl[kBlockThreads];
  int start[kBlockThreads];
  float aval[kBlockThreads];
  int scan[kWarp + 1];
};

// Exclusive scan of v over the block (x) and the block's sum (y). Every
// thread calls it; it ends with a barrier, so scratch may be reused.
__device__ __forceinline__ int2 block_excl_scan(int v, int* scratch) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int incl = csr_accum::warp_incl_scan(v, lane);
  if (lane == kWarp - 1) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < warps ? scratch[lane] : 0;
    const int w_incl = csr_accum::warp_incl_scan(w, lane);
    if (lane < warps) scratch[lane] = w_incl - w;
    if (lane == warps - 1) scratch[kWarp] = w_incl;
  }
  __syncthreads();
  const int2 out = make_int2(scratch[warp] + incl - v, scratch[kWarp]);
  __syncthreads();
  return out;
}

// One step's row: its place, its accumulator (C_prev's row at the first
// chunk, else the row's slab) and its slab.
struct StepRow {
  int g, strip, r, b;
  const int* acc_c;
  const float* acc_v;
  int acc_n;
  int* out_c;
  float* out_v;
};

__device__ StepRow step_row(const Params& p, int g, int j) {
  StepRow s;
  s.g = g;
  s.strip = g / p.strip_rows;
  s.r = g - s.strip * p.strip_rows;
  s.b = s.strip / p.n_ac;
  s.out_c = p.slab_cols + (long long)g * p.row_cap;
  s.out_v = p.slab_vals + (long long)g * p.row_cap;
  if (j == 0) {
    const int* ip = p.c0_ip + (long long)s.strip * (p.strip_rows + 1);
    const int st = min(ip[s.r], p.c_cap), e = min(ip[s.r + 1], p.c_cap);
    s.acc_c = p.c0_ix + (long long)s.strip * p.c_cap + st;
    s.acc_v = p.c0_d + (long long)s.strip * p.c_cap + st;
    s.acc_n = max(e - st, 0);
  } else {
    s.acc_c = s.out_c;
    s.acc_v = s.out_v;
    s.acc_n = p.slab_cnt[g];
  }
  if (s.acc_n > p.row_cap) {
    if (threadIdx.x == 0) csr_accum::flag_overflow(p);
    s.acc_n = p.row_cap;
  }
  return s;
}

// The step's in-range products of chunk j in the reference's order: keys
// (column << shift) | position (Key: 32 or 64 bits, as the wrapper's
// key_bits allows) and values by position, for the positions below cap
// (shared or global memory). Returns the product count (<= the step's
// keys, which the wrapper holds to 2^30).
template <class Key>
__device__ int block_expand(const Params& p, const StepRow& s, int j, Key* keys, float* vals,
                            int cap, int shift, ExpandScratch& x) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int* a_ip = p.a_ip + (long long)s.strip * (p.strip_rows + 1);
  const int* a_ix = p.a_ix + (long long)s.strip * p.a_cap;
  const float* a_d = p.a_d + (long long)s.strip * p.a_cap;
  const int a_start = min(a_ip[s.r], p.a_cap), a_end = min(a_ip[s.r + 1], p.a_cap);
  const long long chunk = (long long)s.b * p.n_b + j;
  const int* b_ip = p.b_ip + chunk * (p.chunk_rows + 1);
  const int* b_ix = p.b_ix + chunk * p.chunk_cap;
  const float* b_d = p.b_d + chunk * p.chunk_cap;
  const int r0 = p.r0s[j], r1 = p.r1s[j];
  int n_prod = 0;
  for (int tile = a_start; tile < a_end; tile += nt) {
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
    const int2 scan = block_excl_scan(cnt, x.scan);
    const int total = scan.y;
    x.excl[tid] = scan.x;
    x.start[tid] = start;
    x.aval[tid] = a;
    __syncthreads();
    for (int q = tid; q < total; q += nt) {
      // the entry of product q: the last whose exclusive scan is <= q
      int lo = 0;
      for (int st = nt / 2; st > 0; st >>= 1)
        if (x.excl[lo + st] <= q) lo += st;
      const int pos = n_prod + q;
      if (pos < cap) {
        const int src = min(x.start[lo] + q - x.excl[lo], p.chunk_cap - 1);
        keys[pos] = ((Key)(unsigned)b_ix[src] << shift) | (Key)(unsigned)pos;
        vals[pos] = x.aval[lo] * b_d[src];
      }
    }
    n_prod += total;
    __syncthreads();
  }
  return n_prod;
}

// The accumulator's entries after the n_prod products, then ~0 keys up to
// n2 (the caller's barrier follows).
template <class Key>
__device__ void block_append(const StepRow& s, int n_prod, int n, int n2, int shift, Key* keys,
                             float* vals) {
  for (int t = threadIdx.x; t < s.acc_n; t += blockDim.x) {
    const int pos = n_prod + t;
    keys[pos] = ((Key)(unsigned)s.acc_c[t] << shift) | (Key)(unsigned)pos;
    vals[pos] = s.acc_v[t];
  }
  for (int t = n + threadIdx.x; t < n2; t += blockDim.x) keys[t] = ~(Key)0;
}

// Stages k = k_first, 2 k_first, ..., k_last of an ascending bitonic sort
// on the n keys (a power of two) at keys, which are slots base ... base + n
// - 1 of the whole sort: of each stage the sub-stages of stride below n
// (the wider ones run elsewhere). Pair i of a sub-stage is (t, t | jj).
// Ends with a barrier.
template <class Key>
__device__ void block_bitonic(Key* keys, int n, unsigned base, unsigned k_first,
                              unsigned k_last) {
  for (unsigned k = k_first; k <= k_last; k <<= 1) {
    for (int jj = (int)(min(k, (unsigned)n) >> 1); jj > 0; jj >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
        const int t = ((i & ~(jj - 1)) << 1) | (i & (jj - 1));
        const int u = t | jj;
        const bool ascending = ((base + (unsigned)t) & k) == 0;
        const Key x = keys[t], y = keys[u];
        if ((x > y) == ascending) {
          keys[t] = y;
          keys[u] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Compress the n sorted keys (values by position): one thread per run of
// equal columns sums it in sorted order from 0.0f and writes the row's
// slab. Returns the row's entries.
template <class Key>
__device__ int block_compress(const Params& p, const Key* keys, const float* vals, int n,
                              int shift, int* out_c, float* out_v, int* scratch) {
  const Key pos_mask = ((Key)1 << shift) - 1;
  int out_n = 0;
  bool over = false;
  for (int tile = 0; tile < n; tile += blockDim.x) {
    const int t = tile + threadIdx.x;
    bool head = false;
    unsigned col = 0;
    if (t < n) {
      col = (unsigned)(keys[t] >> shift);
      head = t == 0 || (unsigned)(keys[t - 1] >> shift) != col;
    }
    const int2 scan = block_excl_scan(head ? 1 : 0, scratch);
    const int seg = out_n + scan.x;
    if (head) {
      float sum = 0.f;
      for (int u = t; u < n; ++u) {
        const Key ku = keys[u];
        if ((unsigned)(ku >> shift) != col) break;
        sum += vals[(unsigned)(ku & pos_mask)];
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
  return min(out_n, p.row_cap);
}

// One block a step of a block class: sort slots for cap keys (the class's
// W) in dynamic shared memory, keys then values; keys (column << shift) |
// position.
template <class Key>
__global__ void __launch_bounds__(kBlockThreads, 1)
    esc_block_kernel(Params p, const int* rows, int j, int cap, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ExpandScratch x;
  Key* keys = reinterpret_cast<Key*>(smem);
  float* vals = reinterpret_cast<float*>(keys + cap);
  const StepRow s = step_row(p, rows[blockIdx.x], j);
  const int n_prod = block_expand(p, s, j, keys, vals, cap, shift, x);
  const int n = n_prod + s.acc_n;
  if (n > cap) {   // the wrapper's count was wrong: report, leave the row empty
    if (threadIdx.x == 0) {
      csr_accum::flag_overflow(p);
      p.slab_cnt[s.g] = 0;
    }
    return;
  }
  const int n2 = csr_accum::next_pow2(n);
  block_append(s, n_prod, n, n2, shift, keys, vals);
  __syncthreads();
  block_bitonic(keys, n2, 0, 2, n2);
  const int out_n = block_compress(p, keys, vals, n, shift, s.out_c, s.out_v, x.scan);
  if (threadIdx.x == 0) p.slab_cnt[s.g] = out_n;
}

// The global steps of one launch: their rows, and their sort slots in the
// workspace (offsets[i]:offsets[i + 1], a power of two at least the keys,
// in keys of the launch's width).
struct GlobalSteps {
  const int* rows;
  const long long* offsets;
  unsigned long long* keys;     // workspace keys
  float* vals;                  // workspace values, by position
};

// Stages k_first ... k_last of the sort on the len slots at g (slots base
// ... of the step's), through shared memory: load, sub-stages, store.
template <class Key>
__device__ void tile_pass(Key* g, Key* sh, int len, unsigned base, unsigned k_first,
                          unsigned k_last) {
  for (int t = threadIdx.x; t < len; t += blockDim.x) sh[t] = g[t];
  __syncthreads();
  block_bitonic(sh, len, base, k_first, k_last);
  for (int t = threadIdx.x; t < len; t += blockDim.x) g[t] = sh[t];
  __syncthreads();
}

// One block a global step: the tile (a power of two, the last class's keys)
// in dynamic shared memory.
template <class Key>
__global__ void __launch_bounds__(kBlockThreads, 1)
    esc_global_kernel(Params p, GlobalSteps w, int j, int tile, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ExpandScratch x;
  Key* sh = reinterpret_cast<Key*>(smem);
  const long long base = w.offsets[blockIdx.x];
  const int cap = (int)(w.offsets[blockIdx.x + 1] - base);   // <= 2^30
  Key* keys = reinterpret_cast<Key*>(w.keys) + base;
  float* vals = w.vals + base;
  const StepRow s = step_row(p, w.rows[blockIdx.x], j);
  const int n_prod = block_expand(p, s, j, keys, vals, cap, shift, x);
  const long long n = (long long)n_prod + s.acc_n;
  if (n > cap) {   // the wrapper's count was wrong: report, leave the row empty
    if (threadIdx.x == 0) {
      csr_accum::flag_overflow(p);
      p.slab_cnt[s.g] = 0;
    }
    return;
  }
  const int n2 = csr_accum::next_pow2((int)n);   // <= cap
  block_append(s, n_prod, (int)n, n2, shift, keys, vals);
  __syncthreads();
  const int len = min(tile, n2);
  for (int t0 = 0; t0 < n2; t0 += len) tile_pass(keys + t0, sh, len, t0, 2, len);
  for (unsigned k = 2u * len; k <= (unsigned)n2; k <<= 1) {
    // the sub-stages of stride at least a tile, over global memory
    for (unsigned jj = k >> 1; jj >= (unsigned)len; jj >>= 1) {
      for (int i = threadIdx.x; i < n2 / 2; i += blockDim.x) {
        const unsigned t = (((unsigned)i & ~(jj - 1)) << 1) | ((unsigned)i & (jj - 1));
        const unsigned u = t | jj;
        const bool ascending = (t & k) == 0;
        const Key a = keys[t], b = keys[u];
        if ((a > b) == ascending) {
          keys[t] = b;
          keys[u] = a;
        }
      }
      __syncthreads();
    }
    for (int t0 = 0; t0 < n2; t0 += len) tile_pass(keys + t0, sh, len, t0, k, k);
  }
  const int out_n = block_compress(p, keys, vals, (int)n, shift, s.out_c, s.out_v, x.scan);
  if (threadIdx.x == 0) p.slab_cnt[s.g] = out_n;
}

// A kernel's dynamic shared memory limit, raised only when a call needs
// more than the largest earlier one (one setting per Tag).
template <int Tag, class Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  return 0;
}

// A classed call's steps: the rows of every non-empty step (chunk-major,
// then by class, then by row) and the global steps' workspace.
struct ClassedSteps {
  const int* items;
  const long long* offsets;     // [global steps + 1], in the items' order
  unsigned long long* keys;
  float* vals;
};

enum { kWarpClass = 0, kBlockClass = 1, kGlobalClass = 2 };
// kind, work_cap, acc slots, smem_per_warp, threads, dynamic smem, key bits
// and shift (block and global classes)
constexpr int kClassFields = 8;

// One launch of a block or global class: 32-bit keys where the wrapper's
// key bits allow, else 64-bit keys (column << 32 | position).
int launch_block_class(const Params& p, const int* f, const int* rows, const GlobalSteps& gs,
                       int items, int j, int tile, cudaStream_t stream) {
  const bool narrow = f[6] == 32;
  const int shift = narrow ? f[7] : 32;
  int err;
  if (f[0] == kBlockClass && narrow) {
    if ((err = allow_smem<0>(esc_block_kernel<unsigned>, f[5]))) return err;
    esc_block_kernel<unsigned><<<items, f[4], f[5], stream>>>(p, rows, j, f[1], shift);
  } else if (f[0] == kBlockClass) {
    if ((err = allow_smem<1>(esc_block_kernel<unsigned long long>, f[5]))) return err;
    esc_block_kernel<unsigned long long><<<items, f[4], f[5], stream>>>(p, rows, j, f[1], shift);
  } else if (narrow) {
    if ((err = allow_smem<2>(esc_global_kernel<unsigned>, f[5]))) return err;
    esc_global_kernel<unsigned><<<items, f[4], f[5], stream>>>(p, gs, j, tile, shift);
  } else {
    if ((err = allow_smem<3>(esc_global_kernel<unsigned long long>, f[5]))) return err;
    esc_global_kernel<unsigned long long><<<items, f[4], f[5], stream>>>(p, gs, j, tile, shift);
  }
  return 0;
}

// host_plan (a host array): the number of classes, the global tile, per
// class its kClassFields, then each (chunk, class)'s first item (chunk-major,
// n_b * classes + 1 of them). Chunk by chunk, each class with steps there
// launches once over its rows; then the scan and the copy.
int esc_launch_classed(Params p, const ClassedSteps& w, const int* host_plan,
                       cudaStream_t stream) {
  const long long rows = (long long)p.batch * p.n_ac * p.strip_rows;
  if (rows >= (1ll << 31) || rows == 0) return (int)cudaErrorInvalidValue;
  const int n_cls = host_plan[0], tile = host_plan[1];
  const int* cls = host_plan + 2;
  const int* starts = cls + n_cls * kClassFields;
  // an empty step launches nothing: its row stays at zero entries
  const cudaError_t zero = cudaMemsetAsync(p.slab_cnt, 0, (size_t)rows * sizeof(int), stream);
  if (zero != cudaSuccess) return (int)zero;
  int global_seen = 0;
  for (int j = 0; j < p.n_b; ++j) {
    for (int c = 0; c < n_cls; ++c) {
      const int* f = cls + c * kClassFields;
      const int first = starts[j * n_cls + c];
      const int items = starts[j * n_cls + c + 1] - first;
      if (items == 0) continue;
      const int* rows_c = w.items + first;
      if (f[0] == kWarpClass) {
        if (int err = allow_smem<4>(esc_warp_kernel, f[5])) return err;
        Params q = p;
        q.work_cap = f[1];
        q.row_cap = f[2];
        q.smem_per_warp = f[3];
        const int warps = f[4] / kWarp;
        esc_warp_kernel<<<(items + warps - 1) / warps, f[4], f[5], stream>>>(q, rows_c, items, j,
                                                                             p.row_cap);
        continue;
      }
      const GlobalSteps gs{rows_c, w.offsets + global_seen, w.keys, w.vals};
      if (int err = launch_block_class(p, f, rows_c, gs, items, j, tile, stream)) return err;
      if (f[0] == kGlobalClass) global_seen += items;
    }
  }
  csr_accum::finish(p, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// The skeleton's entry (CSR_ACCUM_ENTRY_FN) with the classed launch's
// operands after the common pointers: the steps' rows, the global steps'
// offsets, the workspace's keys and values, and host_plan (a host array,
// see esc_launch_classed); all null for a call on the shared route.
extern "C" int sparse_accum_launch(
    const int* a_ip, const int* a_ix, const float* a_d, const int* b_ip, const int* b_ix,
    const float* b_d, const int* c0_ip, const int* c0_ix, const float* c0_d, const int* r0s,
    const int* r1s, int* slab_cols, float* slab_vals, int* slab_cnt, int* out_ip,
    int* out_ix, float* out_d, int* overflow, const int* items, const long long* offsets,
    unsigned long long* ws_keys, float* ws_vals, const int* host_plan, int batch, int n_ac,
    int n_b, int strip_rows, int chunk_rows, int a_cap, int chunk_cap, int c_cap, int a_mrn,
    int b_mrn, int row_cap, int work_cap, int smem_per_warp, int warps_per_block, int order,
    void* stream) {
  const csr_accum::Params p{a_ip,      a_ix,      a_d,      b_ip,       b_ix,       b_d,
                            c0_ip,     c0_ix,     c0_d,     r0s,        r1s,        slab_cols,
                            slab_vals, slab_cnt,  out_ip,   out_ix,     out_d,      overflow,
                            batch,     n_ac,      n_b,      strip_rows, chunk_rows, a_cap,
                            chunk_cap, c_cap,     a_mrn,    b_mrn,      row_cap,    work_cap,
                            smem_per_warp};
  if (host_plan == nullptr)
    return csr_accum::launch<EscMerge>(p, warps_per_block, order, (cudaStream_t)stream);
  const ClassedSteps w{items, offsets, ws_keys, ws_vals};
  return esc_launch_classed(p, w, host_plan, (cudaStream_t)stream);
}

extern "C" const char* sparse_accum_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
