// Mask-fused hash-accumulated CSR-output ranged SpGEMM for sm_90a.
//
// Replaces: hash_masked_accum_spgemm_stream with its merge
// hash_masked_merge_impl (src/repro/kernels/hash_accum_spgemm.py), run by
// the TPU inside the sparse_accum_spgemm_stream pallas_call. It computes
// C = ((A[:, r0:r1] x B) + C_prev) o M per strip: each row's table is seeded
// from the mask row (value 0) and then frozen; products and C_prev entries
// only probe, and a miss drops the write; the output structure is the
// mask's, with explicit zeros where no product landed.
//
// Bound on this card: memory traffic and load latency, as for the unmasked
// kernels (csr_accum.cuh): the products gather B rows through A's columns,
// and each product costs one probe chain. The TPU sized every row's table
// from the densest mask row; at graph scale that table (32,768 slots for a
// 25,125-entry row) exceeds a block's shared memory, so here each row's
// table is sized from its own mask row: the smallest power of two of at
// least twice its nnz, since probe-only lookups mostly miss and a miss scans
// to the next empty slot, which at a load factor near 1 is most of the
// table. The wrapper decides every size (masked_table_slots, masked_bins)
// and passes them as a prefix sum goff over the binned rows: row t's table
// has goff[t+1] - goff[t] slots. Rows are binned by table size (the
// wrapper's MASKED_BINS): tables up to 2,048 slots run one warp per row in
// shared memory, several warps per block; up to 16,384 slots one 512-thread
// block per row in shared memory; larger ones one block per row with the
// table in global memory at offset goff[t] - goff[first global row].
//
// Products are walked balanced: a team takes its row's A entries in tiles
// (32 for a warp, 512 for a block), scans the tile's B-row lengths, and
// deals the tile's products out to its threads one product each, a thread
// finding its product's A entry by binary search in the scan. A B row of
// thousands of entries is thus spread over the team instead of walked by one
// lane (graph rows reach B rows of 11,407 entries at scale 18).
//
// Keys are claimed with atomicCAS while seeding; after a team barrier they
// are read-only, and values are added with atomicAdd, so the summation
// order changes from run to run (the structure does not). The hash is
// (uint32)col * 2654435769u & (T - 1), the reference's; a probe visits each
// slot at most once (probe_step_bound(T) == T). Extraction walks the mask
// row, whose columns are strictly increasing (the wrapper checks), so the
// walk is the reference's sort by key, and each entry lands at its mask
// position: the output indptr is the mask's.
//
// Orders: chunk1 (and knl) keep the table resident across all chunks of the
// row (the reference re-seeds per chunk and adds the previous result; the
// key set and the sums are the same); chunk2 launches once per chunk, each
// launch re-seeds and adds C_prev probe-only: C0 on the first chunk, then
// the previous launch's output, read at the row's mask positions before the
// same positions are written.

#include "csr_accum.cuh"

namespace {

using csr_accum::Params;
using csr_accum::kWarp;
using csr_accum::kFull;

constexpr int kEmpty = -1;
constexpr unsigned kKnuth = 2654435769u;
constexpr int kBins = 5;
constexpr int kBlockTeamBin = 3;   // first bin run by whole blocks
constexpr int kGlobalBin = 4;      // the bin whose tables live in global memory
constexpr int kBlockThreads = 512;

struct MaskedParams {
  Params base;             // A, B, C0, r0s/r1s, out_ix/out_d, overflow, geometry
  const int* m_ip;         // [batch, n_ac, strip_rows + 1]
  const int* m_ix;         // [batch, n_ac, m_cap]
  const int* rows;         // team -> global strip row, this bin's slice
  const long long* goff;   // team -> prefix sum of table slots, this bin's
                           // slice (one longer than rows)
  int* gkeys;
  float* gvals;
  int m_cap;
  int n_teams;
  int table_slots;         // shared bins: slots reserved per team
};

__device__ __forceinline__ unsigned first_slot(int col, int table) {
  return ((unsigned)col * kKnuth) & (unsigned)(table - 1);
}

__device__ bool seed_key(int* keys, int table, int col) {
  const unsigned mask = (unsigned)table - 1u;
  unsigned slot = first_slot(col, table);
  for (int step = 0; step < table; ++step) {
    int k = atomicCAS(&keys[slot], kEmpty, col);
    if (k == kEmpty || k == col) return true;
    slot = (slot + 1u) & mask;
  }
  return false;
}

__device__ int find_key(const int* keys, int table, int col) {
  const unsigned mask = (unsigned)table - 1u;
  unsigned slot = first_slot(col, table);
  for (int step = 0; step < table; ++step) {
    int k = keys[slot];
    if (k == col) return (int)slot;
    if (k == kEmpty) return -1;
    slot = (slot + 1u) & mask;
  }
  return -1;
}

__device__ __forceinline__ void probe_add(const int* keys, float* vals,
                                          int table, int col, float v) {
  int slot = find_key(keys, table, col);
  if (slot >= 0) atomicAdd(&vals[slot], v);
}

// One A entry of a product tile: its B row's start and in-range length, and
// its value.
struct Entry {
  int b_start;
  int cnt;
  float a_val;
};

__device__ __forceinline__ Entry load_entry(const Params& p, const int* a_ix,
                                            const float* a_d, int e, int a_end,
                                            const int* b_ip, int r0, int r1) {
  Entry x{0, 0, 0.f};
  if (e < a_end) {
    const int col = a_ix[e];
    if (col >= r0 && col < r1) {
      const int b_row = min(max(col - r0, 0), p.chunk_rows - 1);
      x.b_start = b_ip[b_row];
      x.cnt = max(min(b_ip[b_row + 1] - x.b_start, p.b_mrn), 0);
      x.a_val = a_d[e];
    }
  }
  return x;
}

// Warp team: tiles of 32 A entries; the owner of product q is the first lane
// whose inclusive scan exceeds q, found by a 5-step search over shuffles.
template <class Probe>
__device__ void walk_products_warp(const Params& p, const int* a_ix,
                                   const float* a_d, int a_start, int a_end,
                                   const int* b_ip, const int* b_ix,
                                   const float* b_d, int r0, int r1, int lane,
                                   Probe probe) {
  for (int base = a_start; base < a_end; base += kWarp) {
    const Entry x = load_entry(p, a_ix, a_d, base + lane, a_end, b_ip, r0, r1);
    const int incl = csr_accum::warp_incl_scan(x.cnt, lane);
    const int excl = incl - x.cnt;
    const int total = __shfl_sync(kFull, incl, kWarp - 1);
    for (int q0 = 0; q0 < total; q0 += kWarp) {
      const int q = q0 + lane;
      int lo = 0;
#pragma unroll
      for (int step = kWarp / 2; step >= 1; step >>= 1) {
        if (__shfl_sync(kFull, incl, lo + step - 1) <= q) lo += step;
      }
      const int owner = min(lo, kWarp - 1);
      const int b_start = __shfl_sync(kFull, x.b_start, owner);
      const int o_excl = __shfl_sync(kFull, excl, owner);
      const float a_val = __shfl_sync(kFull, x.a_val, owner);
      if (q < total) {
        const int src = min(b_start + (q - o_excl), p.chunk_cap - 1);
        probe(b_ix[src], a_val * b_d[src]);
      }
    }
  }
}

// Block team: tiles of blockDim A entries, the tile's scan in shared memory.
template <class Probe>
__device__ void walk_products_block(const Params& p, const int* a_ix,
                                    const float* a_d, int a_start, int a_end,
                                    const int* b_ip, const int* b_ix,
                                    const float* b_d, int r0, int r1,
                                    Probe probe) {
  __shared__ int s_incl[kBlockThreads];
  __shared__ int s_start[kBlockThreads];
  __shared__ float s_val[kBlockThreads];
  __shared__ int s_warp[kBlockThreads / kWarp];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int n_threads = blockDim.x, n_warps = n_threads / kWarp;
  for (int base = a_start; base < a_end; base += n_threads) {
    const Entry x = load_entry(p, a_ix, a_d, base + tid, a_end, b_ip, r0, r1);
    const int incl = csr_accum::warp_incl_scan(x.cnt, lane);
    if (lane == kWarp - 1) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < n_warps ? s_warp[lane] : 0;
      const int w_incl = csr_accum::warp_incl_scan(v, lane);
      if (lane < n_warps) s_warp[lane] = w_incl - v;
    }
    __syncthreads();
    s_incl[tid] = s_warp[warp] + incl;
    s_start[tid] = x.b_start;
    s_val[tid] = x.a_val;
    __syncthreads();
    const int total = s_incl[n_threads - 1];
    for (int q = tid; q < total; q += n_threads) {
      int lo = 0, hi = n_threads - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_incl[mid] > q) hi = mid; else lo = mid + 1;
      }
      const int o_excl = lo ? s_incl[lo - 1] : 0;
      const int src = min(s_start[lo] + (q - o_excl), p.chunk_cap - 1);
      probe(b_ix[src], s_val[lo] * b_d[src]);
    }
    __syncthreads();
  }
}

template <bool kBlockTeam>
__device__ __forceinline__ void team_sync() {
  if (kBlockTeam) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// One team (a warp, or the whole block) per mask row of its bin: seed,
// C_prev, the chunks [j_begin, j_end), extraction.
template <bool kBlockTeam, bool kGlobal>
__global__ void masked_rows_kernel(MaskedParams mp, int j_begin, int j_end) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Params& p = mp.base;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int tid = kBlockTeam ? (int)threadIdx.x : lane;
  const int n_threads = kBlockTeam ? (int)blockDim.x : kWarp;
  const long long team =
      kBlockTeam ? (long long)blockIdx.x
                 : (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (team >= mp.n_teams) return;  // uniform across the team
  const long long g = mp.rows[team];
  const long long strip = g / p.strip_rows;
  const int r = (int)(g % p.strip_rows);
  const long long b = strip / p.n_ac;

  const int* m_ip = mp.m_ip + strip * (p.strip_rows + 1);
  const int ms = m_ip[r];
  const int cnt = m_ip[r + 1] - ms;
  const int table = (int)(mp.goff[team + 1] - mp.goff[team]);
  if (!kGlobal && table > mp.table_slots) {  // uniform across the team
    csr_accum::flag_overflow(p);
    return;
  }
  int* keys;
  float* vals;
  if (kGlobal) {
    keys = mp.gkeys + (mp.goff[team] - mp.goff[0]);
    vals = mp.gvals + (mp.goff[team] - mp.goff[0]);
  } else {
    unsigned char* base =
        smem + (kBlockTeam ? 0 : (size_t)warp * mp.table_slots * 8);
    keys = reinterpret_cast<int*>(base);
    vals = reinterpret_cast<float*>(keys + mp.table_slots);
  }
  for (int t = tid; t < table; t += n_threads) {
    keys[t] = kEmpty;
    vals[t] = 0.f;
  }
  team_sync<kBlockTeam>();

  // seed: the mask row's keys, the only inserts; afterwards the set is frozen
  const int* m_ix = mp.m_ix + strip * mp.m_cap + ms;
  bool ok = true;
  for (int t = tid; t < cnt; t += n_threads) ok &= seed_key(keys, table, m_ix[t]);
  if (!ok) csr_accum::flag_overflow(p);
  team_sync<kBlockTeam>();

  // C_prev, probe-only
  int* out_ix = p.out_ix + strip * p.c_cap + ms;
  float* out_d = p.out_d + strip * p.c_cap + ms;
  if (j_begin == 0) {
    const int* ip = p.c0_ip + strip * (p.strip_rows + 1);
    const int s = min(ip[r], p.c_cap), e = min(ip[r + 1], p.c_cap);
    const int* c_ix = p.c0_ix + strip * p.c_cap;
    const float* c_d = p.c0_d + strip * p.c_cap;
    for (int t = s + tid; t < e; t += n_threads)
      probe_add(keys, vals, table, c_ix[t], c_d[t]);
  } else {
    for (int t = tid; t < cnt; t += n_threads)
      probe_add(keys, vals, table, out_ix[t], out_d[t]);
  }

  // products, probe-only, dealt out over the team
  const int* a_ip = p.a_ip + strip * (p.strip_rows + 1);
  const int* a_ix = p.a_ix + strip * p.a_cap;
  const float* a_d = p.a_d + strip * p.a_cap;
  const int a_start = min(a_ip[r], p.a_cap), a_end = min(a_ip[r + 1], p.a_cap);
  auto probe = [&](int col, float v) { probe_add(keys, vals, table, col, v); };
  for (int j = j_begin; j < j_end; ++j) {
    const long long chunk = b * p.n_b + j;
    const int* b_ip = p.b_ip + chunk * (p.chunk_rows + 1);
    const int* b_ix = p.b_ix + chunk * p.chunk_cap;
    const float* b_d = p.b_d + chunk * p.chunk_cap;
    if constexpr (kBlockTeam) {
      walk_products_block(p, a_ix, a_d, a_start, a_end, b_ip, b_ix, b_d,
                          p.r0s[j], p.r1s[j], probe);
    } else {
      walk_products_warp(p, a_ix, a_d, a_start, a_end, b_ip, b_ix, b_d,
                         p.r0s[j], p.r1s[j], lane, probe);
    }
  }
  team_sync<kBlockTeam>();

  // extraction at the mask positions (the mask row is column-sorted)
  bool found = true;
  for (int t = tid; t < cnt; t += n_threads) {
    const int col = m_ix[t];
    const int slot = find_key(keys, table, col);
    found &= slot >= 0;
    out_ix[t] = col;
    out_d[t] = slot >= 0 ? vals[slot] : 0.f;
  }
  if (!found) csr_accum::flag_overflow(p);
}

template <bool kBlockTeam, bool kGlobal>
cudaError_t launch_bin(const MaskedParams& mp, int warps, int j_begin,
                       int j_end, cudaStream_t stream) {
  if (mp.n_teams == 0) return cudaSuccess;
  const int threads = kBlockTeam ? kBlockThreads : warps * kWarp;
  const size_t smem =
      kGlobal ? 0
              : (size_t)mp.table_slots * 8 * (kBlockTeam ? 1 : (size_t)warps);
  cudaError_t err = cudaFuncSetAttribute(
      masked_rows_kernel<kBlockTeam, kGlobal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      kBlockTeam ? (unsigned)mp.n_teams
                 : (unsigned)((mp.n_teams + warps - 1) / warps);
  masked_rows_kernel<kBlockTeam, kGlobal>
      <<<blocks, threads, smem, stream>>>(mp, j_begin, j_end);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hash_masked_accum_launch(
    const int* a_ip, const int* a_ix, const float* a_d, const int* b_ip,
    const int* b_ix, const float* b_d, const int* c0_ip, const int* c0_ix,
    const float* c0_d, const int* r0s, const int* r1s, const int* m_ip,
    const int* m_ix, const int* rows, const long long* goff, int* gkeys,
    float* gvals, int* out_ix, float* out_d, int* overflow, int batch,
    int n_ac, int n_b, int strip_rows, int chunk_rows, int a_cap,
    int chunk_cap, int c_cap, int a_mrn, int b_mrn, int m_cap, int order,
    int n0, int s0, int w0, int n1, int s1, int w1, int n2, int s2, int w2,
    int n3, int s3, int w3, int n4, int s4, int w4, void* stream) {
  Params base{a_ip,    a_ix,       a_d,     b_ip,      b_ix,   b_d,
              c0_ip,   c0_ix,      c0_d,    r0s,       r1s,    nullptr,
              nullptr, nullptr,    nullptr, out_ix,    out_d,  overflow,
              batch,   n_ac,       n_b,     strip_rows, chunk_rows, a_cap,
              chunk_cap, c_cap,    a_mrn,   b_mrn,     0,      0,
              0};
  const int counts[kBins] = {n0, n1, n2, n3, n4};
  const int slots[kBins] = {s0, s1, s2, s3, s4};
  const int warps[kBins] = {w0, w1, w2, w3, w4};
  cudaStream_t s = (cudaStream_t)stream;
  const int steps = order == 1 ? 1 : n_b;
  for (int step = 0; step < steps; ++step) {
    const int j_begin = order == 1 ? 0 : step;
    const int j_end = order == 1 ? n_b : step + 1;
    long long offset = 0;
    for (int bin = 0; bin < kBins; ++bin) {
      MaskedParams mp{base,  m_ip,  m_ix,  rows + offset, goff + offset,
                      gkeys, gvals, m_cap, counts[bin],  slots[bin]};
      cudaError_t err;
      if (bin < kBlockTeamBin)
        err = launch_bin<false, false>(mp, warps[bin], j_begin, j_end, s);
      else if (bin < kGlobalBin)
        err = launch_bin<true, false>(mp, warps[bin], j_begin, j_end, s);
      else
        err = launch_bin<true, true>(mp, warps[bin], j_begin, j_end, s);
      if (err != cudaSuccess) return (int)err;
      offset += counts[bin];
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* hash_masked_accum_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
