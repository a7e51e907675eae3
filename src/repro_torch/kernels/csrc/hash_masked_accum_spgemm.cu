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
// least twice its nnz (the wrapper's masked_table_slots), since probe-only
// lookups mostly miss and a miss scans to the next empty slot.
//
// The work is cut by products, not by rows (the wrapper's masked_work and
// masked_launches decide all of it): a row whose products exceed the part
// size (from the call's products and the SM count) is cut into parts, each
// a contiguous range of its A entries, so no team walks a row of millions
// of products alone. A part is one team's work, and the parts of a launch
// come heaviest first. A launch holds the parts of one team kind and one
// table size, and reserves exactly that table for each team (the global
// parts, whose tables are not in shared memory, share one launch):
//   warp   one warp a part, 8 warps a block, each with its own table in
//          shared memory (small tables, few products);
//   block  one block a part (512 threads, 1,024 where the table leaves
//          room for one block an SM), its table in shared memory;
//   global one 512-thread block a part of a row whose table exceeds a
//          block's shared memory; the row's parts share one table in
//          global memory, seeded once by masked_seed_kernel, probed
//          through the read-only cache (its keys are frozen) and added to
//          with global atomics, and masked_gather_kernel writes the row.
// A shared-memory part seeds its own copy of its row's table from the mask
// row, probes it with its products, then walks the mask row and adds each
// nonzero sum into the output at the mask position with atomicAdd (the
// row's only part stores instead, which also writes the zeros). The row's
// first part also writes the output columns, the mask row, and adds C_prev
// probe-only on the first chunk.
//
// Orders: chunk1 (and knl) walk all chunks in one launch of each kind;
// chunk2 launches once per chunk, and a later launch adds onto the output,
// which holds C_prev at the mask positions. A global table lives across the
// chunk2 launches: seeded before the first, gathered after the last.
//
// Products are dealt out over the team: a warp by the load-balanced expand
// of csr_accum.cuh; a block takes its range's A entries in tiles of
// blockDim, scans the tile's B-row lengths in shared memory, and deals the
// tile's products to its threads, thread t taking products t, t + blockDim,
// ... (neighbouring threads on neighbouring B entries); a thread finds each
// product's A entry from its previous one, galloping forward in the scan.
// Keys are claimed with atomicCAS while seeding; after a barrier they are
// read-only, and values are added with atomicAdd, so the summation order
// changes from run to run (the structure does not; integer sums, as in
// triangle counting, are exact). The hash is (uint32)col * 2654435769u &
// (T - 1), the reference's; a probe visits each slot at most once
// (probe_step_bound(T) == T). The mask row's columns are strictly
// increasing (the wrapper checks), so writing at the mask positions is the
// reference's extraction sorted by key: the output indptr is the mask's.

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
// team kinds, as the wrapper's MASKED_TEAMS
constexpr int kWarpTeam = 0;
constexpr int kBlockTeam = 1;
constexpr int kGlobalTeam = 2;
constexpr int kWarpThreads = 256;     // a warp launch's block: 8 teams
constexpr int kGlobalThreads = 512;
// part flags, as the wrapper's
constexpr int kFirst = 1;   // the row's first part: out_ix, C_prev
constexpr int kOnly = 2;    // the row's only part: stores its sums

struct MaskedParams {
  Params base;            // A, B, C0, r0s/r1s, out_ix/out_d, overflow, geometry
  const int* m_ip;        // [batch, n_ac, strip_rows + 1]
  const int* m_ix;        // [batch, n_ac, m_cap]
  const int4* parts;      // this launch's parts: (strip row, e0, e1, flags)
  const int* pglob;       // global team: the part's index among the global rows
  const int* grows;       // [G] the global rows (global strip row ids)
  const long long* goff;  // [G + 1] their tables' offsets in gkeys / gvals
  int* gkeys;
  float* gvals;
  int m_cap;
  int n_parts;
  int table;              // shared teams: the launch's table slots
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

// The slot of col, or -1; kFrozen reads the keys through the read-only
// cache (a global table during the parts' launch, seeded by an earlier one).
template <bool kFrozen>
__device__ __forceinline__ int find_key(const int* keys, int table, int col) {
  const unsigned mask = (unsigned)table - 1u;
  unsigned slot = first_slot(col, table);
  for (int step = 0; step < table; ++step) {
    const int k = kFrozen ? __ldg(&keys[slot]) : keys[slot];
    if (k == col) return (int)slot;
    if (k == kEmpty) return -1;
    slot = (slot + 1u) & mask;
  }
  return -1;
}

// A team's view of one row's table.
template <bool kFrozen>
struct Table {
  int* keys;
  float* vals;
  int slots;

  __device__ __forceinline__ void add(int col, float v) const {
    const int slot = find_key<kFrozen>(keys, slots, col);
    if (slot >= 0) atomicAdd(&vals[slot], v);
  }
};

// Warp team: the load-balanced expand over the part's A entries [e0, e1).
template <class Probe>
__device__ void walk_products_warp(const Params& p, const int* a_ix,
                                   const float* a_d, int e0, int e1,
                                   const int* b_ip, const int* b_ix,
                                   const float* b_d, int r0, int r1, int lane,
                                   Probe probe) {
  for (int base = e0; base < e1; base += kWarp) {
    const Batch bt = load_batch(p, a_ix, a_d, base + lane, e1, b_ip, r0, r1, lane);
    for (int q0 = 0; q0 < bt.total; q0 += kWarp) {
      int src;
      float a;
      locate(p, bt, q0 + lane, src, a);
      if (src >= 0) probe(__ldg(&b_ix[src]), a * __ldg(&b_d[src]));
    }
  }
}

// Block team: tiles of kThreads A entries, the tile's scan in shared memory.
template <int kThreads, class Probe>
__device__ void walk_products_block(const Params& p, const int* a_ix,
                                    const float* a_d, int e0, int e1,
                                    const int* b_ip, const int* b_ix,
                                    const float* b_d, int r0, int r1,
                                    Probe probe) {
  __shared__ int s_incl[kThreads];
  __shared__ int s_start[kThreads];
  __shared__ float s_val[kThreads];
  __shared__ int s_warp[kThreads / kWarp];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  constexpr int kWarps = kThreads / kWarp;
  for (int base = e0; base < e1; base += kThreads) {
    const int e = base + tid;
    int cnt = 0, b_start = 0;
    float a_val = 0.f;
    if (e < e1) {
      const int col = a_ix[e];
      if (col >= r0 && col < r1) {
        const int b_row = min(max(col - r0, 0), p.chunk_rows - 1);
        b_start = b_ip[b_row];
        cnt = max(min(b_ip[b_row + 1] - b_start, p.b_mrn), 0);
        a_val = a_d[e];
      }
    }
    const int incl = csr_accum::warp_incl_scan(cnt, lane);
    if (lane == kWarp - 1) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < kWarps ? s_warp[lane] : 0;
      const int w_incl = csr_accum::warp_incl_scan(v, lane);
      if (lane < kWarps) s_warp[lane] = w_incl - v;
    }
    __syncthreads();
    s_incl[tid] = s_warp[warp] + incl;
    s_start[tid] = b_start;
    s_val[tid] = a_val;
    __syncthreads();
    const int total = s_incl[kThreads - 1];
    int lo = 0;   // the entry of the thread's product: it never moves back
    for (int q = tid; q < total; q += kThreads) {
      if (s_incl[lo] <= q) {   // past entry lo: gallop forward, then bisect
        int hi = lo + 1;
        for (int step = 2; s_incl[hi] <= q; step <<= 1) {
          lo = hi;
          hi = min(lo + step, kThreads - 1);   // s_incl[kThreads - 1] = total > q
        }
        ++lo;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_incl[mid] > q) hi = mid; else lo = mid + 1;
        }
      }
      const int o_excl = lo ? s_incl[lo - 1] : 0;
      const int src = min(s_start[lo] + (q - o_excl), p.chunk_cap - 1);
      probe(__ldg(&b_ix[src]), s_val[lo] * __ldg(&b_d[src]));
    }
    __syncthreads();
  }
}

template <bool kWarpT>
__device__ __forceinline__ void team_sync() {
  if (kWarpT) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// One team per part: its table (seeded, or the row's global one), C_prev on
// the first chunk if it is its row's first part, the products of its A
// entries for chunks [j_begin, j_end), then (shared tables) its sums out.
template <int kTeam, int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    masked_part_kernel(MaskedParams mp, int j_begin, int j_end) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kWarpT = kTeam == kWarpTeam;
  constexpr bool kGlobal = kTeam == kGlobalTeam;
  constexpr int kTeamThreads = kWarpT ? kWarp : kThreads;
  const Params& p = mp.base;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int tid = kWarpT ? lane : (int)threadIdx.x;
  const long long team =
      kWarpT ? (long long)blockIdx.x * (kThreads / kWarp) + warp : (long long)blockIdx.x;
  if (team >= mp.n_parts) return;  // uniform across the team
  const int4 part = mp.parts[team];
  const long long g = part.x;
  const long long strip = g / p.strip_rows;
  const int r = (int)(g % p.strip_rows);
  const long long b = strip / p.n_ac;
  const bool first = (part.w & kFirst) != 0;
  const bool only = (part.w & kOnly) != 0;

  const int* m_ip = mp.m_ip + strip * (p.strip_rows + 1);
  const int ms = m_ip[r];
  const int cnt = m_ip[r + 1] - ms;
  const int* m_ix = mp.m_ix + strip * mp.m_cap + ms;
  Table<kGlobal> tab;
  if constexpr (kGlobal) {
    const int gi = mp.pglob[team];
    tab.keys = mp.gkeys + mp.goff[gi];
    tab.vals = mp.gvals + mp.goff[gi];
    tab.slots = (int)(mp.goff[gi + 1] - mp.goff[gi]);
  } else {
    unsigned char* base = smem + (kWarpT ? (size_t)warp * mp.table * 8 : 0);
    tab.keys = reinterpret_cast<int*>(base);
    tab.vals = reinterpret_cast<float*>(tab.keys + mp.table);
    tab.slots = mp.table;
    for (int t = tid; t < tab.slots; t += kTeamThreads) {
      tab.keys[t] = kEmpty;
      tab.vals[t] = 0.f;
    }
    team_sync<kWarpT>();
    // seed: the mask row's keys, the only inserts; afterwards the set is frozen
    bool ok = true;
    for (int t = tid; t < cnt; t += kTeamThreads) ok &= seed_key(tab.keys, tab.slots, m_ix[t]);
    if (!ok) csr_accum::flag_overflow(p);
    team_sync<kWarpT>();
  }

  // C_prev, probe-only, once a row
  if (j_begin == 0 && first) {
    const int* ip = p.c0_ip + strip * (p.strip_rows + 1);
    const int s = min(ip[r], p.c_cap), e = min(ip[r + 1], p.c_cap);
    const int* c_ix = p.c0_ix + strip * p.c_cap;
    const float* c_d = p.c0_d + strip * p.c_cap;
    for (int t = s + tid; t < e; t += kTeamThreads) tab.add(c_ix[t], c_d[t]);
  }

  // products, probe-only, dealt out over the team
  const int* a_ix = p.a_ix + strip * p.a_cap;
  const float* a_d = p.a_d + strip * p.a_cap;
  const int e0 = min(part.y, p.a_cap), e1 = min(part.z, p.a_cap);
  auto probe = [&](int col, float v) { tab.add(col, v); };
  for (int j = j_begin; j < j_end; ++j) {
    const long long chunk = b * p.n_b + j;
    const int* b_ip = p.b_ip + chunk * (p.chunk_rows + 1);
    const int* b_ix = p.b_ix + chunk * p.chunk_cap;
    const float* b_d = p.b_d + chunk * p.chunk_cap;
    if constexpr (kWarpT) {
      walk_products_warp(p, a_ix, a_d, e0, e1, b_ip, b_ix, b_d, p.r0s[j], p.r1s[j], lane,
                         probe);
    } else {
      walk_products_block<kThreads>(p, a_ix, a_d, e0, e1, b_ip, b_ix, b_d, p.r0s[j],
                                    p.r1s[j], probe);
    }
  }
  if constexpr (kGlobal) return;   // masked_gather_kernel writes the row
  team_sync<kWarpT>();

  // the part's sums at the mask positions (the mask row is column-sorted)
  int* out_ix = p.out_ix + strip * p.c_cap + ms;
  float* out_d = p.out_d + strip * p.c_cap + ms;
  bool found = true;
  for (int t = tid; t < cnt; t += kTeamThreads) {
    const int col = m_ix[t];
    const int slot = find_key<false>(tab.keys, tab.slots, col);
    found &= slot >= 0;
    const float v = slot >= 0 ? tab.vals[slot] : 0.f;
    if (first && j_begin == 0) out_ix[t] = col;
    if (only) {
      out_d[t] = j_begin == 0 ? v : out_d[t] + v;
    } else if (v != 0.f) {
      atomicAdd(&out_d[t], v);
    }
  }
  if (!found) csr_accum::flag_overflow(p);
}

// The global rows' tables (filled with EMPTY keys and zero values by the
// wrapper): block (x, y) seeds mask entries [x * blockDim, ...) of global
// row y.
__global__ void masked_seed_kernel(MaskedParams mp) {
  const Params& p = mp.base;
  const long long g = mp.grows[blockIdx.y];
  const long long strip = g / p.strip_rows;
  const int r = (int)(g % p.strip_rows);
  const int* m_ip = mp.m_ip + strip * (p.strip_rows + 1);
  const int ms = m_ip[r];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m_ip[r + 1] - ms) return;
  const long long off = mp.goff[blockIdx.y];
  if (!seed_key(mp.gkeys + off, (int)(mp.goff[blockIdx.y + 1] - off),
                mp.m_ix[strip * mp.m_cap + ms + t]))
    csr_accum::flag_overflow(p);
}

// The global rows out: each mask entry's sum (C_prev and every chunk's
// products) at its mask position.
__global__ void masked_gather_kernel(MaskedParams mp) {
  const Params& p = mp.base;
  const long long g = mp.grows[blockIdx.y];
  const long long strip = g / p.strip_rows;
  const int r = (int)(g % p.strip_rows);
  const int* m_ip = mp.m_ip + strip * (p.strip_rows + 1);
  const int ms = m_ip[r];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m_ip[r + 1] - ms) return;
  const long long off = mp.goff[blockIdx.y];
  const int col = mp.m_ix[strip * mp.m_cap + ms + t];
  const int slot = find_key<false>(mp.gkeys + off, (int)(mp.goff[blockIdx.y + 1] - off), col);
  if (slot < 0) csr_accum::flag_overflow(p);
  p.out_ix[strip * p.c_cap + ms + t] = col;
  p.out_d[strip * p.c_cap + ms + t] = slot >= 0 ? mp.gvals[off + slot] : 0.f;
}

// One launch of masked_part_kernel<kTeam, kThreads>; the kernel's dynamic
// shared-memory limit is raised only past the largest earlier setting.
template <int kTeam, int kThreads>
cudaError_t launch_parts(const MaskedParams& mp, int j_begin, int j_end,
                         cudaStream_t stream) {
  const int teams_per_block = kTeam == kWarpTeam ? kThreads / kWarp : 1;
  const size_t smem = kTeam == kGlobalTeam ? 0 : (size_t)mp.table * 8 * teams_per_block;
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(masked_part_kernel<kTeam, kThreads>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  const unsigned blocks = (unsigned)((mp.n_parts + teams_per_block - 1) / teams_per_block);
  masked_part_kernel<kTeam, kThreads><<<blocks, kThreads, smem, stream>>>(mp, j_begin, j_end);
  return cudaGetLastError();
}

constexpr int kRowThreads = 256;   // the seed and gather kernels' blocks

}  // namespace

// groups: host int32 [n_groups, 4], one launch each: (team, table slots,
// parts, threads); the parts are consecutive in `parts` in group order.
extern "C" int hash_masked_accum_launch(
    const int* a_ip, const int* a_ix, const float* a_d, const int* b_ip,
    const int* b_ix, const float* b_d, const int* c0_ip, const int* c0_ix,
    const float* c0_d, const int* r0s, const int* r1s, const int* m_ip,
    const int* m_ix, const int* parts, const int* pglob, const int* grows,
    const long long* goff, int* gkeys, float* gvals, int* out_ix, float* out_d,
    int* overflow, const int* groups, int batch, int n_ac, int n_b, int strip_rows,
    int chunk_rows, int a_cap, int chunk_cap, int c_cap, int a_mrn, int b_mrn,
    int m_cap, int order, int n_groups, int n_grows, int grow_max_nnz, void* stream) {
  Params base{a_ip,    a_ix,       a_d,     b_ip,      b_ix,   b_d,
              c0_ip,   c0_ix,      c0_d,    r0s,       r1s,    nullptr,
              nullptr, nullptr,    nullptr, out_ix,    out_d,  overflow,
              batch,   n_ac,       n_b,     strip_rows, chunk_rows, a_cap,
              chunk_cap, c_cap,    a_mrn,   b_mrn,     0,      0,
              0};
  MaskedParams mp{base, m_ip, m_ix, reinterpret_cast<const int4*>(parts), pglob, grows,
                  goff, gkeys, gvals, m_cap, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 row_grid((unsigned)((grow_max_nnz + kRowThreads - 1) / kRowThreads),
                      (unsigned)n_grows);
  const int steps = order == 1 ? 1 : n_b;
  for (int step = 0; step < steps; ++step) {
    const int j_begin = order == 1 ? 0 : step;
    const int j_end = order == 1 ? n_b : step + 1;
    if (step == 0 && n_grows > 0 && grow_max_nnz > 0)
      masked_seed_kernel<<<row_grid, kRowThreads, 0, s>>>(mp);
    long long offset = 0;
    for (int k = 0; k < n_groups; ++k) {
      const int team = groups[4 * k], threads = groups[4 * k + 3];
      MaskedParams gp = mp;
      gp.parts = mp.parts + offset;
      gp.pglob = pglob + offset;
      gp.n_parts = groups[4 * k + 2];
      gp.table = groups[4 * k + 1];
      offset += gp.n_parts;
      if (gp.n_parts == 0) continue;
      cudaError_t err;
      if (team == kWarpTeam && threads == kWarpThreads)
        err = launch_parts<kWarpTeam, kWarpThreads>(gp, j_begin, j_end, s);
      else if (team == kBlockTeam && threads == 512)
        err = launch_parts<kBlockTeam, 512>(gp, j_begin, j_end, s);
      else if (team == kBlockTeam && threads == 1024)
        err = launch_parts<kBlockTeam, 1024>(gp, j_begin, j_end, s);
      else if (team == kGlobalTeam && threads == kGlobalThreads)
        err = launch_parts<kGlobalTeam, kGlobalThreads>(gp, j_begin, j_end, s);
      else
        err = cudaErrorInvalidValue;
      if (err != cudaSuccess) return (int)err;
    }
    if (step == steps - 1 && n_grows > 0 && grow_max_nnz > 0)
      masked_gather_kernel<<<row_grid, kRowThreads, 0, s>>>(mp);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* hash_masked_accum_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
