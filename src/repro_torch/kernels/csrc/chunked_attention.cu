// Length-masked GQA decode attention (one query token per sequence), sm_90a:
// split-KV flash-decoding.
//
// Replaces: decode_attention (src/repro/kernels/chunked_attention.py:62),
// whose pallas_call walked a grid (B, Hkv, S / bs_kv) with the S axis
// sequential: the [G, D] queries of one KV head and their f32 online-softmax
// state (m, l, acc) stayed in VMEM while [bs_kv, D] chunks of the K and V
// cache streamed in, positions >= lengths[b] (scalar-prefetched) masked with
// the finite NEG_INF. Blocks on this card run in parallel and carry nothing
// from one to the next, so the sequential S axis becomes a split across
// blocks and a second pass that combines their partial states.
//
// Layout as the reference: q [B, Hkv, G, D], k and v [B, S, Hkv, D] (the
// cache), lengths int32 [B]; out [B, Hkv, G, D] in q's dtype (f32 or bf16;
// every sum in f32). Position p of sequence b is visible iff p < lengths[b];
// lengths[b] = 0 gives zeros.
//
// Bound on this card: bytes. Each visible cache position is read once for
// 4 D G operations per KV head, about G flops a byte in bf16 against the
// card's ~20 f32 flops a byte, so the least time is the live K and V bytes
// over 3.35 TB/s, and f32 FMAs suffice (no tensor cores).
//
// Design:
// - decode_split_kernel, grid (n_split, Hkv, B), 128 threads. The host picks
//   n_split from the shapes and the SM count alone (chunked_attention.py::
//   choose_split: at most two blocks an SM, so the bf16 serve kernels'
//   blocks run in one wave); it never reads lengths. Each block reads lengths[b] itself and
//   takes positions [split * share, split * share + share) below the
//   length, share = ceil(len / n_split) rounded up to the 64-position chunk.
//   A block whose share is empty writes the partial (m = NEG_INF, l = 0,
//   acc = 0), which the combine gives weight 0.
// - The cache stays in its own dtype in shared memory: 64-position chunks of
//   K and V arrive by 16-byte cp.async copies (zero-filled past the share)
//   in a ring of three stages (two where a row is 256 bytes or more), so
//   the next chunks load while this one computes. The 16-byte chunk c of
//   row j sits at c ^ (j % 8), so the threads reading one chunk index of
//   eight consecutive rows hit eight different bank groups.
// - A thread owns a tile of GT query rows (GT = 4; 1 when G = 1) times
//   EPT = two 16-byte chunks of D: q's part and the output's part sit in
//   its registers as f32, with its own online-softmax state (m, l, acc).
//   NL = D / EPT threads share a position: each K row it reads is widened
//   once and used for GT dot products, summed over the NL threads by warp
//   shuffles; then one max / rescale step for PB positions and the V rows
//   into acc. No thread waits for another inside a chunk: the one
//   __syncthreads a chunk guards the ring. The 128 / n_items thread subsets
//   (js) each take every js-th position and are merged pairwise at the end
//   (log2 js rounds through shared memory), as the combine merges splits.
//   Visibility is an explicit flag (a position past the share contributes
//   p = 0), so a state that has seen no visible key keeps l = 0.
// - Every block writes its f32 partial (m, l, acc) to the scratch the
//   wrapper allocates, and decode_combine_kernel (a thread an output
//   element) rescales each live split by exp(m_i - M) and divides by the
//   summed l, also when n_split = 1 (one output path). Splits with l = 0
//   get weight 0 (the finite NEG_INF never becomes exp(0) = 1); l = 0
//   overall gives zeros.

#include "attn_common.cuh"
#include "tc_common.cuh"

namespace {

using attn::NEG_INF;

constexpr int THREADS = 128;
constexpr int BKV = 64;          // cache positions per chunk
constexpr int MAX_GD = 2048;     // G * D
constexpr int MAX_SPLIT = 32;    // chunked_attention.py::MAX_SPLIT

template <typename T, int D, int GT>
struct Geo {
  static constexpr int CH = 16 / sizeof(T);     // elements in a 16-byte chunk
  static constexpr int NC = D / CH;             // chunks in a cache row (>= 8)
  static constexpr int CPT = 2;                 // 16-byte chunks of D a thread owns
  static constexpr int EPT = CPT * CH;          // elements of D a thread owns
  static constexpr int NL = D / EPT;            // threads on one position
  static constexpr int PB = GT == 1 ? 4 : 2;    // positions a thread takes at once
  static constexpr int STAGES = D * sizeof(T) <= 128 ? 3 : 2;
  static constexpr int STAGE = 2 * BKV * D;     // elements: K, then V
  static constexpr int STATE = GT * EPT + 2 * GT;   // floats of one thread's state
  static_assert(NC >= 8, "the swizzle needs 8 chunks a row");
  static_assert(THREADS * STATE * sizeof(float) <= STAGES * STAGE * sizeof(T),
                "the subset merge reuses the ring");
};

__device__ __forceinline__ int split_share(int len, int n_split) {
  return ((len + n_split - 1) / n_split + BKV - 1) / BKV * BKV;
}

// fold the online-softmax state (m2, l2, acc2) into (m, l, acc); a state
// with l = 0 has seen no visible key and gets weight 0
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l, float* acc, float m2, float l2,
                                            const float* acc2) {
  float mm = NEG_INF;
  if (l > 0.f) mm = m;
  if (l2 > 0.f) mm = fmaxf(mm, m2);
  const float w1 = l > 0.f ? expf(m - mm) : 0.f;
  const float w2 = l2 > 0.f ? expf(m2 - mm) : 0.f;
  m = mm;
  l = w1 * l + w2 * l2;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = w1 * acc[e] + w2 * acc2[e];
}

template <typename T, int D, int GT>
__global__ void __launch_bounds__(THREADS)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        float* __restrict__ part, int S, int Hkv, int G, float scale) {
  using Gm = Geo<T, D, GT>;
  constexpr int CH = Gm::CH, CPT = Gm::CPT, EPT = Gm::EPT, NL = Gm::NL, PB = Gm::PB;
  constexpr int STAGES = Gm::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);   // [STAGES][2][BKV][D]

  const int tid = threadIdx.x;
  const int split = blockIdx.x, n_split = gridDim.x, hk = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), S);
  const int share = split_share(len, n_split);
  const int start = min(split * share, len), end = min(start + share, len);
  const int n_chunks = (end - start + BKV - 1) / BKV;
  const int64_t bh = (int64_t)b * Hkv + hk;

  // item (tile of GT query rows, EPT elements of D): NL consecutive threads
  // share a position; js subsets of n_items threads each take every js-th
  // position of a chunk (threads past js * n_items run masked)
  const int n_items = (G + GT - 1) / GT * NL;   // <= THREADS: G * D <= 2048
  const int js = THREADS / n_items;
  const int jsub = tid / n_items;
  const int item = tid % n_items, g0 = item / NL * GT, cl = item % NL;
  float qf[GT][EPT], acc[GT][EPT], m[GT], l[GT];
#pragma unroll
  for (int gt = 0; gt < GT; ++gt) {
    const int g = g0 + gt;
#pragma unroll
    for (int h = 0; h < CPT; ++h) {
      if (g < G) {
        attn::load_vec(q + (bh * G + g) * D + cl * EPT + h * CH, qf[gt] + h * CH);
      } else {
#pragma unroll
        for (int e = 0; e < CH; ++e) qf[gt][h * CH + e] = 0.f;
      }
    }
    m[gt] = NEG_INF;
    l[gt] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[gt][e] = 0.f;
  }

  const int64_t pos_stride = (int64_t)Hkv * D;
  const int64_t base = (int64_t)b * S * pos_stride + (int64_t)hk * D;
  auto load_chunk = [&](int ci) {
    if (ci < n_chunks) {
      T* ks = ring + (ci % STAGES) * Gm::STAGE;
      T* vs = ks + BKV * D;
      const int p0 = start + ci * BKV;
      for (int i = tid; i < BKV * Gm::NC; i += THREADS) {
        const int j = i / Gm::NC, cc = i % Gm::NC;
        const bool valid = p0 + j < end;
        const int64_t off = valid ? base + (p0 + j) * pos_stride + cc * CH : 0;
        const int dst = j * D + tc::swz(j, cc) * CH;
        tc::cp_async16(tc::smem_addr(ks + dst), k + off, valid);
        tc::cp_async16(tc::smem_addr(vs + dst), v + off, valid);
      }
    }
    tc::cp_async_commit();   // an empty group past the end keeps the count uniform
  };
  // this thread's EPT elements of row j (CPT swizzled 16-byte chunks), as f32
  auto row = [&](const T* tile, int j, float* out) {
#pragma unroll
    for (int h = 0; h < CPT; ++h)
      attn::load_vec(tile + j * D + tc::swz(j, CPT * cl + h) * CH, out + h * CH);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) load_chunk(st);

  const int per_sub = (BKV + js - 1) / js;   // positions of a chunk a subset visits
  for (int ci = 0; ci < n_chunks; ++ci) {
    tc::cp_async_wait<STAGES - 2>();   // this thread's copies of chunk ci landed
    __syncthreads();                   // everyone's; chunk ci - 1 fully consumed
    load_chunk(ci + STAGES - 1);       // into the stage chunk ci - 1 used
    const T* ks = ring + (ci % STAGES) * Gm::STAGE;
    const T* vs = ks + BKV * D;
    const int live_end = end - (start + ci * BKV);   // positions j < live_end are visible

    for (int i0 = 0; i0 < per_sub; i0 += PB) {
      // PB positions: GT x PB partial dot products over this thread's EPT
      // elements, summed over the NL threads of the position
      float sc[GT][PB];
      int jp[PB];
      bool live[PB];
#pragma unroll
      for (int pb = 0; pb < PB; ++pb) {
        const int j = jsub + js * (i0 + pb);
        live[pb] = i0 + pb < per_sub && j < BKV && j < live_end && jsub < js;
        jp[pb] = min(j, BKV - 1);
        float kf[EPT];
        row(ks, jp[pb], kf);
#pragma unroll
        for (int gt = 0; gt < GT; ++gt) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < EPT; ++e) d = fmaf(qf[gt][e], kf[e], d);
          sc[gt][pb] = d;
        }
      }
#pragma unroll
      for (int off = NL / 2; off > 0; off /= 2)
#pragma unroll
        for (int gt = 0; gt < GT; ++gt)
#pragma unroll
          for (int pb = 0; pb < PB; ++pb)
            sc[gt][pb] += __shfl_xor_sync(0xffffffffu, sc[gt][pb], off);
      // one online-softmax step per query row
      float p[GT][PB];
#pragma unroll
      for (int gt = 0; gt < GT; ++gt) {
        float mx = NEG_INF;
#pragma unroll
        for (int pb = 0; pb < PB; ++pb) {
          sc[gt][pb] *= scale;
          if (live[pb]) mx = fmaxf(mx, sc[gt][pb]);
        }
        const float m_new = fmaxf(m[gt], mx);
        const float alpha = expf(m[gt] - m_new);
        m[gt] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int pb = 0; pb < PB; ++pb) {
          p[gt][pb] = live[pb] ? expf(sc[gt][pb] - m_new) : 0.f;
          psum += p[gt][pb];
        }
        l[gt] = l[gt] * alpha + psum;
#pragma unroll
        for (int e = 0; e < EPT; ++e) acc[gt][e] *= alpha;
      }
#pragma unroll
      for (int pb = 0; pb < PB; ++pb) {
        float vf[EPT];
        row(vs, jp[pb], vf);
#pragma unroll
        for (int gt = 0; gt < GT; ++gt)
#pragma unroll
          for (int e = 0; e < EPT; ++e) acc[gt][e] = fmaf(p[gt][pb], vf[e], acc[gt][e]);
      }
    }
  }
  tc::cp_async_wait<0>();

  // merge the js subsets' states pairwise into subset 0 (log2 js rounds)
  float* red = reinterpret_cast<float*>(smem);   // [THREADS][STATE], reuses the ring
  for (int w = 1; w < js; w *= 2) {
    __syncthreads();   // the ring (first round) or the last round's reads are done
    if (jsub < js && jsub % (2 * w) == w) {
      float* r = red + tid * Gm::STATE;
#pragma unroll
      for (int gt = 0; gt < GT; ++gt) {
#pragma unroll
        for (int e = 0; e < EPT; ++e) r[gt * EPT + e] = acc[gt][e];
        r[GT * EPT + gt] = m[gt];
        r[GT * EPT + GT + gt] = l[gt];
      }
    }
    __syncthreads();
    if (jsub % (2 * w) == 0 && jsub + w < js) {
      const float* r = red + (tid + w * n_items) * Gm::STATE;
#pragma unroll
      for (int gt = 0; gt < GT; ++gt)
        merge_state<EPT>(m[gt], l[gt], acc[gt], r[GT * EPT + gt], r[GT * EPT + GT + gt],
                         r + gt * EPT);
    }
  }
  if (jsub != 0) return;

  // the partial: acc [B Hkv][n_split][G D], then m and l [B Hkv][n_split][G]
  const int64_t n_bh = (int64_t)gridDim.z * Hkv;
  float* pa = part + (bh * n_split + split) * G * D;
  float* pm = part + n_bh * n_split * G * D + (bh * n_split + split) * G;
  float* pl = pm + n_bh * n_split * G;
#pragma unroll
  for (int gt = 0; gt < GT; ++gt) {
    if (g0 + gt < G) {
#pragma unroll
      for (int e = 0; e < EPT; ++e) pa[(g0 + gt) * D + cl * EPT + e] = acc[gt][e];
      if (cl == 0) {
        pm[g0 + gt] = m[gt];
        pl[g0 + gt] = l[gt];
      }
    }
  }
}

// one thread an output element: the live splits' weights exp(m_i - M),
// recomputed by each thread from the (cached) m and l of its row
template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_combine_kernel(const float* __restrict__ part, T* __restrict__ o, int G, int D,
                          int n_split, int64_t n_bh) {
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;   // over B Hkv G D
  if (idx >= n_bh * G * D) return;
  const int64_t bh = idx / (G * D);
  const int gd = (int)(idx % (G * D)), g = gd / D;
  const float* pa = part + bh * n_split * G * D + gd;
  const float* pm = part + n_bh * n_split * G * D + bh * n_split * G + g;
  const float* pl = pm + n_bh * n_split * G;
  float mm = NEG_INF;
  for (int i = 0; i < n_split; ++i)
    if (pl[i * G] > 0.f) mm = fmaxf(mm, pm[i * G]);
  float ll = 0.f, s = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float li = pl[i * G];
    const float w = li > 0.f ? expf(pm[i * G] - mm) : 0.f;
    ll = fmaf(w, li, ll);
    s = fmaf(w, pa[(int64_t)i * G * D], s);
  }
  attn::store(o + idx, ll > 0.f ? s / ll : 0.f);
}

template <typename T, int D, int GT>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o,
           float* part, int B, int S, int Hkv, int G, int n_split, cudaStream_t stream) {
  using Gm = Geo<T, D, GT>;
  const size_t smem = Gm::STAGES * Gm::STAGE * sizeof(T);
  cudaError_t err = tc::allow_smem(decode_split_kernel<T, D, GT>, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)D));
  decode_split_kernel<T, D, GT><<<dim3(n_split, Hkv, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      part, S, Hkv, G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_bh = (int64_t)B * Hkv;
  const unsigned blocks = (unsigned)((n_bh * G * D + THREADS - 1) / THREADS);
  decode_combine_kernel<T><<<blocks, THREADS, 0, stream>>>(part, static_cast<T*>(o), G, D,
                                                           n_split, n_bh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const int* lengths, void* o,
             float* part, int B, int S, int Hkv, int G, int D, int n_split,
             cudaStream_t stream) {
  // one query row a thread for G = 1, else tiles of four
  if (D == 64 && G == 1)
    return launch<T, 64, 1>(q, k, v, lengths, o, part, B, S, Hkv, G, n_split, stream);
  if (D == 64) return launch<T, 64, 4>(q, k, v, lengths, o, part, B, S, Hkv, G, n_split, stream);
  if (D == 128 && G == 1)
    return launch<T, 128, 1>(q, k, v, lengths, o, part, B, S, Hkv, G, n_split, stream);
  if (D == 128)
    return launch<T, 128, 4>(q, k, v, lengths, o, part, B, S, Hkv, G, n_split, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). D is 64 or
// 128 (the head widths of the ported configs), G * D at most 2048, n_split
// in [1, 32]. part: f32 scratch of B Hkv n_split G (D + 2) floats. One
// call launches the split kernel, then the combine.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* lengths, void* o, void* part, int B,
                                       int S, int Hkv, int G, int D, int dtype, int n_split,
                                       void* stream) {
  if (B < 0 || S < 0 || Hkv < 0 || G < 0 || G * D > MAX_GD || n_split < 1 ||
      n_split > MAX_SPLIT || part == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0 || G == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  float* p = static_cast<float*>(part);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, lengths, o, p, B, S, Hkv, G, D, n_split, s);
  return launch_d<float>(q, k, v, lengths, o, p, B, S, Hkv, G, D, n_split, s);
}

extern "C" const char* decode_attention_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
