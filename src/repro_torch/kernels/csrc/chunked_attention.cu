// Length-masked GQA decode attention (one query token per sequence), sm_90a.
//
// Replaces: decode_attention (src/repro/kernels/chunked_attention.py:62),
// whose pallas_call walked a grid (B, Hkv, S / bs_kv) with the S axis
// sequential: the [G, D] queries of one KV head and their f32 online-softmax
// state (m, l, acc) stayed in VMEM while [bs_kv, D] chunks of the K and V
// cache streamed in, positions >= lengths[b] (scalar-prefetched) masked with
// the finite NEG_INF. Here the S axis is a loop inside the block, and
// lengths is a plain argument.
//
// Layout as the reference: q [B, Hkv, G, D], k and v [B, S, Hkv, D] (the
// cache), lengths int32 [B]; out [B, Hkv, G, D] in q's dtype (f32 or bf16,
// widened to f32; every sum in f32). Position p of sequence b is visible iff
// p < lengths[b].
//
// Bound on this card: bytes. Each visible cache position is read once for
// 4 D G operations per KV head, a few operations a byte against the card's
// ~295 (bf16 tensor cores) or ~20 (f32), so the least time is the live K and
// V bytes over 3.35 TB/s. Design: one block of 256 threads per (KV head,
// batch). The G queries sit in shared memory as f32, each thread owns
// G D / 256 outputs in registers, and the (m, l) state of the G rows sits in
// shared memory. The cache streams through shared memory in chunks of 128
// positions (K rows padded to D + 1 floats, so the threads of a warp, on 32
// consecutive positions, read 32 banks), loaded as 16-byte vectors; a warp
// per query row takes the chunk's max and sum. The loop stops at the chunk
// holding position lengths[b] - 1 instead of masking whole dead chunks: once
// a live key is seen, NEG_INF terms add exp(NEG_INF - m) = 0, so the result
// is the same. lengths[b] = 0 gives zeros. What the design leaves on the
// table: B x Hkv blocks (64 at the serve run's batch of 8 with 8 KV heads)
// fill under half of the 132 SMs, and each block waits on one chunk's loads
// before it computes; splitting S across blocks with a second combine pass
// (flash-decoding proper) and double-buffered chunks are the redesign.

#include "attn_common.cuh"

namespace {

using attn::NEG_INF;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BKV = 128;       // cache positions per chunk
constexpr int MAX_OUT = 8;     // outputs per thread: G * D <= THREADS * MAX_OUT

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const int* __restrict__ lengths,
                            T* __restrict__ o, int S, int Hkv, int G, float scale) {
  constexpr int N = attn::Pack<T>::N;
  constexpr int KS = D + 1;
  extern __shared__ float sh[];
  float* ks = sh;                  // [BKV][D + 1]
  float* vs = ks + BKV * KS;       // [BKV][D]
  float* qs = vs + BKV * D;        // [G][D]
  float* ps = qs + G * D;          // [G][BKV]
  float* m_s = ps + G * BKV;       // [G] running max
  float* l_s = m_s + G;            // [G] running sum
  float* a_s = l_s + G;            // [G] this chunk's rescale

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int len = min(max(lengths[b], 0), S);
  const int n_out = G * D;

  const T* qb = q + ((int64_t)b * Hkv + hk) * G * D;
  for (int i = tid; i < n_out / N; i += THREADS) attn::load_vec(qb + i * N, qs + i * N);
  for (int i = tid; i < G; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int t = 0; t < MAX_OUT; ++t) acc[t] = 0.f;

  const int64_t pos_stride = (int64_t)Hkv * D;
  const int64_t base = ((int64_t)b * S * Hkv + hk) * D;
  for (int k0 = 0; k0 < len; k0 += BKV) {
    __syncthreads();  // the previous chunk's reads are done (and qs is set)
    for (int i = tid; i < BKV * (D / N); i += THREADS) {
      const int j = i / (D / N), d = (i % (D / N)) * N;
      float kv[N], vv[N];
      if (k0 + j < len) {
        const int64_t off = base + (k0 + j) * pos_stride + d;
        attn::load_vec(k + off, kv);
        attn::load_vec(v + off, vv);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < N; ++e) {
        ks[j * KS + d + e] = kv[e];
        vs[j * D + d + e] = vv[e];
      }
    }
    __syncthreads();

    for (int i = tid; i < G * BKV; i += THREADS) {
      const int gi = i / BKV, j = i % BKV;
      const float* qr = qs + gi * D;
      const float* kr = ks + j * KS;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      ps[i] = k0 + j < len ? dot * scale : NEG_INF;
    }
    __syncthreads();

    for (int gi = warp; gi < G; gi += WARPS) {
      float* pr = ps + gi * BKV;
      float mx = NEG_INF;
      for (int j = lane; j < BKV; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BKV; j += 32) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < MAX_OUT; ++t) {
      const int i = tid + t * THREADS;
      if (i < n_out) {
        const int gi = i / D, d = i % D;
        const float* pr = ps + gi * BKV;
        float a = acc[t] * a_s[gi];
        for (int j = 0; j < BKV; ++j) a = fmaf(pr[j], vs[j * D + d], a);
        acc[t] = a;
      }
    }
  }
  __syncthreads();
  T* ob = o + ((int64_t)b * Hkv + hk) * G * D;
#pragma unroll
  for (int t = 0; t < MAX_OUT; ++t) {
    const int i = tid + t * THREADS;
    if (i < n_out) attn::store(ob + i, acc[t] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o,
           int B, int S, int Hkv, int G, cudaStream_t stream) {
  const size_t smem =
      (size_t)(BKV * (D + 1) + BKV * D + G * D + G * BKV + 3 * G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)Hkv, (unsigned)B);
  const float scale = (float)(1.0 / sqrt((double)D));
  decode_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(o), S, Hkv, G, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const int* lengths, void* o,
             int B, int S, int Hkv, int G, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, lengths, o, B, S, Hkv, G, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, o, B, S, Hkv, G, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). D is 64 or
// 128 (the head widths of the ported configs), and G * D at most 2048.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* lengths, void* o, int B, int S,
                                       int Hkv, int G, int D, int dtype, void* stream) {
  if (B < 0 || S < 0 || Hkv < 0 || G < 0 || G * D > THREADS * MAX_OUT)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0 || G == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, lengths, o, B, S, Hkv, G, D, s);
  return launch_d<float>(q, k, v, lengths, o, B, S, Hkv, G, D, s);
}

extern "C" const char* decode_attention_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
