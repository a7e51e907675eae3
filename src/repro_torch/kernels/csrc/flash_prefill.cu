// Causal (optionally sliding-window) GQA flash attention for prefill, sm_90a.
//
// Replaces: flash_prefill (src/repro/kernels/flash_prefill.py:77), whose
// pallas_call walked a grid (B, Hkv, nQ, nK) with the K axis sequential:
// the online-softmax state (m, l, acc) of a [bq * g, d] Q tile (the g query
// heads of one KV head folded into the rows) sat in VMEM while [bk, d] K and
// V tiles streamed in, whole future tiles (and tiles behind the window) were
// skipped by pl.when, and the diagonal tile was masked elementwise with the
// finite NEG_INF. Here the sequential K axis is a loop inside the block.
//
// Layout as the reference: q [B, S, H, D], k and v [B, S, Hkv, D], out
// [B, S, H, D] in q's dtype (f32 or bf16, widened to f32; every sum in f32).
// Query row r of a block is position q0 + r / g of head hk * g + r % g.
//
// Bound on this card: 4 D operations per visible (query, key) pair and head
// against 2 D bytes per position and head of Q, K, V and O in bf16, so at
// D = 64 and prompts of thousands of tokens the function does hundreds of
// operations a byte and is bound by operations (989 TFLOP/s on the bf16
// tensor cores). This kernel does them as f32 FMAs (67 TFLOP/s without the
// tensor cores), so its own ceiling is that rate: a later kernel can move
// both products to mma/wgmma bf16 with f32 accumulation, which is exact for
// bf16 operands. Design: one block of 256 threads per (query tile, KV head,
// batch) with 64 query rows (bq = 64 / g positions times the g heads), four
// threads per row. A thread keeps its row's Q (D floats) and a quarter of
// its output (D / 4 floats) in registers, with the row's (m, l) state; K and
// V tiles of 64 keys are staged in shared memory as f32 (K rows padded to
// D + 1 floats, so the four threads of a row read four banks), and the
// probabilities of a tile go through shared memory (rows padded to 65) to
// the P V product. Shared memory is 49,664 bytes at D = 64 (K 16,640, V
// 16,384, P 16,640) and 82,432 at D = 128. The loop over key tiles starts at
// the first tile the window lets the tile's first row see and ends at the
// tile holding its last row: the work skip of pl.when, by loop bounds.
// Blocks are issued heaviest (last) query tile first. The kernel masks its
// own ragged edge, so any S works; offsets are 64-bit.

#include "attn_common.cuh"

namespace {

using attn::NEG_INF;

constexpr int ROWS = 64;              // query rows of a block
constexpr int TPR = 4;                // threads per row
constexpr int THREADS = ROWS * TPR;   // 256
constexpr int BK = 64;                // keys per tile

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int S,
                         int H, int Hkv, int g, int bq, int window,
                         float scale) {
  constexpr int N = attn::Pack<T>::N;
  constexpr int KS = D + 1;        // padded K row (floats)
  constexpr int PS = BK + 1;       // padded P row (floats)
  constexpr int DPT = D / TPR;     // output columns per thread
  constexpr int KPT = BK / TPR;    // keys per thread per tile
  extern __shared__ float sh[];
  float* ks = sh;                  // [BK][D + 1]
  float* vs = ks + BK * KS;        // [BK][D]
  float* ps = vs + BK * D;         // [ROWS][BK + 1]

  const int tid = threadIdx.x;
  const int row = tid / TPR, c = tid % TPR;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * bq;
  const int qpos = q0 + row / g;
  const int head = hk * g + row % g;
  const bool active = row < bq * g && qpos < S;

  float qr[D];
  if (active) {
    const T* src = q + (((int64_t)b * S + qpos) * H + head) * D;
#pragma unroll
    for (int d = 0; d < D; d += N) attn::load_vec(src + d, qr + d);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f, acc[DPT], s[KPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  const int q_last = min(q0 + bq, S) - 1;
  const int kt_hi = q_last / BK;
  const int kt_lo = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  const int64_t pos_stride = (int64_t)Hkv * D;
  const int64_t base = ((int64_t)b * S * Hkv + hk) * D;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of ks, vs and ps are done
    for (int i = tid; i < BK * (D / N); i += THREADS) {
      const int j = i / (D / N), d = (i % (D / N)) * N;
      float kv[N], vv[N];
      if (k0 + j < S) {
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

    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = c + TPR * i;
      const float* kr = ks + j * KS;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int kpos = k0 + j;
      const bool visible = kpos <= qpos && kpos < S &&
                           (window <= 0 || qpos - kpos < window);
      s[i] = visible ? dot * scale : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    // the four threads of a row are neighbouring lanes
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = expf(s[i] - m_new);
      rs += p;
      ps[row * PS + c + TPR * i] = p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * alpha + rs;
    m = m_new;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = ps[row * PS + j];
      const float* vr = vs + j * D + c;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vr[TPR * i], acc[i]);
    }
  }
  if (active) {
    T* dst = o + (((int64_t)b * S + qpos) * H + head) * D + c;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) attn::store(dst + TPR * i, acc[i] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int Hkv, int window, cudaStream_t stream) {
  const int g = H / Hkv;
  const int bq = ROWS / g;
  const size_t smem = (size_t)(BK * (D + 1) + BK * D + ROWS * (BK + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + bq - 1) / bq), (unsigned)Hkv, (unsigned)B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_prefill_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Hkv, g, bq, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int S,
             int H, int Hkv, int D, int window, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, Hkv, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, Hkv, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). window 0 is
// plain causal attention. D is 64 or 128 (the head widths of the ported
// configs); H / Hkv at most 64.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v,
                                    void* o, int B, int S, int H, int Hkv, int D,
                                    int window, int dtype, void* stream) {
  if (B < 0 || S < 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > ROWS || H == 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, D, window, s);
  return launch_d<float>(q, k, v, o, B, S, H, Hkv, D, window, s);
}

extern "C" const char* flash_prefill_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
