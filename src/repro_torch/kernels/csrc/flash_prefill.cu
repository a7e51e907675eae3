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
// [B, S, H, D] in q's dtype (f32 or bf16; every sum in f32).
//
// Bound on this card: 4 D operations per visible (query, key) pair and head
// against 2 D bytes per position and head of Q, K, V and O in bf16, so at
// D = 64 and prompts of thousands of tokens the function does hundreds of
// operations a byte and is bound by operations (989 TFLOP/s on the bf16
// tensor cores). Two routes, one for each dtype:
//
// "tc" (bf16): flash attention on the tensor cores, in the structure of
// FlashAttention-2 with mma.sync.m16n8k16 (bf16 operands, f32 accumulators;
// a bf16 x bf16 product is exact in f32, so only the summation order
// differs from the plain version). A block of 4 warps owns 64 query rows
// (GQA folded as below), 16 a warp. Q is copied once into shared memory and
// held as ldmatrix A fragments in registers. K and V tiles of 64 keys stay
// bf16 in shared memory (rows swizzled by 16-byte chunk, so ldmatrix reads
// no bank twice) and arrive by cp.async into a ring of two stages: the next
// tile loads while this one computes; keys past S are zero-filled by the
// copy. S = Q K^T stays in registers (ldmatrix of K rows gives the B
// fragments); the online softmax reduces each row over the 4 lanes of a
// quad; the masking is the FMA kernel's. P V: the plain version multiplies
// f32 P by V, and one bf16 rounding of P would move outputs near
// cancellation by more than the gate allows, so P is split into
// P_hi = bf16(P) and P_lo = bf16(P - P_hi) and both products accumulate in
// f32 (about 16 bits of P, 1.5x FlashAttention-2's MMA count). The S
// accumulators are already the A fragments of P V (P never goes through
// shared memory); V's B fragments come from ldmatrix.trans. Shared memory:
// Q 64 D plus 2 stages of K and V of 64 D each, bf16: 40 KB at D = 64,
// 80 KB at D = 128.
//
// "fma" (f32): every sum by f32 FMAs (67 TFLOP/s without the tensor
// cores, which have no f32-exact mode). An SM's shared memory gives 32
// words a clock against 128 FMAs, so one word read an FMA would cap the
// kernel near a quarter of that rate; the design is about FMAs per word
// read: one block of 256 threads per (query tile, KV head,
// batch) with 64 query rows, a 16 x 16 grid of threads. S = Q K^T: a
// thread computes 4 rows x 4 keys (rows 4 tr + i, keys tc + 16 j) in steps
// of 4 d from 16-byte reads of Q and K, 64 FMAs for 8 reads; Q is staged
// once and K and V tiles of 64 keys arrive by cp.async into a two-stage
// ring, so the next tile loads while this one computes (rows padded to D
// + 4 floats: the 16 keys a half-warp reads fall in distinct banks). The
// online softmax reduces a row's max over its 16 threads by shuffles; each
// thread keeps its part of the row sum, rescaled with the max each tile and
// added by a shuffle tree at the end. P goes through shared memory as P^T,
// and P V gives a thread 4 rows x D / 16 columns, 16 or 32 FMAs for one
// 16-byte read of P^T and one or two of V a key. Shared memory: 102,400
// bytes at D = 64 (two blocks an SM), 184,320 at D = 128 (one).
//
// Both: query row r of a block is position q0 + r / g of head hk * g + r % g
// (bq = 64 / g positions times the g heads). The loop over key tiles starts
// at the first tile the window lets the tile's first row see and ends at the
// tile holding its last row: the work skip of pl.when, by loop bounds.
// Blocks are issued heaviest (last) query tile first. The kernels mask
// their own ragged edge, so any S works; offsets are 64-bit; the output is
// acc / max(l, 1e-30), rounded once to the output dtype.

#include "attn_common.cuh"
#include "tc_common.cuh"

namespace {

using attn::NEG_INF;

constexpr int ROWS = 64;              // query rows of a block (both routes)
constexpr int BK = 64;                // keys per tile

// ---- route "fma": f32 on f32 FMAs -------------------------------------------

namespace ffma {

constexpr int THREADS = 256;          // 16 x 16: 4 rows x (4 keys or D / 16 columns) each
constexpr int PP = ROWS + 4;          // padded row of P^T (floats)

template <int D>
struct Layout {
  static constexpr int QP = D + 4;    // padded row of Q and K (floats)
  static constexpr int Q = 0;                       // [ROWS][QP]
  static constexpr int K = Q + ROWS * QP;           // [2][BK][QP]
  static constexpr int V = K + 2 * BK * QP;         // [2][BK][D]
  static constexpr int P = V + 2 * BK * D;          // [BK][PP]: P^T
  static constexpr size_t BYTES = (size_t)(P + BK * PP) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
    flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int S, int H,
                         int Hkv, int g, int bq, int window, float scale) {
  using L = Layout<D>;
  constexpr int QP = L::QP, C = D / 4;   // 16-byte chunks of a row
  constexpr int DC = D / 64;             // 4-column groups of the output a thread owns
  extern __shared__ __align__(16) float sh[];
  float* qs = sh + L::Q;
  float* ks = sh + L::K;
  float* vs = sh + L::V;
  float* ps = sh + L::P;

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;   // rows 4 tr + i; keys tc + 16 j
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * bq;

  // Q rows, zero past the block's bq * g rows or past S
  for (int i = tid; i < ROWS * C; i += THREADS) {
    const int r = i / C, c = i % C, pos = q0 + r / g;
    const bool valid = r < bq * g && pos < S;
    const float* src =
        q + (((int64_t)b * S + (valid ? pos : 0)) * H + hk * g + r % g) * D + c * 4;
    tc::cp_async16(tc::smem_addr(qs + r * QP + c * 4), src, valid);
  }
  tc::cp_async_commit();

  const int64_t pos_stride = (int64_t)Hkv * D;
  const int64_t base = ((int64_t)b * S * Hkv + hk) * D;
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * BK;
    for (int i = tid; i < BK * C; i += THREADS) {
      const int j = i / C, c = i % C;
      const bool valid = k0 + j < S;
      const int64_t off = base + (valid ? k0 + j : 0) * pos_stride + c * 4;
      tc::cp_async16(tc::smem_addr(ks + (st * BK + j) * QP + c * 4), k + off, valid);
      tc::cp_async16(tc::smem_addr(vs + (st * BK + j) * D + c * 4), v + off, valid);
    }
  };

  const int q_last = min(q0 + bq, S) - 1;
  const int kt_hi = q_last / BK;
  const int kt_lo = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  load_kv(kt_lo, 0);
  tc::cp_async_commit();

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = q0 + (4 * tr + i) / g;
  // per row: the running max (the same in the 16 threads of a row) and this
  // thread's part of the running sum (its keys tc + 16 j)
  float m[4], l[4], acc[4][4 * DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    if (kt < kt_hi) load_kv(kt + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();   // tile kt (and Q) has landed
    __syncthreads();
    const float* kst = ks + st * BK * QP;
    const float* vst = vs + st * BK * D;
    const int k0 = kt * BK;

    // S = Q K^T over d in steps of 4: 4 rows x 4 keys from 8 16-byte reads
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * tr + i) * QP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kst + (tc + 16 * j) * QP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale and mask, then the online softmax: a row's max over its 16
    // threads (lanes tc of one half-warp) by shuffles
    const bool full = k0 + BK - 1 <= q0 && k0 + BK <= S &&
                      (window <= 0 || q_last - k0 < window);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 16 * j;
        float x = s[i][j] * scale;
        if (!full) {
          const bool visible = kpos <= qpos[i] && kpos < S &&
                               (window <= 0 || qpos[i] - kpos < window);
          x = visible ? x : NEG_INF;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha[i] + rs;
    }
    // P^T: key tc + 16 j's row holds the probabilities of rows 4 tr .. 4 tr + 3
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (tc + 16 * j) * PP + 4 * tr) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // O = O alpha + P V: 4 rows x 4 DC columns (4 tc + 64 c + (0..3)) a
    // thread, a 16-byte read of P^T and DC of V a key
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4 * DC; ++c) acc[i][c] *= alpha[i];
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(ps + j * PP + 4 * tr);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vst + j * D + 64 * c + 4 * tc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c] = fmaf(pr[i], vv.x, acc[i][4 * c]);
          acc[i][4 * c + 1] = fmaf(pr[i], vv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pr[i], vv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pr[i], vv.w, acc[i][4 * c + 3]);
        }
      }
    }
    __syncthreads();  // every thread is done with stage st and P before they are refilled
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int r = 4 * tr + i;
    if (r >= bq * g || qpos[i] >= S) continue;
    float* dst = o + (((int64_t)b * S + qpos[i]) * H + hk * g + r % g) * D + 4 * tc;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      *reinterpret_cast<float4*>(dst + 64 * c) =
          make_float4(acc[i][4 * c] / den, acc[i][4 * c + 1] / den, acc[i][4 * c + 2] / den,
                      acc[i][4 * c + 3] / den);
  }
}

}  // namespace ffma

// ---- route "tc": bf16 on the tensor cores ---------------------------------

constexpr int TC_ROWS = 64;                 // query rows of a block
constexpr int TC_WARPS = TC_ROWS / 16;     // 16 query rows a warp
constexpr int TC_THREADS = 32 * TC_WARPS;  // 128

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
    flash_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, int S, int H, int Hkv, int g,
                            int bq, int window, float scale) {
  constexpr int C = D / 8;       // 16-byte chunks of a row
  constexpr int KD = D / 16;     // k16 steps of Q K^T
  constexpr int ND = D / 8;      // n8 tiles of the output
  constexpr int NK = BK / 8;     // n8 tiles of S (keys)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TC_ROWS][D]
  __nv_bfloat16* ks = qs + TC_ROWS * D;                              // [2][BK][D]
  __nv_bfloat16* vs = ks + 2 * BK * D;                               // [2][BK][D]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * bq;

  // Q rows, zero past the block's bq * g rows or past S
  for (int i = tid; i < TC_ROWS * C; i += TC_THREADS) {
    const int r = i / C, c = i % C, pos = q0 + r / g;
    const bool valid = r < bq * g && pos < S;
    const __nv_bfloat16* src =
        q + (((int64_t)b * S + (valid ? pos : 0)) * H + hk * g + r % g) * D + c * 8;
    tc::cp_async16(tc::smem_addr(qs + r * D + tc::swz(r, c) * 8), src, valid);
  }
  tc::cp_async_commit();

  const int64_t pos_stride = (int64_t)Hkv * D;
  const int64_t base = ((int64_t)b * S * Hkv + hk) * D;
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * BK;
    for (int i = tid; i < BK * C; i += TC_THREADS) {
      const int j = i / C, c = i % C;
      const bool valid = k0 + j < S;
      const int64_t off = base + (valid ? k0 + j : 0) * pos_stride + c * 8;
      const int dst = st * BK * D + j * D + tc::swz(j, c) * 8;
      tc::cp_async16(tc::smem_addr(ks + dst), k + off, valid);
      tc::cp_async16(tc::smem_addr(vs + dst), v + off, valid);
    }
  };

  const int q_last = min(q0 + bq, S) - 1;
  const int kt_hi = q_last / BK;
  const int kt_lo = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  load_kv(kt_lo, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // Q as A fragments: matrix i of ldmatrix.x4 is rows + 8 (i & 1), chunk + (i >> 1)
  uint32_t qf[KD][4];
  {
    const int i = lane / 8, r = warp * 16 + (i & 1) * 8 + lane % 8;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      tc::ldsm_x4(qf[kk], tc::smem_addr(qs + r * D + tc::swz(r, 2 * kk + (i >> 1)) * 8));
  }

  // this thread's two rows: warp * 16 + lane / 4 + 8 i
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = q0 + (warp * 16 + lane / 4 + 8 * i) / g;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's part
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    if (kt < kt_hi) load_kv(kt + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const __nv_bfloat16* kst = ks + st * BK * D;
    const __nv_bfloat16* vst = vs + st * BK * D;
    const int k0 = kt * BK;

    // S = Q K^T: matrix i is keys + 8 (i >> 1), chunk + (i & 1)
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NK / 2; ++n2) {
        const int i = lane / 8, key = n2 * 16 + (i >> 1) * 8 + lane % 8;
        uint32_t kb[4];
        tc::ldsm_x4(kb, tc::smem_addr(kst + key * D + tc::swz(key, 2 * kk + (i & 1)) * 8));
        tc::mma_bf16(s[2 * n2], qf[kk], kb[0], kb[1]);
        tc::mma_bf16(s[2 * n2 + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale and mask (the FMA kernel's rule), then the online softmax
    const bool full = k0 + BK - 1 <= q0 && k0 + BK <= S &&
                      (window <= 0 || q_last - k0 < window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, kpos = k0 + n * 8 + 2 * (lane % 4) + (e & 1);
        float x = s[n][e] * scale;
        if (!full) {
          const bool visible = kpos <= qpos[i] && kpos < S &&
                               (window <= 0 || qpos[i] - kpos < window);
          x = visible ? x : NEG_INF;
        }
        s[n][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e / 2]);
        l[e / 2] += p;
        s[n][e] = p;
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];

    // O += (P_hi + P_lo) V over 16 keys a step: the S tiles 2 kk and 2 kk + 1
    // are the A fragment; V's matrix i is keys + 8 (i & 1), chunk + (i >> 1)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float* pr = s[2 * kk + f / 2] + 2 * (f % 2);
        hi[f] = tc::pack_bf16(pr[0], pr[1]);
        lo[f] = tc::pack_bf16(pr[0] - tc::bf16_lo(hi[f]), pr[1] - tc::bf16_hi(hi[f]));
      }
#pragma unroll
      for (int n2 = 0; n2 < ND / 2; ++n2) {
        const int i = lane / 8, key = kk * 16 + (i & 1) * 8 + lane % 8;
        uint32_t vb[4];
        tc::ldsm_x4_t(vb, tc::smem_addr(vst + key * D + tc::swz(key, 2 * n2 + (i >> 1)) * 8));
        tc::mma_bf16(acc[2 * n2], hi, vb[0], vb[1]);
        tc::mma_bf16(acc[2 * n2], lo, vb[0], vb[1]);
        tc::mma_bf16(acc[2 * n2 + 1], hi, vb[2], vb[3]);
        tc::mma_bf16(acc[2 * n2 + 1], lo, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = warp * 16 + lane / 4 + 8 * i;
    if (r >= bq * g || qpos[i] >= S) continue;
    __nv_bfloat16* dst = o + (((int64_t)b * S + qpos[i]) * H + hk * g + r % g) * D +
                         2 * (lane % 4);
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          tc::pack_bf16(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
  }
}

// ---- launch -----------------------------------------------------------------

template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
               int Hkv, int window, cudaStream_t stream) {
  const int g = H / Hkv;
  const int bq = ROWS / g;
  constexpr size_t smem = ffma::Layout<D>::BYTES;
  static const cudaError_t attr = tc::allow_smem(ffma::flash_prefill_kernel<D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((S + bq - 1) / bq), (unsigned)Hkv, (unsigned)B);
  const float scale = (float)(1.0 / sqrt((double)D));
  ffma::flash_prefill_kernel<D><<<grid, ffma::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, H, Hkv, g, bq, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
              int Hkv, int window, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int g = H / Hkv;
  const int bq = TC_ROWS / g;
  const size_t smem = (size_t)(TC_ROWS + 4 * BK) * D * sizeof(bf);
  static const cudaError_t attr = tc::allow_smem(flash_prefill_tc_kernel<D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((S + bq - 1) / bq), (unsigned)Hkv, (unsigned)B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_prefill_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<bf*>(o), S, H, Hkv, g, bq, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core
// kernel); q, k, v and out share it. window 0 is plain causal attention. D
// is 64 or 128 (the head widths of the ported configs); H / Hkv at most 64.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v,
                                    void* o, int B, int S, int H, int Hkv, int D,
                                    int window, int dtype, void* stream) {
  if (B < 0 || S < 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > ROWS || H == 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != 1) {
    switch (D) {
      case 64: return launch_fma<64>(q, k, v, o, B, S, H, Hkv, window, s);
      case 128: return launch_fma<128>(q, k, v, o, B, S, H, Hkv, window, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 64: return launch_tc<64>(q, k, v, o, B, S, H, Hkv, window, s);
    case 128: return launch_tc<128>(q, k, v, o, B, S, H, Hkv, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_prefill_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
