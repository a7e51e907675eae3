// Helpers of the attention kernels: the finite mask value (flash_prefill.cu
// and chunked_attention.cu), 16-byte vector loads widened to f32 and stores
// that round f32 to the tensor's dtype (chunked_attention.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace attn {

// The finite mask value of the TPU kernels: a row whose visible keys all
// come later accumulates exp(0) terms that the first visible key rescales by
// exp(NEG_INF - m) = 0, where -inf would give exp(-inf + inf) = NaN.
constexpr float NEG_INF = -1e30f;

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;  // elements in 16 bytes
  __device__ __forceinline__ static void unpack(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the high half of the f32 with the same value, so widening is
  // exact; the element at the lower address sits in the low half of a word
  __device__ __forceinline__ static void unpack(const uint4& u, float* out) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// N consecutive elements at p (16-byte aligned) as f32
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  Pack<T>::unpack(*reinterpret_cast<const uint4*>(p), out);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

}  // namespace attn
