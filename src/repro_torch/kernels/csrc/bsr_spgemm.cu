// Block-sparse (BSR x BSR) SpGEMM numeric phase for sm_90a.
//
// Replaces: bsr_spgemm_blocks (src/repro/kernels/bsr_spgemm.py), whose
// pallas_call walked a grid (nc_pad, u_max) with scalar-prefetched slot
// tables and an f32 VMEM accumulator per C block: for every C block e,
// out[e] = sum over u of A_blk[a_slots[e, u]] @ B_blk[b_slots[e, u]], steps
// whose A slot is the zero sentinel (index nbl_a, the appended all-zero
// block) skipped.
//
// Bound on this card: f32 operations for large blocks, bytes for the
// 8 x 8 blocks the chunked backend stages (2 bs^3 flops against 2 bs^2
// inputs read per contributor pair). One thread owns one element (i, j) of
// one C block and keeps its sum in a register across all u; a block of
// threads holds max(1, 256 / bs^2) C blocks. The slot tables are plain
// kernel arguments, each thread reading its C block's row. A and B tiles
// come from global memory (L1 serves the bs-fold reuse inside a C block).
// Inputs are f32 or bf16 and are widened to f32; products and sums are f32
// FMAs, so an f32 result matches the plain f32 version to rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void bsr_spgemm_kernel(const T* a_blocks, const T* b_blocks,
                                  const int* a_slots, const int* b_slots,
                                  float* out, int nc_pad, int u_max, int bs,
                                  int a_zero, int skip_zero) {
  const int e = blockIdx.x * blockDim.y + threadIdx.y;
  if (e >= nc_pad) return;
  const int tid = threadIdx.x;   // element of the C block
  const int i = tid / bs, j = tid % bs;
  const long long tile = (long long)bs * bs;
  const int* as = a_slots + (long long)e * u_max;
  const int* bsl = b_slots + (long long)e * u_max;
  float acc = 0.f;
  for (int u = 0; u < u_max; ++u) {
    const int sa = as[u];
    if (skip_zero && sa == a_zero) continue;
    const T* a = a_blocks + sa * tile + (long long)i * bs;
    const T* b = b_blocks + bsl[u] * tile + j;
    for (int k = 0; k < bs; ++k) acc = fmaf(widen(a[k]), widen(b[(long long)k * bs]), acc);
  }
  out[(long long)e * tile + tid] = acc;
}

template <typename T>
int launch(const void* a_blocks, const void* b_blocks, const int* a_slots,
           const int* b_slots, float* out, int nc_pad, int u_max, int bs,
           int a_zero, int skip_zero, cudaStream_t stream) {
  if (nc_pad == 0) return (int)cudaGetLastError();
  const int per_block = bs * bs >= 256 ? 1 : 256 / (bs * bs);
  const dim3 threads(bs * bs, per_block);
  const unsigned blocks = (unsigned)((nc_pad + per_block - 1) / per_block);
  bsr_spgemm_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(a_blocks), static_cast<const T*>(b_blocks), a_slots,
      b_slots, out, nc_pad, u_max, bs, a_zero, skip_zero);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 blocks, 1 = bfloat16 blocks; out is float32.
extern "C" int bsr_spgemm_launch(const void* a_blocks, const void* b_blocks,
                                 const int* a_slots, const int* b_slots,
                                 float* out, int nc_pad, int u_max, int bs,
                                 int a_zero, int skip_zero, int dtype,
                                 void* stream) {
  if (bs < 1 || bs > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(a_blocks, b_blocks, a_slots, b_slots, out,
                                 nc_pad, u_max, bs, a_zero, skip_zero, s);
  return launch<float>(a_blocks, b_blocks, a_slots, b_slots, out, nc_pad,
                       u_max, bs, a_zero, skip_zero, s);
}

extern "C" const char* bsr_spgemm_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
