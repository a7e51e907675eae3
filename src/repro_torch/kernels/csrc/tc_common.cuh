// Helpers shared by the bf16 tensor-core routes of flash_prefill.cu and
// grouped_matmul.cu (sm_90a): 16-byte cp.async copies that zero-fill a
// source outside the operand, ldmatrix (plain and transposed), the bf16
// mma.sync.m16n8k16 with f32 accumulation, bf16 packing, the 128-byte
// swizzle of the shared-memory tiles, and the dynamic shared memory limit.
// The cp.async rings of chunked_attention.cu and ranged_spgemm.cu use the
// copies, the swizzle and the limit too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst, or 16 zero bytes when !valid (the
// source is then not read: a src-size of 0 fills the whole copy with zeros)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and receives element [l / 4][2 (l % 4) + {0, 1}] of each (of its
// transpose with .trans)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: a 16 x 16 (row-major fragment), b 16 x 8 (column-major), bf16
// operands, f32 accumulator. Fragments (g = lane / 4, q = lane % 4): a[0]
// rows g, columns 2q, 2q + 1; a[1] rows g + 8; a[2] columns + 8; a[3] both;
// b0 rows 2q, 2q + 1 of column g, b1 those rows + 8; d[0..1] row g, columns
// 2q, 2q + 1, d[2..3] row g + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half (the lower
// address, the lower column of a fragment pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// The 16-byte chunk c of row r of a tile whose rows are whole 128-byte
// lines (or several): the chunk index XOR r % 8, so that the eight rows an
// ldmatrix reads (or a column of chunks) fall in eight different bank groups.
// For rows of 128 bytes at a 1024-byte aligned base this is the 128-byte
// swizzle of wgmma's shared-memory layouts.
__device__ __forceinline__ int swz(int r, int c) { return c ^ (r & 7); }

// raise a kernel's dynamic shared memory limit past the 48 KB default
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace tc
