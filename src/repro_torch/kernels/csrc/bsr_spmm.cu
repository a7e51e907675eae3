// Block-sparse times dense (BSR x dense) SpMM for sm_90a.
//
// Replaces: bsr_spmm_blocks (src/repro/kernels/bsr_spmm.py), whose
// pallas_call walked a grid (mb, nf / bn, U) with scalar-prefetched slot
// and block-column tables: Y[i-block, tile] = sum over u of
// A_blk[a_slots[i, u]] @ X[a_cols[i, u] * bs : + bs, tile], in an f32 VMEM
// accumulator written once per output tile.
//
// Bound on this card: the function does 2 d nf operations per output row
// (d values stored per A row, the blocks' zeros included) against about
// 4 d + 8 nf bytes (A read once, X read and Y written once), and the card
// does about 20 f32 operations per byte of memory traffic, so it is bound
// by operations when 2 d nf / (4 d + 8 nf) > 20: at brick3d n=48 with
// bs = 8 and nf = 128 (d about 187, 27 operations a byte), and by bytes for
// narrow X or sparse rows. This kernel moves more than that: every A block
// is read once per column tile and every X row slab once per A block that
// names it, so at 8 x 8 blocks each X element it reads feeds only bs
// multiply-adds. The grid is (block row, bn-wide column tile,
// sub-tile): a block of threads holds bs rows x tc columns (tc <= bn,
// tc * bs <= 1024) and walks u, staging the A block (bs x bs) and the X
// slab (bs x tc) in shared memory; each thread keeps its output element's
// f32 sum in a register and writes it once. Steps on the zero-sentinel slot
// (a block row with fewer blocks than u_max) are skipped; the TPU kernel
// multiplied the all-zero block instead, which adds nothing. The slot and
// column tables are plain kernel arguments. Inputs are f32 or bf16 and are
// widened to f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void bsr_spmm_kernel(const T* a_blocks, const T* x,
                                const int* a_slots, const int* a_cols,
                                float* y, int u_max, int bs, int nf, int bn,
                                int a_zero) {
  extern __shared__ __align__(16) float sh[];
  const int tc = blockDim.x;
  float* a_s = sh;             // [bs, bs]
  float* x_s = sh + bs * bs;   // [bs, tc]
  const int i_blk = blockIdx.x;
  const int col0 = blockIdx.y * bn + blockIdx.z * tc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * tc + tx, n_threads = tc * bs;
  const int jx = col0 + tx;
  const int tile_end = min(blockIdx.y * bn + bn, nf);
  const long long tile = (long long)bs * bs;
  float acc = 0.f;
  for (int u = 0; u < u_max; ++u) {
    const int slot = a_slots[(long long)i_blk * u_max + u];
    if (slot == a_zero) continue;   // uniform across the block
    const long long xrow0 = (long long)a_cols[(long long)i_blk * u_max + u] * bs;
    for (int t = tid; t < bs * bs; t += n_threads) a_s[t] = widen(a_blocks[slot * tile + t]);
    for (int t = tid; t < bs * tc; t += n_threads) {
      const int k = t / tc, c = col0 + t % tc;
      x_s[t] = c < tile_end ? widen(x[(xrow0 + k) * nf + c]) : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < bs; ++k) acc = fmaf(a_s[ty * bs + k], x_s[k * tc + tx], acc);
    __syncthreads();
  }
  if (jx < tile_end) y[((long long)i_blk * bs + ty) * nf + jx] = acc;
}

template <typename T>
int launch(const void* a_blocks, const void* x, const int* a_slots,
           const int* a_cols, float* y, int mb, int u_max, int bs, int nf,
           int bn, int a_zero, cudaStream_t stream) {
  if (mb == 0 || nf == 0) return (int)cudaGetLastError();
  int tc = bn;
  while (tc * bs > 1024 && tc > 1) tc = (tc + 1) / 2;
  const dim3 grid((unsigned)mb, (unsigned)((nf + bn - 1) / bn),
                  (unsigned)((bn + tc - 1) / tc));
  const dim3 threads(tc, bs);
  const size_t smem = (size_t)(bs * bs + bs * tc) * sizeof(float);
  bsr_spmm_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a_blocks), static_cast<const T*>(x), a_slots,
      a_cols, y, u_max, bs, nf, bn, a_zero);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 blocks and X, 1 = bfloat16; Y is float32.
extern "C" int bsr_spmm_launch(const void* a_blocks, const void* x,
                               const int* a_slots, const int* a_cols, float* y,
                               int mb, int u_max, int bs, int nf, int bn,
                               int a_zero, int dtype, void* stream) {
  if (bs < 1 || bs > 32 || bn < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(a_blocks, x, a_slots, a_cols, y, mb, u_max,
                                 bs, nf, bn, a_zero, s);
  return launch<float>(a_blocks, x, a_slots, a_cols, y, mb, u_max, bs, nf, bn,
                       a_zero, s);
}

extern "C" const char* bsr_spmm_launch_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
