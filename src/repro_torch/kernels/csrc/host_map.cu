// The device address of an operand in pinned host memory.
//
// Replaces: no TPU kernel; it holds none. The reference's streaming kernels take their
// streamed operand with memory_space=ANY (src/repro/kernels/ranged_spgemm.py,
// sparse_accum_spgemm.py, hash_accum_spgemm.py), and a slow operand there is
// in pinned_host memory (src/repro/core/placement.py, place(x, "slow")): the
// kernel DMAs from it where it lies. Here the same operand is read in place
// by the port's kernels through the address the card maps it at. PyTorch's
// pinned memory may come from cudaHostAlloc (mapped at the host address
// under unified addressing) or from cudaHostRegister (mapped elsewhere
// where the card cannot use the host address), so the address is asked of
// the runtime and checked twice: cudaHostGetDevicePointer gives it, and
// cudaPointerGetAttributes must agree that the memory is host memory mapped
// at that address. Memory that is not mapped (pageable, or on a card) is an
// error; nothing falls back to a copy.
//
// Bound on this card: none; no device code. Two runtime queries on the host
// for each operand a launch reads in place.

#include <cuda_runtime.h>
#include <stdint.h>

// host: an address inside a pinned allocation. On success *device is the
// address a kernel reads it at, and 0 is returned; else a CUDA error code
// (cudaErrorInvalidValue where the two queries disagree or the memory is not
// host memory). *mem_type is cudaPointerAttributes::type where it was read.
extern "C" int host_device_pointer(void* host, void** device, int* mem_type) {
  *device = nullptr;
  *mem_type = -1;
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, host);
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear the error the failed query left
    return (int)err;
  }
  *mem_type = (int)attr.type;
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return (int)cudaErrorInvalidValue;
  void* mapped = nullptr;
  err = cudaHostGetDevicePointer(&mapped, host, 0);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  if (mapped != attr.devicePointer) return (int)cudaErrorInvalidValue;
  *device = mapped;
  return 0;
}

extern "C" const char* host_device_pointer_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
