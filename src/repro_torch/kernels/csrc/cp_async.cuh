// Shared-memory addresses and cp.async copies (global to shared, 16 bytes,
// zero-filled past the source's end), used by the tensor-core kernels'
// staging rings (wq_gemm.cuh, int_mma.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cp_async {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; bytes past `bytes` are zero-filled.
__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Until at most N of this thread's latest groups of copies are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace cp_async
