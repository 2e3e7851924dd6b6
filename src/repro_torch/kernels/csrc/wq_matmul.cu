// Weight-only int8 matmul: out (M, N) = (x (M, K) f32 @ w (K, N) int8) * scale.
//
// Replaces repro/kernels/wq_matmul.py::wq_matmul_pallas.  The weight stays
// int8 in device memory.  The pow2 scale (per output channel, or one for
// the tensor) commutes with the sum, so it is applied once in the epilogue.
// Every edge (M, K, N not multiples of a tile) is masked.  The kernel is
// the bf16 tensor-core GEMM of wq_gemm.cuh at every M, one launch per call
// with K split across a thread-block cluster; the bound and the design are
// in that header.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wq_gemm.cuh"

namespace {

template <int BM>
__global__ void __launch_bounds__(wq_gemm::NT)
wq_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, int scale_stride, int block_size,
                 float* __restrict__ out, int M, int K, int N, int k_per_rank, int vec_x,
                 int vec_w) {
  wq_gemm::gemm<BM, false>(x, w, scale, scale_stride, block_size, out, M, K, N, k_per_rank,
                           vec_x, vec_w);
}

int grants = 0;   // cudaFuncSetAttribute calls of this library (wq_gemm::grant)

}  // namespace

// x (M, K) f32, w (K, N) int8, both row-major and contiguous; scale has N
// entries (scale_stride 1) or one (scale_stride 0); out (M, N) f32.
// bm (16, 32 or 64), ranks and k_per_rank are the tiling of
// kernels/wq_gemm.py.  Returns the launch's error (cudaErrorInvalidValue,
// with no launch, for a tiling that does not fit the call).
extern "C" int wq_matmul_f32_s8(const float* x, const int8_t* w, const float* scale,
                                int scale_stride, float* out, int M, int K, int N, int bm,
                                int ranks, int k_per_rank, void* stream) {
  return static_cast<int>(
      wq_gemm::launch<false, wq_matmul_kernel<16>, wq_matmul_kernel<32>, wq_matmul_kernel<64>>(
          grants, x, w, scale, scale_stride, 0, out, M, K, N, bm, ranks, k_per_rank,
          static_cast<cudaStream_t>(stream)));
}

// The cudaFuncSetAttribute calls this library has made: one per tile kernel
// it has launched, at most 3.
extern "C" int wq_matmul_grants() { return grants; }
