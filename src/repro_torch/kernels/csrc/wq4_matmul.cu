// Packed int4 weight-only matmul:
//   out (M, N) = sum_k x[m, k] * nibble[k, n] * scale[k / block_size, n]
// with x (M, K) f32, the weight as (ceil(K/2), N) int8 bytes whose byte row
// j holds logical rows 2j (low nibble) and 2j+1 (high nibble) in two's
// complement, and scale f32 2^-n per output channel (1, N) or per block of
// block_size K rows (ceil(K/block_size), N).
//
// Replaces repro/kernels/wq_matmul.py::wq4_matmul_pallas.  As there, only
// int4 bytes and the scale grid come from device memory and each weight
// tile is unpacked on chip; unlike there, a block scale is not applied to
// the weights before the products (the reference's 2^-n table is inexact
// at |n| >= 13, so nibble * scale is not exact in bf16): each block's
// products are summed apart and scaled once.  The kernel is the bf16
// tensor-core GEMM of wq_gemm.cuh at every M, one launch per call with K
// split across a thread-block cluster; its bound and design are there.
// Every edge (M, N, odd K, a partial block, any even block_size) is
// masked; x is never read past column K, and rows past K weigh zero.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wq_gemm.cuh"

namespace {

template <int BM>
__global__ void __launch_bounds__(wq_gemm::NT)
wq4_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, int scale_stride, int block_size,
                  float* __restrict__ out, int M, int K, int N, int k_per_rank, int vec_x,
                  int vec_w) {
  wq_gemm::gemm<BM, true>(x, w, scale, scale_stride, block_size, out, M, K, N, k_per_rank,
                          vec_x, vec_w);
}

int grants = 0;   // cudaFuncSetAttribute calls of this library (wq_gemm::grant)

}  // namespace

// x (M, K) f32, w (ceil(K/2), N) int8, scale (1, N) f32 when block_size is 0
// or (ceil(K/block_size), N) f32, all row-major and contiguous; out (M, N)
// f32.  bm (16, 32 or 64), ranks and k_per_rank are the tiling of
// kernels/wq_gemm.py.  Returns the launch's error (cudaErrorInvalidValue,
// with no launch, for a tiling that does not fit the call or an odd or
// negative block_size).
extern "C" int wq4_matmul_f32_s4(const float* x, const int8_t* w, const float* scale,
                                 int block_size, float* out, int M, int K, int N, int bm,
                                 int ranks, int k_per_rank, void* stream) {
  return static_cast<int>(
      wq_gemm::launch<true, wq4_matmul_kernel<16>, wq4_matmul_kernel<32>, wq4_matmul_kernel<64>>(
          grants, x, w, scale, 1, block_size, out, M, K, N, bm, ranks, k_per_rank,
          static_cast<cudaStream_t>(stream)));
}

// The cudaFuncSetAttribute calls this library has made: one per tile kernel
// it has launched, at most 3.
extern "C" int wq4_matmul_grants() { return grants; }
