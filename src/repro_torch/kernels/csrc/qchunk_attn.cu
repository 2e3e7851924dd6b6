// Chunked-prefill attention into one slot of a dense int8 KV cache.
//
// Replaces repro/kernels/qchunk_attn.py::qchunk_attn_pallas.
// q (C, Hq, D) f32 and the chunk's k, v (C, Hkv, D) f32, all RoPE'd; caches
// k, v (B, S, Hkv, D) int8 on the pow2 grid 2^-k_n / 2^-v_n.  The chunk's
// K/V rows are quantized as qformat.quantize does (x * 2^n, truncated toward
// zero, saturated to [-128, 127]) and written into rows [start, start + C) of
// batch row `slot`; chunk query c attends positions <= start + c of that
// slot (the slot's prefix, then the chunk causally).  out (C, Hq, D) f32.
// Every other row and slot is left byte for byte as it was.
//
// The cache is a pool of page size S under the one-entry table row {slot},
// run by the chunk core of chunk_split.cuh (which qpaged_attn.cu's chunk
// kernel shares): a query tile on the bf16x3 tensor cores, the slot's
// prefix split across a thread-block cluster of `ranks` blocks, one launch
// per call.  The core's note gives the design and the bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_split.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(chunk_split::kThreads)
qchunk_attn_kernel(const chunk_split::Args a) {
  chunk_split::chunk<D>(a);
}

}  // namespace

// Exponents come from device memory (non-null pointer) or by value.  Takes
// D in {16, 32, 64, 128}, G <= 16, 1 <= ranks <= 8 (the cluster that splits
// each tile's prefix; kernels/attn_split.py::chunk_ranks), 16-byte aligned
// caches and a chunk inside the cache (0 <= slot < B, 0 <= start, start + C
// <= S).  Returns the launch's error (cudaErrorInvalidValue for arguments
// it does not take).
extern "C" int qchunk_attn_f32_s8(const float* q, const float* kc, const float* vc, int8_t* k,
                                  int8_t* v, const int* k_n_ptr, int k_n_val,
                                  const int* v_n_ptr, int v_n_val, float* out, int B, int C,
                                  int S, int Hkv, int G, int D, int slot, int start,
                                  float sm_scale, int ranks, void* stream) {
  if (G > chunk_split::kMaxG || G < 1 || C < 1 || Hkv < 1 || Hkv > 65535 || slot < 0 ||
      slot >= B || start < 0 || start + C > S || ranks < 1 || ranks > attn_split::kMaxRanks ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const chunk_split::Args a = {q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val,
                               nullptr, slot, nullptr, start, out, C, S, 1, Hkv, G,
                               chunk_split::query_rows(C, G), sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (D) {
    case 16: e = chunk_split::launch<16, qchunk_attn_kernel<16>>(a, ranks, st); break;
    case 32: e = chunk_split::launch<32, qchunk_attn_kernel<32>>(a, ranks, st); break;
    case 64: e = chunk_split::launch<64, qchunk_attn_kernel<64>>(a, ranks, st); break;
    case 128: e = chunk_split::launch<128, qchunk_attn_kernel<128>>(a, ranks, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
