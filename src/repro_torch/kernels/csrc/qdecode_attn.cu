// GQA decode attention over a dense int8 KV cache.
//
// Replaces repro/kernels/qdecode_attn.py::qdecode_attn_pallas.
// q (B, Hq, D) f32; k, v (B, S, Hkv, D) int8 on the pow2 grid 2^-k_n / 2^-v_n;
// per-row live length kv_len; out (B, Hq, D) f32.  Hq = G * Hkv.  As the
// Pallas kernel and the plain version do: positions >= kv_len score -1e30,
// the output is acc / max(l, 1e-30), and a row with kv_len <= 0 gives the
// mean of V over the whole cache row (every score masked); a length past S
// sees all of S.
//
// Design: the split walk of attn_split.cuh, the body qpaged_attn.cu's
// decode runs.  The dense cache is a pool of B pages of page size S, slot b
// pool page b under the one-entry table row {b} (a null table, ps = S,
// max_pages = 1), so the paged decode's visited range is [0, min(kv_len,
// S)), and [0, S) at kv_len <= 0: the dense semantics, and the same bytes
// read in the same order as qpaged_decode_attn under that table.  One
// cluster of R blocks per (KV head, slot), grid (Hkv * R, B); each rank
// walks its run of whole tiles through a cp.async ring per warp, lane
// groups of D / 8 lanes each an online softmax, folded by shuffles, warps
// and then ranks through distributed shared memory; one launch per call.
// R comes from shapes alone (kernels/attn_split.py::split_ranks(S, B, Hkv,
// D), never kv_len), so a call makes no host sync and is safe in a CUDA
// graph.
//
// Bound on an H100: bytes, the int8 K/V of the live rows, 2 * len * Hkv * D
// per slot and layer (all of S at kv_len <= 0); q.k and p.v are f32 FMAs
// on the CUDA cores, about one multiply-add per byte read.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_split.cuh"

namespace {

template <int D, int KG>
// G <= 4: two blocks an SM (at most 128 registers), as a cluster needs its
// ranks resident at once
__global__ void __launch_bounds__(attn_split::kThreads, KG <= 4 ? 2 : 1)
qdecode_attn_kernel(const attn_split::DecodeArgs a) {
  attn_split::decode<D, KG>(a);
}

// The G bucket's instantiation: 4 query heads a group, or 16.
template <int D>
cudaError_t decode_by_g(const attn_split::DecodeArgs& a, int B, int ranks, cudaStream_t st) {
  using attn_split::launch_decode;
  return a.G <= 4 ? launch_decode<D, 4, qdecode_attn_kernel<D, 4>>(a, B, ranks, st)
                  : launch_decode<D, 16, qdecode_attn_kernel<D, 16>>(a, B, ranks, st);
}

}  // namespace

// Exponents and the live length come from device memory (non-null pointer;
// kv_len_stride 1 for a (B,) vector, 0 for one shared value) or by value.
// Takes D in {16, 32, 64, 128}, G <= 16, S >= 1, B <= 65535, 1 <= ranks <= 8
// (the cluster that splits each walk) and 16-byte aligned caches.  Returns
// the launch's error (cudaErrorInvalidValue, with no launch, for arguments
// it does not take).
extern "C" int qdecode_attn_f32_s8(const float* q, const int8_t* k, const int8_t* v,
                                   const int* k_n_ptr, int k_n_val, const int* v_n_ptr,
                                   int v_n_val, const int* kv_len_ptr, int kv_len_stride,
                                   int kv_len_val, float* out, int B, int S, int Hkv,
                                   int G, int D, float sm_scale, int ranks, void* stream) {
  const attn_split::DecodeArgs a = {q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, nullptr,
                                    kv_len_ptr, kv_len_stride, kv_len_val, out, S, 1, Hkv, G,
                                    sm_scale};
  cudaError_t e = attn_split::check_decode(a, B, D, ranks);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B <= 0 || Hkv <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: e = decode_by_g<16>(a, B, ranks, st); break;
    case 32: e = decode_by_g<32>(a, B, ranks, st); break;
    case 64: e = decode_by_g<64>(a, B, ranks, st); break;
    default: e = decode_by_g<128>(a, B, ranks, st);
  }
  return static_cast<int>(e);
}
