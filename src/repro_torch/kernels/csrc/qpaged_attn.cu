// Attention over a paged int8 KV cache: decode, and chunked prefill with
// quantize-on-write into the pool.
//
// Replaces repro/kernels/qpaged_attn.py::qpaged_decode_attn_pallas and
// ::qpaged_chunk_attn_pallas.  The cache is a pool k, v (P, ps, Hkv, D) int8
// on the pow2 grid 2^-k_n / 2^-v_n, shared by every slot, and a page table:
// a slot's logical position p lives at row p % ps of pool page
// table[p / ps]; -1 marks an unmapped entry.  Neither kernel takes a
// scalar-prefetch grid: each block reads the table entries of the positions
// it loads.
//
// qpaged_decode_attn: q (B, Hq, D) f32, table (B, max_pages) int32, per-slot
// live length kv_len; out (B, Hq, D) f32, Hq = G * Hkv.  The reads are the
// Pallas kernel's: pages 0 .. min((kv_len - 1) / ps, max_pages - 1) are
// visited (page 0 alone when kv_len <= 0), so the walk stops at the table's
// end even when an inactive slot's length has ticked past it; an unmapped
// entry reads pool page 0 (jnp.maximum(page, 0)) and never faults; positions
// >= kv_len are masked with -1e30, and the output is acc / max(l, 1e-30).
//
// qpaged_chunk_attn: chunk q (C, Hq, D) f32 and k, v (C, Hkv, D) f32, the
// target slot's table row (max_pages,) and start.  Logical rows [start,
// start + C) are quantized as qformat.quantize does (x * 2^n, truncated
// toward zero, saturated to [-128, 127]) and written into their pool pages;
// a row whose table entry is -1, or whose position lies at or past
// max_pages * ps, is dropped (the chunk-padding tail), and every other pool
// byte is left as it was.  Chunk query c attends logical positions <=
// start + c below max_pages * ps, through the table, after the write: the
// plain version's scatter-then-gather.  A position whose entry is -1 reads
// pool page 0, or the chunk row this launch writes there.  Each (head, row)
// is written by exactly one block.  A table that maps one pool page at two
// logical pages has no defined result (the scheduler never builds one).
//
// Bound on an H100: bytes.  Decode reads the live rows' int8 K/V, 2 * len *
// Hkv * D bytes per slot and layer, at about one multiply-add per byte; the
// chunk reads the slot's int8 prefix and the f32 chunk.  The table adds 4
// bytes per page.  Positions, not pages, are the unit of both walks, so any
// page size >= 1 takes the same path.
//
// Decode design (attn_split::decode, the body qdecode_attn.cu's dense
// cache runs too): one cluster of R blocks per (KV head, slot), grid
// (Hkv * R, B).  Each rank reads kv_len, computes the visited range above,
// and walks its contiguous run of whole tiles of it over cp.async-staged
// rows, each group of lanes an online softmax of its own; the ranks' (m, l,
// acc) are folded through distributed shared memory and one launch writes
// out.  R comes from shapes alone (kernels/attn_split.py: the table's
// reach, B and Hkv, never kv_len), so a call makes no host sync and is
// safe in a CUDA graph.
//
// Chunk design (chunk_split.cuh, shared with qchunk_attn.cu's dense cache):
// one cluster of R blocks per (query tile, KV head); a query tile's rows
// times their G heads on the bf16x3 tensor cores, the prefix each tile sees
// split across the cluster, R from shapes alone (attn_split.py::chunk_ranks:
// the table's reach, tiles x Hkv and D, never start), one launch per call.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_split.cuh"
#include "chunk_split.cuh"

namespace {

constexpr int kMaxG = 16;

// ---------------------------------------------------------------------------
// Decode (attn_split::decode)
// ---------------------------------------------------------------------------

template <int D, int KG>
// G <= 4: two blocks an SM (at most 128 registers), as a cluster needs its
// ranks resident at once
__global__ void __launch_bounds__(attn_split::kThreads, KG <= 4 ? 2 : 1)
qpaged_decode_kernel(const attn_split::DecodeArgs a) {
  attn_split::decode<D, KG>(a);
}

// The G bucket's instantiation: 4 query heads a group, or 16.
template <int D>
cudaError_t decode_by_g(const attn_split::DecodeArgs& a, int B, int ranks, cudaStream_t st) {
  using attn_split::launch_decode;
  return a.G <= 4 ? launch_decode<D, 4, qpaged_decode_kernel<D, 4>>(a, B, ranks, st)
                  : launch_decode<D, 16, qpaged_decode_kernel<D, 16>>(a, B, ranks, st);
}

// ---------------------------------------------------------------------------
// Chunked prefill (chunk_split.cuh)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(attn_split::kThreads)
qpaged_chunk_kernel(const chunk_split::Args a) {
  chunk_split::chunk<D>(a);
}

}  // namespace

// Exponents and the live length come from device memory (non-null pointer;
// kv_len_stride 1 for a (B,) vector, 0 for one shared value) or by value.
// Takes D in {16, 32, 64, 128}, G <= 16, ps >= 1, max_pages >= 1, B <= 65535,
// 1 <= ranks <= 8 (the cluster that splits each walk) and 16-byte aligned
// pools.  Returns the launch's error (cudaErrorInvalidValue for arguments
// it does not take).
extern "C" int qpaged_decode_attn_f32_s8(const float* q, const int8_t* k, const int8_t* v,
                                         const int* k_n_ptr, int k_n_val,
                                         const int* v_n_ptr, int v_n_val, const int* table,
                                         const int* kv_len_ptr, int kv_len_stride,
                                         int kv_len_val, float* out, int B, int ps,
                                         int max_pages, int Hkv, int G, int D,
                                         float sm_scale, int ranks, void* stream) {
  const attn_split::DecodeArgs a = {q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                                    kv_len_ptr, kv_len_stride, kv_len_val, out, ps,
                                    max_pages, Hkv, G, sm_scale};
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

// The exponents and start come from device memory (non-null pointer) or by
// value.  Takes D in {16, 32, 64, 128}, G <= 16, C >= 1, ps >= 1,
// max_pages >= 1, start >= 0, 1 <= ranks <= 8 (the cluster that splits each
// tile's prefix; kernels/attn_split.py::chunk_ranks) and 16-byte aligned
// pools; rows outside the table are dropped, not refused.  Returns the
// launch's error (cudaErrorInvalidValue for arguments it does not take).
extern "C" int qpaged_chunk_attn_f32_s8(const float* q, const float* kc, const float* vc,
                                        int8_t* k, int8_t* v, const int* k_n_ptr,
                                        int k_n_val, const int* v_n_ptr, int v_n_val,
                                        const int* trow, const int* start_ptr, int start_val,
                                        float* out, int C, int ps, int max_pages, int Hkv,
                                        int G, int D, float sm_scale, int ranks, void* stream) {
  if (G > kMaxG || G < 1 || C < 1 || Hkv < 1 || Hkv > 65535 || ps < 1 || max_pages < 1 ||
      (!start_ptr && start_val < 0) || ranks < 1 || ranks > attn_split::kMaxRanks ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const chunk_split::Args a = {q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val,
                               trow, 0, start_ptr, start_val, out, C, ps, max_pages, Hkv, G,
                               chunk_split::query_rows(C, G), sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (D) {
    case 16: e = chunk_split::launch<16, qpaged_chunk_kernel<16>>(a, ranks, st); break;
    case 32: e = chunk_split::launch<32, qpaged_chunk_kernel<32>>(a, ranks, st); break;
    case 64: e = chunk_split::launch<64, qpaged_chunk_kernel<64>>(a, ranks, st); break;
    case 128: e = chunk_split::launch<128, qpaged_chunk_kernel<128>>(a, ranks, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
