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
// Decode design (attn_split.cuh): one cluster of R blocks per (KV head,
// slot), grid (Hkv * R, B).  Each rank reads kv_len, computes the visited
// range above, and walks its contiguous run of whole tiles of it over
// cp.async-staged rows, each group of lanes an online softmax of its own;
// the ranks' (m, l, acc) are folded through distributed shared memory and one
// launch writes out.  R comes from shapes alone (kernels/attn_split.py:
// the table's reach, B and Hkv, never kv_len), so a call makes no host
// sync and is safe in a CUDA graph.
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

namespace cg = cooperative_groups;
using attn_split::kMasked;
using attn_split::kThreads;

constexpr int kMaxG = 16;

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

template <int D, int KG>
// G <= 4: two blocks an SM (at most 128 registers), as a cluster needs its
// ranks resident at once
__global__ void __launch_bounds__(kThreads, KG <= 4 ? 2 : 1)
qpaged_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
                     const int8_t* __restrict__ v, const int* __restrict__ k_n_ptr,
                     int k_n_val, const int* __restrict__ v_n_ptr, int v_n_val,
                     const int* __restrict__ table, const int* __restrict__ kv_len_ptr,
                     int kv_len_stride, int kv_len_val, float* __restrict__ out, int ps,
                     int max_pages, int Hkv, int G, float sm_scale) {
  using Gm = attn_split::Geom<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<attn_split::Smem<D, KG>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.x / ranks;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int Hq = Hkv * G;
  const int len = kv_len_ptr ? kv_len_ptr[(size_t)b * kv_len_stride] : kv_len_val;
  // pages the Pallas kernel visits: through the last live one (page 0 when
  // the slot is empty), never past the table
  const int last = min(max((len - 1) / ps, 0), max_pages - 1);
  const int n_walk = (last + 1) * ps;
  const int s_end = len > 0 ? min(len, n_walk) : n_walk;

  attn_split::Walk wk = {};
  wk.kh = k + (size_t)h * D;
  wk.vh = v + (size_t)h * D;
  wk.trow = table + (size_t)b * max_pages;
  wk.row = (size_t)Hkv * D;
  wk.page_elems = (size_t)ps * wk.row;
  wk.ps = ps;
  attn_split::rank_range(s_end, Gm::BS, static_cast<int>(cluster.block_rank()), ranks, wk.lo,
                         wk.hi);
  wk.len = len;
  wk.k_scale = exp2f(-static_cast<float>(k_n_ptr ? *k_n_ptr : k_n_val));
  wk.v_scale = exp2f(-static_cast<float>(v_n_ptr ? *v_n_ptr : v_n_val));
  wk.sm_scale = sm_scale;

  const float* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  // this lane's 8 dimensions of q, times 2^-k_n (exact)
  const int d0 = (lane % Gm::LPP) * 8;
  float qv[KG][8], acc[KG][8], m[KG], l[KG];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    m[g] = kMasked;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      qv[g][j] = g < G ? qb[g * D + d0 + j] * wk.k_scale : 0.f;
      acc[g][j] = 0.f;
    }
  }
  attn_split::walk<D, KG, false>(sm, wk, G, qv, acc, m, l);
  attn_split::combine<D, KG>(sm, G, wk.v_scale, acc, m, l,
                             out + ((size_t)b * Hq + (size_t)h * G) * D);
}

// ---------------------------------------------------------------------------
// Chunked prefill (chunk_split.cuh)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) qpaged_chunk_kernel(const chunk_split::Args a) {
  chunk_split::chunk<D>(a);
}

template <int D, int KG>
cudaError_t launch_decode(const float* q, const int8_t* k, const int8_t* v, const int* k_n_ptr,
                          int k_n_val, const int* v_n_ptr, int v_n_val, const int* table,
                          const int* kv_len_ptr, int kv_len_stride, int kv_len_val, float* out,
                          int B, int ps, int max_pages, int Hkv, int G, float sm_scale,
                          int ranks, cudaStream_t stream) {
  constexpr size_t smem = sizeof(attn_split::Smem<D, KG>);
  static const cudaError_t granted = attn_split::grant(qpaged_decode_kernel<D, KG>, smem);
  if (granted != cudaSuccess) return granted;
  return attn_split::launch(qpaged_decode_kernel<D, KG>, dim3(Hkv * ranks, B), ranks, smem,
                            stream, q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                            kv_len_ptr, kv_len_stride, kv_len_val, out, ps, max_pages, Hkv, G,
                            sm_scale);
}

template <int KG>
cudaError_t dispatch_decode(const float* q, const int8_t* k, const int8_t* v,
                            const int* k_n_ptr, int k_n_val, const int* v_n_ptr, int v_n_val,
                            const int* table, const int* kv_len_ptr, int kv_len_stride,
                            int kv_len_val, float* out, int B, int ps, int max_pages, int Hkv,
                            int G, int D, float sm_scale, int ranks, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch_decode<16, KG>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                                   kv_len_ptr, kv_len_stride, kv_len_val, out, B, ps,
                                   max_pages, Hkv, G, sm_scale, ranks, st);
    case 32:
      return launch_decode<32, KG>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                                   kv_len_ptr, kv_len_stride, kv_len_val, out, B, ps,
                                   max_pages, Hkv, G, sm_scale, ranks, st);
    case 64:
      return launch_decode<64, KG>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                                   kv_len_ptr, kv_len_stride, kv_len_val, out, B, ps,
                                   max_pages, Hkv, G, sm_scale, ranks, st);
    case 128:
      return launch_decode<128, KG>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                                    kv_len_ptr, kv_len_stride, kv_len_val, out, B, ps,
                                    max_pages, Hkv, G, sm_scale, ranks, st);
    default:
      return cudaErrorInvalidValue;
  }
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
  if (G > kMaxG || G < 1 || ps < 1 || max_pages < 1 || B > 65535 || ranks < 1 ||
      ranks > attn_split::kMaxRanks ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Hkv <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      G <= 4 ? dispatch_decode<4>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                                  kv_len_ptr, kv_len_stride, kv_len_val, out, B, ps, max_pages,
                                  Hkv, G, D, sm_scale, ranks, st)
             : dispatch_decode<16>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                                   kv_len_ptr, kv_len_stride, kv_len_val, out, B, ps,
                                   max_pages, Hkv, G, D, sm_scale, ranks, st);
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
