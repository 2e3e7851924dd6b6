// Ragged token-batch attention into an int8 KV pool, with quantize-on-write:
// one launch per layer serves a whole ragged tick.
//
// Replaces repro/kernels/qragged_attn.py::qragged_attn_pallas.  A tick
// flattens every live slot's decode token and up to L prompt chunks into T
// tokens: q (T, Hq, D) f32, k/v new (T, Hkv, D) f32, and per token a slot
// (slot_ids) and a logical row (positions; -1 marks an inert row).  The
// cache is a pool k, v (P, ps, Hkv, D) int8 on the pow2 grid 2^-k_n / 2^-v_n
// and a page table (slots, max_pages) int32 (-1 unmapped): logical row p of
// slot s lives at row p % ps of pool page table[s][p / ps].  A dense
// (B, S, Hkv, D) cache is the pool of B pages of S rows under the identity
// table (B, 1), so one kernel serves both layouts.
//
// What it computes, as ref.qragged_attn_ref does: token t's K/V row is
// quantized as qformat.quantize does (x * 2^n, truncated toward zero,
// saturated to [-128, 127]) and written at logical row positions[t] of slot
// slot_ids[t]; a row with position < 0, past the table or on a -1 entry is
// dropped.  Token t's G query heads of KV head h then attend the slot's
// mapped positions <= positions[t] (below max_pages * ps) with an online
// softmax, after every write of the tick.  Inert rows write nothing and
// output exact zeros, as does a row that sees no mapped position.
//
// Ordering.  The Pallas kernel re-merges every batch row of its slot into
// each page it visits; here blocks run in no order, so no block reads a pool
// row that any block of the launch writes: a position that a batch row of
// the same slot writes this tick takes that row's K/V, quantized in the
// block from the f32 inputs, and only the others are read from the pool.
// So a slot may carry a decode row and chunk rows in one tick.  Each
// written (row, KV head) is stored by exactly one block, rank 0 of the
// token's own cluster.  Two batch rows at one (slot, position), a table
// that maps one pool page at two logical pages, or a write through a page
// that another slot also maps (the scheduler's assert_private_write keeps
// them out) have no defined result.
//
// Bound on an H100: bytes.  The tick must read each slot's visible int8
// prefix once, 2 * len * Hkv * D bytes, at about one multiply-add per byte
// per query head.  Its time is its longest walk: a decode row at the end of
// a long slot.
//
// Design (attn_split.cuh): one cluster of R blocks per (KV head, token),
// grid (Hkv * R, T); R comes from shapes alone (kernels/attn_split.py: the
// table's reach, T and Hkv, never the positions).  Each rank walks its run
// of whole tiles of [0, s_end) over cp.async-staged rows, each group of
// lanes an online softmax of its own, and the ranks' (m, l, acc) are
// folded through distributed shared memory.  At the start each block scans
// the T tokens once for the lowest position its slot writes this tick
// (wmin); only a warp step that reaches wmin scans them again, to mark the
// positions that take a batch row.  An inert token is inert for every rank
// of its cluster: all of them write their slice of zeros and leave before
// any barrier.  A slot's chunk tokens still re-read the same prefix rows
// (from L2 after the first): sharing one prefix walk between them, as the
// chunk kernels do, is not done here.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attn_split.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxG = 16;

template <int D, int KG>
// G <= 4: two blocks an SM (at most 128 registers), as a cluster needs its
// ranks resident at once
__global__ void __launch_bounds__(attn_split::kThreads, KG <= 4 ? 2 : 1)
qragged_kernel(const float* __restrict__ q, const float* __restrict__ kc,
               const float* __restrict__ vc, int8_t* k, int8_t* v,
               const int* __restrict__ k_n_ptr, int k_n_val, const int* __restrict__ v_n_ptr,
               int v_n_val, const int* __restrict__ table, const int* __restrict__ slot_ids,
               const int* __restrict__ positions, float* __restrict__ out, int T, int ps,
               int max_pages, int Hkv, int G, float sm_scale) {
  using Gm = attn_split::Geom<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<attn_split::Smem<D, KG>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / ranks;
  const int t = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32;
  const int Hq = Hkv * G;
  const int my_pos = __ldg(positions + t);
  float* ob = out + ((size_t)t * Hq + (size_t)h * G) * D;
  if (my_pos < 0) {  // inert: every rank of the cluster leaves here, before any barrier
    for (int e = rank * G * D / ranks + tid; e < (rank + 1) * G * D / ranks;
         e += attn_split::kThreads)
      ob[e] = 0.f;
    return;
  }
  const int slot = __ldg(slot_ids + t);
  const int k_n = k_n_ptr ? *k_n_ptr : k_n_val;
  const int v_n = v_n_ptr ? *v_n_ptr : v_n_val;

  attn_split::Walk wk = {};
  wk.kh = k + (size_t)h * D;
  wk.vh = v + (size_t)h * D;
  wk.trow = table + (size_t)slot * max_pages;
  wk.row = (size_t)Hkv * D;   // elements between consecutive token or pool rows
  wk.page_elems = (size_t)ps * wk.row;
  wk.ps = ps;
  wk.len = INT_MAX;
  wk.k_scale = exp2f(-static_cast<float>(k_n));
  wk.v_scale = exp2f(-static_cast<float>(v_n));
  wk.k_inv = exp2f(static_cast<float>(k_n));
  wk.v_inv = exp2f(static_cast<float>(v_n));
  wk.sm_scale = sm_scale;
  wk.kc = kc + (size_t)h * D;
  wk.vc = vc + (size_t)h * D;
  wk.slot_ids = slot_ids;
  wk.positions = positions;
  wk.T = T;
  wk.slot = slot;

  // this token's own row: quantized and stored by rank 0 alone; no block of
  // the launch reads it back from the pool
  const int my_lp = my_pos / ps;
  if (rank == 0 && my_lp < max_pages) {
    const int page = __ldg(wk.trow + my_lp);
    if (page >= 0) {
      const size_t off = (size_t)page * wk.page_elems +
                         (size_t)(my_pos - my_lp * ps) * wk.row + (size_t)h * D;
      for (int d = tid; d < D; d += attn_split::kThreads) {
        k[off + d] = attn_split::quantize_i8(wk.kc[(size_t)t * wk.row + d], wk.k_inv);
        v[off + d] = attn_split::quantize_i8(wk.vc[(size_t)t * wk.row + d], wk.v_inv);
      }
    }
  }

  // the lowest position a row of this slot writes this tick
  if (tid == 0) sm.wmin = INT_MAX;
  __syncthreads();
  int lowest = INT_MAX;
  for (int u = tid; u < T; u += attn_split::kThreads) {
    const int pu = __ldg(positions + u);
    if (pu >= 0 && __ldg(slot_ids + u) == slot) lowest = min(lowest, pu);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lowest = min(lowest, __shfl_xor_sync(0xffffffffu, lowest, off));
  if (lane == 0 && lowest != INT_MAX) atomicMin(&sm.wmin, lowest);
  __syncthreads();
  wk.wmin = sm.wmin;

  // visible positions [0, s_end): through the token's own, never past the table
  const int s_end = min(my_pos + 1, max_pages * ps);
  attn_split::rank_range(s_end, Gm::BS, rank, ranks, wk.lo, wk.hi);

  const float* qb = q + ((size_t)t * Hq + (size_t)h * G) * D;
  // this lane's 8 dimensions of q, times 2^-k_n (exact)
  const int d0 = (lane % Gm::LPP) * 8;
  float qv[KG][8], acc[KG][8], m[KG], l[KG];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    m[g] = attn_split::kMasked;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      qv[g][j] = g < G ? qb[g * D + d0 + j] * wk.k_scale : 0.f;
      acc[g][j] = 0.f;
    }
  }
  attn_split::walk<D, KG, true>(sm, wk, G, qv, acc, m, l);
  attn_split::combine<D, KG>(sm, G, wk.v_scale, acc, m, l, ob);
}

template <int D, int KG>
cudaError_t launch(const float* q, const float* kc, const float* vc, int8_t* k, int8_t* v,
                   const int* k_n_ptr, int k_n_val, const int* v_n_ptr, int v_n_val,
                   const int* table, const int* slot_ids, const int* positions, float* out,
                   int T, int ps, int max_pages, int Hkv, int G, float sm_scale, int ranks,
                   cudaStream_t stream) {
  constexpr size_t smem = sizeof(attn_split::Smem<D, KG>);
  static const cudaError_t granted = attn_split::grant(qragged_kernel<D, KG>, smem);
  if (granted != cudaSuccess) return granted;
  return attn_split::launch(qragged_kernel<D, KG>, dim3(Hkv * ranks, T), ranks, smem, stream,
                            q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                            slot_ids, positions, out, T, ps, max_pages, Hkv, G, sm_scale);
}

template <int KG>
cudaError_t dispatch(const float* q, const float* kc, const float* vc, int8_t* k, int8_t* v,
                     const int* k_n_ptr, int k_n_val, const int* v_n_ptr, int v_n_val,
                     const int* table, const int* slot_ids, const int* positions, float* out,
                     int T, int ps, int max_pages, int Hkv, int G, int D, float sm_scale,
                     int ranks, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<16, KG>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                            slot_ids, positions, out, T, ps, max_pages, Hkv, G, sm_scale,
                            ranks, st);
    case 32:
      return launch<32, KG>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                            slot_ids, positions, out, T, ps, max_pages, Hkv, G, sm_scale,
                            ranks, st);
    case 64:
      return launch<64, KG>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                            slot_ids, positions, out, T, ps, max_pages, Hkv, G, sm_scale,
                            ranks, st);
    case 128:
      return launch<128, KG>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                             slot_ids, positions, out, T, ps, max_pages, Hkv, G, sm_scale,
                             ranks, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The exponents come from device memory (non-null pointer) or by value.
// Takes D in {16, 32, 64, 128}, G <= 16, ps >= 1, max_pages >= 1, T <= 65535,
// 1 <= ranks <= 8 (the cluster that splits each walk) and 16-byte aligned
// pools; slot ids must index the table's rows.  Returns the launch's error
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int qragged_attn_f32_s8(const float* q, const float* kc, const float* vc,
                                   int8_t* k, int8_t* v, const int* k_n_ptr, int k_n_val,
                                   const int* v_n_ptr, int v_n_val, const int* table,
                                   const int* slot_ids, const int* positions, float* out,
                                   int T, int ps, int max_pages, int Hkv, int G, int D,
                                   float sm_scale, int ranks, void* stream) {
  if (G > kMaxG || G < 1 || Hkv < 1 || ps < 1 || max_pages < 1 || T > 65535 || ranks < 1 ||
      ranks > attn_split::kMaxRanks || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      G <= 4 ? dispatch<4>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table, slot_ids,
                           positions, out, T, ps, max_pages, Hkv, G, D, sm_scale, ranks, st)
             : dispatch<16>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table,
                            slot_ids, positions, out, T, ps, max_pages, Hkv, G, D, sm_scale,
                            ranks, st);
  return static_cast<int>(e);
}
