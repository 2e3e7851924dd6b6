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
// plain version's scatter-then-gather.  One block per (KV head, tile of
// chunk rows), the dense qchunk_attn design: blocks run in no order, so no
// block reads a pool row that any block of the launch writes.  A chunk row's
// K/V are quantized in registers from the f32 inputs; a position whose entry
// is -1 reads pool page 0, or the chunk row this launch writes there.  Each
// (head, row) is written by exactly one block, the one owning the row.  A
// table that maps one pool page at two logical pages has no defined result
// (the scheduler never builds one).
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
// The chunk kernel runs one block per (KV head, tile of chunk rows) and
// walks the prefix serially.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_split.cuh"

namespace {

namespace cg = cooperative_groups;
using attn_split::kMasked;
using attn_split::kThreads;
using attn_split::quantize_i8;

constexpr int kMaxG = 16;
constexpr int kMaxQ = 32;  // chunk kernel: queries (chunk rows x group heads) per block

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
// Chunked prefill
// ---------------------------------------------------------------------------

template <int D, int BS>
__global__ void __launch_bounds__(kThreads)
qpaged_chunk_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                    const float* __restrict__ vc, int8_t* __restrict__ k,
                    int8_t* __restrict__ v, const int* __restrict__ k_n_ptr, int k_n_val,
                    const int* __restrict__ v_n_ptr, int v_n_val,
                    const int* __restrict__ trow, const int* __restrict__ start_ptr,
                    int start_val, float* __restrict__ out, int C, int ps, int max_pages,
                    int Hkv, int G, int rows, float sm_scale) {
  __shared__ float qs[kMaxQ][D];
  __shared__ float ks[BS][D + 1];  // +1: conflict-free reads along a row
  __shared__ float vs[BS][D];
  __shared__ float ps_[kMaxQ][BS];
  __shared__ float m_s[kMaxQ], l_s[kMaxQ], alpha_s[kMaxQ];
  constexpr int kAcc = kMaxQ * D / kThreads;
  constexpr int kLoads = BS * D / 4 / kThreads;
  static_assert(kAcc * kThreads == kMaxQ * D, "the accumulators split evenly");
  static_assert(kLoads * kThreads * 4 == BS * D, "a tile splits evenly over the threads");

  const int h = blockIdx.x;
  const int c0 = blockIdx.y * rows;
  const int n_rows = min(rows, C - c0);
  if (n_rows <= 0) return;  // the whole block: no barrier is left waiting
  const int nq = n_rows * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Hq = Hkv * G;
  const int start = start_ptr ? *start_ptr : start_val;
  const int k_n = k_n_ptr ? *k_n_ptr : k_n_val;
  const int v_n = v_n_ptr ? *v_n_ptr : v_n_val;
  const float k_scale = exp2f(-static_cast<float>(k_n));
  const float v_scale = exp2f(-static_cast<float>(v_n));
  const float k_inv = exp2f(static_cast<float>(k_n));
  const float v_inv = exp2f(static_cast<float>(v_n));
  // one past this block's last visible position; the table ends the slot
  const int s_end = min(start + c0 + n_rows, max_pages * ps);
  // logical pages the chunk covers inside the table
  const int lp_lo = max(start, 0) / ps;
  const int lp_hi = min((start + C - 1) / ps, max_pages - 1);

  const size_t row = (size_t)Hkv * D;  // elements between consecutive rows of a page
  const size_t page_elems = (size_t)ps * row;
  int8_t* kh = k + (size_t)h * D;
  int8_t* vh = v + (size_t)h * D;
  const float* kcb = kc + (size_t)h * D;
  const float* vcb = vc + (size_t)h * D;

  // query qi = r * G + g is head h * G + g at chunk row c0 + r
  for (int e = tid; e < nq * D; e += kThreads) {
    const int qi = e / D, d = e % D;
    qs[qi][d] = q[((size_t)(c0 + qi / G) * Hq + (size_t)h * G + qi % G) * D + d];
  }
  if (tid < kMaxQ) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int s0 = 0; s0 < s_end; s0 += BS) {
    __syncthreads();  // the previous tile's ps_ / vs are consumed
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int s = e / (D / 4), d = (e % (D / 4)) * 4;
      const int pos = s0 + s;
      float kf[4] = {0.f, 0.f, 0.f, 0.f}, vf[4] = {0.f, 0.f, 0.f, 0.f};
      if (pos < s_end) {
        const int lp = pos / ps, r = pos - lp * ps;
        const int entry = __ldg(trow + lp);
        int ci = -1;  // the chunk row whose codes this position holds after the write
        if (entry >= 0) {
          if (pos >= start && pos < start + C) ci = pos - start;
        } else {
          // an unmapped entry reads pool page 0: the chunk's own row there, if any
          for (int lq = lp_lo; lq <= lp_hi; ++lq) {
            const int p2 = lq * ps + r;
            if (__ldg(trow + lq) == 0 && p2 >= start && p2 < start + C) ci = p2 - start;
          }
        }
        const size_t off = (size_t)max(entry, 0) * page_elems + (size_t)r * row + d;
        if (ci >= 0) {
          const float* kp = kcb + (size_t)ci * row + d;
          const float* vp = vcb + (size_t)ci * row + d;
          signed char kq[4], vq[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            kq[j] = quantize_i8(kp[j], k_inv);
            vq[j] = quantize_i8(vp[j], v_inv);
            kf[j] = kq[j] * k_scale;
            vf[j] = vq[j] * v_scale;
          }
          // a mapped row of this block's own: it alone writes the codes
          if (entry >= 0 && ci >= c0 && ci < c0 + n_rows) {
            *reinterpret_cast<char4*>(kh + off) = make_char4(kq[0], kq[1], kq[2], kq[3]);
            *reinterpret_cast<char4*>(vh + off) = make_char4(vq[0], vq[1], vq[2], vq[3]);
          }
        } else {
          const char4 kq = *reinterpret_cast<const char4*>(kh + off);
          const char4 vq = *reinterpret_cast<const char4*>(vh + off);
          kf[0] = kq.x * k_scale;
          kf[1] = kq.y * k_scale;
          kf[2] = kq.z * k_scale;
          kf[3] = kq.w * k_scale;
          vf[0] = vq.x * v_scale;
          vf[1] = vq.y * v_scale;
          vf[2] = vq.z * v_scale;
          vf[3] = vq.w * v_scale;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ks[s][d + j] = kf[j];
        vs[s][d + j] = vf[j];
      }
    }
    __syncthreads();
    for (int e = tid; e < nq * BS; e += kThreads) {
      const int qi = e / BS, s = e % BS;
      const int pos = s0 + s;
      float sc;
      if (pos >= s_end) {
        sc = -INFINITY;  // past every query of the block, or past the table
      } else if (pos > start + c0 + qi / G) {
        sc = kMasked;  // causal within the chunk, as the reference masks it
      } else {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          a0 = fmaf(qs[qi][d + 0], ks[s][d + 0], a0);
          a1 = fmaf(qs[qi][d + 1], ks[s][d + 1], a1);
          a2 = fmaf(qs[qi][d + 2], ks[s][d + 2], a2);
          a3 = fmaf(qs[qi][d + 3], ks[s][d + 3], a3);
        }
        sc = ((a0 + a1) + (a2 + a3)) * sm_scale;
      }
      ps_[qi][s] = sc;
    }
    __syncthreads();
    for (int qi = warp; qi < nq; qi += kThreads / 32) {
      float mx = -INFINITY;
      for (int s = lane; s < BS; s += 32) mx = fmaxf(mx, ps_[qi][s]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[qi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < BS; s += 32) {
        const float p = expf(ps_[qi][s] - m_new);
        ps_[qi][s] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[qi] = alpha;
        l_s[qi] = l_s[qi] * alpha + sum;
        m_s[qi] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      const int qi = e / D, d = e % D;
      if (qi < nq) {
        float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll
        for (int s = 0; s < BS; s += 4) {
          b0 = fmaf(ps_[qi][s + 0], vs[s + 0][d], b0);
          b1 = fmaf(ps_[qi][s + 1], vs[s + 1][d], b1);
          b2 = fmaf(ps_[qi][s + 2], vs[s + 2][d], b2);
          b3 = fmaf(ps_[qi][s + 3], vs[s + 3][d], b3);
        }
        acc[i] = acc[i] * alpha_s[qi] + ((b0 + b1) + (b2 + b3));
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    const int qi = e / D, d = e % D;
    if (qi < nq) {
      out[((size_t)(c0 + qi / G) * Hq + (size_t)h * G + qi % G) * D + d] =
          acc[i] / fmaxf(l_s[qi], 1e-30f);
    }
  }
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

template <int D, int BS>
void launch_chunk(const float* q, const float* kc, const float* vc, int8_t* k, int8_t* v,
                  const int* k_n_ptr, int k_n_val, const int* v_n_ptr, int v_n_val,
                  const int* trow, const int* start_ptr, int start_val, float* out, int C,
                  int ps, int max_pages, int Hkv, int G, float sm_scale, cudaStream_t stream) {
  // as few tiles as kMaxQ queries per block allow, rows spread evenly over them
  const int tiles = (C + kMaxQ / G - 1) / (kMaxQ / G);
  const int rows = (C + tiles - 1) / tiles;
  qpaged_chunk_kernel<D, BS><<<dim3(Hkv, tiles), kThreads, 0, stream>>>(
      q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, trow, start_ptr, start_val, out,
      C, ps, max_pages, Hkv, G, rows, sm_scale);
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
// max_pages >= 1, start >= 0 and 4-byte aligned pools; rows outside the
// table are dropped, not refused.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments it does not take).
extern "C" int qpaged_chunk_attn_f32_s8(const float* q, const float* kc, const float* vc,
                                        int8_t* k, int8_t* v, const int* k_n_ptr,
                                        int k_n_val, const int* v_n_ptr, int v_n_val,
                                        const int* trow, const int* start_ptr, int start_val,
                                        float* out, int C, int ps, int max_pages, int Hkv,
                                        int G, int D, float sm_scale, void* stream) {
  if (G > kMaxG || G < 1 || C < 1 || Hkv < 1 || ps < 1 || max_pages < 1 ||
      (!start_ptr && start_val < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      launch_chunk<16, 64>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, trow,
                           start_ptr, start_val, out, C, ps, max_pages, Hkv, G, sm_scale, st);
      break;
    case 32:
      launch_chunk<32, 64>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, trow,
                           start_ptr, start_val, out, C, ps, max_pages, Hkv, G, sm_scale, st);
      break;
    case 64:
      launch_chunk<64, 32>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, trow,
                           start_ptr, start_val, out, C, ps, max_pages, Hkv, G, sm_scale, st);
      break;
    case 128:
      launch_chunk<128, 16>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, trow,
                            start_ptr, start_val, out, C, ps, max_pages, Hkv, G, sm_scale,
                            st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
