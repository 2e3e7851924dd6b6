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
// row that any block of the launch writes.  One block per (KV head, token)
// walks its slot's positions in tiles of BS.  For each tile it first marks
// which positions a batch row of the same slot writes this tick (a scan of
// the T slot ids and positions, L1 hits after the first tile); those
// positions take that row's K/V, quantized in the block from the f32 inputs,
// and only the others are read from the pool.  So a slot may carry a decode
// row and chunk rows in one tick.  Each written (row, KV head) is stored by
// exactly one block, the token's own.  Two batch rows at one (slot,
// position), a table that maps one pool page at two logical pages, or a
// write through a page that another slot also maps (the scheduler's
// assert_private_write keeps them out) have no defined result.
//
// Bound on an H100: bytes.  The tick must read each slot's visible int8
// prefix once, 2 * len * Hkv * D bytes, at about one multiply-add per byte
// per query head.  This first version gives each token its own block, as
// the decode kernels give each slot one: T * Hkv blocks (216 at the serving
// shape, all resident at once) that each walk their own prefix serially, so
// a slot's chunk tokens re-read the same prefix rows (from L2 after the
// first).  Sharing one prefix walk between a chunk's tokens, as the chunk
// kernels do, and splitting long walks across blocks are the next steps.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 16;
constexpr float kMasked = -1e30f;
constexpr int kFromPool = -1;   // src[]: the position's bytes come from the pool
constexpr int kUnseen = -2;     // src[]: past the walk or on an unmapped entry

// sat(trunc(x * 2^n)) with inv_scale = 2^n: a product by an exact power of
// two, so the codes equal the plain version's bit for bit.
__device__ __forceinline__ signed char quantize_i8(float x, float inv_scale) {
  const float t = truncf(x * inv_scale);
  return static_cast<signed char>(fminf(fmaxf(t, -128.f), 127.f));
}

template <int D, int BS>
__global__ void __launch_bounds__(kThreads)
qragged_kernel(const float* __restrict__ q, const float* __restrict__ kc,
               const float* __restrict__ vc, int8_t* k, int8_t* v,
               const int* __restrict__ k_n_ptr, int k_n_val, const int* __restrict__ v_n_ptr,
               int v_n_val, const int* __restrict__ table, const int* __restrict__ slot_ids,
               const int* __restrict__ positions, float* __restrict__ out, int T, int ps,
               int max_pages, int Hkv, int G, float sm_scale) {
  __shared__ float qs[kMaxG][D];
  __shared__ float ks[BS][D + 1];  // +1: conflict-free reads along a row
  __shared__ float vs[BS][D];
  __shared__ float ps_[kMaxG][BS];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  __shared__ int src[BS];          // batch row, kFromPool or kUnseen per tile position
  constexpr int kAcc = (kMaxG * D + kThreads - 1) / kThreads;
  constexpr int kLoads = BS * D / 4 / kThreads;
  static_assert(kLoads * kThreads * 4 == BS * D, "a tile splits evenly over the threads");

  const int h = blockIdx.x;
  const int t = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Hq = Hkv * G;
  const int my_pos = __ldg(positions + t);
  float* ob = out + ((size_t)t * Hq + (size_t)h * G) * D;
  if (my_pos < 0) {  // inert: the whole block leaves before any barrier
    for (int e = tid; e < G * D; e += kThreads) ob[e] = 0.f;
    return;
  }
  const int slot = __ldg(slot_ids + t);
  const int k_n = k_n_ptr ? *k_n_ptr : k_n_val;
  const int v_n = v_n_ptr ? *v_n_ptr : v_n_val;
  const float k_scale = exp2f(-static_cast<float>(k_n));
  const float v_scale = exp2f(-static_cast<float>(v_n));
  const float k_inv = exp2f(static_cast<float>(k_n));
  const float v_inv = exp2f(static_cast<float>(v_n));

  const size_t row = (size_t)Hkv * D;  // elements between consecutive token or pool rows
  const size_t page_elems = (size_t)ps * row;
  const int* trow = table + (size_t)slot * max_pages;
  int8_t* kh = k + (size_t)h * D;
  int8_t* vh = v + (size_t)h * D;
  const float* kcb = kc + (size_t)h * D;
  const float* vcb = vc + (size_t)h * D;

  // this token's own row: quantized and stored by this block alone; no block
  // of the launch reads it back from the pool
  const int my_lp = my_pos / ps;
  if (my_lp < max_pages) {
    const int page = __ldg(trow + my_lp);
    if (page >= 0) {
      const size_t off = (size_t)page * page_elems + (size_t)(my_pos - my_lp * ps) * row;
      for (int d = tid; d < D; d += kThreads) {
        kh[off + d] = quantize_i8(kcb[(size_t)t * row + d], k_inv);
        vh[off + d] = quantize_i8(vcb[(size_t)t * row + d], v_inv);
      }
    }
  }

  // visible positions [0, s_end): through the token's own, never past the table
  const int s_end = min(my_pos + 1, max_pages * ps);
  const float* qb = q + ((size_t)t * Hq + (size_t)h * G) * D;
  for (int e = tid; e < G * D; e += kThreads) qs[e / D][e % D] = qb[e];
  if (tid < G) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int s0 = 0; s0 < s_end; s0 += BS) {
    __syncthreads();  // the previous tile's ps_ / vs / src are consumed
    for (int s = tid; s < BS; s += kThreads) {
      const int pos = s0 + s;
      src[s] = (pos < s_end && __ldg(trow + pos / ps) >= 0) ? kFromPool : kUnseen;
    }
    __syncthreads();
    // batch rows of this slot that land on a mapped position of the tile
    // replace the pool's bytes there
    const int tile_end = min(s0 + BS, s_end);
    for (int u = tid; u < T; u += kThreads) {
      const int pu = __ldg(positions + u);
      if (pu >= s0 && pu < tile_end && __ldg(slot_ids + u) == slot && src[pu - s0] == kFromPool)
        src[pu - s0] = u;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int s = e / (D / 4), d = (e % (D / 4)) * 4;
      const int pos = s0 + s;
      const int sr = src[s];
      float kf[4] = {0.f, 0.f, 0.f, 0.f}, vf[4] = {0.f, 0.f, 0.f, 0.f};
      if (sr >= 0) {
        const float* kp = kcb + (size_t)sr * row + d;
        const float* vp = vcb + (size_t)sr * row + d;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kf[j] = static_cast<float>(quantize_i8(kp[j], k_inv)) * k_scale;
          vf[j] = static_cast<float>(quantize_i8(vp[j], v_inv)) * v_scale;
        }
      } else if (sr == kFromPool) {
        const int lp = pos / ps;
        const size_t off = (size_t)__ldg(trow + lp) * page_elems + (size_t)(pos - lp * ps) * row + d;
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ks[s][d + j] = kf[j];
        vs[s][d + j] = vf[j];
      }
    }
    __syncthreads();
    for (int e = tid; e < G * BS; e += kThreads) {
      const int g = e / BS, s = e % BS;
      float sc = -INFINITY;  // unseen positions weigh exactly 0, and a row that
      //                        sees nothing keeps l = 0 and outputs zeros
      if (src[s] != kUnseen) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          a0 = fmaf(qs[g][d + 0], ks[s][d + 0], a0);
          a1 = fmaf(qs[g][d + 1], ks[s][d + 1], a1);
          a2 = fmaf(qs[g][d + 2], ks[s][d + 2], a2);
          a3 = fmaf(qs[g][d + 3], ks[s][d + 3], a3);
        }
        sc = ((a0 + a1) + (a2 + a3)) * sm_scale;
      }
      ps_[g][s] = sc;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = -INFINITY;
      for (int s = lane; s < BS; s += 32) mx = fmaxf(mx, ps_[g][s]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < BS; s += 32) {
        const float p = expf(ps_[g][s] - m_new);
        ps_[g][s] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * D) {
        const int g = e / D, d = e % D;
        float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll
        for (int s = 0; s < BS; s += 4) {
          b0 = fmaf(ps_[g][s + 0], vs[s + 0][d], b0);
          b1 = fmaf(ps_[g][s + 1], vs[s + 1][d], b1);
          b2 = fmaf(ps_[g][s + 2], vs[s + 2][d], b2);
          b3 = fmaf(ps_[g][s + 3], vs[s + 3][d], b3);
        }
        acc[i] = acc[i] * alpha_s[g] + ((b0 + b1) + (b2 + b3));
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * D) ob[e] = acc[i] / fmaxf(l_s[e / D], 1e-30f);
  }
}

template <int D, int BS>
void launch(const float* q, const float* kc, const float* vc, int8_t* k, int8_t* v,
            const int* k_n_ptr, int k_n_val, const int* v_n_ptr, int v_n_val,
            const int* table, const int* slot_ids, const int* positions, float* out, int T,
            int ps, int max_pages, int Hkv, int G, float sm_scale, cudaStream_t stream) {
  qragged_kernel<D, BS><<<dim3(Hkv, T), kThreads, 0, stream>>>(
      q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table, slot_ids, positions, out, T,
      ps, max_pages, Hkv, G, sm_scale);
}

}  // namespace

// The exponents come from device memory (non-null pointer) or by value.
// Takes D in {16, 32, 64, 128}, G <= 16, ps >= 1, max_pages >= 1, T <= 65535
// and 4-byte aligned pools; slot ids must index the table's rows.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// it does not take).
extern "C" int qragged_attn_f32_s8(const float* q, const float* kc, const float* vc,
                                   int8_t* k, int8_t* v, const int* k_n_ptr, int k_n_val,
                                   const int* v_n_ptr, int v_n_val, const int* table,
                                   const int* slot_ids, const int* positions, float* out,
                                   int T, int ps, int max_pages, int Hkv, int G, int D,
                                   float sm_scale, void* stream) {
  if (G > kMaxG || G < 1 || Hkv < 1 || ps < 1 || max_pages < 1 || T > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      launch<16, 64>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table, slot_ids,
                     positions, out, T, ps, max_pages, Hkv, G, sm_scale, st);
      break;
    case 32:
      launch<32, 64>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table, slot_ids,
                     positions, out, T, ps, max_pages, Hkv, G, sm_scale, st);
      break;
    case 64:
      launch<64, 64>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table, slot_ids,
                     positions, out, T, ps, max_pages, Hkv, G, sm_scale, st);
      break;
    case 128:
      launch<128, 32>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table, slot_ids,
                      positions, out, T, ps, max_pages, Hkv, G, sm_scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
