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
// >= kv_len are masked with -1e30.  One block of 256 threads per (KV head,
// slot), the dense qdecode_attn design: the G query heads sit in shared
// memory, the block walks its visited positions in tiles of BS (each
// position's pool row looked up through the table, the next tile's loads in
// flight while the current one is computed) with a running (m, l, acc)
// online softmax and the reference's max(l, 1e-30) floor.
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
// bytes per page.  This first version, like the dense kernels, runs one
// block per (slot, head) or per (head, row tile) and walks the positions
// serially: few SMs are busy at serving shapes, and splitting the walk
// across blocks (flash-decoding) is the next step.  Positions, not pages,
// are the unit of the walk, so any page size >= 1 takes the same path.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 16;
constexpr int kMaxQ = 32;  // chunk kernel: queries (chunk rows x group heads) per block
constexpr float kMasked = -1e30f;

// sat(trunc(x * 2^n)) with inv_scale = 2^n: a product by an exact power of
// two, so the codes equal the plain version's bit for bit.
__device__ __forceinline__ signed char quantize_i8(float x, float inv_scale) {
  const float t = truncf(x * inv_scale);
  return static_cast<signed char>(fminf(fmaxf(t, -128.f), 127.f));
}

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

// The tile's K/V bytes for this thread, each position's row found through
// the slot's table row; positions at or past s_end load zeros.
template <int D, int kLoads>
__device__ __forceinline__ void fetch_paged(char4 (&kr)[kLoads], char4 (&vr)[kLoads],
                                            const int8_t* __restrict__ kh,
                                            const int8_t* __restrict__ vh,
                                            const int* __restrict__ trow, int ps,
                                            size_t page_elems, size_t row, int s0,
                                            int s_end) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int s = e / (D / 4), d = (e % (D / 4)) * 4;
    const int pos = s0 + s;
    kr[i] = make_char4(0, 0, 0, 0);
    vr[i] = make_char4(0, 0, 0, 0);
    if (pos < s_end) {
      const int lp = pos / ps;
      const int page = max(__ldg(trow + lp), 0);
      const size_t off = (size_t)page * page_elems + (size_t)(pos - lp * ps) * row + d;
      kr[i] = *reinterpret_cast<const char4*>(kh + off);
      vr[i] = *reinterpret_cast<const char4*>(vh + off);
    }
  }
}

template <int D, int BS>
__global__ void __launch_bounds__(kThreads)
qpaged_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
                     const int8_t* __restrict__ v, const int* __restrict__ k_n_ptr,
                     int k_n_val, const int* __restrict__ v_n_ptr, int v_n_val,
                     const int* __restrict__ table, const int* __restrict__ kv_len_ptr,
                     int kv_len_stride, int kv_len_val, float* __restrict__ out, int ps,
                     int max_pages, int Hkv, int G, float sm_scale) {
  __shared__ float qs[kMaxG][D];
  __shared__ float ks[BS][D + 1];  // +1: conflict-free reads along a row
  __shared__ float vs[BS][D];
  __shared__ float ps_[kMaxG][BS];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  constexpr int kAcc = (kMaxG * D + kThreads - 1) / kThreads;
  constexpr int kLoads = BS * D / 4 / kThreads;
  static_assert(kLoads * kThreads * 4 == BS * D, "a tile splits evenly over the threads");

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Hq = Hkv * G;
  const float k_scale = exp2f(-static_cast<float>(k_n_ptr ? *k_n_ptr : k_n_val));
  const float v_scale = exp2f(-static_cast<float>(v_n_ptr ? *v_n_ptr : v_n_val));
  const int len = kv_len_ptr ? kv_len_ptr[(size_t)b * kv_len_stride] : kv_len_val;
  // pages the Pallas kernel visits: through the last live one (page 0 when
  // the slot is empty), never past the table
  const int last = min(max((len - 1) / ps, 0), max_pages - 1);
  const int n_walk = (last + 1) * ps;
  const int s_end = len > 0 ? min(len, n_walk) : n_walk;

  const size_t row = (size_t)Hkv * D;  // elements between consecutive rows of a page
  const size_t page_elems = (size_t)ps * row;
  const int8_t* kh = k + (size_t)h * D;
  const int8_t* vh = v + (size_t)h * D;
  const int* trow = table + (size_t)b * max_pages;
  char4 kr[kLoads], vr[kLoads];
  fetch_paged<D, kLoads>(kr, vr, kh, vh, trow, ps, page_elems, row, 0, s_end);

  const float* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int e = tid; e < G * D; e += kThreads) qs[e / D][e % D] = qb[e];
  if (tid < G) {
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
      ks[s][d + 0] = kr[i].x * k_scale;
      ks[s][d + 1] = kr[i].y * k_scale;
      ks[s][d + 2] = kr[i].z * k_scale;
      ks[s][d + 3] = kr[i].w * k_scale;
      vs[s][d + 0] = vr[i].x * v_scale;
      vs[s][d + 1] = vr[i].y * v_scale;
      vs[s][d + 2] = vr[i].z * v_scale;
      vs[s][d + 3] = vr[i].w * v_scale;
    }
    __syncthreads();
    if (s0 + BS < s_end)
      fetch_paged<D, kLoads>(kr, vr, kh, vh, trow, ps, page_elems, row, s0 + BS, s_end);
    for (int e = tid; e < G * BS; e += kThreads) {
      const int g = e / BS, s = e % BS;
      const int pos = s0 + s;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        a0 = fmaf(qs[g][d + 0], ks[s][d + 0], a0);
        a1 = fmaf(qs[g][d + 1], ks[s][d + 1], a1);
        a2 = fmaf(qs[g][d + 2], ks[s][d + 2], a2);
        a3 = fmaf(qs[g][d + 3], ks[s][d + 3], a3);
      }
      const float dot = (a0 + a1) + (a2 + a3);
      // positions past the walk are not visited; masked ones weigh exp(-1e30 - m)
      ps_[g][s] = pos >= s_end ? -INFINITY : (pos < len ? dot * sm_scale : kMasked);
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
  float* ob = out + ((size_t)b * Hq + (size_t)h * G) * D;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * D) ob[e] = acc[i] / fmaxf(l_s[e / D], 1e-30f);
  }
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

template <int D, int BS>
void launch_decode(const float* q, const int8_t* k, const int8_t* v, const int* k_n_ptr,
                   int k_n_val, const int* v_n_ptr, int v_n_val, const int* table,
                   const int* kv_len_ptr, int kv_len_stride, int kv_len_val, float* out,
                   int B, int ps, int max_pages, int Hkv, int G, float sm_scale,
                   cudaStream_t stream) {
  qpaged_decode_kernel<D, BS><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table, kv_len_ptr, kv_len_stride,
      kv_len_val, out, ps, max_pages, Hkv, G, sm_scale);
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
// Takes D in {16, 32, 64, 128}, G <= 16, ps >= 1, max_pages >= 1 and 4-byte
// aligned pools.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int qpaged_decode_attn_f32_s8(const float* q, const int8_t* k, const int8_t* v,
                                         const int* k_n_ptr, int k_n_val,
                                         const int* v_n_ptr, int v_n_val, const int* table,
                                         const int* kv_len_ptr, int kv_len_stride,
                                         int kv_len_val, float* out, int B, int ps,
                                         int max_pages, int Hkv, int G, int D,
                                         float sm_scale, void* stream) {
  if (G > kMaxG || G < 1 || ps < 1 || max_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Hkv <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      launch_decode<16, 64>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table, kv_len_ptr,
                            kv_len_stride, kv_len_val, out, B, ps, max_pages, Hkv, G,
                            sm_scale, st);
      break;
    case 32:
      launch_decode<32, 64>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table, kv_len_ptr,
                            kv_len_stride, kv_len_val, out, B, ps, max_pages, Hkv, G,
                            sm_scale, st);
      break;
    case 64:
      launch_decode<64, 64>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table, kv_len_ptr,
                            kv_len_stride, kv_len_val, out, B, ps, max_pages, Hkv, G,
                            sm_scale, st);
      break;
    case 128:
      launch_decode<128, 32>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, table, kv_len_ptr,
                             kv_len_stride, kv_len_val, out, B, ps, max_pages, Hkv, G,
                             sm_scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
