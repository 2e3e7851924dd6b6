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
// One block of 256 threads per (KV head, tile of `rows` chunk rows): the
// tile's rows x G queries sit in shared memory, and the block walks S in
// tiles of BS positions up to its last visible position (start + last row).
// Positions before `start` are dequantized from the int8 cache; chunk
// positions are quantized in registers from the f32 inputs and dequantized
// from those codes, so no block reads a cache row that any block writes in
// the same launch: there is no ordering hazard.  Each block writes the int8
// codes of its own chunk rows for its head, so every written row has one
// writer.  A running (m, l, acc) online softmax carries across tiles, with
// the reference's -1e30 mask and max(l, 1e-30) floor.  Any S is taken; the
// TPU kernel's equal S blocks and its one-hot merge are not carried over.
//
// Bound on an H100: the int8 prefix read, 2 * start * Hkv * D bytes, and
// the f32 chunk in and out; the operations, about 4 * C * (start + C/2) *
// Hq * D, are far below the f32 rate.  This first version runs Hkv x
// ceil(C / rows) blocks (12 at C = 32, Hkv = 3), each walking its prefix
// serially: few SMs are busy, and a split of S across blocks is the next step.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 32;  // queries (chunk rows x group heads) per block
constexpr int kMaxG = 16;
constexpr float kMasked = -1e30f;

// sat(trunc(x * 2^n)) with inv_scale = 2^n: a product by an exact power of
// two, so the codes equal the plain version's bit for bit.
__device__ __forceinline__ signed char quantize_i8(float x, float inv_scale) {
  const float t = truncf(x * inv_scale);
  return static_cast<signed char>(fminf(fmaxf(t, -128.f), 127.f));
}

template <int D, int BS>
__global__ void __launch_bounds__(kThreads)
qchunk_attn_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                   const float* __restrict__ vc, int8_t* __restrict__ k,
                   int8_t* __restrict__ v, const int* __restrict__ k_n_ptr, int k_n_val,
                   const int* __restrict__ v_n_ptr, int v_n_val, float* __restrict__ out,
                   int C, int S, int Hkv, int G, int rows, int slot, int start,
                   float sm_scale) {
  __shared__ float qs[kMaxQ][D];
  __shared__ float ks[BS][D + 1];  // +1: conflict-free reads along a row
  __shared__ float vs[BS][D];
  __shared__ float ps[kMaxQ][BS];
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
  const int k_n = k_n_ptr ? *k_n_ptr : k_n_val;
  const int v_n = v_n_ptr ? *v_n_ptr : v_n_val;
  const float k_scale = exp2f(-static_cast<float>(k_n));
  const float v_scale = exp2f(-static_cast<float>(v_n));
  const float k_inv = exp2f(static_cast<float>(k_n));
  const float v_inv = exp2f(static_cast<float>(v_n));
  const int s_end = start + c0 + n_rows;  // one past this block's last visible position

  const size_t row = (size_t)Hkv * D;  // elements between consecutive positions
  int8_t* kb = k + (size_t)slot * S * row + (size_t)h * D;
  int8_t* vb = v + (size_t)slot * S * row + (size_t)h * D;
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
    __syncthreads();  // the previous tile's ps / vs are consumed
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int s = e / (D / 4), d = (e % (D / 4)) * 4;
      const int pos = s0 + s;
      float kf[4] = {0.f, 0.f, 0.f, 0.f}, vf[4] = {0.f, 0.f, 0.f, 0.f};
      if (pos < start) {
        const char4 kq = *reinterpret_cast<const char4*>(kb + (size_t)pos * row + d);
        const char4 vq = *reinterpret_cast<const char4*>(vb + (size_t)pos * row + d);
        kf[0] = kq.x * k_scale;
        kf[1] = kq.y * k_scale;
        kf[2] = kq.z * k_scale;
        kf[3] = kq.w * k_scale;
        vf[0] = vq.x * v_scale;
        vf[1] = vq.y * v_scale;
        vf[2] = vq.z * v_scale;
        vf[3] = vq.w * v_scale;
      } else if (pos < s_end) {
        const int r = pos - start;  // chunk row
        const float* kp = kcb + (size_t)r * row + d;
        const float* vp = vcb + (size_t)r * row + d;
        signed char kq[4], vq[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kq[j] = quantize_i8(kp[j], k_inv);
          vq[j] = quantize_i8(vp[j], v_inv);
          kf[j] = kq[j] * k_scale;
          vf[j] = vq[j] * v_scale;
        }
        if (r >= c0) {  // this block's own rows: it alone writes their codes
          *reinterpret_cast<char4*>(kb + (size_t)pos * row + d) =
              make_char4(kq[0], kq[1], kq[2], kq[3]);
          *reinterpret_cast<char4*>(vb + (size_t)pos * row + d) =
              make_char4(vq[0], vq[1], vq[2], vq[3]);
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
        sc = -INFINITY;  // past every query of the block: weighs exactly zero
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
      ps[qi][s] = sc;
    }
    __syncthreads();
    for (int qi = warp; qi < nq; qi += kThreads / 32) {
      float mx = -INFINITY;
      for (int s = lane; s < BS; s += 32) mx = fmaxf(mx, ps[qi][s]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[qi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < BS; s += 32) {
        const float p = expf(ps[qi][s] - m_new);
        ps[qi][s] = p;
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
          b0 = fmaf(ps[qi][s + 0], vs[s + 0][d], b0);
          b1 = fmaf(ps[qi][s + 1], vs[s + 1][d], b1);
          b2 = fmaf(ps[qi][s + 2], vs[s + 2][d], b2);
          b3 = fmaf(ps[qi][s + 3], vs[s + 3][d], b3);
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
void launch(const float* q, const float* kc, const float* vc, int8_t* k, int8_t* v,
            const int* k_n_ptr, int k_n_val, const int* v_n_ptr, int v_n_val, float* out,
            int C, int S, int Hkv, int G, int slot, int start, float sm_scale,
            cudaStream_t stream) {
  // as few tiles as kMaxQ queries per block allow, rows spread evenly over them
  const int tiles = (C + kMaxQ / G - 1) / (kMaxQ / G);
  const int rows = (C + tiles - 1) / tiles;
  qchunk_attn_kernel<D, BS><<<dim3(Hkv, tiles), kThreads, 0, stream>>>(
      q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, out, C, S, Hkv, G, rows, slot,
      start, sm_scale);
}

}  // namespace

// Exponents come from device memory (non-null pointer) or by value.  Takes
// D in {16, 32, 64, 128}, G <= 16, 4-byte aligned caches and a chunk inside
// the cache (0 <= slot < B, 0 <= start, start + C <= S).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// it does not take).
extern "C" int qchunk_attn_f32_s8(const float* q, const float* kc, const float* vc, int8_t* k,
                                  int8_t* v, const int* k_n_ptr, int k_n_val,
                                  const int* v_n_ptr, int v_n_val, float* out, int B, int C,
                                  int S, int Hkv, int G, int D, int slot, int start,
                                  float sm_scale, void* stream) {
  if (G > kMaxG || G < 1 || C < 1 || Hkv < 1 || slot < 0 || slot >= B || start < 0 ||
      start + C > S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      launch<16, 64>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, out, C, S, Hkv, G,
                     slot, start, sm_scale, st);
      break;
    case 32:
      launch<32, 64>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, out, C, S, Hkv, G,
                     slot, start, sm_scale, st);
      break;
    case 64:
      launch<64, 32>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, out, C, S, Hkv, G,
                     slot, start, sm_scale, st);
      break;
    case 128:
      launch<128, 16>(q, kc, vc, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, out, C, S, Hkv, G,
                      slot, start, sm_scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
