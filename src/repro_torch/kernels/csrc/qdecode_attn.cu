// GQA decode attention over a dense int8 KV cache.
//
// Replaces repro/kernels/qdecode_attn.py::qdecode_attn_pallas.
// q (B, Hq, D) f32; k, v (B, S, Hkv, D) int8 on the pow2 grid 2^-k_n / 2^-v_n;
// per-row live length kv_len (positions >= kv_len are masked with -1e30, as
// the reference does); out (B, Hq, D) f32.  Hq = G * Hkv.
//
// One block of 256 threads per (KV head, batch row): the G query heads of the
// group sit in shared memory, and the block walks S in tiles of BS positions.
// Each K/V tile is dequantized right after its load (4 bytes per thread,
// neighbouring threads on neighbouring bytes; the next tile's loads fly while
// the current one is computed).  The head dim is a template constant, so the
// q.k and p.v loops unroll, each split over four accumulators to shorten the
// dependent FMA chains.  A running (m, l, acc) online softmax
// carries across tiles, with the reference's -1e30 mask and max(l, 1e-30)
// floor.  Tiles past the live length are skipped: their masked scores add
// exactly zero once a live position has been seen.  A row with kv_len <= 0
// walks the whole cache, as the reference's fully masked softmax does.
//
// Bound on an H100: the int8 K/V bytes of the live rows, 2 * B * len * Hkv * D
// per layer.  This first version does not split S across blocks
// (flash-decoding), so B * Hkv blocks carry the whole read.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 16;
constexpr float kMasked = -1e30f;

// The tile's K/V bytes for this thread: every load of a tile issued at once.
template <int D, int BS, int kLoads>
__device__ __forceinline__ void fetch(char4 (&kr)[kLoads], char4 (&vr)[kLoads],
                                      const int8_t* __restrict__ kb,
                                      const int8_t* __restrict__ vb, size_t row, int s0,
                                      int S) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int s = e / (D / 4), d = (e % (D / 4)) * 4;
    kr[i] = make_char4(0, 0, 0, 0);
    vr[i] = make_char4(0, 0, 0, 0);
    if (s0 + s < S) {
      kr[i] = *reinterpret_cast<const char4*>(kb + (size_t)(s0 + s) * row + d);
      vr[i] = *reinterpret_cast<const char4*>(vb + (size_t)(s0 + s) * row + d);
    }
  }
}

template <int D, int BS>
__global__ void __launch_bounds__(kThreads)
qdecode_attn_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
                    const int8_t* __restrict__ v, const int* __restrict__ k_n_ptr,
                    int k_n_val, const int* __restrict__ v_n_ptr, int v_n_val,
                    const int* __restrict__ kv_len_ptr, int kv_len_stride,
                    int kv_len_val, float* __restrict__ out, int S, int Hkv, int G,
                    float sm_scale) {
  __shared__ float qs[kMaxG][D];
  __shared__ float ks[BS][D + 1];   // +1: conflict-free reads along a row
  __shared__ float vs[BS][D];
  __shared__ float ps[kMaxG][BS];
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
  const int s_end = len > 0 ? min(len, S) : S;

  const size_t row = (size_t)Hkv * D;  // bytes between consecutive positions
  const int8_t* kb = k + (size_t)b * S * row + (size_t)h * D;
  const int8_t* vb = v + (size_t)b * S * row + (size_t)h * D;
  // The next tile's loads fly while the current tile is computed.
  char4 kr[kLoads], vr[kLoads];
  fetch<D, BS, kLoads>(kr, vr, kb, vb, row, 0, S);

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
    __syncthreads();  // the previous tile's ps / vs are consumed
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
    if (s0 + BS < s_end) fetch<D, BS, kLoads>(kr, vr, kb, vb, row, s0 + BS, S);
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
      // positions past the cache do not exist; masked ones weigh exp(-1e30 - m)
      ps[g][s] = pos >= S ? -INFINITY : (pos < len ? dot * sm_scale : kMasked);
    }
    __syncthreads();
    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = -INFINITY;
      for (int s = lane; s < BS; s += 32) mx = fmaxf(mx, ps[g][s]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < BS; s += 32) {
        const float p = expf(ps[g][s] - m_new);
        ps[g][s] = p;
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
          b0 = fmaf(ps[g][s + 0], vs[s + 0][d], b0);
          b1 = fmaf(ps[g][s + 1], vs[s + 1][d], b1);
          b2 = fmaf(ps[g][s + 2], vs[s + 2][d], b2);
          b3 = fmaf(ps[g][s + 3], vs[s + 3][d], b3);
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

template <int D, int BS>
void launch(const float* q, const int8_t* k, const int8_t* v, const int* k_n_ptr,
            int k_n_val, const int* v_n_ptr, int v_n_val, const int* kv_len_ptr,
            int kv_len_stride, int kv_len_val, float* out, int B, int S, int Hkv, int G,
            float sm_scale, cudaStream_t stream) {
  qdecode_attn_kernel<D, BS><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, kv_len_ptr, kv_len_stride, kv_len_val,
      out, S, Hkv, G, sm_scale);
}

}  // namespace

// Exponents and the live length come either from device memory (non-null
// pointer; kv_len_stride 1 for a (B,) vector, 0 for one shared value) or by
// value.  Takes D in {16, 32, 64, 128}, G <= 16 and 4-byte aligned caches.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported shape).
extern "C" int qdecode_attn_f32_s8(const float* q, const int8_t* k, const int8_t* v,
                                   const int* k_n_ptr, int k_n_val, const int* v_n_ptr,
                                   int v_n_val, const int* kv_len_ptr, int kv_len_stride,
                                   int kv_len_val, float* out, int B, int S, int Hkv,
                                   int G, int D, float sm_scale, void* stream) {
  if (G > kMaxG || G < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Hkv <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      launch<16, 64>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, kv_len_ptr, kv_len_stride,
                     kv_len_val, out, B, S, Hkv, G, sm_scale, st);
      break;
    case 32:
      launch<32, 64>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, kv_len_ptr, kv_len_stride,
                     kv_len_val, out, B, S, Hkv, G, sm_scale, st);
      break;
    case 64:
      launch<64, 64>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, kv_len_ptr, kv_len_stride,
                     kv_len_val, out, B, S, Hkv, G, sm_scale, st);
      break;
    case 128:
      launch<128, 32>(q, k, v, k_n_ptr, k_n_val, v_n_ptr, v_n_val, kv_len_ptr, kv_len_stride,
                      kv_len_val, out, B, S, Hkv, G, sm_scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
