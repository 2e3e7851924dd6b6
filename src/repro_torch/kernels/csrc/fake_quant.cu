// Fused fake-quantization on the power-of-two grid, float32:
//   out = clip(trunc(x * s), qmin, qmax) * inv,   s = 2^n, inv = 2^-n
// over a contiguous tensor of any shape, with the two factors read from
// device memory (factors[0] = s, factors[1] = inv).
//
// Replaces repro/kernels/fake_quant.py::fake_quant_pallas.  The TPU kernel
// computes jnp.exp2(±n) from an SMEM exponent; here the kernel never
// computes a power of two: the wrapper passes the reference's own float32
// factors (the port's exp2 table, gathered on the device, so nothing is
// read back), since XLA's exp2 misses 2^n for |n| >= 13.  The arithmetic
// is two float32 multiplies (round to nearest, no contraction possible),
// a truncation and a clip that keeps NaN: bit for bit the plain version.
//
// Bound on an H100: bytes, 4 read and 4 written per element.  One pass,
// 16-byte (float4) loads and stores where the pointers allow, a grid-stride
// loop over 8 blocks per SM's worth of threads; the tail (and a misaligned
// tensor) takes scalar accesses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float fq(float v, float s, float inv, float lo, float hi) {
  float t = truncf(__fmul_rn(v, s));
  t = t < lo ? lo : (t > hi ? hi : t);
  return __fmul_rn(t, inv);
}

__global__ void __launch_bounds__(NT)
fake_quant_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const float* __restrict__ factors, float lo, float hi, long long n,
                  int vec) {
  const float s = factors[0], inv = factors[1];
  const long long stride = (long long)gridDim.x * NT;
  long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (vec) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long j = i; j < n4; j += stride) {
      float4 v = x4[j];
      v.x = fq(v.x, s, inv, lo, hi);
      v.y = fq(v.y, s, inv, lo, hi);
      v.z = fq(v.z, s, inv, lo, hi);
      v.w = fq(v.w, s, inv, lo, hi);
      o4[j] = v;
    }
    i += n4 * 4;
  }
  for (long long j = i; j < n; j += stride) out[j] = fq(x[j], s, inv, lo, hi);
}

}  // namespace

// x and out: n contiguous float32; factors: two float32 on the device.
// Returns cudaGetLastError() after the launch.
extern "C" int fake_quant_f32(const float* x, float* out, const float* factors, int qmin,
                              int qmax, long long n, void* stream) {
  if (n < 0 || qmin > qmax) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long work = vec ? (n + 3) / 4 : n;
  const long long want = (work + NT - 1) / NT;
  const int blocks = (int)(want < 8LL * sms ? want : 8LL * sms);
  fake_quant_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, factors, (float)qmin, (float)qmax, n, vec);
  return static_cast<int>(cudaGetLastError());
}
