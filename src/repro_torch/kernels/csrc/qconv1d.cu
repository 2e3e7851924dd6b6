// Integer 1-D convolution, channels last, into an int32 accumulator:
//   out (B, W', F) int32 = sum_{k, c} xpad[b, w*stride + k, c] * w[k, c, f]
// summed modulo 2^32, with x (B, W, C) and w (K, C, F) both int8 or both
// int16, row-major and contiguous.  SAME pads pad_total // 2 positions
// low and the rest high (XLA's rule); VALID pads nothing.
//
// Replaces repro/kernels/qconv1d.py::qconv1d_pallas, which runs K shifted
// (W' x C) @ (C x F) matmuls over one VMEM-resident padded row per grid
// step.  Here a block owns one batch row, a tile of TW output positions and
// a tile of TF filters: the input rows the tile needs, halo included, and
// the (K, C, TF) weights go to shared memory once, so each input element
// is read from device memory about once per filter tile.  Padding is
// masked while the rows are staged, never materialized.  The sums are
// unsigned (or dp4a's wrapping 32-bit add): XLA's int32 convolution wraps,
// and signed overflow is undefined in C++.
//
// Bound on an H100: bytes.  The int32 output is 4x the int8 input; at
// B = 2947, W = 128, F = 80 it writes 120.7 MB (about 36 us at 3.35 TB/s)
// against about 7 us of int8 tensor-core work.  This first version does
// the products on the CUDA cores (int8: dp4a over four channels per
// instruction; int16: one multiply-add per product), so at C = 80 it is
// bound by those instructions, not yet by the bytes.
//
// Threads: 256, thread t owns filter f = t % 32 of the tile and output
// positions t / 32 + 8 i (i < 8) of it.  Shared memory holds 32-bit words,
// four int8 channels (or one int16 channel) per word, channels padded to a
// whole word with zeros.  Within a warp every thread reads the same input
// word (a broadcast) and consecutive weight words (no bank conflict).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 64, TF = 32, NT = 256, PW = NT / TF;   // PW position groups
constexpr int NPOS = TW / PW;                            // positions per thread

template <typename T> struct Pack;
template <> struct Pack<int8_t> { static constexpr int PER = 4; };
template <> struct Pack<int16_t> { static constexpr int PER = 1; };

template <typename T>
__device__ __forceinline__ int pack(const T* __restrict__ src, size_t step, int c, int C) {
  if constexpr (Pack<T>::PER == 1) {
    return c < C ? static_cast<int>(src[0]) : 0;
  } else {
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < C) word |= static_cast<unsigned>(static_cast<uint8_t>(src[i * step])) << (8 * i);
    return static_cast<int>(word);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
qconv1d_kernel(const T* __restrict__ x, const T* __restrict__ w, int32_t* __restrict__ out,
               int W, int C, int K, int F, int Wout, int stride, int pad_lo, int w_tiles,
               int rows) {
  constexpr int PER = Pack<T>::PER;
  extern __shared__ int smem[];
  const int CW = (C + PER - 1) / PER;
  int* xs = smem;                 // [rows][CW]
  int* ws = smem + rows * CW;     // [K][CW][TF]

  const int b = blockIdx.x / w_tiles;
  const int w0 = (blockIdx.x % w_tiles) * TW;
  const int f0 = blockIdx.y * TF;
  const int tid = threadIdx.x;
  const int f = tid % TF, pg = tid / TF;

  const int p0 = w0 * stride - pad_lo;     // input position of shared row 0
  const T* xb = x + (size_t)b * W * C;
  for (int e = tid; e < rows * CW; e += NT) {
    const int r = e / CW, cw = e % CW, p = p0 + r;
    xs[e] = (p >= 0 && p < W) ? pack(xb + (size_t)p * C + cw * PER, 1, cw * PER, C) : 0;
  }
  for (int e = tid; e < K * CW * TF; e += NT) {
    const int ff = e % TF, kc = e / TF, cw = kc % CW, k = kc / CW, gf = f0 + ff;
    ws[e] = gf < F ? pack(w + ((size_t)k * C + cw * PER) * F + gf, (size_t)F, cw * PER, C) : 0;
  }
  __syncthreads();

  unsigned acc[NPOS];
#pragma unroll
  for (int i = 0; i < NPOS; ++i) acc[i] = 0u;
  for (int k = 0; k < K; ++k) {
    for (int cw = 0; cw < CW; ++cw) {
      const int wv = ws[(k * CW + cw) * TF + f];
#pragma unroll
      for (int i = 0; i < NPOS; ++i) {
        const int xv = xs[((pg + PW * i) * stride + k) * CW + cw];
        if constexpr (PER == 4)
          acc[i] = static_cast<unsigned>(__dp4a(xv, wv, static_cast<int>(acc[i])));
        else
          acc[i] += static_cast<unsigned>(xv * wv);    // |xv*wv| <= 2^30: no overflow
      }
    }
  }

  const int gf = f0 + f;
  if (gf >= F) return;
  int32_t* ob = out + (size_t)b * Wout * F;
#pragma unroll
  for (int i = 0; i < NPOS; ++i) {
    const int wo = w0 + pg + PW * i;
    if (wo < Wout) ob[(size_t)wo * F + gf] = static_cast<int32_t>(acc[i]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, int32_t* out, int B, int W, int C, int K,
                   int F, int Wout, int stride, int pad_lo, cudaStream_t s) {
  constexpr int PER = Pack<T>::PER;
  const int CW = (C + PER - 1) / PER;
  const int rows = (TW - 1) * stride + K;
  const size_t smem = ((size_t)rows * CW + (size_t)K * CW * TF) * sizeof(int);
  static size_t granted = 48 << 10;        // the default dynamic shared memory limit
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        qconv1d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {      // more than one block can have: refused, and the
      cudaGetLastError();        // error is cleared so no later launch reports it
      return e;
    }
    granted = smem;
  }
  const int w_tiles = (Wout + TW - 1) / TW;
  const dim3 grid((unsigned)B * w_tiles, (F + TF - 1) / TF);
  qconv1d_kernel<T><<<grid, NT, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                           out, W, C, K, F, Wout, stride, pad_lo, w_tiles, rows);
  return cudaGetLastError();
}

}  // namespace

// x (B, W, C) and w (K, C, F), both int8 (in_bytes 1) or both int16
// (in_bytes 2); out (B, Wout, F) int32.  Input position of output o, tap k:
// o * stride + k - pad_lo (outside [0, W) reads 0).  Returns
// cudaGetLastError() after the launch, or cudaFuncSetAttribute's error,
// with no launch, when a block would need more shared memory than it can
// have (C, K and stride set how much; C=80 int16 at K=3 needs 51,840 B).
extern "C" int qconv1d_int(const void* x, const void* w, int in_bytes, int32_t* out, int B,
                           int W, int C, int K, int F, int Wout, int stride, int pad_lo,
                           void* stream) {
  if ((in_bytes != 1 && in_bytes != 2) || B < 0 || W < 0 || C < 1 || K < 1 || F < 0 ||
      Wout < 0 || stride < 1 || pad_lo < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || F == 0 || Wout == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      in_bytes == 1 ? launch<int8_t>(x, w, out, B, W, C, K, F, Wout, stride, pad_lo, s)
                    : launch<int16_t>(x, w, out, B, W, C, K, F, Wout, stride, pad_lo, s));
}
