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
// the (K, C, TF) weights go to shared memory one chunk of channels at a
// time (all of C at once up to 64 KB: every ResNetv1-6 layer, C <= 80;
// past that the chunks walk C, and the taps too where one channel of all
// K taps would not fit), so each input element is read from device memory
// about once per filter tile and any C, K and stride fits.  Padding is
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

#include <algorithm>

namespace {

constexpr int TW = 64, TF = 32, NT = 256, PW = NT / TF;   // PW position groups
constexpr int NPOS = TW / PW;                            // positions per thread
constexpr size_t kSmemBudget = 64 << 10;                 // dynamic shared memory per block

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

// kChunked false: all K taps and all C channels in one chunk (KC = K,
// CC = CW), with the input rows of TW outputs as one contiguous span
// (every ResNetv1-6 layer).  kChunked true: taps in chunks of KC and channel
// words in chunks of CC, the sums carried over (they wrap modulo 2^32 in
// any order); shared row r then holds input position
// p0 + (r / RS) * stride + r % RS with RS = min(stride, KC): the span of the
// chunk's taps when stride <= KC, else KC taps per output.  One loop for
// both made the int8 ResNetv1-6 forward 8% slower (PERF.md).
template <typename T, bool kChunked>
__global__ void __launch_bounds__(NT)
qconv1d_kernel(const T* __restrict__ x, const T* __restrict__ w, int32_t* __restrict__ out,
               int W, int C, int K, int F, int Wout, int stride, int pad_lo, int w_tiles,
               int KC, int CC) {
  constexpr int PER = Pack<T>::PER;
  extern __shared__ int smem[];
  const int CW = (C + PER - 1) / PER;
  if constexpr (!kChunked) {
    KC = K;
    CC = CW;
  }
  const int RS = kChunked ? min(stride, KC) : stride;   // shared rows per output position
  const bool span = !kChunked || stride <= KC;          // row r holds position p0 + r
  const int rows = (TW - 1) * RS + KC;
  int* xs = smem;                 // [rows][CC]
  int* ws = smem + rows * CC;     // [KC][CC][TF]

  const int b = blockIdx.x / w_tiles;
  const int w0 = (blockIdx.x % w_tiles) * TW;
  const int f0 = blockIdx.y * TF;
  const int tid = threadIdx.x;
  const int f = tid % TF, pg = tid / TF;
  const T* xb = x + (size_t)b * W * C;

  unsigned acc[NPOS];
#pragma unroll
  for (int i = 0; i < NPOS; ++i) acc[i] = 0u;

  // taps [k0, k0 + kn) and channel words [c0, c0 + cn)
  auto chunk = [&](int k0, int kn, int c0, int cn) {
    const int p0 = w0 * stride + k0 - pad_lo;   // input position of shared row 0
    for (int e = tid; e < rows * cn; e += NT) {
      const int r = e / cn, cw = c0 + e % cn;
      const int p = span ? p0 + r : p0 + (r / RS) * stride + r % RS;
      xs[r * CC + cw - c0] =
          (p >= 0 && p < W) ? pack(xb + (size_t)p * C + cw * PER, 1, cw * PER, C) : 0;
    }
    for (int e = tid; e < kn * cn * TF; e += NT) {
      const int ff = e % TF, kc = e / TF, cw = c0 + kc % cn, k = kc / cn, gf = f0 + ff;
      ws[(k * CC + cw - c0) * TF + ff] =
          gf < F ? pack(w + ((size_t)(k0 + k) * C + cw * PER) * F + gf, (size_t)F, cw * PER, C)
                 : 0;
    }
    __syncthreads();
    for (int k = 0; k < kn; ++k) {
      for (int cw = 0; cw < cn; ++cw) {
        const int wv = ws[(k * CC + cw) * TF + f];
#pragma unroll
        for (int i = 0; i < NPOS; ++i) {
          const int xv = xs[((pg + PW * i) * RS + k) * CC + cw];
          if constexpr (PER == 4)
            acc[i] = static_cast<unsigned>(__dp4a(xv, wv, static_cast<int>(acc[i])));
          else
            acc[i] += static_cast<unsigned>(xv * wv);    // |xv*wv| <= 2^30: no overflow
        }
      }
    }
  };
  if constexpr (kChunked) {
    for (int k0 = 0; k0 < K; k0 += KC)
      for (int c0 = 0; c0 < CW; c0 += CC) {
        if (k0 + c0 > 0) __syncthreads();   // every thread is done with the last chunk
        chunk(k0, min(KC, K - k0), c0, min(CC, CW - c0));
      }
  } else {
    chunk(0, K, 0, CW);
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

// Shared memory per channel word for taps in chunks of kc, rows_per_out
// shared rows per output position: the input rows and (kc, 1, TF) weights.
inline size_t bytes_per_word(int kc, int rows_per_out) {
  return ((size_t)(TW - 1) * rows_per_out + kc + (size_t)kc * TF) * sizeof(int);
}

template <typename T, bool kChunked>
cudaError_t launch_chunks(const T* x, const T* w, int32_t* out, int B, int W, int C, int K,
                          int F, int Wout, int stride, int pad_lo, int kc, int cc, size_t smem,
                          cudaStream_t s) {
  static bool granted = false;   // the budget is above the default 48 KB
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        qconv1d_kernel<T, kChunked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBudget);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    granted = true;
  }
  const int w_tiles = (Wout + TW - 1) / TW;
  const dim3 grid((unsigned)B * w_tiles, (F + TF - 1) / TF);
  qconv1d_kernel<T, kChunked><<<grid, NT, smem, s>>>(x, w, out, W, C, K, F, Wout, stride,
                                                     pad_lo, w_tiles, kc, cc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, int32_t* out, int B, int W, int C, int K,
                   int F, int Wout, int stride, int pad_lo, cudaStream_t s) {
  constexpr int PER = Pack<T>::PER;
  const int CW = (C + PER - 1) / PER;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const size_t whole = (size_t)CW * bytes_per_word(K, stride);
  if (whole <= kSmemBudget)   // one chunk: every ResNetv1-6 layer (C <= 80)
    return launch_chunks<T, false>(xt, wt, out, B, W, C, K, F, Wout, stride, pad_lo, K, CW,
                                   whole, s);
  // All K taps at once unless one channel word of them would not fit
  // (halving until it does: one tap always fits), then as many channel
  // words per chunk as fit.
  int kc = K;
  while (kc > 1 && bytes_per_word(kc, std::min(stride, kc)) > kSmemBudget) kc = (kc + 1) / 2;
  const size_t per_word = bytes_per_word(kc, std::min(stride, kc));
  const int cc = (int)std::min<size_t>(CW, kSmemBudget / per_word);
  return launch_chunks<T, true>(xt, wt, out, B, W, C, K, F, Wout, stride, pad_lo, kc, cc,
                                (size_t)cc * per_word, s);
}

}  // namespace

// x (B, W, C) and w (K, C, F), both int8 (in_bytes 1) or both int16
// (in_bytes 2); out (B, Wout, F) int32.  Input position of output o, tap k:
// o * stride + k - pad_lo (outside [0, W) reads 0).  Any C, K and stride:
// a block walks C (and, past 64 KB for one channel, the taps) in chunks.
// Returns cudaGetLastError() after the launch.
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
