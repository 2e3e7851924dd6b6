// Integer matmul with an int32 accumulator, and the same with a shift-only
// requantization epilogue:
//   qmm:          out (M, N) int32 = x (M, K) @ w (K, N), summed modulo 2^32
//   qmm_requant:  out = clip(acc >> shift  (shift >= 0)
//                            acc << -shift (shift < 0, wrapping), qmin, qmax)
// with x and w both int8 or both int16, row-major and contiguous.
//
// Replaces repro/kernels/qmm.py::qmm_pallas and ::qmm_requant_pallas.  The
// TPU kernel carries an int32 VMEM accumulator across a sequential K grid
// axis; here each block owns a BM x BN output tile and walks all of K
// itself, so nothing carries between blocks.  XLA's int32 dot wraps on
// overflow, and signed overflow is undefined in C++, so the sums are
// unsigned (or the dp4a instruction, whose 32-bit add wraps).  The shift
// is read from device memory (the TPU kernel's SMEM scalar): the caller
// never reads it back.  XLA's shift semantics are reproduced explicitly,
// as a bare >> or << by 32 or more is undefined: a right shift of 32 or
// more gives the sign fill, a left shift of 32 or more gives 0, and a
// smaller left shift wraps.
//
// Bound on an H100: at the classifier's (2947, 80) @ (80, 6) the bytes
// (one wave of 47 blocks, under 1 MB moved); at large M, N, K the integer
// multiply-adds.  int8 takes dp4a, four products per instruction on the
// CUDA cores; int16 has no tensor-core MMA and no dp4a form, so it takes
// one 32-bit multiply-add per product.  The integer tensor cores (mma s8)
// are the next step for int8 at large shapes.
//
// Tiles: BM = BN = 64, 256 threads of 4 x 4 outputs each (rows ty + 16 i,
// columns tx + 16 j).  Each K step stages x and w^T in shared memory as
// 32-bit words, four int8 codes (or one int16 code) per word along K, so
// both operands of a product are one word read; the rows are padded by a
// word against bank conflicts.  Every edge (M, N, K) is masked to 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, TM = 4, TN = 4;
constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;

template <typename T> struct Pack;
template <> struct Pack<int8_t> { static constexpr int PER = 4, KW = 8; };   // BK = 32
template <> struct Pack<int16_t> { static constexpr int PER = 1, KW = 16; };  // BK = 16

// codes src[0], src[step], ... (PER of them, those at k >= K read as 0) in one word
template <typename T>
__device__ __forceinline__ int pack(const T* __restrict__ src, size_t step, int k, int K) {
  if constexpr (Pack<T>::PER == 1) {
    return k < K ? static_cast<int>(src[0]) : 0;
  } else {
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k + i < K) word |= static_cast<unsigned>(static_cast<uint8_t>(src[i * step])) << (8 * i);
    return static_cast<int>(word);
  }
}

__device__ __forceinline__ int requant(unsigned acc, int shift, int lo, int hi) {
  const int v = static_cast<int>(acc);
  int r;
  if (shift >= 0) {
    r = shift >= 32 ? (v < 0 ? -1 : 0) : (v >> shift);
  } else {
    const long long ls = -static_cast<long long>(shift);
    r = ls >= 32 ? 0 : static_cast<int>(acc << ls);
  }
  return r < lo ? lo : (r > hi ? hi : r);
}

template <typename T, typename O>
__global__ void __launch_bounds__(NT)
qmm_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ shift,
           O* __restrict__ out, int lo, int hi, int M, int K, int N) {
  constexpr int PER = Pack<T>::PER, KW = Pack<T>::KW, BK = PER * KW;
  __shared__ int xs[BM][KW + 1];
  __shared__ int ws[BN][KW + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;

  unsigned acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * KW; e += NT) {
      const int m = e / KW, kw = e % KW, gm = row0 + m, gk = k0 + kw * PER;
      xs[m][kw] = gm < M ? pack(x + (size_t)gm * K + gk, 1, gk, K) : 0;
    }
    for (int e = tid; e < BN * KW; e += NT) {
      const int n = e % BN, kw = e / BN, gn = col0 + n, gk = k0 + kw * PER;
      ws[n][kw] = gn < N ? pack(w + (size_t)gk * N + gn, (size_t)N, gk, K) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + TY * i][kw];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[tx + TX * j][kw];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if constexpr (PER == 4)
            acc[i][j] = static_cast<unsigned>(__dp4a(a[i], b[j], static_cast<int>(acc[i][j])));
          else
            acc[i][j] += static_cast<unsigned>(a[i] * b[j]);   // |a*b| <= 2^30: no overflow
        }
    }
    __syncthreads();
  }

  const int s = shift ? *shift : 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty + TY * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx + TX * j;
      if (gn >= N) continue;
      out[(size_t)gm * N + gn] = shift ? static_cast<O>(requant(acc[i][j], s, lo, hi))
                                       : static_cast<O>(static_cast<int>(acc[i][j]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* shift, void* out, int out_bytes,
                   int lo, int hi, int M, int K, int N, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  if (out_bytes == 4)
    qmm_kernel<T, int32_t><<<grid, NT, 0, s>>>(xt, wt, nullptr, static_cast<int32_t*>(out),
                                               lo, hi, M, K, N);
  else if (out_bytes == 2)
    qmm_kernel<T, int16_t><<<grid, NT, 0, s>>>(xt, wt, shift, static_cast<int16_t*>(out), lo,
                                               hi, M, K, N);
  else
    qmm_kernel<T, int8_t><<<grid, NT, 0, s>>>(xt, wt, shift, static_cast<int8_t*>(out), lo, hi,
                                              M, K, N);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) and w (K, N), both int8 (in_bytes 1) or both int16 (in_bytes 2).
// shift NULL: out (M, N) int32 (out_bytes 4).  shift a device int32: out
// (M, N) int8 or int16 (out_bytes 1 or 2), clipped to [lo, hi].  Returns
// cudaGetLastError() after the launch.
extern "C" int qmm_int(const void* x, const void* w, int in_bytes, const int* shift, void* out,
                       int out_bytes, int lo, int hi, int M, int K, int N, void* stream) {
  if ((in_bytes != 1 && in_bytes != 2) || (shift == nullptr) != (out_bytes == 4) ||
      (out_bytes != 1 && out_bytes != 2 && out_bytes != 4) || M < 0 || K < 0 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(in_bytes == 1
                              ? launch<int8_t>(x, w, shift, out, out_bytes, lo, hi, M, K, N, s)
                              : launch<int16_t>(x, w, shift, out, out_bytes, lo, hi, M, K, N, s));
}
