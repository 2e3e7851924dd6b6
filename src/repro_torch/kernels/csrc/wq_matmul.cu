// Weight-only int8 matmul: out (M, N) = (x (M, K) f32 @ w (K, N) int8) * scale.
//
// Replaces repro/kernels/wq_matmul.py::wq_matmul_pallas.  The weight stays
// int8 in device memory; each K x N tile is widened to f32 in shared memory
// right after its load, and the products are summed in f32.  The pow2
// scale (per output channel, or one for the tensor) commutes with the sum,
// so it is applied once in the epilogue.
//
// Bound on an H100: at decode (M = batch) the int8 weight bytes, one read
// of K*N per call; at prefill (M = batch * prompt) the f32 FMAs on the CUDA
// cores.  Neither path uses tensor cores or TMA yet.  Every edge (M, K, N
// not multiples of a tile) is masked.
//
// * M <= 8 (decode): the work is small, so it has to spread over many SMs
//   and keep many loads in flight.  Each block owns 32 columns and all of
//   K; its 256 threads form 32 row groups of 8 lanes, each lane reading 4
//   neighbouring bytes of a row (a row group reads one 32-byte sector).
//   Each row group keeps 8 rows' loads in flight: the next 8 are issued
//   before the current 8 are used, and the first before x is staged.  x is
//   staged transposed, so one row of x is two 16-byte shared loads; the int8
//   bytes are widened with integer byte permutes (the conversion instruction
//   runs at a quarter of the FMA rate).  The 32 partial sums per output are
//   added in a fixed order, so results are reproducible.
// * M > 8 (prefill): a plain shared-memory tiling; each block owns a BM x BN
//   output tile, each thread TM x TN outputs, and the block walks K in BK
//   steps.  Neighbouring threads read neighbouring n, so each weight row
//   loads coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;          // rows of x per decode block (M <= kRows)
constexpr int kLanesPerRow = 8;   // lanes sharing one weight row, 4 bytes each
constexpr int kGroups = 256 / kLanesPerRow;
constexpr int kCols = 4 * kLanesPerRow;
constexpr int kKChunk = 1536;     // K rows of x staged at once (48 KB of shared memory)
constexpr int kUnroll = 8;        // weight rows in flight per row group

// Rows k0, k0 + kGroups, ... of this lane's 4 columns as packed bytes (zero
// past kn or N).
__device__ __forceinline__ void load_rows(uint32_t (&wv)[kUnroll], const int8_t* __restrict__ w,
                                          int kc0, int k0, int kn, int col, int N, bool vec) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int kk = k0 + u * kGroups;
    wv[u] = 0;
    if (kk < kn) {
      const int8_t* p = w + (size_t)(kc0 + kk) * N + col;
      if (vec) {
        wv[u] = *reinterpret_cast<const uint32_t*>(p);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) wv[u] |= (uint32_t)(uint8_t)p[j] << (8 * j);
      }
    }
  }
}

// Byte j of a packed word as a signed float: bias to unsigned, drop the
// byte into the mantissa of 2^23, subtract 2^23 + 128.
__device__ __forceinline__ float4 widen(uint32_t packed) {
  const uint32_t u = packed ^ 0x80808080u;
  return make_float4(__int_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f,
                     __int_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f,
                     __int_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f,
                     __int_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f);
}

__global__ void __launch_bounds__(256)
wq_matmul_rows_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, int scale_stride,
                      float* __restrict__ out, int M, int K, int N) {
  // x transposed while summing, then the row groups' partial sums
  __shared__ __align__(16) float smem[kKChunk * kRows];
  static_assert(kGroups * kRows * kCols <= kKChunk * kRows, "reduction fits");
  float (*xs)[kRows] = reinterpret_cast<float (*)[kRows]>(smem);
  float (*red)[kRows][kCols] = reinterpret_cast<float (*)[kRows][kCols]>(smem);

  const int group = threadIdx.x / kLanesPerRow;
  const int lane = threadIdx.x % kLanesPerRow;
  const int col = blockIdx.x * kCols + lane * 4;
  const bool vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0) && (col + 3 < N);

  float acc[kRows][4];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int kc0 = 0; kc0 < K; kc0 += kKChunk) {
    const int kn = min(kKChunk, K - kc0);
    uint32_t cur[kUnroll], nxt[kUnroll];
    load_rows(cur, w, kc0, group, kn, col, N, vec);   // in flight while x is staged
    __syncthreads();
#pragma unroll 8
    for (int e = threadIdx.x; e < kRows * kn; e += 256) {
      const int kk = e / kRows, m = e % kRows;
      xs[kk][m] = m < M ? x[(size_t)m * K + kc0 + kk] : 0.f;
    }
    __syncthreads();
    for (int k0 = group; k0 < kn; k0 += kGroups * kUnroll) {
      const int k1 = k0 + kGroups * kUnroll;
      if (k1 < kn) load_rows(nxt, w, kc0, k1, kn, col, N, vec);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = k0 + u * kGroups;
        if (kk < kn) {
          const float4 wf = widen(cur[u]);
          const float4 xa = *reinterpret_cast<const float4*>(&xs[kk][0]);
          const float4 xb = *reinterpret_cast<const float4*>(&xs[kk][4]);
          const float xm[kRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int m = 0; m < kRows; ++m) {
            acc[m][0] = fmaf(xm[m], wf.x, acc[m][0]);
            acc[m][1] = fmaf(xm[m], wf.y, acc[m][1]);
            acc[m][2] = fmaf(xm[m], wf.z, acc[m][2]);
            acc[m][3] = fmaf(xm[m], wf.w, acc[m][3]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
    }
  }
  __syncthreads();   // x no longer read: the buffer takes the partial sums
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[group][m][lane * 4 + j] = acc[m][j];
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kCols; e += 256) {
    const int m = e / kCols, c = e % kCols;
    const int gc = blockIdx.x * kCols + c;
    if (m < M && gc < N) {
      float s = 0.f;
      for (int g = 0; g < kGroups; ++g) s += red[g][m][c];
      out[(size_t)m * N + gc] = s * scale[(size_t)gc * scale_stride];
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
wq_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, int scale_stride,
                 float* __restrict__ out, int M, int K, int N) {
  constexpr int TX = BN / TN;          // threads along N
  constexpr int NT = TX * (BM / TM);   // threads per block
  __shared__ float xs[BK][BM + 1];     // x tile, transposed; +1 avoids bank conflicts
  __shared__ float ws[BK][BN];         // weight tile, widened to f32

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int m = e / BK, kk = e % BK;
      const int gm = row0 + m, gk = k0 + kk;
      xs[kk][m] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN, n = e % BN;
      const int gk = k0 + kk, gn = col0 + n;
      ws[kk][n] = (gk < K && gn < N) ? static_cast<float>(w[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx + j * TX;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j] * scale[(size_t)gn * scale_stride];
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
void launch(const float* x, const int8_t* w, const float* scale, int scale_stride,
            float* out, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  wq_matmul_kernel<BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      x, w, scale, scale_stride, out, M, K, N);
}

}  // namespace

// x (M, K) f32, w (K, N) int8, both row-major and contiguous; scale has N
// entries (scale_stride 1) or one (scale_stride 0); out (M, N) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int wq_matmul_f32_s8(const float* x, const int8_t* w, const float* scale,
                                int scale_stride, float* out, int M, int K, int N,
                                void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= kRows) {
    wq_matmul_rows_kernel<<<(N + kCols - 1) / kCols, 256, 0, s>>>(x, w, scale, scale_stride,
                                                                  out, M, K, N);
  } else {
    launch<64, 64, 16, 4, 4>(x, w, scale, scale_stride, out, M, K, N, s);  // prefill rows
  }
  return static_cast<int>(cudaGetLastError());
}
