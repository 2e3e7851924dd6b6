// Packed int4 weight-only matmul:
//   out (M, N) = sum_k x[m, k] * (nibble[k, n] * scale[k / block_size, n])
// with x (M, K) f32, the weight as (ceil(K/2), N) int8 bytes whose byte row
// j holds logical rows 2j (low nibble) and 2j+1 (high nibble) in two's
// complement, and scale f32 2^-n per output channel (1, N) or per block of
// block_size K rows (ceil(K/block_size), N).  Sums are f32.
//
// Replaces repro/kernels/wq_matmul.py::wq4_matmul_pallas.  As there, each
// weight tile is unpacked on chip and its scale rows are applied to the
// weights before the products (a scale that varies along K cannot move to
// the epilogue); only int4 bytes and the scale grid come from device memory.
//
// Bound on an H100: at decode (M = 8) the weight bytes, half of int8's; at
// M = 32-1024 the f32 FMAs on the CUDA cores (no tensor cores yet).  The
// serving shapes are small (K = 576 or 1536, N = 192-1536), so an output
// tiling alone gives a few dozen blocks: fewer than the 132 SMs.  The
// wrapper therefore splits K across blocks (gridDim.z) until the launch
// covers about two waves; each split writes its partial sums to its own
// slice of a workspace, and a second kernel adds the slices in split order.
// No float atomics: the result is the same on every run.
//
// Each block owns a BM x BN output tile and walks its K range in BK-row
// steps: it stages x transposed and the weight unpacked and scaled to f32
// in shared memory, then each thread accumulates TM x TN outputs from
// float4 reads.  Every edge (M, N, odd K, a partial block) is masked; x is
// never read past column K, and rows past K weigh zero.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32, BN = 64, BK = 32;   // BK logical K rows = BK / 2 byte rows
constexpr int TM = 4, TN = 4;
constexpr int TX = BN / TN;                // threads along N
constexpr int NT = TX * (BM / TM);         // threads per block

__global__ void __launch_bounds__(NT)
wq4_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, int block_size,
                  float* __restrict__ dst, int M, int K, int N, int k_per_split) {
  __shared__ __align__(16) float xs[BK][BM + 4];   // +4 keeps rows float4-aligned
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_per_split;       // even: k_per_split is a multiple of BK
  const int kend = min(K, kbeg + k_per_split);
  const int kp = (K + 1) / 2;
  const bool vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  const bool active = row0 + ty * TM < M;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int m = e / BK, kk = e % BK;
      const int gm = row0 + m, gk = k0 + kk;
      xs[kk][m] = (gm < M && gk < kend) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int e = tid; e < (BK / 2) * (BN / 4); e += NT) {
      const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
      const int gr = k0 / 2 + r, gc = col0 + c;
      uint32_t word = 0;
      if (gr < kp) {
        const int8_t* p = w + (size_t)gr * N + gc;
        if (vec && gc + 3 < N) {
          word = *reinterpret_cast<const uint32_t*>(p);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gc + j < N) word |= (uint32_t)(uint8_t)p[j] << (8 * j);
        }
      }
      const int k_lo = k0 + 2 * r;               // logical row of the low nibbles
      const size_t s_lo = (size_t)(block_size ? k_lo / block_size : 0) * N;
      const size_t s_hi = (size_t)(block_size ? (k_lo + 1) / block_size : 0) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = (int)(int8_t)(uint8_t)(word >> (8 * j));
        const int lo = (b << 28) >> 28, hi = b >> 4;
        const bool col_ok = gc + j < N;
        ws[2 * r][c + j] = (col_ok && k_lo < kend) ? lo * scale[s_lo + gc + j] : 0.f;
        ws[2 * r + 1][c + j] = (col_ok && k_lo + 1 < kend) ? hi * scale[s_hi + gc + j] : 0.f;
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* out = dst + (size_t)blockIdx.z * M * N;   // this split's slice (the output if one)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx * TN + j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

// out[i] = sum over splits p = 0, 1, ... of work[p][i], in that order.
__global__ void __launch_bounds__(256)
reduce_splits_kernel(const float* __restrict__ work, float* __restrict__ out, int mn,
                     int splits) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= mn) return;
  float s = work[i];
  for (int p = 1; p < splits; ++p) s += work[(size_t)p * mn + i];
  out[i] = s;
}

}  // namespace

// x (M, K) f32, w (ceil(K/2), N) int8, scale (1, N) f32 when block_size is 0
// or (ceil(K/block_size), N) f32, all row-major and contiguous; out (M, N)
// f32.  K is cut into `splits` ranges of k_per_split rows (a multiple of 32);
// with more than one, work holds splits * M * N f32 partial sums.  Returns
// cudaGetLastError() after the launches.
extern "C" int wq4_matmul_f32_s4(const float* x, const int8_t* w, const float* scale,
                                 int block_size, float* out, float* work, int M, int K, int N,
                                 int splits, int k_per_split, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (splits < 1 || k_per_split % BK || (block_size & 1) || block_size < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  wq4_matmul_kernel<<<grid, NT, 0, s>>>(x, w, scale, block_size, splits > 1 ? work : out, M,
                                        K, N, k_per_split);
  if (splits > 1) {
    const int mn = M * N;
    reduce_splits_kernel<<<(mn + 255) / 256, 256, 0, s>>>(work, out, mn, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
