// Integer 1-D convolution, channels last, into an int32 accumulator:
//   out (B, W', F) int32 = sum_{k, c} xpad[b, w*stride + k, c] * w[k, c, f]
// summed modulo 2^32, with x (B, W, C) and w (K, C, F) both int8 or both
// int16, row-major and contiguous.  SAME pads pad_total // 2 positions
// low and the rest high (XLA's rule); VALID pads nothing.
//
// Replaces repro/kernels/qconv1d.py::qconv1d_pallas, which runs K shifted
// (W' x C) @ (C x F) matmuls over one VMEM-resident padded row per grid
// step.  Here the convolution is an implicit GEMM on the integer tensor
// cores (the tile core of int_mma.cuh; int16 as four 8-bit products on a
// hi/lo byte split): GEMM rows are output positions, columns filters, and
// the reduction runs over (tap, channel).
//
// A block owns BM GEMM rows (128 for int8, 64 for int16) and a tile of BN
// filters (32 or 80; kernels/int_mma.py, `conv_plan`, picks it and the
// rest).  Its rows are `segs` segments of `seg_len` consecutive output
// positions each: whole batch rows when W' is small (conv4/5, W' = 32:
// four batch rows fill an int8 tile), tiles of one batch row when W' is
// large.  The block stages in shared memory each segment's input rows,
// halo included (padding and rows past the batch masked to 0), channels
// zero-padded to a multiple of 16, and all (K, C, BN) weights transposed
// to [f][(k, c)] bytes (4 x 4 blocks with __byte_perm).  For tap k each
// lane hands ldmatrix the address of shared row s * rows + p * stride + k,
// so the im2col costs nothing and reads no extra byte; a channel depth of
// 32 is one mma k32, a 16-deep rest (C = 80, and ResNetv1-6's conv1 with
// C = 9 padded to 16) one mma k16.  Row pitches are odd multiples of 16
// bytes: at stride 1 the 8 rows of an ldmatrix fall in distinct bank
// groups.  Past one block's shared-memory budget the block walks C (and,
// where one 16-channel slice of all taps would not fit, the taps) in
// chunks, carrying the sums, which wrap modulo 2^32 in any order: any C, K
// and stride run, in one launch.  The int32 output leaves in 16-byte
// stores (each lane swaps half a fragment with its neighbour for 4
// consecutive filters of one row).
//
// Bound on an H100: bytes.  The int32 output is 4x the int8 input; at
// B = 2947, W = 128, F = 80 it writes 120.7 MB (36 us at 3.35 TB/s)
// against 7.3 us of int8 tensor-core work (29 us for int16 at a quarter of
// the int8 rate).
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_mma.cuh"

namespace {

using int_mma::pitch;

constexpr int NT = 256;
constexpr size_t kSmemMax = 232448;   // dynamic shared memory one H100 block can have

template <typename T, int NF>
struct Geo {
  static constexpr bool W16 = sizeof(T) == 2;
  static constexpr int BM = W16 ? 64 : 128;            // GEMM rows per block
  static constexpr int WM = BM / 16, WN = 8 / WM;      // warps along M and N
  static constexpr int FN = NF / WN, BN = 8 * NF;      // n8 fragments per warp, filters per block
  static constexpr int NP = W16 ? 2 : 1;               // byte planes per operand
};

// Bytes of shared memory a plan needs: the planes of the segments' input
// rows, then those of the weights (kernels/int_mma.py, `conv_smem`).
size_t smem_bytes(int in_bytes, int nf, int seg_len, int segs, int kc, int cc, int stride) {
  const long long rows = (long long)(seg_len - 1) * stride + kc;
  return (size_t)(in_bytes == 2 ? 2 : 1) *
         ((size_t)segs * rows * pitch(cc) + (size_t)8 * nf * pitch(kc * cc));
}

// Output position o, tap k reads input position o * stride + k - pad_lo
// (outside [0, W) reads 0).  GEMM row m is position m % seg_len of segment
// m / seg_len; segment gs = blockIdx.x * segs + s is tile gs % wt of batch
// row gs / wt, wt = ceil(Wout / seg_len).  Taps in chunks of kc, channels
// in chunks of cc (a multiple of 16).
//
// Occupancy (chip_smoke.py's ResNetv1-6 shapes, measured against other
// settings on the H100): int8 blocks run four to an SM (at most 64
// registers a thread) and start the loads of two staging tasks before their
// stores; int16 blocks, with three accumulators, run two to an SM and
// stage one task at a time.
template <typename T, int NF>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 2 : 4)
qconv1d_kernel(const T* __restrict__ x, const T* __restrict__ w, int32_t* __restrict__ out,
               int B, int W, int C, int K, int F, int Wout, int stride, int pad_lo, int seg_len,
               int segs, int kc, int cc, int vec_x, int vec_w) {
  using G = Geo<T, NF>;
  constexpr int BN = G::BN, WM = G::WM, FN = G::FN;
  constexpr int EPC = 16 / sizeof(T);   // codes per 16-byte load
  constexpr int U = G::W16 ? 1 : 2;     // staging tasks whose loads a thread has in flight
  extern __shared__ __align__(16) uint8_t smem[];
  const int xp = pitch(cc), wp = pitch(kc * cc);
  const int sr = (seg_len - 1) * stride + kc;              // shared input rows per segment
  const int xplane = segs * sr * xp, wplane = BN * wp;     // bytes of one byte plane
  uint8_t* xs = smem;                                      // [NP][segs * sr][xp]
  uint8_t* ws = smem + G::NP * xplane;                     // [NP][BN][wp]
  const int CP = (C + 15) / 16 * 16;
  const int wt = (Wout + seg_len - 1) / seg_len;
  const int f0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp % WM) * 16, wn0 = (warp / WM) * FN * 8;

  // this lane's ldmatrix row of A at tap 0 (rows past the segments: row 0)
  int a_row = 0;
  {
    const int m = wm0 + (lane & 15), s = m / seg_len;
    if (s < segs) a_row = s * sr + (m % seg_len) * stride;
  }
  const uint32_t a_base = int_mma::smem_addr(xs) + a_row * xp + (lane >> 4) * 16;
  const uint32_t b_base = int_mma::smem_addr(ws) + (wn0 + (lane & 7) + (lane >> 4) * 8) * wp +
                          ((lane >> 3) & 1) * 16;

  int_mma::Tile<sizeof(T), 1, FN> tile;
  tile.zero();

  for (int k0 = 0; k0 < K; k0 += kc) {
    for (int c0 = 0; c0 < CP; c0 += cc) {
      const int kn = min(kc, K - k0), cn = min(cc, CP - c0);
      const int rows = (seg_len - 1) * stride + kn;
      if (k0 + c0 > 0) __syncthreads();   // every warp is done with the last chunk

      // input rows: shared row r of segment s holds input position
      // seg_p0 + k0 + r, channels [c0, c0 + cn).  Each loop starts the
      // loads of U tasks before their stores: one latency per U tasks.
      if (vec_x) {
        const int qn = cn / EPC, total = segs * rows * qn;
        for (int e0 = tid; e0 < total; e0 += U * NT) {
          uint4 v[U];
          int dst[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = e0 + u * NT;
            v[u] = make_uint4(0u, 0u, 0u, 0u);
            dst[u] = -1;
            if (e >= total) continue;
            const int q = e % qn, sr_ = e / qn, r = sr_ % rows, s = sr_ / rows;
            const int gs = blockIdx.x * segs + s, b = gs / wt;
            const int pos = (gs % wt) * seg_len * stride - pad_lo + k0 + r, c = c0 + q * EPC;
            dst[u] = (s * sr + r) * xp + q * (G::W16 ? 8 : 16);
            if (b < B && pos >= 0 && pos < W && c < C)
              v[u] = *reinterpret_cast<const uint4*>(x + ((size_t)b * W + pos) * C + c);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (dst[u] < 0) continue;
            if constexpr (G::W16) {
              uint2 hv, lv;
              int_mma::split_row(v[u].x, v[u].y, hv.x, lv.x);
              int_mma::split_row(v[u].z, v[u].w, hv.y, lv.y);
              *reinterpret_cast<uint2*>(xs + dst[u]) = hv;
              *reinterpret_cast<uint2*>(xs + xplane + dst[u]) = lv;
            } else {
              *reinterpret_cast<uint4*>(xs + dst[u]) = v[u];
            }
          }
        }
      } else {
        const int total = segs * rows * cn;
        for (int e0 = tid; e0 < total; e0 += U * NT) {
          int v[U], dst[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = e0 + u * NT;
            v[u] = 0;
            dst[u] = -1;
            if (e >= total) continue;
            const int ci = e % cn, sr_ = e / cn, r = sr_ % rows, s = sr_ / rows;
            const int gs = blockIdx.x * segs + s, b = gs / wt;
            const int pos = (gs % wt) * seg_len * stride - pad_lo + k0 + r, c = c0 + ci;
            dst[u] = (s * sr + r) * xp + ci;
            if (b < B && pos >= 0 && pos < W && c < C)
              v[u] = static_cast<int>(x[((size_t)b * W + pos) * C + c]);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (dst[u] < 0) continue;
            xs[dst[u]] = static_cast<uint8_t>(G::W16 ? (v[u] >> 8) : v[u]);
            if constexpr (G::W16) xs[xplane + dst[u]] = static_cast<uint8_t>(v[u]);
          }
        }
      }

      // weights: plane row n holds w[k0 + k, c0 + c, f0 + n] at byte k * cc + c
      if (vec_w) {
        constexpr int NG = G::W16 ? 2 : 4;   // filters per 32-bit word
        const int c4n = cn / 4, total = kn * c4n * (BN / NG);
        for (int e0 = tid; e0 < total; e0 += U * NT) {
          uint32_t r[U][4];
          int dst[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = e0 + u * NT;
            dst[u] = -1;
#pragma unroll
            for (int i = 0; i < 4; ++i) r[u][i] = 0u;
            if (e >= total) continue;
            const int ng = e % (BN / NG), kc4 = e / (BN / NG), c4 = kc4 % c4n, k = kc4 / c4n;
            const int c = c0 + c4 * 4, n = f0 + ng * NG;
            dst[u] = (ng * NG) * wp + k * cc + c4 * 4;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (c + i < C && n < F)
                r[u][i] = *reinterpret_cast<const uint32_t*>(
                    w + ((size_t)(k0 + k) * C + c + i) * F + n);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (dst[u] < 0) continue;
            uint8_t* d = ws + dst[u];
            if constexpr (G::W16) {
              uint32_t hv[2], lv[2];
              int_mma::split_cols(r[u][0], r[u][1], r[u][2], r[u][3], hv, lv);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                *reinterpret_cast<uint32_t*>(d + h * wp) = hv[h];
                *reinterpret_cast<uint32_t*>(d + wplane + h * wp) = lv[h];
              }
            } else {
              uint32_t cols[4];
              int_mma::transpose4(r[u][0], r[u][1], r[u][2], r[u][3], cols);
#pragma unroll
              for (int j = 0; j < 4; ++j) *reinterpret_cast<uint32_t*>(d + j * wp) = cols[j];
            }
          }
        }
      } else {
        const int total = kn * cn * BN;
        for (int e0 = tid; e0 < total; e0 += U * NT) {
          int v[U], dst[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = e0 + u * NT;
            v[u] = 0;
            dst[u] = -1;
            if (e >= total) continue;
            const int n = e % BN, kci = e / BN, ci = kci % cn, k = kci / cn, c = c0 + ci;
            dst[u] = n * wp + k * cc + ci;
            if (c < C && f0 + n < F)
              v[u] = static_cast<int>(w[((size_t)(k0 + k) * C + c) * F + f0 + n]);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (dst[u] < 0) continue;
            ws[dst[u]] = static_cast<uint8_t>(G::W16 ? (v[u] >> 8) : v[u]);
            if constexpr (G::W16) ws[wplane + dst[u]] = static_cast<uint8_t>(v[u]);
          }
        }
      }
      __syncthreads();

      for (int k = 0; k < kn; ++k) {
        const uint32_t a0 = a_base + k * xp, b0 = b_base + k * cc;
        int cb = 0;
        for (; cb + 32 <= cn; cb += 32) {
          const uint32_t a[1] = {a0 + cb};
          tile.k32(a, xplane, b0 + cb, 8 * wp, wplane);
        }
        if (cb < cn) {   // the 16-deep rest
          const uint32_t a[1] = {a0 + cb};
          tile.k16(a, xplane, b0 + cb, 8 * wp, wplane);
        }
      }
    }
  }

  // Even lanes hold row g, odd lanes row g + 8, four consecutive filters each.
  const int m = wm0 + (lane >> 2) + (lane & 1) * 8, s = m / seg_len;
  const int gs = blockIdx.x * segs + s, b = gs / wt, wo = (gs % wt) * seg_len + m % seg_len;
  const bool live = s < segs && b < B && wo < Wout;
  int32_t* orow = out + ((size_t)b * Wout + wo) * F;
#pragma unroll
  for (int j = 0; j < FN; ++j) {
    const uint4 v = tile.row4(0, j, lane);
    const int f = f0 + wn0 + j * 8 + ((lane & 3) >> 1) * 4;
    if (!live || f >= F) continue;
    if ((F & 3) == 0) {
      *reinterpret_cast<uint4*>(orow + f) = v;
    } else {
      const unsigned vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (f + e < F) orow[f + e] = static_cast<int32_t>(vs[e]);
    }
  }
}

template <typename T, int NF>
cudaError_t launch_plan(const void* x, const void* w, int32_t* out, int B, int W, int C, int K,
                        int F, int Wout, int stride, int pad_lo, int seg_len, int segs, int kc,
                        int cc, size_t smem, cudaStream_t s) {
  static bool granted = false;   // above the default 48 KB
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        qconv1d_kernel<T, NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    granted = true;
  }
  const long long segments = (long long)B * ((Wout + seg_len - 1) / seg_len);
  constexpr int BN = Geo<T, NF>::BN;
  const dim3 grid((unsigned)((segments + segs - 1) / segs), (F + BN - 1) / BN);
  const int vec_x = (C * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = (F * sizeof(T)) % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  qconv1d_kernel<T, NF><<<grid, NT, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                               out, B, W, C, K, F, Wout, stride, pad_lo, seg_len,
                                               segs, kc, cc, vec_x, vec_w);
  return cudaGetLastError();
}

}  // namespace

// x (B, W, C) and w (K, C, F), both int8 (in_bytes 1) or both int16
// (in_bytes 2); out (B, Wout, F) int32.  Input position of output o, tap k:
// o * stride + k - pad_lo (outside [0, W) reads 0).  nf (4 or 10: 32 or 80
// filters a block), seg_len, segs, kc and cc are the plan of
// kernels/int_mma.py (`conv_plan`).  Returns the launch's error
// (cudaErrorInvalidValue, with no launch, for arguments or a plan that do
// not fit the call).
extern "C" int qconv1d_int(const void* x, const void* w, int in_bytes, int32_t* out, int B,
                           int W, int C, int K, int F, int Wout, int stride, int pad_lo, int nf,
                           int seg_len, int segs, int kc, int cc, void* stream) {
  if ((in_bytes != 1 && in_bytes != 2) || B < 0 || W < 0 || C < 1 || K < 1 || F < 0 ||
      Wout < 0 || stride < 1 || pad_lo < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || F == 0 || Wout == 0) return static_cast<int>(cudaGetLastError());
  const int bm = in_bytes == 2 ? 64 : 128;
  if ((nf != 4 && nf != 10) || seg_len < 1 || segs < 1 || (long long)seg_len * segs > bm ||
      kc < 1 || kc > K || cc < 16 || cc % 16 ||
      smem_bytes(in_bytes, nf, seg_len, segs, kc, cc, stride) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(in_bytes, nf, seg_len, segs, kc, cc, stride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_bytes == 1)
    e = nf == 4 ? launch_plan<int8_t, 4>(x, w, out, B, W, C, K, F, Wout, stride, pad_lo, seg_len,
                                         segs, kc, cc, smem, s)
                : launch_plan<int8_t, 10>(x, w, out, B, W, C, K, F, Wout, stride, pad_lo,
                                          seg_len, segs, kc, cc, smem, s);
  else
    e = nf == 4 ? launch_plan<int16_t, 4>(x, w, out, B, W, C, K, F, Wout, stride, pad_lo,
                                          seg_len, segs, kc, cc, smem, s)
                : launch_plan<int16_t, 10>(x, w, out, B, W, C, K, F, Wout, stride, pad_lo,
                                           seg_len, segs, kc, cc, smem, s);
  return static_cast<int>(e);
}
