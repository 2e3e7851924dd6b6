// Integer matmul with an int32 accumulator, and the same with a shift-only
// requantization epilogue:
//   qmm:          out (M, N) int32 = x (M, K) @ w (K, N), summed modulo 2^32
//   qmm_requant:  out = clip(acc >> shift  (shift >= 0)
//                            acc << -shift (shift < 0, wrapping), qmin, qmax)
// with x and w both int8 or both int16, row-major and contiguous.
//
// Replaces repro/kernels/qmm.py::qmm_pallas and ::qmm_requant_pallas (one
// kernel; the epilogue is chosen by the output's width).  The TPU kernel
// carries an int32 VMEM accumulator across a sequential K grid axis.  Here
// the products run on the integer tensor cores through the tile core of
// int_mma.cuh (int8: mma s8; int16: four 8-bit products on a hi/lo byte
// split), the route being mma.sync: it reaches the wrap and edge cases
// with one code path at every shape, and at 4096^3 it is well under
// torch._int_mm (PERF.md); wgmma with TMA is the step past it.
//
// Tiling (planned in Python, kernels/int_mma.py, `qmm_plan`): a block owns
// a BM x 64 output tile (BM 16, 32, 64 or, for int8, 128: an int16 tile of
// 128 rows, three accumulators, leaves registers for one block an SM and
// was slower than 64 rows at 4096^3; 8 warps) and walks its K
// range in steps of 64 bytes per row (64 int8 or 32 int16 codes) through a
// four-stage cp.async ring: 16-byte copies zero-filled past every edge,
// scalar loads where a row is not 16-byte aligned (K = 300 int8, N = 6 or
// 50).  Each step the block transposes the weight bytes into an [n][k]
// plane (4 x 4 blocks with __byte_perm; int16 into hi and lo planes) and,
// for int16, splits x into hi and lo planes; int8 x is read by ldmatrix
// straight from the ring.  Where the output tiles would not fill the 132
// SMs, K is split across a thread-block cluster (at most 8 ranks): each
// rank leaves its partial int32 tile in shared memory and, after a cluster
// barrier, adds one slice of the tile over ranks 0, 1, ... through
// distributed shared memory (unsigned adds: the same wrapped sum in any
// order), then applies the epilogue.  One launch per call.
//
// Wrapping: the mma's s32 sums wrap (no .satfinite; int_mma.cuh), partial
// tiles add in unsigned.  The shift is read from device memory (the TPU
// kernel's SMEM scalar): the caller never reads it back.  XLA's shift
// semantics are reproduced explicitly, as a bare >> or << by 32 or more is
// undefined: a right shift of 32 or more gives the sign fill, a left shift
// of 32 or more gives 0, and a smaller left shift wraps.
//
// Bound on an H100 (bytes at 3.35 TB/s; int8 products at 1,979 TOP/s,
// int16 at a quarter of that, four 8-bit products each): the bytes at the
// classifier's (2947, 80) @ (80, 6) and the small shapes, where a call is
// a few load latencies; the operations at 4096^3.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using int_mma::pitch;

constexpr int BN = 64, NT = 256, STAGES = 4, MAX_RANKS = 8;
constexpr int ROW_BYTES = 64;                  // bytes of a row of x per K step
constexpr int XLD = pitch(ROW_BYTES);          // raw x row pitch (80)
constexpr int RLD = BN + 4;                    // partial tile row pitch (words)

template <typename T>
struct Geo {
  static constexpr bool W16 = sizeof(T) == 2;
  static constexpr int BK = ROW_BYTES / sizeof(T);   // K rows per step
  static constexpr int PLD = pitch(BK);              // plane pitch: 80 (int8), 48 (int16)
};

template <typename T, int BM>
struct Smem {
  static constexpr int BK = Geo<T>::BK, PLD = Geo<T>::PLD;
  static constexpr int NP = Geo<T>::W16 ? 2 : 1;     // byte planes per operand
  union {
    struct {
      alignas(16) uint8_t x[STAGES][BM * XLD];           // x as stored, [m][k]
      alignas(16) uint8_t w[STAGES][BK * BN * sizeof(T)];  // w as stored, [k][n]
    } raw;
    alignas(16) unsigned red[BM * RLD];   // this rank's partial tile, after the K loop
  };
  alignas(16) uint8_t ap[Geo<T>::W16 ? 2 * BM * PLD : 16];   // int16 x: hi, lo planes [m][k]
  alignas(16) uint8_t bp[NP * BN * PLD];                     // w: [n][k] (hi, lo for int16)
};

// Warps: WM along M by WN along N, each FM x FN fragments of 16 x 8.
template <int BM> struct Warps;
template <> struct Warps<16> { static constexpr int WM = 1, FM = 1; };
template <> struct Warps<32> { static constexpr int WM = 2, FM = 1; };
template <> struct Warps<64> { static constexpr int WM = 4, FM = 1; };
template <> struct Warps<128> { static constexpr int WM = 4, FM = 2; };

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

// Cluster rank r sums K rows [r * k_per_rank, min(K, (r + 1) * k_per_rank)).
// out_bytes 4: int32 out (shift unused); 1 or 2: requantized to int8 or
// int16 with the shift at *shift, clipped to [lo, hi].
template <typename T, int BM>
__global__ void __launch_bounds__(NT)
qmm_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ shift,
           void* __restrict__ out, int out_bytes, int lo, int hi, int M, int K, int N,
           int k_per_rank, int vec_x, int vec_w) {
  using G = Geo<T>;
  using S = Smem<T, BM>;
  constexpr int BK = G::BK, PLD = G::PLD, WM = Warps<BM>::WM, WN = 8 / WM;
  constexpr int U = 2;   // scalar loads a thread has in flight
  constexpr int FM = Warps<BM>::FM, FN = BN / (8 * WN);
  constexpr int EPC = 16 / sizeof(T);   // codes per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  S& sm = *reinterpret_cast<S*>(smem_bytes);

  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / ranks) * BN, m0 = blockIdx.y * BM;
  const int kbeg = rank * k_per_rank, kend = min(K, kbeg + k_per_rank);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp % WM) * FM * 16, wn0 = (warp / WM) * FN * 8;

  auto load = [&](int slot, int k0) {
    uint8_t* xs = sm.raw.x[slot];
    if (vec_x) {
      for (int c = tid; c < BM * (ROW_BYTES / 16); c += NT) {
        const int r = c / (ROW_BYTES / 16), kk = k0 + (c % (ROW_BYTES / 16)) * EPC;
        const int bytes = m0 + r < M ? (int)sizeof(T) * max(0, min(EPC, kend - kk)) : 0;
        cp_async::copy16(xs + r * XLD + (c % (ROW_BYTES / 16)) * 16,
                            bytes ? x + (size_t)(m0 + r) * K + kk : x, bytes);
      }
    } else {   // the loads of U elements started before their stores
#pragma unroll 1
      for (int e0 = tid; e0 < BM * BK; e0 += U * NT) {
        T v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * NT, r = e / BK, kk = k0 + e % BK;
          v[u] = (e < BM * BK && m0 + r < M && kk < kend) ? x[(size_t)(m0 + r) * K + kk] : T(0);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * NT;
          if (e < BM * BK) reinterpret_cast<T*>(xs + (e / BK) * XLD)[e % BK] = v[u];
        }
      }
    }
    T* ws = reinterpret_cast<T*>(sm.raw.w[slot]);
    if (vec_w) {
      for (int c = tid; c < BK * (BN / EPC); c += NT) {
        const int r = c / (BN / EPC), n = n0 + (c % (BN / EPC)) * EPC;
        const int bytes = k0 + r < kend ? (int)sizeof(T) * max(0, min(EPC, N - n)) : 0;
        cp_async::copy16(ws + c * EPC, bytes ? w + (size_t)(k0 + r) * N + n : w, bytes);
      }
    } else {
      // Only the rows below kend and the columns below N, densely over the
      // threads: the other rows meet x codes that are 0, the other columns
      // give outputs past N, so whatever the ring holds there is harmless.
      const int nv = min(BN, N - n0), total = min(BK, kend - k0) * nv;
#pragma unroll 1
      for (int e0 = tid; e0 < total; e0 += U * NT) {
        T v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * NT;
          v[u] = e < total ? w[(size_t)(k0 + e / nv) * N + n0 + e % nv] : T(0);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * NT;
          if (e < total) ws[(e / nv) * BN + e % nv] = v[u];
        }
      }
    }
  };

  // The step's weight bytes as [n][k] planes (int16: hi and lo), and int16
  // x as hi and lo planes.
  auto convert = [&](int slot) {
    const uint32_t* wr = reinterpret_cast<const uint32_t*>(sm.raw.w[slot]);
    if constexpr (G::W16) {
      // 4 K rows x 2 columns a thread: BK / 4 * BN / 2 = 256 tasks
      const int kq = tid / (BN / 2), n2 = tid % (BN / 2);
      uint32_t h[2], l[2];
      int_mma::split_cols(wr[(kq * 4 + 0) * (BN / 2) + n2], wr[(kq * 4 + 1) * (BN / 2) + n2],
                          wr[(kq * 4 + 2) * (BN / 2) + n2], wr[(kq * 4 + 3) * (BN / 2) + n2], h, l);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        *reinterpret_cast<uint32_t*>(&sm.bp[(n2 * 2 + c) * PLD + kq * 4]) = h[c];
        *reinterpret_cast<uint32_t*>(&sm.bp[BN * PLD + (n2 * 2 + c) * PLD + kq * 4]) = l[c];
      }
      const uint8_t* xs = sm.raw.x[slot];
      for (int e = tid; e < BM * (ROW_BYTES / 16); e += NT) {   // 8 codes a task
        const int r = e / (ROW_BYTES / 16), q = e % (ROW_BYTES / 16);
        const uint4 v = *reinterpret_cast<const uint4*>(xs + r * XLD + q * 16);
        uint2 hv, lv;
        int_mma::split_row(v.x, v.y, hv.x, lv.x);
        int_mma::split_row(v.z, v.w, hv.y, lv.y);
        *reinterpret_cast<uint2*>(&sm.ap[r * PLD + q * 8]) = hv;
        *reinterpret_cast<uint2*>(&sm.ap[BM * PLD + r * PLD + q * 8]) = lv;
      }
    } else {
      // 4 K rows x 4 columns a thread: BK / 4 * BN / 4 = 256 tasks
      const int kq = tid / (BN / 4), n4 = tid % (BN / 4);
      uint32_t c[4];
      int_mma::transpose4(wr[(kq * 4 + 0) * (BN / 4) + n4], wr[(kq * 4 + 1) * (BN / 4) + n4],
                          wr[(kq * 4 + 2) * (BN / 4) + n4], wr[(kq * 4 + 3) * (BN / 4) + n4], c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(&sm.bp[(n4 * 4 + j) * PLD + kq * 4]) = c[j];
    }
  };

  int_mma::Tile<sizeof(T), FM, FN> tile;
  tile.zero();
  // this lane's ldmatrix rows (see int_mma::Tile)
  const int arow = wm0 + (lane & 15), acol = (lane >> 4) * 16;
  const uint32_t b_addr = int_mma::smem_addr(sm.bp) +
                          (wn0 + (lane & 7) + (lane >> 4) * 8) * PLD + ((lane >> 3) & 1) * 16;

  auto mma_step = [&](int slot, int k0) {
    uint32_t a[FM];
#pragma unroll
    for (int i = 0; i < FM; ++i)
      a[i] = G::W16 ? int_mma::smem_addr(sm.ap) + (arow + i * 16) * PLD + acol
                    : int_mma::smem_addr(sm.raw.x[slot]) + (arow + i * 16) * XLD + acol;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {   // 32 codes a product (int16: per byte plane)
      if (k0 + kk >= kend) break;
      const uint32_t koff = G::W16 ? 0 : kk;
      uint32_t ak[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i) ak[i] = a[i] + koff;
      tile.k32(ak, BM * PLD, b_addr + koff, 8 * PLD, BN * PLD);
    }
  };

  // the K loop: steps s + 1 ... s + STAGES - 1 are in flight while step s is
  // converted and multiplied
  const int steps = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, kbeg + s * BK);
    cp_async::commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async::wait<STAGES - 2>();
    __syncthreads();   // step s visible; every warp is done with step s - 1
    const int next = s + STAGES - 1;
    if (next < steps) load(next % STAGES, kbeg + next * BK);
    cp_async::commit();
    convert(s % STAGES);
    __syncthreads();
    mma_step(s % STAGES, kbeg + s * BK);
  }
  cp_async::wait<0>();
  __syncthreads();   // int8 x is read from the ring, which the partial tile reuses

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int r = wm0 + i * 16 + g, col = wn0 + j * 8 + 2 * t;
      *reinterpret_cast<uint2*>(&sm.red[r * RLD + col]) = make_uint2(tile.value(i, j, 0),
                                                                     tile.value(i, j, 1));
      *reinterpret_cast<uint2*>(&sm.red[(r + 8) * RLD + col]) =
          make_uint2(tile.value(i, j, 2), tile.value(i, j, 3));
    }
  cluster.sync();

  // This rank's slice of the tile, summed over ranks 0, 1, ... in order.
  constexpr int Q = BM * BN / 4;   // groups of 4 columns
  const int q_end = (rank + 1) * Q / ranks;
  const int s = shift ? *shift : 0;
  for (int q = rank * Q / ranks + tid; q < q_end; q += NT) {
    const int r = q / (BN / 4), c = (q % (BN / 4)) * 4, gm = m0 + r;
    if (gm >= M) continue;
    unsigned* mine = &sm.red[r * RLD + c];
    uint4 v = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(mine, 0));
    for (int p = 1; p < ranks; ++p) {
      const uint4 u = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(mine, p));
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const size_t o = (size_t)gm * N + n0 + c;
    if (out_bytes == 4 && (N & 3) == 0 && n0 + c + 3 < N) {
      *reinterpret_cast<uint4*>(static_cast<int32_t*>(out) + o) = v;
      continue;
    }
    const unsigned vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (n0 + c + e >= N) break;
      if (out_bytes == 4)
        static_cast<int32_t*>(out)[o + e] = static_cast<int32_t>(vs[e]);
      else if (out_bytes == 2)
        static_cast<int16_t*>(out)[o + e] = static_cast<int16_t>(requant(vs[e], s, lo, hi));
      else
        static_cast<int8_t*>(out)[o + e] = static_cast<int8_t>(requant(vs[e], s, lo, hi));
    }
  }
  cluster.sync();   // no block leaves while another rank still reads its tile
}

template <typename T, int BM>
cudaError_t launch_tile(const void* x, const void* w, const int* shift, void* out, int out_bytes,
                        int lo, int hi, int M, int K, int N, int ranks, int k_per_rank,
                        cudaStream_t stream) {
  const auto kernel = qmm_kernel<T, BM>;
  constexpr size_t smem = sizeof(Smem<T, BM>);
  static bool granted = false;   // above the default 48 KB
  if (!granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    granted = true;
  }
  const int vec_x = (K * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = (N * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((N + BN - 1) / BN * ranks),
                     static_cast<unsigned>((M + BM - 1) / BM), 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ranks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1 ? 1 : 0;   // one rank: every block is a cluster of its own
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(w), shift,
                         out, out_bytes, lo, hi, M, K, N, k_per_rank, vec_x, vec_w);
  const cudaError_t last = cudaGetLastError();   // read (and clear) the launch's error
  return e != cudaSuccess ? e : last;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* shift, void* out, int out_bytes,
                   int lo, int hi, int M, int K, int N, int bm, int ranks, int k_per_rank,
                   cudaStream_t s) {
  constexpr int BK = Geo<T>::BK;
  // the plan must cover K in whole steps, one rank each (K = 0: one rank)
  const bool covers = K == 0 ? ranks == 1
                             : (static_cast<long long>(ranks - 1) * k_per_rank < K &&
                                static_cast<long long>(ranks) * k_per_rank >= K);
  if (ranks < 1 || ranks > MAX_RANKS || k_per_rank < BK || k_per_rank % BK || !covers ||
      (M + bm - 1) / bm > 65535)
    return cudaErrorInvalidValue;
  switch (bm) {
    case 16:
      return launch_tile<T, 16>(x, w, shift, out, out_bytes, lo, hi, M, K, N, ranks, k_per_rank,
                                s);
    case 32:
      return launch_tile<T, 32>(x, w, shift, out, out_bytes, lo, hi, M, K, N, ranks, k_per_rank,
                                s);
    case 64:
      return launch_tile<T, 64>(x, w, shift, out, out_bytes, lo, hi, M, K, N, ranks, k_per_rank,
                                s);
    case 128:
      if constexpr (sizeof(T) == 1)
        return launch_tile<T, 128>(x, w, shift, out, out_bytes, lo, hi, M, K, N, ranks,
                                   k_per_rank, s);
      else
        return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) and w (K, N), both int8 (in_bytes 1) or both int16 (in_bytes 2).
// shift NULL: out (M, N) int32 (out_bytes 4).  shift a device int32: out
// (M, N) int8 or int16 (out_bytes 1 or 2), clipped to [lo, hi].  bm (16,
// 32, 64 or, for int8, 128), ranks and k_per_rank are the tiling of kernels/int_mma.py
// (`qmm_plan`).  Returns the launch's error (cudaErrorInvalidValue, with no
// launch, for arguments or a tiling that do not fit the call).
extern "C" int qmm_int(const void* x, const void* w, int in_bytes, const int* shift, void* out,
                       int out_bytes, int lo, int hi, int M, int K, int N, int bm, int ranks,
                       int k_per_rank, void* stream) {
  if ((in_bytes != 1 && in_bytes != 2) || (shift == nullptr) != (out_bytes == 4) ||
      (out_bytes != 1 && out_bytes != 2 && out_bytes != 4) || M < 0 || K < 0 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      in_bytes == 1
          ? launch<int8_t>(x, w, shift, out, out_bytes, lo, hi, M, K, N, bm, ranks, k_per_rank, s)
          : launch<int16_t>(x, w, shift, out, out_bytes, lo, hi, M, K, N, bm, ranks, k_per_rank,
                            s));
}
