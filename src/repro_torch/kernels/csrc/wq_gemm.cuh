// Weight-only GEMM on the bf16 tensor cores, shared by wq_matmul.cu (int8
// weights) and wq4_matmul.cu (packed int4 weights):
//   out (M, N) = sum_k x[m, k] * q[k, n] * scale
// with x (M, K) f32 row-major, q integer codes, and scale 2^-n per output
// channel (or one for the tensor), applied once in the epilogue, or per
// block of block_size K rows (int4 only), folded in per block.
//
// Why bf16 three times.  A code |q| <= 128 is exact in bf16.  Each f32 x
// is split into three bf16 parts x0 = bf16(x), x1 = bf16(x - x0),
// x2 = bf16(x - x0 - x1), and x0 + x1 + x2 == x exactly for every finite x
// with |x| >= 2^-110 (below that, bf16's subnormal step 2^-133 drops the
// last bits: an error under 2^-134).  Every product x_i * q has at most
// 8 x 8 significant bits, so it is exact in f32, and three mma passes with
// f32 accumulators give the plain f32 product up to the order of the
// additions.  TF32 keeps 10 bits of x (one pass misses the 2e-5
// tolerance several times over); bf16 twice keeps 16 and is not exact.  With a scale per channel the x0 pass accumulates apart from the
// x1 and x2 passes, so the tensor core's truncating adds into the large
// sum see one pass, not three; with block scales all three go to the
// block's own fragment, which holds a few steps at most.
//
// Block scales.  The reference's 2^-n table is not exact powers of two at
// |n| >= 13, so nibble * scale would not be exact in bf16.  The scales are
// therefore never folded into the weights: each block's products go to
// their own f32 fragment, added to the accumulator as scale[kb, n] * part
// where the block ends (one FMA per output per block).  With blocks of
// whole 32-row steps (the serving default, 32) the fold comes after the
// step's mma loop, its scales loaded while the step is staged: a fold
// inside the unrolled loop stalled it on every step (PERF.md).
// Any other even size runs each 16-deep mma step once per block it spans,
// the other blocks' weight rows masked to zero, and folds where a block
// ends; a byte of two nibbles never spans two blocks (block_size is even).
//
// Filling the card with one launch.  The serving shapes give a few dozen
// output tiles, so K is split across the blocks of a thread-block cluster
// (at most 8, the portable size; the planner in kernels/wq_gemm.py picks
// the tile and the split).  Each rank leaves its partial tile in its
// shared memory, and after a cluster barrier each rank adds one slice of
// the tile over ranks 0, 1, ... in that order through distributed shared
// memory: the same sum, in the same order, as rank 0 adding the other
// ranks' tiles, with no workspace, no atomics and no second kernel.
//
// Each block owns a BM x 64 output tile and walks its rank's K range in
// 32-row steps through a ring of four stages: cp.async brings the f32 x
// tile and the weight bytes as stored (16-byte copies, zero-filled past
// every edge; scalar loads where a row is not 16-byte aligned), then the
// block splits x into three bf16 planes
// [m][k] and widens the codes into one bf16 plane [n][k] (rows of 80
// bytes: ldmatrix without bank conflicts), and four warps run
// mma.m16n8k16 from ldmatrix fragments while the next three steps' copies
// are in flight (a decode rank has 3-6 steps: its loads all start at once).
//
// Bound on an H100 (bytes at 3.35 TB/s; bf16 tensor-core operations, three
// passes, at 989 TFLOP/s): the bytes (weights, x and out) up to M of about
// 90-160 for int8 weights and 45-80 for int4 at the serving shapes (at
// every M for N = 192), the operations above.  Up to M of a few hundred a
// call takes a few load latencies per block, 10-70x either bound
// (PERF.md).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace wq_gemm {

namespace cg = cooperative_groups;

constexpr int BN = 64, BK = 32, NT = 128;   // N tile, K step, threads (4 warps)
constexpr int LDS = BK + 8;                 // bf16 row stride of the planes (80 bytes)
constexpr int RLD = BN + 4;                 // f32 row stride of the partial tile
constexpr int MAX_RANKS = 8;                // the portable cluster size
constexpr int STAGES = 4;                   // K steps in flight (a decode rank has 3-6)

template <int BM, bool S4>
struct Smem {
  static constexpr int WROWS = S4 ? BK / 2 : BK;   // weight byte rows per K step
  union {
    struct {
      float x[STAGES][BM * BK];       // x as stored
      int8_t w[STAGES][WROWS * BN];   // weight bytes as stored
    } raw;
    float red[BM * RLD];              // this rank's partial tile, after the K loop
  };
  uint16_t xp[3][BM * LDS];           // x split into three bf16 parts, [m][k]
  uint16_t wp[BN * LDS];              // the codes as bf16, [n][k]
};

using cp_async::smem_addr;

// Two f32 as bf16x2, round to nearest even; `lo` in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// (lo, hi) as three bf16x2 words whose sum is (lo, hi) (see the note).
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  p0 = bf16x2(lo, hi);
  const float rlo = lo - __uint_as_float(p0 << 16);
  const float rhi = hi - __uint_as_float(p0 & 0xffff0000u);
  p1 = bf16x2(rlo, rhi);
  p2 = bf16x2(rlo - __uint_as_float(p1 << 16), rhi - __uint_as_float(p1 & 0xffff0000u));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// S4: w is (ceil(K/2), N) bytes, byte row j holding K rows 2j (low nibble)
// and 2j+1 (high nibble); else w is (K, N) int8.  scale: with block_size 0,
// scale[n * scale_stride] in the epilogue; else (ceil(K/block_size), N)
// rows folded per block.  Cluster rank r sums K rows [r * k_per_rank,
// min(K, (r + 1) * k_per_rank)).  The body of a __global__ kernel of NT
// threads that each source names for itself (so a profile tells them
// apart), launched with `launch` below.
template <int BM, bool S4>
__device__ __forceinline__ void gemm(const float* __restrict__ x, const int8_t* __restrict__ w,
                                     const float* __restrict__ scale, int scale_stride,
                                     int block_size, float* __restrict__ out, int M, int K,
                                     int N, int k_per_rank, int vec_x, int vec_w) {
  constexpr int WM = BM == 16 ? 1 : 2, WN = 4 / WM;    // warps along M and N
  constexpr int FM = BM / (16 * WM), FN = BN / (8 * WN);   // m16 / n8 fragments per warp
  constexpr int WROWS = Smem<BM, S4>::WROWS;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem<BM, S4>& sm = *reinterpret_cast<Smem<BM, S4>*>(smem_bytes);

  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / ranks) * BN, m0 = blockIdx.y * BM;
  const int kbeg = rank * k_per_rank, kend = min(K, kbeg + k_per_rank);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / WN) * FM * 16, wn0 = (warp % WN) * FN * 8;
  const int g = lane >> 2, t = lane & 3;   // the mma fragments' row group and lane pair

  auto load = [&](int slot, int k0) {
    float* xs = sm.raw.x[slot];
    if (vec_x) {
      for (int c = tid; c < BM * BK / 4; c += NT) {
        const int r = c / (BK / 4), kk = k0 + (c % (BK / 4)) * 4;
        const int bytes = m0 + r < M ? 4 * max(0, min(4, kend - kk)) : 0;
        cp_async::copy16(xs + c * 4, bytes ? x + (size_t)(m0 + r) * K + kk : x, bytes);
      }
    } else {
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, kk = k0 + e % BK;
        xs[e] = (m0 + r < M && kk < kend) ? x[(size_t)(m0 + r) * K + kk] : 0.f;
      }
    }
    // weight rows past kend belong to the next rank: x is zero there
    int8_t* ws = sm.raw.w[slot];
    const int r0 = S4 ? k0 / 2 : k0, rows = S4 ? (K + 1) / 2 : K;
    if (vec_w) {
      for (int c = tid; c < WROWS * BN / 16; c += NT) {
        const int r = c / (BN / 16), n = n0 + (c % (BN / 16)) * 16;
        const int bytes = r0 + r < rows ? max(0, min(16, N - n)) : 0;
        cp_async::copy16(ws + c * 16, bytes ? w + (size_t)(r0 + r) * N + n : w, bytes);
      }
    } else {
      for (int e = tid; e < WROWS * BN; e += NT) {
        const int r = e / BN, n = n0 + e % BN;
        ws[e] = (r0 + r < rows && n < N) ? w[(size_t)(r0 + r) * N + n] : int8_t(0);
      }
    }
  };

  auto convert = [&](int slot) {
    const float* xs = sm.raw.x[slot];
    for (int c = tid; c < BM * BK / 4; c += NT) {
      const int r = c / (BK / 4), kk = (c % (BK / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(xs + c * 4);
      uint32_t a0, a1, a2, b0, b1, b2;
      split3(v.x, v.y, a0, a1, a2);
      split3(v.z, v.w, b0, b1, b2);
      *reinterpret_cast<uint2*>(&sm.xp[0][r * LDS + kk]) = make_uint2(a0, b0);
      *reinterpret_cast<uint2*>(&sm.xp[1][r * LDS + kk]) = make_uint2(a1, b1);
      *reinterpret_cast<uint2*>(&sm.xp[2][r * LDS + kk]) = make_uint2(a2, b2);
    }
    const int8_t* ws = sm.raw.w[slot];
    for (int c = tid; c < BN * (BK / 8); c += NT) {
      const int n = c % BN, kc = (c / BN) * 8;   // K rows kc..kc+7 of column n
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int lo, hi;
        if constexpr (S4) {
          const int b = ws[(kc / 2 + j) * BN + n];
          lo = static_cast<int>(static_cast<uint32_t>(b) << 28) >> 28;
          hi = b >> 4;
        } else {
          lo = ws[(kc + 2 * j) * BN + n];
          hi = ws[(kc + 2 * j + 1) * BN + n];
        }
        v[j] = bf16x2(static_cast<float>(lo), static_cast<float>(hi));
      }
      *reinterpret_cast<uint4*>(&sm.wp[n * LDS + kc]) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };

  float acc[FM][FN][4] = {};
  float part[FM][FN][4] = {};   // the x1 and x2 passes, or the current block's products

  // this lane's two columns of each n8 fragment in scale row kb (0 past N)
  auto scales = [&](float (&sc)[FN][2], int kb) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int col = n0 + wn0 + j * 8 + 2 * t;
      sc[j][0] = col < N ? __ldg(scale + (size_t)kb * N + col) : 0.f;
      sc[j][1] = col + 1 < N ? __ldg(scale + (size_t)kb * N + col + 1) : 0.f;
    }
  };
  // acc += scale * part, part = 0
  auto fold = [&](const float (&sc)[FN][2]) {
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[i][j][c] = fmaf(sc[j][c & 1], part[i][j][c], acc[i][j][c]);
          part[i][j][c] = 0.f;
        }
  };

  auto mma_step = [&](int k0) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int k16 = k0 + kk;
      if (k16 >= kend) break;
      uint32_t a[3][FM][4], b[FN / 2][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int i = 0; i < FM; ++i)
          ldsm_x4(a[p][i], &sm.xp[p][(wm0 + i * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < FN / 2; ++j)
        ldsm_x4(b[j], &sm.wp[(wn0 + j * 16 + (lane >> 4) * 8 + (lane & 7)) * LDS + kk +
                             ((lane >> 3) & 1) * 8]);
      if (block_size == 0) {
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) {
            const uint32_t b0 = b[j / 2][(j & 1) * 2], b1 = b[j / 2][(j & 1) * 2 + 1];
            mma(acc[i][j], a[0][i], b0, b1);
            mma(part[i][j], a[1][i], b0, b1);
            mma(part[i][j], a[2][i], b0, b1);
          }
      } else if (block_size % BK == 0) {   // the step lies in one block: folded after it
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) {
            const uint32_t b0 = b[j / 2][(j & 1) * 2], b1 = b[j / 2][(j & 1) * 2 + 1];
            mma(part[i][j], a[0][i], b0, b1);
            mma(part[i][j], a[1][i], b0, b1);
            mma(part[i][j], a[2][i], b0, b1);
          }
      } else {
        // the blocks these 16 rows fall in; b0 holds rows k16 + 2t, 2t + 1
        // and b1 rows k16 + 8 + 2t, 9 + 2t of this lane's column.  A block
        // is folded in where it ends (or where the rank's rows end); one
        // that runs on keeps summing into `part` in the next 16 rows.
        const int kb_first = k16 / block_size;
        const int kb_last = (min(k16 + 16, kend) - 1) / block_size;
        for (int kb = kb_first; kb <= kb_last; ++kb) {
          const bool whole = kb_first == kb_last;
          const uint32_t keep0 = whole || (k16 + 2 * t) / block_size == kb ? ~0u : 0u;
          const uint32_t keep1 = whole || (k16 + 8 + 2 * t) / block_size == kb ? ~0u : 0u;
#pragma unroll
          for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FN; ++j) {
              const uint32_t b0 = b[j / 2][(j & 1) * 2] & keep0;
              const uint32_t b1 = b[j / 2][(j & 1) * 2 + 1] & keep1;
              mma(part[i][j], a[0][i], b0, b1);
              mma(part[i][j], a[1][i], b0, b1);
              mma(part[i][j], a[2][i], b0, b1);
            }
          if ((kb + 1) * block_size <= k16 + 16 || kend <= k16 + 16) {
            float sc[FN][2];
            scales(sc, kb);
            fold(sc);
          }
        }
      }
    }
  };

  // the K loop: steps s + 1 ... s + STAGES - 1 are in flight while step s is
  // widened and multiplied
  const int steps = (kend - kbeg + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, kbeg + s * BK);
    cp_async::commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int k0 = kbeg + s * BK;
    // With blocks of whole steps the fold comes once per block, after the
    // mma loop of its last step (a fold inside the unrolled loop stalls
    // it); its scales load while the step is staged.
    const bool fold_here = block_size > 0 && block_size % BK == 0 &&
                           ((k0 + BK) % block_size == 0 || k0 + BK >= kend);
    float sc[FN][2];
    if (fold_here) scales(sc, k0 / block_size);
    cp_async::wait<STAGES - 2>();
    __syncthreads();   // step s visible; every warp is done with step s - 1
    const int next = s + STAGES - 1;
    if (next < steps) load(next % STAGES, kbeg + next * BK);
    cp_async::commit();
    convert(s % STAGES);
    __syncthreads();
    mma_step(k0);
    if (fold_here) fold(sc);
  }
  cp_async::wait<0>();   // only empty groups are left: the partial tile may reuse the ring
  if (block_size == 0) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
  }

  // The partial tile goes over the staging buffers.
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int r = wm0 + i * 16 + g, col = wn0 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(&sm.red[r * RLD + col]) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(&sm.red[(r + 8) * RLD + col]) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  cluster.sync();

  // This rank's slice of the tile, summed over ranks 0, 1, ... in order.
  constexpr int Q = BM * BN / 4;   // float4 groups of the tile
  const int q_end = (rank + 1) * Q / ranks;
  for (int q = rank * Q / ranks + tid; q < q_end; q += NT) {
    const int r = q / (BN / 4), c = (q % (BN / 4)) * 4, gm = m0 + r;
    if (gm >= M) continue;
    float* mine = &sm.red[r * RLD + c];
    float4 s = *reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, 0));
    for (int p = 1; p < ranks; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, p));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + c + j;
      if (gn < N)
        out[(size_t)gm * N + gn] =
            block_size ? sv[j] : sv[j] * scale[(size_t)gn * scale_stride];
    }
  }
  cluster.sync();   // no block leaves while another rank still reads its tile
}

using Kernel = void (*)(const float*, const int8_t*, const float*, int, int, float*, int, int,
                       int, int, int, int);

// Dynamic shared memory above 48 KB for `kernel`; counts the call in
// `grants`.
inline cudaError_t set_smem(Kernel kernel, size_t smem, int& grants) {
  ++grants;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// K's grant, asked for on its first launch only.  The kernel is a template
// argument, internal to its source, so each library keeps its own record: a
// static of a function shared by two libraries (keyed by a kernel pointer at
// run time) would be one object per process, and the second library's
// kernels would ask again at every launch.
template <Kernel K, int BM, bool S4>
cudaError_t grant(int& grants) {
  static const cudaError_t granted = set_smem(K, sizeof(Smem<BM, S4>), grants);
  return granted;
}

// One launch of the tiling (bm, ranks, k_per_rank) that kernels/wq_gemm.py
// plans, with the caller's kernel for each M tile (K16, K32, K64 over
// gemm<BM, S4>); a tiling that does not cover K in whole steps, one rank
// each, is refused with cudaErrorInvalidValue and nothing launched.
// `grants` is the caller's count of cudaFuncSetAttribute calls (one per
// tile kernel it has launched).
template <bool S4, Kernel K16, Kernel K32, Kernel K64>
cudaError_t launch(int& grants, const float* x, const int8_t* w, const float* scale,
                   int scale_stride, int block_size, float* out, int M, int K, int N, int bm,
                   int ranks, int k_per_rank, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaGetLastError();
  if (K < 1 || ranks < 1 || ranks > MAX_RANKS || k_per_rank < BK || k_per_rank % BK ||
      static_cast<long long>(ranks - 1) * k_per_rank >= K ||
      static_cast<long long>(ranks) * k_per_rank < K || block_size < 0 || (block_size & 1))
    return cudaErrorInvalidValue;
  const Kernel kernel = bm == 16 ? K16 : bm == 32 ? K32 : bm == 64 ? K64 : nullptr;
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const size_t smem = bm == 16   ? sizeof(Smem<16, S4>)
                      : bm == 32 ? sizeof(Smem<32, S4>)
                                 : sizeof(Smem<64, S4>);
  const cudaError_t granted = bm == 16   ? grant<K16, 16, S4>(grants)
                              : bm == 32 ? grant<K32, 32, S4>(grants)
                                         : grant<K64, 64, S4>(grants);
  if (granted != cudaSuccess) return granted;
  const int vec_x = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((N + BN - 1) / BN * ranks),
                     static_cast<unsigned>((M + bm - 1) / bm), 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ranks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, w, scale, scale_stride, block_size,
                                           out, M, K, N, k_per_rank, vec_x, vec_w);
  const cudaError_t last = cudaGetLastError();   // read (and clear) the launch's error
  return e != cudaSuccess ? e : last;
}

}  // namespace wq_gemm
