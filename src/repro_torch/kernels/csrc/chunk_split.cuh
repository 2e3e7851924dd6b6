// The chunk core shared by qchunk_attn.cu (dense cache) and qpaged_attn.cu
// (paged pool): a prefill chunk of C queries of one slot attends that slot's
// int8 prefix, causally within the chunk, and the chunk's K/V are quantized
// onto the pow2 grid and written into the cache or pool in place.
//
// A dense cache is a pool.  Slot `slot` of a (B, S, Hkv, D) cache is pool
// page `slot` of page size S under a one-entry table row {slot} (Args.trow
// null, Args.page the slot), so both entries run this one body.  Logical
// position p of the slot lives at row p % ps of pool page table[p / ps];
// -1 marks an unmapped entry, which reads pool page 0 (the plain version's
// clamp) and drops a chunk row written through it.
//
// Grid.  One cluster of R blocks per (query tile, KV head), grid
// (tiles * R, Hkv).  A query tile holds `rows` whole chunk rows times their
// G heads, query qi = r G + g (head h G + g at chunk row c0 + r), at most
// kMaxQ = 32 queries: two m16 slabs.  Warp w takes slab w % 2 and the w / 2-th
// 16 positions of every 64-position tile, an online softmax of its own, so
// eight warps share each staged tile.  Small query tiles put more clusters
// on the card (C=32, G=3: 4 tiles of 8 rows) and fewer tensor-core passes
// on each SM sub-partition per tile.  R comes from shapes alone
// (kernels/attn_split.py::chunk_ranks: the table's reach, tiles * Hkv, D),
// never from `start`, which may live on the card.
//
// Partition.  The tile's last query sees positions [0, s_end), s_end =
// min(start + c0 + rows, max_pages * ps), read on the card; rank r takes its
// run of 64-position tiles of [0, s_end) (attn_split::rank_range), so a
// rank past the causal limit of a short chunk has no position.
//
// Staging.  The block brings each tile's K/V rows through the table into a
// 4-stage cp.async ring of int8 bytes as stored, the next three tiles in
// flight while one is computed.  Positions in [start, start + C) are never
// read from the cache or pool: their codes are quantized from the f32 chunk
// inputs (attn_split::quantize_i8, bit for bit the plain version's), and so
// is an unmapped entry's page-0 row that this launch writes.  No block reads
// a row that any block of the launch writes.  The codes are widened exactly
// into bf16 planes (|code| <= 128 is exact in bf16) that ldmatrix reads.
//
// Products on the tensor cores.  Q K^T is mma.sync.m16n8k16 bf16 with f32
// accumulation in three passes: q 2^-k_n (an exact power of two) is split
// into three bf16 parts with wq_gemm::split3, each part times a code is
// exact in f32, and each part accumulates apart: the tensor core's
// truncating adds see one pass of the large sum, and the three chains of
// dependent mma are independent of each other.  sm_scale is applied after
// the product.  The online softmax runs on the accumulator fragments, where
// a quad of lanes owns two query rows, in base 2 (scores times sm_scale
// log2 e, exp2f; m goes back to natural units for the folds); (m, l) start
// at (-1e30, 0).  P is split into three bf16 parts and used from registers
// as the A operand of P V, with V's codes as the B operand through
// ldmatrix.trans; each tile's P V sums into a fresh fragment that is added
// to acc * alpha in f32, and 2^-v_n is applied to the folded acc.
// P never goes through shared memory.
//
// Masks, as the plain versions keep them: a position past the query's row
// (p > start + c, below the rank's end) scores -1e30, and one at or past
// the rank's end (s_end, the table's reach) -inf.  Every query sees
// position 0, so a rank whose positions are all masked for a query (m =
// -1e30) folds with weight 0, as an empty rank (-1e30, 0, 0) does.
//
// Fold.  The four warps of a slab fold in shared memory, then the ranks
// through distributed shared memory in rank order (attn_split::fold_ranks),
// and out = acc / max(l, 1e-30).
//
// Writes.  Rank 0 of the cluster writes the codes of its tile's rows for
// its KV head, so each (head, chunk row) has exactly one writer; a paged
// row whose entry is -1, or whose position is at or past max_pages * ps, is
// dropped.  Every other byte is left as it was.
//
// Bound on an H100: at S=2048 the bytes (the int8 prefix, 2 start Hkv D)
// and the operations (three bf16 passes of 4 C (start + C / 2) Hq D at 989
// TFLOP/s) are both under 1 us.  A call takes a fixed prologue, cluster
// barriers and fold, plus each rank's tiles one after another; a tile's
// time is mostly the latency of its dependent mma passes, with two warps
// on each SM sub-partition to hide it, not its loads (PERF.md, section 6).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_split.cuh"
#include "cp_async.cuh"
#include "wq_gemm.cuh"

namespace chunk_split {

namespace cg = cooperative_groups;
using attn_split::kMasked;
using attn_split::kThreads;

constexpr int kWarps = kThreads / 32;
constexpr int kSlabs = 2;               // m16 query slabs of a tile
constexpr int kStreams = kWarps / kSlabs;   // warps per slab, each its share of every position tile
constexpr int kMaxQ = 16 * kSlabs;      // queries per tile
constexpr int BS = 64;                  // positions per tile
constexpr int PW = BS / kStreams;       // positions per warp and tile
constexpr int kStages = 4;              // tiles in flight
constexpr int kMaxG = 16;

struct Args {
  const float* q;     // (C, Hq, D)
  const float* kc;    // (C, Hkv, D)
  const float* vc;
  int8_t* k;          // the pool (P, ps, Hkv, D), or the dense cache (B, S, Hkv, D)
  int8_t* v;
  const int* k_n_ptr;
  int k_n_val;
  const int* v_n_ptr;
  int v_n_val;
  const int* trow;    // the slot's table row (max_pages,); null: dense, page `page`
  int page;
  const int* start_ptr;
  int start_val;
  float* out;         // (C, Hq, D)
  int C, ps, max_pages, Hkv, G, rows;
  float sm_scale;
};

template <int D>
struct Smem {
  static constexpr int LDS = D + 8;   // bf16 row pitch of the planes: 2D + 16 bytes
  union {
    alignas(16) int8_t ring[kStages][2][BS * D];   // K, V rows as stored
    struct {   // after the walk: each warp's partial softmax
      float acc[kWarps][16][D];
      float m[kWarps][16];
      float l[kWarps][16];
    } part;
  };
  int src[kStages][BS];   // per staged position: chunk row (>= 0), pool (-1), unseen (-2)
  alignas(16) uint16_t kp[BS * LDS];   // K codes as bf16, [position][d]
  alignas(16) uint16_t vp[BS * LDS];   // V codes as bf16, [position][d]
  union {
    alignas(16) uint16_t qp[3][kMaxQ * LDS];   // q 2^-k_n in three bf16 parts, [query][d]
    struct {   // the block's fold, read by the cluster
      float acc[kMaxQ][D];
      float m[kMaxQ];
      float l[kMaxQ];
    } blk;
  };
};

// Four b16 8 x 8 matrices, transposed: the B fragments of two n8 tiles of a
// [k][n] plane.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(cp_async::smem_addr(p)));
}

// Eight exact values (codes) as four bf16x2 words.
__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(wq_gemm::bf16x2(x[0], x[1]), wq_gemm::bf16x2(x[2], x[3]),
                    wq_gemm::bf16x2(x[4], x[5]), wq_gemm::bf16x2(x[6], x[7]));
}

__device__ __forceinline__ int entry(const Args& a, int lp) {
  return a.trow ? __ldg(a.trow + lp) : a.page;
}

// The body of a __global__ kernel of kThreads threads that each source
// names for itself, launched with attn_split::launch over grid
// (tiles * ranks, Hkv) in clusters of (ranks, 1, 1).
template <int D>
__device__ __forceinline__ void chunk(const Args& a) {
  using Sm = Smem<D>;
  constexpr int LDS = Sm::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = static_cast<int>(blockIdx.x) / ranks * a.rows;
  const int h = blockIdx.y;
  const int n_rows = min(a.rows, a.C - c0);
  if (n_rows <= 0) return;   // the whole cluster: no barrier is left waiting
  const int G = a.G, nq = n_rows * G, slabs = (nq + 15) / 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Hq = a.Hkv * G;
  const int start = a.start_ptr ? *a.start_ptr : a.start_val;
  const int k_n = a.k_n_ptr ? *a.k_n_ptr : a.k_n_val;
  const int v_n = a.v_n_ptr ? *a.v_n_ptr : a.v_n_val;
  const float k_scale = exp2f(-static_cast<float>(k_n));
  const float v_scale = exp2f(-static_cast<float>(v_n));
  const float k_inv = exp2f(static_cast<float>(k_n));
  const float v_inv = exp2f(static_cast<float>(v_n));
  const int end = start + a.C;   // one past the chunk's last position
  const int s_end = min(start + c0 + n_rows, a.max_pages * a.ps);
  int lo, hi;
  attn_split::rank_range(s_end, BS, rank, ranks, lo, hi);
  const size_t row = (size_t)a.Hkv * D;   // elements between consecutive rows of a page
  const size_t page_elems = (size_t)a.ps * row;
  const float* kch = a.kc + (size_t)h * D;
  const float* vch = a.vc + (size_t)h * D;

  const int8_t* kh = a.k + (size_t)h * D;
  const int8_t* vh = a.v + (size_t)h * D;
  const int n_tiles = hi > lo ? (hi - lo + BS - 1) / BS : 0;

  // Tile j into ring stage j % kStages: where each position's codes come
  // from, and the copies of the rows read from the cache or pool.
  auto stage = [&](int j) {
    constexpr int CH = D / 16;   // 16-byte copies per row
    const int st = j % kStages, t0 = lo + j * BS;
    for (int e = tid; e < BS * CH; e += kThreads) {
      const int s = e / CH, ch = e % CH, pos = t0 + s;
      int src = -2;
      if (pos < hi) {
        const int lp = pos / a.ps, r = pos - lp * a.ps;
        const int page = entry(a, lp);
        src = -1;
        if (page >= 0) {
          if (pos >= start && pos < end) src = pos - start;
        } else {
          // an unmapped entry reads pool page 0: the chunk's own row there, if any
          const int lq_hi = min((end - 1) / a.ps, a.max_pages - 1);
          for (int lq = start / a.ps; lq <= lq_hi; ++lq) {
            const int p2 = lq * a.ps + r;
            if (p2 >= start && p2 < end && entry(a, lq) == 0) src = p2 - start;
          }
        }
        if (src == -1) {
          const size_t off = (size_t)max(page, 0) * page_elems + (size_t)r * row + ch * 16;
          cp_async::copy16(&sm.ring[st][0][s * D + ch * 16], kh + off, 16);
          cp_async::copy16(&sm.ring[st][1][s * D + ch * 16], vh + off, 16);
        }
      }
      if (ch == 0) sm.src[st][s] = src;
    }
    cp_async::commit();
  };

  // Stage st as bf16 planes: the ring's codes, the chunk's codes, or 0.
  auto widen = [&](int st) {
    for (int e = tid; e < BS * (D / 8); e += kThreads) {
      const int s = e / (D / 8), d = (e % (D / 8)) * 8;
      const int src = sm.src[st][s];
      float kx[8], vx[8];
      if (src == -1) {
        attn_split::widen8(&sm.ring[st][0][s * D + d], kx);
        attn_split::widen8(&sm.ring[st][1][s * D + d], vx);
      } else {
        const float* kf = kch + (size_t)max(src, 0) * row + d;
        const float* vf = vch + (size_t)max(src, 0) * row + d;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          kx[i] = src >= 0 ? static_cast<float>(attn_split::quantize_i8(kf[i], k_inv)) : 0.f;
          vx[i] = src >= 0 ? static_cast<float>(attn_split::quantize_i8(vf[i], v_inv)) : 0.f;
        }
      }
      *reinterpret_cast<uint4*>(&sm.kp[s * LDS + d]) = pack8(kx);
      *reinterpret_cast<uint4*>(&sm.vp[s * LDS + d]) = pack8(vx);
    }
  };

  const int slab = warp % kSlabs, stream = warp / kSlabs;
  const bool active = slab < slabs;
  const int g = lane >> 2, t = lane & 3;   // the fragments' row group and lane pair
  // this lane's query rows g and g + 8 see positions <= vis (rows past nq: the last query's)
  int vis[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) vis[i] = start + c0 + min(slab * 16 + g + 8 * i, nq - 1) / G;
  const int vis_lo = start + c0 + min(slab * 16, nq - 1) / G;   // the slab's first query
  const float scale2 = a.sm_scale * 1.44269504088896341f;      // log2 e
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {   // in flight while the prologue runs
    if (j < n_tiles)
      stage(j);
    else
      cp_async::commit();
  }

  // q 2^-k_n (exact) in three bf16 planes; rows past nq in the last slab
  // are 0.  q's loads are in flight while rank 0 writes the chunk's rows.
  constexpr int QPAIRS = kMaxQ * (D / 2) / kThreads;
  static_assert(QPAIRS * kThreads == kMaxQ * (D / 2), "the tile's q splits evenly");
  float2 qx[QPAIRS];
#pragma unroll
  for (int i = 0; i < QPAIRS; ++i) {
    const int e = tid + i * kThreads, qi = e / (D / 2), d = (e % (D / 2)) * 2;
    qx[i] = make_float2(0.f, 0.f);
    if (qi < nq) {
      const float* x = a.q + ((size_t)(c0 + qi / G) * Hq + (size_t)h * G + qi % G) * D + d;
      qx[i] = make_float2(x[0], x[1]);
    }
  }
  // The one writer of this tile's rows at head h: rank 0.
  if (rank == 0) {
    for (int e = tid; e < n_rows * (D / 4); e += kThreads) {
      const int c = c0 + e / (D / 4), d = (e % (D / 4)) * 4;
      const int pos = start + c, lp = pos / a.ps;
      const int page = lp < a.max_pages ? entry(a, lp) : -1;
      if (page < 0) continue;   // dropped
      const size_t off = (size_t)page * page_elems + (size_t)(pos - lp * a.ps) * row +
                         (size_t)h * D + d;
      const float* kx = kch + (size_t)c * row + d;
      const float* vx = vch + (size_t)c * row + d;
      signed char kq[4], vq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kq[j] = attn_split::quantize_i8(kx[j], k_inv);
        vq[j] = attn_split::quantize_i8(vx[j], v_inv);
      }
      *reinterpret_cast<char4*>(a.k + off) = make_char4(kq[0], kq[1], kq[2], kq[3]);
      *reinterpret_cast<char4*>(a.v + off) = make_char4(vq[0], vq[1], vq[2], vq[3]);
    }
  }

#pragma unroll
  for (int i = 0; i < QPAIRS; ++i) {
    const int e = tid + i * kThreads, qi = e / (D / 2), d = (e % (D / 2)) * 2;
    if (qi >= slabs * 16) break;
    uint32_t p0, p1, p2;
    wq_gemm::split3(qx[i].x * k_scale, qx[i].y * k_scale, p0, p1, p2);
    *reinterpret_cast<uint32_t*>(&sm.qp[0][qi * LDS + d]) = p0;
    *reinterpret_cast<uint32_t*>(&sm.qp[1][qi * LDS + d]) = p1;
    *reinterpret_cast<uint32_t*>(&sm.qp[2][qi * LDS + d]) = p2;
  }

  for (int j = 0; j < n_tiles; ++j) {
    cp_async::wait<kStages - 2>();
    __syncthreads();   // tile j landed; every warp is done with tile j - 1's planes
    if (j + kStages - 1 < n_tiles)
      stage(j + kStages - 1);
    else
      cp_async::commit();
    widen(j % kStages);
    __syncthreads();
    if (!active) continue;
    const int p0 = lo + j * BS + stream * PW;   // this warp's first position

    // scores: each part of q in its own accumulator (independent chains),
    // the first apart from the other two
    float sh[PW / 8][4], s1[PW / 8][4], s2[PW / 8][4];
#pragma unroll
    for (int n = 0; n < PW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[n][e] = s1[n][e] = s2[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t qa[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
        wq_gemm::ldsm_x4(qa[p], &sm.qp[p][(slab * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int n = 0; n < PW / 16; ++n) {
        uint32_t kb[4];
        wq_gemm::ldsm_x4(kb, &sm.kp[(stream * PW + n * 16 + (lane >> 4) * 8 + (lane & 7)) * LDS +
                                    kk + ((lane >> 3) & 1) * 8]);
        wq_gemm::mma(sh[2 * n], qa[0], kb[0], kb[1]);
        wq_gemm::mma(sh[2 * n + 1], qa[0], kb[2], kb[3]);
        wq_gemm::mma(s1[2 * n], qa[1], kb[0], kb[1]);
        wq_gemm::mma(s1[2 * n + 1], qa[1], kb[2], kb[3]);
        wq_gemm::mma(s2[2 * n], qa[2], kb[0], kb[1]);
        wq_gemm::mma(s2[2 * n + 1], qa[2], kb[2], kb[3]);
      }
    }

    // masks and the online softmax in base 2 (scores times sm_scale log2 e);
    // c[e]: row g + 8 (e >> 1), position 2t + (e & 1).  A warp whose
    // positions all lie below hi and at or before its first query's row
    // masks nothing.
    float mx[2] = {-INFINITY, -INFINITY};
    const bool open = p0 + PW <= hi && p0 + PW - 1 <= vis_lo;
#pragma unroll
    for (int n = 0; n < PW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = p0 + n * 8 + 2 * t + (e & 1);
        const float s = (sh[n][e] + (s2[n][e] + s1[n][e])) * scale2;
        sh[n][e] = open ? s : (pos >= hi ? -INFINITY : (pos > vis[e >> 1] ? kMasked : s));
        mx[e >> 1] = fmaxf(mx[e >> 1], sh[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < PW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sh[n][e] = exp2f(sh[n][e] - m[e >> 1]);
        sum[e >> 1] += sh[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];   // this lane's share

    // P V: P in three bf16 parts from the score fragments, V through ldmatrix.trans
    float pv[D / 8][4];
#pragma unroll
    for (int j2 = 0; j2 < D / 8; ++j2)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j2][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < PW / 16; ++kk) {
      uint32_t pa[3][4];
      wq_gemm::split3(sh[2 * kk][0], sh[2 * kk][1], pa[0][0], pa[1][0], pa[2][0]);
      wq_gemm::split3(sh[2 * kk][2], sh[2 * kk][3], pa[0][1], pa[1][1], pa[2][1]);
      wq_gemm::split3(sh[2 * kk + 1][0], sh[2 * kk + 1][1], pa[0][2], pa[1][2], pa[2][2]);
      wq_gemm::split3(sh[2 * kk + 1][2], sh[2 * kk + 1][3], pa[0][3], pa[1][3], pa[2][3]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t vb[4];
        ldsm_x4_t(vb, &sm.vp[(stream * PW + kk * 16 + (lane & 15)) * LDS + dn * 16 +
                             (lane >> 4) * 8]);
#pragma unroll
        for (int p = 2; p >= 0; --p) {
          wq_gemm::mma(pv[2 * dn], pa[p], vb[0], vb[1]);
          wq_gemm::mma(pv[2 * dn + 1], pa[p], vb[2], vb[3]);
        }
      }
    }
#pragma unroll
    for (int j2 = 0; j2 < D / 8; ++j2)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j2][e] = fmaf(acc[j2][e], alpha[e >> 1], pv[j2][e]);
  }

  // The four warps of each slab, then the cluster's ranks.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  cp_async::wait<0>();   // only empty groups are left
  __syncthreads();       // every warp is past the ring and the planes
  if (active) {
#pragma unroll
    for (int j2 = 0; j2 < D / 8; ++j2)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm.part.acc[warp][g + 8 * (e >> 1)][j2 * 8 + 2 * t + (e & 1)] = acc[j2][e] * v_scale;
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sm.part.m[warp][g + 8 * i] = m[i] * 0.693147180559945309f;   // ln 2: natural units
        sm.part.l[warp][g + 8 * i] = l[i];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nq * (D / 4); e += kThreads) {   // groups of four outputs of a query
    const int qi = e / (D / 4), d = (e % (D / 4)) * 4, r = qi % 16;
    const int w0 = qi / 16;   // the slab's warps: w0 + kSlabs * stream
    float mxw = sm.part.m[w0][r];
#pragma unroll
    for (int v = 1; v < kStreams; ++v) mxw = fmaxf(mxw, sm.part.m[w0 + kSlabs * v][r]);
    float s_acc[4] = {0.f, 0.f, 0.f, 0.f}, s_l = 0.f;
#pragma unroll
    for (int v = 0; v < kStreams; ++v) {
      const int w = w0 + kSlabs * v;
      const float f = expf(sm.part.m[w][r] - mxw);
      const float4 x = *reinterpret_cast<const float4*>(&sm.part.acc[w][r][d]);
      s_acc[0] = fmaf(x.x, f, s_acc[0]);
      s_acc[1] = fmaf(x.y, f, s_acc[1]);
      s_acc[2] = fmaf(x.z, f, s_acc[2]);
      s_acc[3] = fmaf(x.w, f, s_acc[3]);
      s_l = fmaf(sm.part.l[w][r], f, s_l);
    }
    *reinterpret_cast<float4*>(&sm.blk.acc[qi][d]) =
        make_float4(s_acc[0], s_acc[1], s_acc[2], s_acc[3]);
    if (d == 0) {
      sm.blk.m[qi] = mxw;
      sm.blk.l[qi] = s_l;
    }
  }
  attn_split::fold_ranks<D, 4>(&sm.blk.acc[0][0], sm.blk.m, sm.blk.l, nq, [&](int e, float x) {
    const int qi = e / D;
    a.out[((size_t)(c0 + qi / G) * Hq + (size_t)h * G + qi % G) * D + e % D] = x;
  });
}

// One launch of Kernel (the caller's __global__ around chunk<D>) for
// `args`: ceil(C / rows) query tiles of `rows` rows (query_rows below) x
// Hkv heads, each a cluster of `ranks` blocks.  Returns the launch's error.
// The kernel is a template argument so that each kernel, internal to its
// source, keeps its own record of the grant.
template <int D, void (*Kernel)(Args)>
cudaError_t launch(const Args& args, int ranks, cudaStream_t stream) {
  constexpr size_t smem = sizeof(Smem<D>);
  static const cudaError_t granted = attn_split::grant(Kernel, smem);
  if (granted != cudaSuccess) return granted;
  const int tiles = (args.C + args.rows - 1) / args.rows;
  return attn_split::launch(Kernel, dim3(tiles * ranks, args.Hkv), ranks, smem, stream, args);
}

// Rows per query tile: as few tiles of at most kMaxQ queries as G allows,
// the rows spread evenly over them (kernels/attn_split.py::chunk_tiles).
inline int query_rows(int C, int G) {
  const int most = kMaxQ / G;
  const int tiles = (C + most - 1) / most;
  return (C + tiles - 1) / tiles;
}

}  // namespace chunk_split
