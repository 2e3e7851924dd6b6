// The split walk over an int8 KV pool shared by qpaged_attn.cu (decode),
// qdecode_attn.cu (decode over a dense cache) and qragged_attn.cu (the
// ragged tick): one query group of G heads of one KV head attends one
// slot's positions [0, s_end) through its page table row, the walk split
// across the R blocks of a thread-block cluster (flash-decoding in one
// launch).  The two decode entries run one body, decode below: a dense
// (B, S, Hkv, D) cache is a pool of B pages of page size S, slot b pool
// page b under the one-entry table row {b} (a null table).  The chunk core
// (chunk_split.cuh) takes its partition (rank_range), cluster fold
// (fold_ranks), quantize_i8, widen8 and launch.
//
// Partition.  [0, s_end) is cut into tiles of BS positions (64 at D = 32
// and 64, 128 at D = 16, 32 at D = 128), and rank r of the cluster takes
// tiles [r n / R, (r + 1) n / R) of the n tiles: a contiguous run of whole
// tiles, at most one tile more than any other rank's, so no rank is empty
// while R <= n.
// Inside a block each of the 8 warps walks its own P positions of every
// tile (tile t, warp w: positions lo + t BS + w P .. + P), so a step costs
// the warp no block barrier.  Each warp stages its positions' K and V rows
// (int8, as stored) through a ring of four cp.async stages, the next three
// steps' rows in flight while this one is computed.  In the warp, D / 8
// lanes share a position, 8 dimensions each: q.k is each lane's 8 FMAs and
// a butterfly over its D / 8 lanes; each group of lanes is an online
// softmax of its own, (m, l, acc) in registers, over the positions it is
// given, and the groups are folded by shuffles when the walk ends.  Codes
// are read from shared memory as bytes and widened exactly (byte ^ 0x80
// into the low bits of 2^23, minus 2^23 + 128: a byte permute and an add);
// the dequantizing power of two 2^-n is exact, so it is applied to q
// (2^-k_n) and to the folded acc (2^-v_n) instead of to every code.  q.k
// and p.v are f32 FMAs on the CUDA cores: a group is G = 3 rows at the
// serving shape, far under one m16 tensor-core tile, and the walk is bound
// by latency, not by arithmetic.
//
// The split R.  kernels/attn_split.py picks it from shapes alone (the
// table's reach, the number of walks, Hkv, D): at most one rank per tile of
// a walk to the table's end, minimising the longest rank's tiles plus 5 per
// wave of blocks (two an SM).  A cluster holds its R blocks until its
// longest rank ends, so ranks pay only where walks are long and few: at
// D=64, Hkv=3 on an H100 the decode of B=8 slots at S=2048 takes 38.3 /
// 21.6 / 13.1 / 10.0 us at R = 1 / 2 / 4 / 8, and the ragged tick of T=72
// tokens 44.5 / 26.1 / 30.6 / 55.4 (PERF.md).
//
// Softmax conventions, as the references keep them: (m, l, acc) start at
// (-1e30, 0, 0); a position the walk does not see (past s_end, or an
// unmapped entry in the ragged tick) scores -inf and weighs exactly 0; a
// masked position (decode, kv_len <= 0) scores -1e30 and weighs
// exp(-1e30 - m), which is 1 while every score is masked, so a slot with
// nothing live gives the mean of V over the visited page, as the Pallas
// kernel does.  A rank or warp with no position keeps (-1e30, 0, 0).
//
// Combine.  The lane groups of a warp fold by shuffles, the warps' (m, l,
// acc) go over the ring in shared memory and the block folds them
// (rescaled by exp(m_w - m)); after a cluster barrier rank r folds slice
// [r GD / R, (r + 1) GD / R) of the GD = G D outputs over ranks 0 .. R-1 in
// order through distributed shared memory, divides by max(l, 1e-30) and
// writes out; a second barrier keeps every block alive until its peers
// have read it.  A row that sees nothing has l = 0 and
// acc = 0 everywhere, and outputs exact zeros.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace attn_split {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;       // steps of a warp in flight
constexpr int kMaxRanks = 8;     // the portable cluster size
constexpr float kMasked = -1e30f;

template <int D>
struct Geom {
  static constexpr int DL = 8;                         // dimensions per lane
  static constexpr int LPP = D / DL;                   // lanes per position
  static constexpr int GP = 32 / LPP;                  // position groups per warp
  static constexpr int P = D == 128 ? 4 : (GP > 8 ? GP : 8);   // positions per warp and step
  static constexpr int PPG = P / GP;                   // positions per group and step
  static constexpr int BS = P * kWarps;                // a tile: one step of the block
  static constexpr int CHUNKS = D / 16;                // 16-byte copies per row
  static constexpr int COPIES = P * CHUNKS;            // per tensor and step
  static_assert(D % 16 == 0 && COPIES <= 32 && PPG >= 1, "one K and one V copy per lane");
};

template <int D, int KG>
struct Smem {
  using Gm = Geom<D>;
  union {
    alignas(16) int8_t ring[kWarps][kStages][2][Gm::P * D];   // K, V rows per warp and stage
    struct {   // after the walk: each warp's partial softmax
      float acc[kWarps][KG][D];
      float m[kWarps][KG];
      float l[kWarps][KG];
    } part;
  };
  float blk_acc[KG][D];   // the block's fold, read by the cluster
  float blk_m[KG];
  float blk_l[KG];
  int page[kWarps][kStages][Gm::P];   // pool page of each staged position; -1: not seen
  int row[kWarps][kStages][Gm::P];    // ragged: the tick row whose codes it takes; -1: pool
  int wmin;
};

// One rank's walk.
struct Walk {
  const int8_t* kh;        // the pools at this KV head (k + h * D)
  const int8_t* vh;
  const int* trow;         // the slot's table row; null: page `slot` (a dense cache)
  size_t row;              // elements between consecutive rows of a page (Hkv * D)
  size_t page_elems;       // and between pages (ps * row)
  int ps;
  int lo, hi;              // this rank's positions
  int len;                 // positions >= len score -1e30 (decode); INT_MAX: none
  float k_scale, v_scale, sm_scale;
  // the ragged tick: rows of this slot that the tick writes replace the
  // pool's bytes (quantized here from the f32 inputs), and are never read
  // from the pool; no row of the slot lies below wmin
  const float* kc;         // k/v new at this KV head (kc + h * D)
  const float* vc;
  const int* slot_ids;
  const int* positions;
  int T, slot, wmin;
  float k_inv, v_inv;
};

// sat(trunc(x * 2^n)) with inv_scale = 2^n: a product by an exact power of
// two, so the codes equal the plain version's bit for bit.
__device__ __forceinline__ signed char quantize_i8(float x, float inv_scale) {
  const float t = truncf(x * inv_scale);
  return static_cast<signed char>(fminf(fmaxf(t, -128.f), 127.f));
}

// [lo, hi): rank `rank` of `ranks` takes its run of the ceil(s_end / bs) tiles.
__device__ __forceinline__ void rank_range(int s_end, int bs, int rank, int ranks, int& lo,
                                           int& hi) {
  const int n = (s_end + bs - 1) / bs;
  lo = rank * n / ranks * bs;
  hi = min((rank + 1) * n / ranks * bs, s_end);
}

// Stage the warp's P positions from p0: their pages (and, in the ragged
// tick, the tick rows that replace them), then the copies of the rows read
// from the pool.  Commits one cp.async group.
template <int D, int KG, bool kRagged>
__device__ __forceinline__ void stage(Smem<D, KG>& sm, const Walk& wk, int w, int lane, int st,
                                      int p0) {
  using Gm = Geom<D>;
  if (lane < Gm::P) {
    const int pos = p0 + lane;
    int page = -1;
    if (pos < wk.hi) {
      const int e = wk.trow ? __ldg(wk.trow + pos / wk.ps) : wk.slot;
      page = kRagged ? e : max(e, 0);   // decode: an unmapped entry reads pool page 0
    }
    sm.page[w][st][lane] = page;
    sm.row[w][st][lane] = -1;
  }
  __syncwarp();
  if (kRagged && p0 + Gm::P > wk.wmin) {
    const int end = min(p0 + Gm::P, wk.hi);
    for (int u = lane; u < wk.T; u += 32) {
      const int pu = __ldg(wk.positions + u);
      if (pu >= p0 && pu < end && __ldg(wk.slot_ids + u) == wk.slot &&
          sm.page[w][st][pu - p0] >= 0)
        sm.row[w][st][pu - p0] = u;
    }
    __syncwarp();
  }
  if (lane < Gm::COPIES) {
    const int s = lane / Gm::CHUNKS, ch = lane % Gm::CHUNKS;
    const int page = sm.page[w][st][s];
    if (page >= 0 && sm.row[w][st][s] < 0) {
      const int pos = p0 + s;
      const size_t off =
          (size_t)page * wk.page_elems + (size_t)(pos % wk.ps) * wk.row + ch * 16;
      cp_async::copy16(&sm.ring[w][st][0][s * D + ch * 16], wk.kh + off, 16);
      cp_async::copy16(&sm.ring[w][st][1][s * D + ch * 16], wk.vh + off, 16);
    }
  }
  cp_async::commit();
}

// Eight int8 codes as exact floats: byte ^ 0x80 becomes the low byte of
// the float 2^23 + u, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void widen8(const int8_t* p, float (&x)[8]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const uint32_t lo = w.x ^ 0x80808080u, hi = w.y ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = __uint_as_float(__byte_perm(lo, 0x4B00u, 0x5440u + i)) - 8388736.f;
    x[i + 4] = __uint_as_float(__byte_perm(hi, 0x4B00u, 0x5440u + i)) - 8388736.f;
  }
}

// One step of the lane group's online softmax over its staged positions
// (group gi: positions p0 + k GP + gi, k < PPG).  qv holds q 2^-k_n and
// acc sums p times V's codes (2^-v_n is applied when the walk ends).
template <int D, int KG, bool kRagged>
__device__ __forceinline__ void consume(const Smem<D, KG>& sm, const Walk& wk, int w, int lane,
                                        int st, int p0, int G, const float (&qv)[KG][8],
                                        float (&acc)[KG][8], float (&m)[KG], float (&l)[KG]) {
  using Gm = Geom<D>;
  constexpr int PPG = Gm::PPG;
  const int gi = lane / Gm::LPP, d0 = (lane % Gm::LPP) * 8;
  float kf[PPG][8], vf[PPG][8];
  bool seen[PPG];
#pragma unroll
  for (int k = 0; k < PPG; ++k) {
    const int s = k * Gm::GP + gi;
    seen[k] = sm.page[w][st][s] >= 0;
    const int r = kRagged ? sm.row[w][st][s] : -1;
    if (kRagged && r >= 0) {
      const float* kp = wk.kc + (size_t)r * wk.row + d0;
      const float* vp = wk.vc + (size_t)r * wk.row + d0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kf[k][j] = static_cast<float>(quantize_i8(kp[j], wk.k_inv));
        vf[k][j] = static_cast<float>(quantize_i8(vp[j], wk.v_inv));
      }
    } else {
      widen8(&sm.ring[w][st][0][s * D + d0], kf[k]);
      widen8(&sm.ring[w][st][1][s * D + d0], vf[k]);
    }
  }
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    if (g >= G) break;
    float sc[PPG];
#pragma unroll
    for (int k = 0; k < PPG; ++k) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) a = fmaf(qv[g][j], kf[k][j], a);
      sc[k] = a;
    }
#pragma unroll
    for (int off = Gm::LPP / 2; off > 0; off >>= 1)
#pragma unroll
      for (int k = 0; k < PPG; ++k) sc[k] += __shfl_xor_sync(0xffffffffu, sc[k], off);
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < PPG; ++k) {
      // unseen positions weigh exactly 0; masked ones exp(-1e30 - m)
      const int pos = p0 + k * Gm::GP + gi;
      sc[k] = !seen[k] ? -INFINITY : (pos < wk.len ? sc[k] * wk.sm_scale : kMasked);
      mx = fmaxf(mx, sc[k]);
    }
    const float m_new = fmaxf(m[g], mx);
    const float alpha = expf(m[g] - m_new);
    float sum = 0.f, pv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) pv[j] = 0.f;
#pragma unroll
    for (int k = 0; k < PPG; ++k) {
      const float p = expf(sc[k] - m_new);
      sum += p;
#pragma unroll
      for (int j = 0; j < 8; ++j) pv[j] = fmaf(p, vf[k][j], pv[j]);
    }
    l[g] = l[g] * alpha + sum;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = acc[g][j] * alpha + pv[j];
    m[g] = m_new;
  }
}

// The rank's walk over [wk.lo, wk.hi), each lane group with its own (m, l, acc).
template <int D, int KG, bool kRagged>
__device__ __forceinline__ void walk(Smem<D, KG>& sm, const Walk& wk, int G,
                                     const float (&qv)[KG][8], float (&acc)[KG][8],
                                     float (&m)[KG], float (&l)[KG]) {
  using Gm = Geom<D>;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_steps = wk.hi > wk.lo ? (wk.hi - wk.lo + Gm::BS - 1) / Gm::BS : 0;
  const int first = wk.lo + w * Gm::P;
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_steps)
      stage<D, KG, kRagged>(sm, wk, w, lane, j, first + j * Gm::BS);
    else
      cp_async::commit();
  }
  for (int j = 0; j < n_steps; ++j) {
    const int jn = j + kStages - 1;
    __syncwarp();   // the stage refilled here was consumed by the previous step
    if (jn < n_steps)
      stage<D, KG, kRagged>(sm, wk, w, lane, jn % kStages, first + jn * Gm::BS);
    else
      cp_async::commit();
    cp_async::wait<kStages - 1>();   // this step's copies have landed (this lane's)
    __syncwarp();                    // and the other lanes'
    consume<D, KG, kRagged>(sm, wk, w, lane, j % kStages, first + j * Gm::BS, G, qv, acc, m, l);
  }
}

// The cluster's fold of `rows` rows of D outputs, each block's (m, l, acc)
// in its shared memory (acc row-major [rows][D], 16-byte aligned when W is
// 4): after a cluster barrier rank r folds slice [r n / R, (r + 1) n / R) of
// the n = rows D / W groups of W outputs of a row over ranks 0 .. R-1 in
// order through distributed shared memory (rescaled by exp(m_i - max m);
// each rank's m and l read once a group) and hands out(e, acc / max(l,
// 1e-30)) each output e = row D + d; a second barrier keeps every block
// alive until its peers have read it.  combine below folds one output a
// group (W = 1), chunk_split.cuh four (a float4 of acc per rank).
template <int D, int W, typename Out>
__device__ __forceinline__ void fold_ranks(const float* blk_acc, const float* blk_m,
                                           const float* blk_l, int rows, Out out) {
  static_assert((W == 1 || W == 4) && D % W == 0, "groups of one or four outputs of a row");
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = rows * (D / W);
  for (int e = rank * n / ranks + static_cast<int>(threadIdx.x); e < (rank + 1) * n / ranks;
       e += kThreads) {
    const int g = e / (D / W);
    float a[W], ls = 0.f;
#pragma unroll
    for (int j = 0; j < W; ++j) a[j] = 0.f;
    if constexpr (W == 4) {
      // every rank's m, l and float4 of acc loaded before the first use
      float mv[kMaxRanks], lv[kMaxRanks];
      float4 av[kMaxRanks];
      float mx = -INFINITY;
#pragma unroll
      for (int p = 0; p < kMaxRanks; ++p) {
        if (p < ranks) {
          mv[p] = *cluster.map_shared_rank(blk_m + g, p);
          lv[p] = *cluster.map_shared_rank(blk_l + g, p);
          av[p] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(blk_acc + W * e, p));
        }
      }
#pragma unroll
      for (int p = 0; p < kMaxRanks; ++p)
        if (p < ranks) mx = fmaxf(mx, mv[p]);
#pragma unroll
      for (int p = 0; p < kMaxRanks; ++p) {
        if (p < ranks) {
          const float f = expf(mv[p] - mx);
          a[0] = fmaf(av[p].x, f, a[0]);
          a[1] = fmaf(av[p].y, f, a[1]);
          a[2] = fmaf(av[p].z, f, a[2]);
          a[3] = fmaf(av[p].w, f, a[3]);
          ls = fmaf(lv[p], f, ls);
        }
      }
    } else {
      float mx = -INFINITY;
      for (int p = 0; p < ranks; ++p) mx = fmaxf(mx, *cluster.map_shared_rank(blk_m + g, p));
      for (int p = 0; p < ranks; ++p) {
        const float f = expf(*cluster.map_shared_rank(blk_m + g, p) - mx);
        a[0] = fmaf(*cluster.map_shared_rank(blk_acc + e, p), f, a[0]);
        ls = fmaf(*cluster.map_shared_rank(blk_l + g, p), f, ls);
      }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) out(W * e + j, a[j] / fmaxf(ls, 1e-30f));
  }
  cluster.sync();   // no block leaves while a peer still reads its fold
}

// Fold the lane groups, the warps, then the cluster's ranks, and write
// out[0 .. G*D) (acc times v_scale over l).
template <int D, int KG>
__device__ __forceinline__ void combine(Smem<D, KG>& sm, int G, float v_scale,
                                        float (&acc)[KG][8], float (&m)[KG], float (&l)[KG],
                                        float* __restrict__ out) {
  using Gm = Geom<D>;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
#pragma unroll
  for (int off = Gm::LPP; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      if (g >= G) break;
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float f = expf(m[g] - mn), fo = expf(mo - mn);
      l[g] = l[g] * f + lo * fo;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[g][j] = acc[g][j] * f + __shfl_xor_sync(0xffffffffu, acc[g][j], off) * fo;
      m[g] = mn;
    }
  }
  cp_async::wait<0>();   // only empty groups are left
  __syncthreads();       // every warp is past the ring: the partials go over it
  if (lane < Gm::LPP) {  // group 0 holds the warp's fold
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int j = 0; j < 8; ++j) sm.part.acc[w][g][lane * 8 + j] = acc[g][j] * v_scale;
      if (lane == 0) {
        sm.part.m[w][g] = m[g];
        sm.part.l[w][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float mx = sm.part.m[0][g];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) mx = fmaxf(mx, sm.part.m[v][g]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float f = expf(sm.part.m[v][g] - mx);
      a = fmaf(sm.part.acc[v][g][d], f, a);
      ls = fmaf(sm.part.l[v][g], f, ls);
    }
    sm.blk_acc[g][d] = a;
    if (d == 0) {
      sm.blk_m[g] = mx;
      sm.blk_l[g] = ls;
    }
  }
  fold_ranks<D, 1>(&sm.blk_acc[0][0], sm.blk_m, sm.blk_l, G, [&](int e, float x) { out[e] = x; });
}

// The arguments of a decode launch over B slots.  The paged pool (P, ps,
// Hkv, D) comes with its table (B, max_pages); a dense cache (B, S, Hkv, D)
// is the pool with a null table, ps = S and max_pages = 1.  The exponents
// and the live length come from device memory (non-null pointer;
// kv_len_stride 1 for a (B,) vector, 0 for one shared value) or by value.
struct DecodeArgs {
  const float* q;          // (B, Hq, D), Hq = G * Hkv
  const int8_t* k;
  const int8_t* v;
  const int* k_n_ptr;
  int k_n_val;
  const int* v_n_ptr;
  int v_n_val;
  const int* table;
  const int* kv_len_ptr;
  int kv_len_stride;
  int kv_len_val;
  float* out;              // (B, Hq, D)
  int ps, max_pages, Hkv, G;
  float sm_scale;
};

// The body of a decode kernel of kThreads threads that each source names
// for itself (launch_decode below): one cluster of R blocks per (KV head,
// slot), grid (Hkv * R, B).  The reads are the Pallas kernels': pages 0 ..
// min((kv_len - 1) / ps, max_pages - 1) are visited (page 0 alone when
// kv_len <= 0), so the walk stops at the table's end even when an inactive
// slot's length has ticked past it; an unmapped entry reads pool page 0.
// For a dense cache that is [0, min(kv_len, S)), and all of [0, S) at
// kv_len <= 0, where every score is masked and the output is the mean of V
// over the whole row.
template <int D, int KG>
__device__ __forceinline__ void decode(const DecodeArgs& a) {
  using Gm = Geom<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<D, KG>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.x / ranks;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int G = a.G, Hq = a.Hkv * G;
  const int len = a.kv_len_ptr ? a.kv_len_ptr[(size_t)b * a.kv_len_stride] : a.kv_len_val;
  // pages the Pallas kernel visits: through the last live one (page 0 when
  // the slot is empty), never past the table
  const int last = min(max((len - 1) / a.ps, 0), a.max_pages - 1);
  const int n_walk = (last + 1) * a.ps;
  const int s_end = len > 0 ? min(len, n_walk) : n_walk;

  Walk wk = {};
  wk.kh = a.k + (size_t)h * D;
  wk.vh = a.v + (size_t)h * D;
  wk.trow = a.table ? a.table + (size_t)b * a.max_pages : nullptr;
  wk.slot = b;
  wk.row = (size_t)a.Hkv * D;
  wk.page_elems = (size_t)a.ps * wk.row;
  wk.ps = a.ps;
  rank_range(s_end, Gm::BS, static_cast<int>(cluster.block_rank()), ranks, wk.lo, wk.hi);
  wk.len = len;
  wk.k_scale = exp2f(-static_cast<float>(a.k_n_ptr ? *a.k_n_ptr : a.k_n_val));
  wk.v_scale = exp2f(-static_cast<float>(a.v_n_ptr ? *a.v_n_ptr : a.v_n_val));
  wk.sm_scale = a.sm_scale;

  const float* qb = a.q + ((size_t)b * Hq + (size_t)h * G) * D;
  // this lane's 8 dimensions of q, times 2^-k_n (exact)
  const int d0 = (lane % Gm::LPP) * 8;
  float qv[KG][8], acc[KG][8], m[KG], l[KG];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    m[g] = kMasked;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      qv[g][j] = g < G ? qb[g * D + d0 + j] * wk.k_scale : 0.f;
      acc[g][j] = 0.f;
    }
  }
  walk<D, KG, false>(sm, wk, G, qv, acc, m, l);
  combine<D, KG>(sm, G, wk.v_scale, acc, m, l, a.out + ((size_t)b * Hq + (size_t)h * G) * D);
}

// Dynamic shared memory above 48 KB for `kernel` (the G > 4 instantiations
// at D = 128); call once per kernel.
template <typename Kernel>
inline cudaError_t grant(Kernel kernel, size_t smem) {
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// One launch of `grid` blocks in clusters of (ranks, 1, 1); returns the
// launch's error, cleared.
template <typename... Params, typename... Args>
inline cudaError_t launch(void (*kernel)(Params...), dim3 grid, int ranks, size_t smem,
                          cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ranks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();   // read (and clear) the launch's error
  return e != cudaSuccess ? e : last;
}

// cudaErrorInvalidValue for a decode launch of B slots at head dimension D
// in clusters of `ranks` blocks that decode does not take: D in {16, 32,
// 64, 128}, G <= 16, ps >= 1, max_pages >= 1, B <= 65535, 1 <= ranks <= 8
// and 16-byte aligned pools (the walk stages rows with 16-byte copies).
inline cudaError_t check_decode(const DecodeArgs& a, int B, int D, int ranks) {
  const bool ok = (D == 16 || D == 32 || D == 64 || D == 128) && a.G >= 1 && a.G <= 16 &&
                  a.ps >= 1 && a.max_pages >= 1 && B <= 65535 && ranks >= 1 &&
                  ranks <= kMaxRanks && reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// One launch of Kernel (the caller's __global__ around decode<D, KG>) over
// B slots, each (KV head, slot) a cluster of `ranks` blocks.  Returns the
// launch's error.  The kernel is a template argument so that each kernel,
// internal to its source, keeps its own record of the grant: a static of a
// function shared by two libraries would be one object per process.
template <int D, int KG, void (*Kernel)(DecodeArgs)>
cudaError_t launch_decode(const DecodeArgs& a, int B, int ranks, cudaStream_t stream) {
  constexpr size_t smem = sizeof(Smem<D, KG>);
  static const cudaError_t granted = grant(Kernel, smem);
  if (granted != cudaSuccess) return granted;
  return launch(Kernel, dim3(a.Hkv * ranks, B), ranks, smem, stream, a);
}

}  // namespace attn_split
