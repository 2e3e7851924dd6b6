// The integer tensor-core tile core shared by qmm.cu (qmm, qmm_requant)
// and qconv1d.cu: int8 or int16 operands, int32 sums that wrap modulo 2^32
// as XLA's int32 dot and convolution do.
//
// Products.  int8 codes go to mma.sync.aligned.m16n8k32 .s32.s8.s8.s32
// (m16n8k16 for a 16-deep tail), fed from ldmatrix fragments: an 8-bit
// m16n8k32 fragment is byte for byte a 16-bit m16n8k16 one, so the b16
// ldmatrix forms serve.  int16 has no tensor-core form of its own, but
// every int16 code is a = 256 * hi + lo with hi = a >> 8 (signed byte) and
// lo = a & 0xFF (unsigned byte), so
//   a * b = 65536 * hi_a * hi_b + 256 * (hi_a * lo_b + lo_a * hi_b) + lo_a * lo_b
// is four 8-bit products: mma with .s8.s8, .s8.u8, .u8.s8 and .u8.u8
// operands into three accumulators (hh, mixed, ll), combined in the
// epilogue as (hh << 16) + (mixed << 8) + ll in unsigned arithmetic.  Each
// accumulator is exact modulo 2^32, and so is the combination: the same
// value as the wrapping int32 sum of the products.  The split happens while
// a tile is staged, into a hi and a lo byte plane per operand.
//
// Wrapping.  No .satfinite: the mma's s32 accumulation then wraps modulo
// 2^32 (the card's wrap cases in chip_smoke.py hold this: all -128 at
// C = 65536 in qconv1d, all -128 at K = 196608 in qmm), so the sums stay
// in the mma's registers for the whole K loop; no partial sum is moved to
// CUDA-core adds.  Sums of partial tiles across cluster ranks or taps are
// unsigned adds, which wrap the same way in any order.
//
// Layout.  A is [m][k] bytes, B is [n][k] bytes (the reduction contiguous
// in both, ldmatrix without .trans); rows are padded to a pitch that is an
// odd number of 16-byte groups (`pitch` below), so the 8 rows one 8x8
// ldmatrix reads lie in 8 distinct bank groups.  The weights arrive with N
// (qmm) or F (qconv1d) contiguous, so their bytes are transposed while
// staged, 4 x 4 bytes at a time with __byte_perm (`transpose4`,
// `split_cols`); never in a separate pass or launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace int_mma {

// Bytes of a plane row holding `bytes` of the reduction: an odd multiple of
// 16, so the 8 rows of one ldmatrix lie in distinct 16-byte bank groups.
__host__ __device__ constexpr int pitch(int bytes) {
  return ((bytes + 15) / 16) % 2 ? (bytes + 15) / 16 * 16 : (bytes + 15) / 16 * 16 + 16;
}

using cp_async::smem_addr;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x1(uint32_t& r0, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n" : "=r"(r0) : "r"(addr));
}

#define INT_MMA_K32(TA, TB)                                                               \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." TA "." TB                         \
               ".s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n" \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                         \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
#define INT_MMA_K16(TA, TB)                                                   \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.s32." TA "." TB             \
               ".s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n" \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])             \
               : "r"(a[0]), "r"(a[1]), "r"(b0))

// d += a (16 x 32, row) * b (32 x 8, col), 8-bit operands signed (SA, SB
// true) or unsigned, s32 sums that wrap.
template <bool SA, bool SB>
__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  if constexpr (SA && SB) INT_MMA_K32("s8", "s8");
  else if constexpr (SA) INT_MMA_K32("s8", "u8");
  else if constexpr (SB) INT_MMA_K32("u8", "s8");
  else INT_MMA_K32("u8", "u8");
}

// d += a (16 x 16, row) * b (16 x 8, col): the 16-deep tail.
template <bool SA, bool SB>
__device__ __forceinline__ void mma_k16(int (&d)[4], const uint32_t (&a)[2], uint32_t b0) {
  if constexpr (SA && SB) INT_MMA_K16("s8", "s8");
  else if constexpr (SA) INT_MMA_K16("s8", "u8");
  else if constexpr (SB) INT_MMA_K16("u8", "s8");
  else INT_MMA_K16("u8", "u8");
}

#undef INT_MMA_K32
#undef INT_MMA_K16

// One warp's FM x FN fragments of 16 x 8 outputs.  BYTES 1: int8 operands,
// one accumulator; BYTES 2: int16 operands as hi/lo byte planes, three
// accumulators (hh, mixed, ll).
//
// Addresses (shared-space bytes, this lane's): a[i] is the row of A
// fragment i that ldmatrix takes from this lane (row 16 i + lane % 16 of
// the warp's rows, byte 16 * (lane / 16)) at the first byte of the step;
// b is B fragment 0's (row lane % 8 + 8 * (lane / 16) of the warp's
// columns, byte 16 * (lane / 8 % 2)), fragment j lying j * b_step bytes
// on.  The lo planes lie a_lo and b_lo bytes after the hi planes (int16).
// The same addresses serve the 16-deep tail (lanes 0-15 carry byte 0).
template <int BYTES, int FM, int FN>
struct Tile {
  static constexpr bool W16 = BYTES == 2;
  static constexpr int NACC = W16 ? 3 : 1;
  int acc[NACC][FM][FN][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int p = 0; p < NACC; ++p)
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[p][i][j][c] = 0;
  }

  __device__ __forceinline__ void k32(const uint32_t (&a)[FM], uint32_t a_lo, uint32_t b,
                                      uint32_t b_step, uint32_t b_lo) {
    uint32_t ah[FM][4], al[FM][4];
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      ldsm_x4(ah[i], a[i]);
      if constexpr (W16) ldsm_x4(al[i], a[i] + a_lo);
    }
#pragma unroll
    for (int j = 0; j < FN; j += 2) {
      // fragments j and j + 1 in one x4 (j alone, x2, at an odd end)
      uint32_t bh[4], bl[4];
      if (j + 1 < FN) {
        ldsm_x4(bh, b + j * b_step);
        if constexpr (W16) ldsm_x4(bl, b + j * b_step + b_lo);
      } else {
        ldsm_x2(bh[0], bh[1], b + j * b_step);
        if constexpr (W16) ldsm_x2(bl[0], bl[1], b + j * b_step + b_lo);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (j + h >= FN) break;
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          if constexpr (W16) {
            mma_k32<true, true>(acc[0][i][j + h], ah[i], bh[2 * h], bh[2 * h + 1]);
            mma_k32<true, false>(acc[1][i][j + h], ah[i], bl[2 * h], bl[2 * h + 1]);
            mma_k32<false, true>(acc[1][i][j + h], al[i], bh[2 * h], bh[2 * h + 1]);
            mma_k32<false, false>(acc[2][i][j + h], al[i], bl[2 * h], bl[2 * h + 1]);
          } else {
            mma_k32<true, true>(acc[0][i][j + h], ah[i], bh[2 * h], bh[2 * h + 1]);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void k16(const uint32_t (&a)[FM], uint32_t a_lo, uint32_t b,
                                      uint32_t b_step, uint32_t b_lo) {
    uint32_t ah[FM][2], al[FM][2];
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      ldsm_x2(ah[i][0], ah[i][1], a[i]);
      if constexpr (W16) ldsm_x2(al[i][0], al[i][1], a[i] + a_lo);
    }
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      uint32_t bh, bl = 0;
      ldsm_x1(bh, b + j * b_step);
      if constexpr (W16) ldsm_x1(bl, b + j * b_step + b_lo);
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        if constexpr (W16) {
          mma_k16<true, true>(acc[0][i][j], ah[i], bh);
          mma_k16<true, false>(acc[1][i][j], ah[i], bl);
          mma_k16<false, true>(acc[1][i][j], al[i], bh);
          mma_k16<false, false>(acc[2][i][j], al[i], bl);
        } else {
          mma_k16<true, true>(acc[0][i][j], ah[i], bh);
        }
      }
    }
  }

  // Output c of fragment (i, j) modulo 2^32: (hh << 16) + (mixed << 8) + ll
  // for int16.  c 0, 1: row g = lane / 4, columns 2 t, 2 t + 1 (t = lane %
  // 4); c 2, 3: row g + 8.
  __device__ __forceinline__ unsigned value(int i, int j, int c) const {
    if constexpr (W16)
      return (static_cast<unsigned>(acc[0][i][j][c]) << 16) +
             (static_cast<unsigned>(acc[1][i][j][c]) << 8) + static_cast<unsigned>(acc[2][i][j][c]);
    else
      return static_cast<unsigned>(acc[0][i][j][c]);
  }

  // Fragment (i, j) as 4 consecutive columns of one row per lane (a swap
  // with the neighbouring lane): even t gets row g, columns 2 t .. 2 t + 3;
  // odd t row g + 8, columns 2 t - 2 .. 2 t + 1.  Every lane of the warp
  // must call it.
  __device__ __forceinline__ uint4 row4(int i, int j, int lane) const {
    const unsigned v0 = value(i, j, 0), v1 = value(i, j, 1), v2 = value(i, j, 2),
                   v3 = value(i, j, 3);
    const bool even = (lane & 1) == 0;
    const unsigned r0 = __shfl_xor_sync(0xffffffffu, even ? v2 : v0, 1);
    const unsigned r1 = __shfl_xor_sync(0xffffffffu, even ? v3 : v1, 1);
    return even ? make_uint4(v0, v1, r0, r1) : make_uint4(r0, r1, v2, v3);
  }
};

// Rows r0..r3 of a 4 x 4 byte block (one 32-bit word each) as its columns:
// c[j] holds byte j of r0, r1, r2, r3 in that order.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// Rows r0..r3 of int16 pairs (one word each: column n in the low half,
// n + 1 in the high half) as byte columns: hi[h] and lo[h] hold the high
// and low bytes of column n + h of r0..r3.
__device__ __forceinline__ void split_cols(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  uint32_t c[4];
  transpose4(r0, r1, r2, r3, c);   // bytes: lo(n), hi(n), lo(n + 1), hi(n + 1)
  lo[0] = c[0];
  hi[0] = c[1];
  lo[1] = c[2];
  hi[1] = c[3];
}

// Four int16 codes (two words, in order) as their hi and lo bytes.
__device__ __forceinline__ void split_row(uint32_t w0, uint32_t w1, uint32_t& hi, uint32_t& lo) {
  lo = __byte_perm(w0, w1, 0x6420);
  hi = __byte_perm(w0, w1, 0x7531);
}

}  // namespace int_mma
