// Device functions of the ML-KEM kernels (mlkem.cu).
//
// Every polynomial is 256 int32 coefficients in [0, q), q = 3329.  K2 and
// K3 run one sponge per thread, 32 rows a warp, seeds staged through
// shared memory (warp_sampler.cuh).  K2 compacts each row in its thread
// into the warp's ring and the warp copies the rings out row by row
// (warp_sampler.cuh: sample_rows over SampleNttCands); K3 writes each
// squeezed block to the warp's staging buffer and the 32 lanes decode one
// row at a time (cbd2_word / cbd3_chunk).  K3's fused NTT and K4 take K7's
// layout (ntt_halfwarp.cuh): a half-warp a polynomial, 16 coefficients a
// lane in registers (kem_ntt_forward, kem_ntt_inverse).
#pragma once

#include <stdint.h>

#include "keccak.cuh"
#include "ntt_halfwarp.cuh"
#include "warp_sampler.cuh"

namespace qrp {

constexpr int kQ = 3329;

// ---------------------------------------------------------------------------
// SampleNTT (K2).  SHAKE-128(rho || j || i), at most 4 squeezed blocks (672
// bytes, 448 12-bit candidates, 112 a block: candidate c is bits [12 c,
// 12 c + 12) of the block).  The candidates < q are kept in order up to
// 256, the rejected ones after them where the 448 give fewer
// (warp_sampler.cuh: sample_rows).  Two blocks hold only 224 candidates,
// so every row squeezes at least three; 336 candidates give 256 accepted
// but for ~0.8% of rows.
// ---------------------------------------------------------------------------

struct SampleNttCands {
  using Value = uint16_t;
  static constexpr int kSlots = 168 * 8 / 12;  // 112 candidates a block
  static constexpr int kBlocks = 4;
  static constexpr int kRate = 168;
  static constexpr int kSeedLen = 34;
  static constexpr uint32_t kBound = kQ;
  // Candidate c of the squeezed block in s (compile-time c: the lane index
  // and shift fold away).
  static __device__ __forceinline__ uint32_t at(const uint64_t s[25], int c) {
    const int w = (12 * c) >> 6, sh = (12 * c) & 63;
    const uint64_t v = sh <= 52 ? s[w] >> sh : (s[w] >> sh) | (s[w + 1] << (64 - sh));
    return (uint32_t)v & 0xFFFu;
  }
};

// ---------------------------------------------------------------------------
// PRF_eta + SamplePolyCBD_eta (K3).  SHAKE-256(s || b) squeezed to 64 eta
// bytes (one 136-byte block for eta = 2, two for eta = 3).  Coefficient i
// is the bit run [2 eta i, 2 eta (i + 1)) of the LSB-first byte stream:
// the first eta bits summed minus the next eta.  The decoders below sum
// the bits of every eta-bit field of a word at once.
// ---------------------------------------------------------------------------

constexpr int kPrfRate = 136;
constexpr int kPrfSeedLen = 33;

// The 6 bytes [6 l, 6 l + 6) of a staged row (32-bit words `row`) as two
// 24-bit chunks: the low 24 bits of *c0 and of *c1.  6 l is 0 or 2 mod 4,
// so the bytes lie in two aligned words.
__device__ __forceinline__ void row_six_bytes(const uint32_t* row, int l, uint32_t* c0,
                                              uint32_t* c1) {
  const uint32_t w0 = row[(6 * l) >> 2], w1 = row[((6 * l) >> 2) + 1];
  const int sh = 8 * ((6 * l) & 3);  // 0 or 16
  const uint32_t x = __funnelshift_r(w0, w1, sh);  // bytes 0..3
  const uint32_t y = (w1 >> sh) & 0xFFFFu;         // bytes 4, 5
  *c0 = x & 0xFFFFFFu;
  *c1 = (x >> 24) | (y << 8);
}

// eta = 2: the 8 coefficients of a 32-bit word (4 bits each), canonical.
__device__ __forceinline__ void cbd2_word(uint32_t w, int32_t c[8]) {
  const uint32_t t = (w & 0x55555555u) + ((w >> 1) & 0x55555555u);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int32_t x = (int32_t)((t >> (4 * k)) & 3), y = (int32_t)((t >> (4 * k + 2)) & 3);
    c[k] = x >= y ? x - y : x - y + kQ;
  }
}

// eta = 3: the 4 coefficients of a 24-bit chunk (6 bits each), canonical.
__device__ __forceinline__ void cbd3_chunk(uint32_t w, int32_t c[4]) {
  const uint32_t t = (w & 0x249249u) + ((w >> 1) & 0x249249u) + ((w >> 2) & 0x249249u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int32_t x = (int32_t)((t >> (6 * k)) & 7), y = (int32_t)((t >> (6 * k + 3)) & 7);
    c[k] = x >= y ? x - y : x - y + kQ;
  }
}

// One coefficient as the fused NTT takes it, x - y + q in [q - eta, q +
// eta], from its bit field: eta = 2 the nibble v, eta = 3 the 6-bit v.
template <int ETA>
__device__ __forceinline__ uint32_t cbd_lazy(uint32_t v) {
  if (ETA == 2) {
    const uint32_t t = (v & 0x5u) + ((v >> 1) & 0x5u);
    return (t & 3) + kQ - ((t >> 2) & 3);
  } else {
    const uint32_t t = (v & 0x9u) + ((v >> 1) & 0x9u) + ((v >> 2) & 0x9u);
    return (t & 7) + kQ - ((t >> 3) & 7);
  }
}

// The words of a staged K3 row: eta 2 the first block's 136 bytes (17
// lanes), eta 3 those and 56 bytes of the second block (24 lanes, padded to
// an odd 25).
template <int ETA>
struct PrfStage {
  static constexpr int kStride = ETA == 2 ? 17 : 25;  // 64-bit lanes a row
  static constexpr int kWords = 2 * kStride;           // 32-bit words a row
};

// ---------------------------------------------------------------------------
// NTT mod q in K7's layout (K3 with the NTT fused, and K4), from
// ntt_halfwarp.cuh: stage A runs the layers of length 128, 64, 32, 16
// (h = 8, 4, 2, 1), stage B those of length 8, 4, 2 (h = 8, 4, 2); the
// forward runs A then B, the inverse B then A.  kem/mlkem_cuda.py builds
// both directions' tables.
//
// Bounds (no value comes near 2^31; tests/test_torch_mlkem_schedule.py
// asserts each).  Forward: inputs below 2q (K3's CBD values x - y + q, or
// K4's canonical ones) stay below (2 + 2k) q after layer k, 16 q = 53,264
// after the seventh; one Shoup reduction by 1 and a conditional subtract
// make them canonical.  Inverse, on canonical inputs: layer k's inputs are
// below 2^(k-1) q, its bias M; stage B's layers (k = 1, 2, 3) leave them
// below 2q, 4q, 8q, stage A's first three (k = 4, 5, 6) below 16q, 32q,
// 64q, and the last (k = 7, M = 64q) multiplies both outputs by 128^-1 =
// 3303 (folded into its zetas) and reduces them.
// ---------------------------------------------------------------------------

constexpr int kKemNttSlotsB = 7;
// floor(2^32 / q): the Shoup companion of 1
constexpr uint32_t kShoupOne = 1290167u;

// c_kem_ntt_uniform[direction][0 | 1][slot]: stage A's zetas and Shoup
// companions floor(w 2^32 / q), the same for every lane (the inverse's
// slot 0 times 128^-1, its slot 15 128^-1 itself); g_kem_ntt_lanes
// [direction][0 | 1][slot][lane]: stage B's, one per lane.  Direction 0 is
// the forward, 1 the inverse.  Loaded by qrp_mlkem_init_ntt.
__constant__ uint32_t c_kem_ntt_uniform[2][2][16];
__device__ uint32_t g_kem_ntt_lanes[2][2][kKemNttSlotsB][16];

// Any 32-bit value -> [0, q).
__device__ __forceinline__ uint32_t kem_reduce(uint32_t x) {
  return mulmod<kQ>(x, 1u, kShoupOne);
}

// Stage A's zetas: constant memory at compile-time slots.
template <bool INVERSE>
struct KemUniformZetas {
  __device__ __forceinline__ uint32_t w(int slot) const {
    return c_kem_ntt_uniform[INVERSE][0][slot];
  }
  __device__ __forceinline__ uint32_t w_shoup(int slot) const {
    return c_kem_ntt_uniform[INVERSE][1][slot];
  }
};

// Stage B's zetas of direction INVERSE for lane t of a half-warp.
template <bool INVERSE>
__device__ __forceinline__ LaneZetas<kKemNttSlotsB> kem_lane_zetas(int t) {
  LaneZetas<kKemNttSlotsB> zb;
  zb.load(&g_kem_ntt_lanes[INVERSE][0][0][0], t);
  return zb;
}

// Forward NTT of the half-warp's polynomial, from stage-A registers (lazy
// values below 2q) to canonical coefficients in stage-A registers.
__device__ __forceinline__ void kem_ntt_forward(uint32_t f[kNttRegs],
                                                const LaneZetas<kKemNttSlotsB>& zb,
                                                uint32_t* buf, int t) {
  ntt_stage_fwd<kQ, 1>(f, KemUniformZetas<false>());
  ntt_a_to_b(f, buf, t);
  ntt_stage_fwd<kQ, 2>(f, zb);
#pragma unroll
  for (int j = 0; j < kNttRegs; ++j) f[j] = kem_reduce(f[j]);
  ntt_b_to_a(f, buf, t);
}

// Inverse NTT scaled by 128^-1, from canonical coefficients in stage-A
// registers to canonical ones in stage-A registers.
__device__ __forceinline__ void kem_ntt_inverse(uint32_t f[kNttRegs],
                                                const LaneZetas<kKemNttSlotsB>& zb,
                                                uint32_t* buf, int t) {
  ntt_a_to_b(f, buf, t);
  ntt_stage_inv<kQ, 2>(f, zb, kQ);
  ntt_b_to_a(f, buf, t);
  ntt_stage_a_inv_scaled<kQ>(f, KemUniformZetas<true>(), 8 * kQ);
}

}  // namespace qrp
