// Per-polynomial device functions of the ML-DSA kernels (mldsa.cu).
//
// q = 8380417 < 2^23, so a coefficient fits 32 bits but a product of two
// does not.  The TPU kernels split one factor into 8-bit limbs (Horner) to
// stay inside int32.  Here every zeta product is Shoup's modular product
// (ntt_halfwarp.cuh): each zeta w comes with w' = floor(w * 2^32 / q), and
// a * w mod q costs one high multiply and two low multiplies, all in 32
// bits, with a result in [0, 2q) for any 32-bit a.  K5 and K6 run on the
// warp sampler that K2 shares (warp_sampler.cuh), each through a traits
// class of its candidates.
#pragma once

#include <stdint.h>

#include "keccak.cuh"
#include "ntt_halfwarp.cuh"
#include "warp_sampler.cuh"

namespace qrp {

constexpr uint32_t kDsaQ = 8380417;

// K7's zeta tables, built by sig/mldsa_cuda.py (its schedule is there) and
// loaded by qrp_mldsa_init.  c_dsa_ntt_uniform[d][0 | 1][slot]: the zetas
// and Shoup companions of stage A of direction d (0 forward, 1 inverse),
// the same for every lane, read at compile-time slots only; the inverse's
// slot 0 carries 256^-1 and slot 15 is 256^-1 itself.
// g_dsa_ntt_lanes[d][0 | 1][slot][lane]: those of stage B, one per lane,
// read once per thread through the read-only cache.
__constant__ uint32_t c_dsa_ntt_uniform[2][2][16];
__device__ uint32_t g_dsa_ntt_lanes[2][2][15][16];

// ---------------------------------------------------------------------------
// RejNTTPoly (K5).  SHAKE-128(rho || s || r) squeezed for at most 7 blocks
// (1176 bytes, 392 candidates b0 | b1 << 8 | (b2 & 0x7F) << 16, 56 per
// block: candidate c is bits [24 c, 24 c + 23) of the block).  Candidates
// < q are appended in order up to 256.  When fewer than 256 of the 392
// pass, a second pass over the same 392 appends the rejected candidates in
// order: the reference sorts on key = reject << 10 | index and keeps the
// candidate values, so its tail holds exactly those, with values >= q
// (warp_sampler.cuh: sample_rows).  Four blocks hold 224 candidates, so
// every row squeezes at least five; 280 give 256 accepted but where more
// than 24 of them are rejected (probability 1.4e-40).
// ---------------------------------------------------------------------------

struct RejNttCands {
  using Value = uint32_t;
  static constexpr int kSlots = 168 / 3;  // 56 candidates a block
  static constexpr int kBlocks = 7;
  static constexpr int kRate = 168;
  static constexpr int kSeedLen = 34;
  static constexpr uint32_t kBound = kDsaQ;
  // Candidate c of the squeezed block in s.  c is a compile-time constant,
  // so the lane index and shift fold away, and the candidates at bit 48
  // and 56 of a lane, which straddle two lanes, are the compile-time cases
  // of the funnel.
  static __device__ __forceinline__ uint32_t at(const uint64_t s[25], int c) {
    const int w = (24 * c) >> 6, sh = (24 * c) & 63;
    const uint64_t v = sh <= 40 ? s[w] >> sh : (s[w] >> sh) | (s[w + 1] << (64 - sh));
    return (uint32_t)v & 0x7FFFFFu;
  }
};

// ---------------------------------------------------------------------------
// RejBoundedPoly (K6).  SHAKE-256(rho' || n) and its first 512 squeezed
// bytes (3 whole blocks and 104 bytes of a fourth): 1024 nibbles, low
// nibble of each byte first, 272 a block (nibble c is bits [4 c, 4 c + 4)
// of the block) and 208 of the fourth.  Nibbles below the bound (15 for
// eta = 2, 9 for eta = 4) are appended raw, in order, up to 256; the eta
// map stays with the caller.  When fewer than 256 of the 1024 pass, a
// second pass appends the rejected nibbles in order, which is what the
// reference's key reject << 16 | index << 4 | nibble puts in the tail
// (warp_sampler.cuh: sample_rows; neither pass reads past nibble 1023).
// Every row squeezes at least one block and two hold 544 nibbles; eta 4
// accepts 9 of 16, so most rows take two, and eta 2 15 of 16, so about
// half take one.  A slot is one byte: the ring is 8,976 B a warp (16-bit
// slots would take 17,952 B and hold an SM to 12 warps).  272 slots hold
// a row's whole run (256, and 16 past it for the clamp of append_block),
// so a pass appends its blocks to one run a row and the warp copies the
// rows out once, a full row in 16-byte stores (warp_sampler.cuh).
// ---------------------------------------------------------------------------

template <int ETA>
struct RejBoundedCands {
  static_assert(ETA == 2 || ETA == 4, "ML-DSA uses eta 2 and 4");
  using Value = uint8_t;
  static constexpr int kSlots = 2 * 136;  // 272 nibbles a block
  static constexpr int kLastSlots = 2 * (512 - 3 * 136);  // 208 of the fourth
  static constexpr int kBlocks = 4;
  static constexpr int kRate = 136;
  static constexpr int kSeedLen = 66;
  static constexpr uint32_t kBound = ETA == 2 ? 15 : 9;
  // Nibble c of the squeezed block in s: c is a compile-time constant, so
  // the lane index and shift fold away.
  static __device__ __forceinline__ uint32_t at(const uint64_t s[25], int c) {
    return (uint32_t)(s[c >> 4] >> (4 * (c & 15))) & 0xFu;
  }
};

// ---------------------------------------------------------------------------
// NTT mod q (K7), the layer order of sig/mldsa.py:ntt / ntt_inv, on
// ntt_halfwarp.cuh: stage A runs the layers of length 128..16, stage B
// those of length 8..1 (h = 8, 4, 2, 1 in each); the forward runs A then
// B, the inverse B then A.
//
// Forward: starting in [0, q), values stay below (1 + 2k) q < 2^28 after
// layer k, and one reduction at the end makes them canonical.  Inverse:
// layer k's inputs are below M = 2^(k-1) q, sums stay below 2^k q <= 256 q
// < 2^31, and the last layer multiplies both outputs by 256^-1 (folded
// into its zeta) and reduces them.
// ---------------------------------------------------------------------------

// Stage A's zetas: constant memory at compile-time slots.
template <bool INVERSE>
struct UniformZetas {
  __device__ __forceinline__ uint32_t w(int slot) const {
    return c_dsa_ntt_uniform[INVERSE][0][slot];
  }
  __device__ __forceinline__ uint32_t w_shoup(int slot) const {
    return c_dsa_ntt_uniform[INVERSE][1][slot];
  }
};

// Stage B's zetas of direction INVERSE for lane t of a half-warp.
template <bool INVERSE>
__device__ __forceinline__ LaneZetas<15> dsa_lane_zetas(int t) {
  LaneZetas<15> zb;
  zb.load(&g_dsa_ntt_lanes[INVERSE][0][0][0], t);
  return zb;
}

// [0, 17q) -> [0, q): x >> 23 is floor(x / q) or one less below 2^28.
__device__ __forceinline__ uint32_t reduce_dsa(uint32_t x) {
  const uint32_t r = x - (x >> 23) * kDsaQ;
  return min(r, r - kDsaQ);
}

}  // namespace qrp
