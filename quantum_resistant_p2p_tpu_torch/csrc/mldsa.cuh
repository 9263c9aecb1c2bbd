// Per-polynomial device functions of the ML-DSA kernels (mldsa.cu).
//
// q = 8380417 < 2^23, so a coefficient fits 32 bits but a product of two
// does not.  The TPU kernels split one factor into 8-bit limbs (Horner) to
// stay inside int32.  Here every zeta product is Shoup's modular product:
// each zeta w comes with w' = floor(w * 2^32 / q), and a * w mod q costs
// one high multiply and two low multiplies, all in 32 bits, with a result
// in [0, 2q) for any 32-bit a.  A polynomial being built by one sampler
// thread lives in a shared-memory tile column: coefficient i at
// col[i * kTileRows] (see tile.cuh).
#pragma once

#include <stdint.h>

#include "keccak.cuh"
#include "tile.cuh"

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

// a * w mod q up to one q: a * w - hi * q lies in [0, 2q) for any 32-bit a,
// w in [0, q) and w_shoup as above (hi is floor(a*w/q) or one less), and is
// exact modulo 2^32.
__device__ __forceinline__ uint32_t mulmod_shoup_lazy(uint32_t a, uint32_t w,
                                                      uint32_t w_shoup) {
  return a * w - __umulhi(a, w_shoup) * kDsaQ;
}

// The same, canonical in [0, q): min(r, r - q) (unsigned) subtracts q
// once where r >= q.
__device__ __forceinline__ uint32_t mulmod_shoup(uint32_t a, uint32_t w, uint32_t w_shoup) {
  const uint32_t r = mulmod_shoup_lazy(a, w, w_shoup);
  return min(r, r - kDsaQ);
}

// ---------------------------------------------------------------------------
// RejNTTPoly (K5).  SHAKE-128(rho || s || r) squeezed for at most 7 blocks
// (1176 bytes, 392 candidates b0 | b1 << 8 | (b2 & 0x7F) << 16, 56 per
// block).  Candidates < q are appended in order and the thread stops at
// 256.  When fewer than 256 of the 392 pass, a second pass over the same
// 392 appends the rejected candidates in order: the reference sorts on
// key = reject << 10 | index and keeps the candidate values, so its tail
// holds exactly those, with values >= q.
// ---------------------------------------------------------------------------

constexpr int kRejNttRate = 168;
constexpr int kRejNttSeedLen = 34;
constexpr int kRejNttBlocks = 7;

__device__ __forceinline__ void rej_ntt_poly(const uint8_t* __restrict__ seed,
                                             int32_t* col) {
  int cnt = 0;
  for (int pass = 0; pass < 2 && cnt < kN; ++pass) {
    const bool want_accepted = pass == 0;
    uint64_t s[25];
    absorb_short<kRejNttRate, kRejNttSeedLen>(s, seed, 0x1F);
    for (int blk = 0; blk < kRejNttBlocks && cnt < kN; ++blk) {
      if (blk) keccak_f1600(s);
#pragma unroll
      for (int tr = 0; tr < kRejNttRate / 3; ++tr) {
        const uint32_t c = state_byte(s, 3 * tr) | (state_byte(s, 3 * tr + 1) << 8) |
                           ((state_byte(s, 3 * tr + 2) & 0x7F) << 16);
        if ((c < kDsaQ) == want_accepted && cnt < kN) col[kTileRows * cnt++] = (int32_t)c;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// RejBoundedPoly (K6).  SHAKE-256(rho' || n) and its first 512 squeezed
// bytes (3 whole blocks and 104 bytes of a fourth): 1024 nibbles, low
// nibble of each byte first.  Nibbles below the bound (15 for eta = 2, 9
// for eta = 4) are appended raw, in order, up to 256; the eta map stays
// with the caller.  When fewer than 256 of the 1024 pass, a second pass
// appends the rejected nibbles in order, which is what the reference's
// key reject << 16 | index << 4 | nibble puts in the tail.
// ---------------------------------------------------------------------------

constexpr int kRejBoundedRate = 136;
constexpr int kRejBoundedSeedLen = 66;
constexpr int kRejBoundedBytes = 512;

template <int ETA>
__device__ __forceinline__ void rej_bounded_poly(const uint8_t* __restrict__ seed,
                                                 int32_t* col) {
  static_assert(ETA == 2 || ETA == 4, "ML-DSA uses eta 2 and 4");
  constexpr uint32_t kBound = ETA == 2 ? 15 : 9;
  int cnt = 0;
  for (int pass = 0; pass < 2 && cnt < kN; ++pass) {
    const bool want_accepted = pass == 0;
    uint64_t s[25];
    absorb_short<kRejBoundedRate, kRejBoundedSeedLen>(s, seed, 0x1F);
    for (int blk = 0; blk * kRejBoundedRate < kRejBoundedBytes && cnt < kN; ++blk) {
      if (blk) keccak_f1600(s);
      const int n_bytes = min(kRejBoundedRate, kRejBoundedBytes - blk * kRejBoundedRate);
#pragma unroll
      for (int p = 0; p < kRejBoundedRate; ++p) {
        if (p < n_bytes) {
          const uint32_t b = state_byte(s, p);
          const uint32_t z0 = b & 0xF, z1 = b >> 4;
          if ((z0 < kBound) == want_accepted && cnt < kN) col[kTileRows * cnt++] = (int32_t)z0;
          if ((z1 < kBound) == want_accepted && cnt < kN) col[kTileRows * cnt++] = (int32_t)z1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// NTT mod q (K7), the layer order of sig/mldsa.py:ntt / ntt_inv.  A
// half-warp holds one polynomial, 16 coefficients a lane in registers f[j]:
// in stage A lane t holds coefficient t + 16 j, in stage B 16 t + j.  A
// stage runs four layers; in each, registers j and j + h are a butterfly
// pair (h = 8, 4, 2, 1 for layer length 16 h in stage A and h in stage B),
// and the pair's zeta sits at slot 8 / h - 1 + j / (2 h) of the stage's
// table.  The forward runs A then B, the inverse B then A.
//
// Butterflies are lazy.  Forward (Cooley-Tukey): t = w * b up to one q,
// a' = a + t, b' = a + 2q - t; starting in [0, q), values stay below
// (1 + 2k) q < 2^28 after layer k, and one reduction at the end makes them
// canonical.  Inverse (Gentleman-Sande): a' = a + b, b' = w (b - a + M)
// up to one q, where M = 2^(k-1) q bounds the inputs of layer k; sums stay
// below 2^k q <= 256 q < 2^31, and the last layer multiplies both outputs
// by 256^-1 (folded into its zeta) and reduces them.
// ---------------------------------------------------------------------------

constexpr int kNttRegs = 16;

template <int H, bool INVERSE, class Zeta>
__device__ __forceinline__ void ntt_layer(uint32_t f[kNttRegs], const Zeta& zeta,
                                          uint32_t bias) {
#pragma unroll
  for (int j = 0; j < kNttRegs; ++j) {
    if (j & H) continue;
    const int slot = 8 / H - 1 + j / (2 * H);
    const uint32_t w = zeta.w(slot), w_shoup = zeta.w_shoup(slot);
    if (!INVERSE) {
      const uint32_t t = mulmod_shoup_lazy(f[j + H], w, w_shoup);
      f[j + H] = f[j] + 2 * kDsaQ - t;
      f[j] += t;
    } else {
      const uint32_t a = f[j], b = f[j + H];
      f[j] = a + b;
      f[j + H] = mulmod_shoup_lazy(b + bias - a, w, w_shoup);
    }
  }
}

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

// Stage B's zetas: this lane's, in registers.
struct LaneZetas {
  uint32_t z[15], z_shoup[15];
  template <bool INVERSE>
  __device__ __forceinline__ void load(int lane) {
#pragma unroll
    for (int s = 0; s < 15; ++s) {
      z[s] = __ldg(&g_dsa_ntt_lanes[INVERSE][0][s][lane]);
      z_shoup[s] = __ldg(&g_dsa_ntt_lanes[INVERSE][1][s][lane]);
    }
  }
  __device__ __forceinline__ uint32_t w(int slot) const { return z[slot]; }
  __device__ __forceinline__ uint32_t w_shoup(int slot) const { return z_shoup[slot]; }
};

// Forward stage (A or B): layers h = 8, 4, 2, 1.
template <class Zeta>
__device__ __forceinline__ void ntt_stage_fwd(uint32_t f[kNttRegs], const Zeta& zeta) {
  ntt_layer<8, false>(f, zeta, 0);
  ntt_layer<4, false>(f, zeta, 0);
  ntt_layer<2, false>(f, zeta, 0);
  ntt_layer<1, false>(f, zeta, 0);
}

// Inverse stage: layers h = 1, 2, 4, 8, whose inputs are bounded by
// `bound` = 2^(k-1) q at the stage's first layer k.
template <class Zeta>
__device__ __forceinline__ void ntt_stage_inv(uint32_t f[kNttRegs], const Zeta& zeta,
                                              uint32_t bound) {
  ntt_layer<1, true>(f, zeta, bound);
  ntt_layer<2, true>(f, zeta, 2 * bound);
  ntt_layer<4, true>(f, zeta, 4 * bound);
  ntt_layer<8, true>(f, zeta, 8 * bound);
}

// The inverse's stage A: its first three layers, then the last (length
// 128) with 256^-1 folded in, whose outputs are canonical.
__device__ __forceinline__ void ntt_stage_a_inv_scaled(uint32_t f[kNttRegs]) {
  const UniformZetas<true> zeta;
  ntt_layer<1, true>(f, zeta, 16 * kDsaQ);
  ntt_layer<2, true>(f, zeta, 32 * kDsaQ);
  ntt_layer<4, true>(f, zeta, 64 * kDsaQ);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t a = f[j], b = f[j + 8];
    f[j] = mulmod_shoup(a + b, zeta.w(15), zeta.w_shoup(15));
    f[j + 8] = mulmod_shoup(b + 128 * kDsaQ - a, zeta.w(0), zeta.w_shoup(0));
  }
}

// [0, 17q) -> [0, q): x >> 23 is floor(x / q) or one less below 2^28.
__device__ __forceinline__ uint32_t reduce_dsa(uint32_t x) {
  const uint32_t r = x - (x >> 23) * kDsaQ;
  return min(r, r - kDsaQ);
}

// A half-warp's transposes through its shared buffer.  Coefficient i sits
// at word i + 4 (i / 16): lane t's stage-A words t + 20 j are 16
// consecutive banks for each j (the other half-warp's buffer starts 16
// banks on), and its stage-B words 20 t + 4 m are four 16-byte vectors
// that eight lanes read or write on disjoint banks.
__device__ __forceinline__ void ntt_a_to_b(uint32_t f[kNttRegs], uint32_t* buf, int t) {
#pragma unroll
  for (int j = 0; j < kNttRegs; ++j) buf[t + 20 * j] = f[j];
  __syncwarp();
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const uint4 v = *reinterpret_cast<const uint4*>(buf + 20 * t + 4 * m);
    f[4 * m] = v.x, f[4 * m + 1] = v.y, f[4 * m + 2] = v.z, f[4 * m + 3] = v.w;
  }
}

__device__ __forceinline__ void ntt_b_to_a(uint32_t f[kNttRegs], uint32_t* buf, int t) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    *reinterpret_cast<uint4*>(buf + 20 * t + 4 * m) =
        make_uint4(f[4 * m], f[4 * m + 1], f[4 * m + 2], f[4 * m + 3]);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kNttRegs; ++j) f[j] = buf[t + 20 * j];
}

}  // namespace qrp
