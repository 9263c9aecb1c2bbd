// Per-polynomial device functions of the ML-DSA kernels (mldsa.cu).
//
// q = 8380417 < 2^23, so a coefficient fits 32 bits but a product of two
// does not.  The TPU kernels split one factor into 8-bit limbs (Horner) to
// stay inside int32.  Here every zeta product is Shoup's modular product:
// each zeta w comes with w' = floor(w * 2^32 / q), and a * w mod q costs
// one high multiply, two low multiplies and one conditional subtraction,
// all in 32 bits, with the canonical result in [0, q).  A polynomial being
// built by one sampler thread lives in a shared-memory tile column:
// coefficient i at col[i * kTileRows] (see tile.cuh).
#pragma once

#include <stdint.h>

#include "keccak.cuh"
#include "tile.cuh"

namespace qrp {

constexpr uint32_t kDsaQ = 8380417;
constexpr uint32_t kDsaNInv = 8347681;           // 256^-1 mod q
constexpr uint32_t kDsaNInvShoup = 4278190082u;  // floor(kDsaNInv * 2^32 / q)

// zeta[i] = 1753^bitrev8(i) mod q and floor(zeta[i] * 2^32 / q), loaded by
// qrp_mldsa_init.
__constant__ uint32_t c_dsa_zetas[256];
__constant__ uint32_t c_dsa_zetas_shoup[256];

// (a * w) mod q for w in [0, q), any 32-bit a, and w_shoup as above: the
// quotient estimate hi is floor(a*w/q) or one less, so a*w - hi*q lies in
// [0, 2q) and is exact modulo 2^32; min(r, r - q) (unsigned) subtracts q
// once where r >= q.
__device__ __forceinline__ uint32_t mulmod_shoup(uint32_t a, uint32_t w,
                                                 uint32_t w_shoup) {
  const uint32_t hi = __umulhi(a, w_shoup);
  const uint32_t r = a * w - hi * kDsaQ;
  return min(r, r - kDsaQ);
}

// (a + b) mod q and (a - b) mod q for a, b in [0, q).
__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return min(s, s - kDsaQ);
}

__device__ __forceinline__ uint32_t submod(uint32_t a, uint32_t b) {
  const uint32_t d = a - b + kDsaQ;
  return min(d, d - kDsaQ);
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
// NTT mod q (K7), the layer order of sig/mldsa.py:ntt / ntt_inv: 8 layers
// of 128 butterflies.  Butterfly t (0..127) of the layer whose groups are
// `len` long; forward layers run len = 128 .. 1 with zeta index
// 128 / len + group, inverse layers len = 1 .. 128 with 2 * 128 / len - 1
// - group.
// ---------------------------------------------------------------------------

template <bool INVERSE>
__device__ __forceinline__ void dsa_ntt_butterfly(uint32_t* f, int t, int len) {
  const int groups = 128 / len;
  const int g = t / len, i0 = 2 * g * len + t % len, i1 = i0 + len;
  if (!INVERSE) {
    const int k = groups + g;
    const uint32_t a = f[i0];
    const uint32_t b = mulmod_shoup(f[i1], c_dsa_zetas[k], c_dsa_zetas_shoup[k]);
    f[i0] = addmod(a, b);
    f[i1] = submod(a, b);
  } else {
    const int k = 2 * groups - 1 - g;
    const uint32_t a = f[i0], b = f[i1];
    f[i0] = addmod(a, b);
    f[i1] = mulmod_shoup(submod(b, a), c_dsa_zetas[k], c_dsa_zetas_shoup[k]);
  }
}

}  // namespace qrp
