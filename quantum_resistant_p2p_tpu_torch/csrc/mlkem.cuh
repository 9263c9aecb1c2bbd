// Per-polynomial device functions of the ML-KEM kernels (mlkem.cu).
//
// Every polynomial is 256 int32 coefficients in [0, q), q = 3329, so every
// product stays below q^2 < 2^31 and the arithmetic is plain int32.  A
// polynomial being built by one thread lives in a shared-memory tile
// column: coefficient i at col[i * kTileRows] (see mlkem.cu).
#pragma once

#include <stdint.h>

#include "keccak.cuh"

namespace qrp {

constexpr int kQ = 3329;
constexpr int kN = 256;
constexpr int kNInv = 3303;  // 128^-1 mod q

// Polynomials (threads) per block of K2/K3, and the padded tile row.
constexpr int kPolys = 32;
constexpr int kTileRows = kPolys + 1;

// zeta[i] = 17^bitrev7(i) mod q, loaded by qrp_mlkem_init.
__constant__ int32_t c_zetas[128];

// ---------------------------------------------------------------------------
// SampleNTT (K2).  SHAKE-128(rho || j || i), at most 4 squeezed blocks (672
// bytes, 448 12-bit candidates).  Candidates < q are appended in order and
// the thread stops at 256.  When fewer than 256 of the 448 pass, a second
// pass over the same 448 appends the rejected candidates in order, which
// is what the reference's sort key (accepted before rejected, index order
// within each) puts in the tail.
// ---------------------------------------------------------------------------

constexpr int kXofRate = 168;
constexpr int kXofSeedLen = 34;
constexpr int kSqueezeBlocks = 4;

__device__ __forceinline__ void sample_ntt_poly(const uint8_t* __restrict__ seed,
                                                int32_t* col) {
  int cnt = 0;
  for (int pass = 0; pass < 2 && cnt < kN; ++pass) {
    const bool want_accepted = pass == 0;
    uint64_t s[25];
    absorb_short<kXofRate, kXofSeedLen>(s, seed, 0x1F);
    for (int blk = 0; blk < kSqueezeBlocks && cnt < kN; ++blk) {
      if (blk) keccak_f1600(s);
#pragma unroll
      for (int tr = 0; tr < kXofRate / 3; ++tr) {
        const uint32_t b0 = state_byte(s, 3 * tr);
        const uint32_t b1 = state_byte(s, 3 * tr + 1);
        const uint32_t b2 = state_byte(s, 3 * tr + 2);
        const int32_t d1 = (int32_t)(b0 | ((b1 & 0xF) << 8));
        const int32_t d2 = (int32_t)((b1 >> 4) | (b2 << 4));
        if ((d1 < kQ) == want_accepted && cnt < kN) col[kTileRows * cnt++] = d1;
        if ((d2 < kQ) == want_accepted && cnt < kN) col[kTileRows * cnt++] = d2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// PRF_eta + SamplePolyCBD_eta (K3).  SHAKE-256(s || b) squeezed to 64*eta
// bytes (one 136-byte block for eta = 2, two for eta = 3).  Coefficient i
// is the bit run [2*eta*i, 2*eta*(i+1)) of the LSB-first byte stream: the
// first eta bits summed minus the next eta, mod q.
// ---------------------------------------------------------------------------

constexpr int kPrfRate = 136;
constexpr int kPrfSeedLen = 33;

__device__ __forceinline__ int32_t cbd_coeff(uint32_t bits, int eta) {
  int32_t x = 0, y = 0;
#pragma unroll
  for (int k = 0; k < eta; ++k) {
    x += (bits >> k) & 1;
    y += (bits >> (eta + k)) & 1;
  }
  return x >= y ? x - y : x - y + kQ;
}

// Coefficients 4c .. 4c+3 of eta = 3 from the 24-bit chunk w.
__device__ __forceinline__ void cbd3_chunk(int32_t* col, int c, uint32_t w) {
#pragma unroll
  for (int k = 0; k < 4; ++k) col[(4 * c + k) * kTileRows] = cbd_coeff(w >> (6 * k), 3);
}

template <int ETA>
__device__ __forceinline__ void prf_cbd_poly(const uint8_t* __restrict__ seed,
                                             int32_t* col) {
  static_assert(ETA == 2 || ETA == 3, "ML-KEM uses eta 2 and 3");
  uint64_t s[25];
  absorb_short<kPrfRate, kPrfSeedLen>(s, seed, 0x1F);
  if (ETA == 2) {
    // 128 bytes of the first block, two 4-bit coefficients per byte.
#pragma unroll
    for (int p = 0; p < 128; ++p) {
      const uint32_t b = state_byte(s, p);
      col[(2 * p) * kTileRows] = cbd_coeff(b, 2);
      col[(2 * p + 1) * kTileRows] = cbd_coeff(b >> 4, 2);
    }
  } else {
    // 192 bytes as 64 three-byte chunks; chunk 45 spans the block edge.
#pragma unroll
    for (int c = 0; c < 45; ++c) {
      cbd3_chunk(col, c,
                 state_byte(s, 3 * c) | (state_byte(s, 3 * c + 1) << 8) |
                     (state_byte(s, 3 * c + 2) << 16));
    }
    const uint32_t b135 = state_byte(s, 135);
    keccak_f1600(s);
    cbd3_chunk(col, 45, b135 | (state_byte(s, 0) << 8) | (state_byte(s, 1) << 16));
#pragma unroll
    for (int c = 46; c < 64; ++c) {
      const int p = 3 * c - kPrfRate;
      cbd3_chunk(col, c,
                 state_byte(s, p) | (state_byte(s, p + 1) << 8) |
                     (state_byte(s, p + 2) << 16));
    }
  }
}

// ---------------------------------------------------------------------------
// NTT mod q, the layer order of kem/mlkem.py:ntt / ntt_inv.
// ---------------------------------------------------------------------------

// Forward NTT of one polynomial in a tile column, all 7 layers by one
// thread (K3 with the NTT fused).
__device__ __forceinline__ void ntt_column(int32_t* col) {
  for (int len = 128, groups = 1; len >= 2; len >>= 1, groups <<= 1) {
    for (int g = 0; g < groups; ++g) {
      const int32_t z = c_zetas[groups + g];
      const int base = 2 * g * len;
      for (int j = base; j < base + len; ++j) {
        const int32_t a = col[j * kTileRows];
        const int32_t t = (z * col[(j + len) * kTileRows]) % kQ;
        col[j * kTileRows] = (a + t) % kQ;
        col[(j + len) * kTileRows] = (a - t + kQ) % kQ;
      }
    }
  }
}

// Butterfly t (0..127) of the layer with butterfly groups of `len` (K4).
// Forward layers run len = 128 .. 2 with groups = 128 / len; inverse
// layers len = 2 .. 128.
template <bool INVERSE>
__device__ __forceinline__ void ntt_butterfly(int32_t* f, int t, int len) {
  const int groups = 128 / len;
  const int g = t / len, i0 = 2 * g * len + t % len, i1 = i0 + len;
  if (!INVERSE) {
    const int32_t z = c_zetas[groups + g];
    const int32_t a = f[i0];
    const int32_t b = (z * f[i1]) % kQ;
    f[i0] = (a + b) % kQ;
    f[i1] = (a - b + kQ) % kQ;
  } else {
    const int32_t z = c_zetas[2 * groups - 1 - g];
    const int32_t a = f[i0], b = f[i1];
    f[i0] = (a + b) % kQ;
    f[i1] = (z * ((b - a + kQ) % kQ)) % kQ;
  }
}

}  // namespace qrp
