// Keccak-f[1600] and sponge helpers shared by the port's CUDA kernels.
//
// One sponge per thread: the 25 lanes are native uint64_t values held in
// registers.  Every index into the state array below is a compile-time
// constant (fully unrolled loops, templated rates), so the array never
// leaves the register file; `nvcc -Xptxas -v` reports the frame size.
//
// This replaces the shared in-kernel pieces of the Pallas sponge
// (core/keccak_pallas.py: _f1600, absorb_block, block_bytes), which held
// each lane as a pair of uint32 words spread over (8, 128) TPU tiles.
#pragma once

#include <stdint.h>

namespace qrp {

__device__ __constant__ uint64_t kKeccakRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));
}

// Keccak-f[1600] in place; lane index l = x + 5*y.
__device__ __forceinline__ void keccak_f1600(uint64_t s[25]) {
#pragma unroll 1
  for (int r = 0; r < 24; ++r) {
    // theta
    const uint64_t c0 = s[0] ^ s[5] ^ s[10] ^ s[15] ^ s[20];
    const uint64_t c1 = s[1] ^ s[6] ^ s[11] ^ s[16] ^ s[21];
    const uint64_t c2 = s[2] ^ s[7] ^ s[12] ^ s[17] ^ s[22];
    const uint64_t c3 = s[3] ^ s[8] ^ s[13] ^ s[18] ^ s[23];
    const uint64_t c4 = s[4] ^ s[9] ^ s[14] ^ s[19] ^ s[24];
    const uint64_t d0 = c4 ^ rotl64(c1, 1);
    const uint64_t d1 = c0 ^ rotl64(c2, 1);
    const uint64_t d2 = c1 ^ rotl64(c3, 1);
    const uint64_t d3 = c2 ^ rotl64(c4, 1);
    const uint64_t d4 = c3 ^ rotl64(c0, 1);
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
      s[y + 0] ^= d0;
      s[y + 1] ^= d1;
      s[y + 2] ^= d2;
      s[y + 3] ^= d3;
      s[y + 4] ^= d4;
    }
    // rho + pi: b[dst] = rotl(s[src], RHO[src]), dst = y + 5*((2x + 3y) % 5)
    uint64_t b[25];
    b[0] = s[0];
    b[1] = rotl64(s[6], 44);
    b[2] = rotl64(s[12], 43);
    b[3] = rotl64(s[18], 21);
    b[4] = rotl64(s[24], 14);
    b[5] = rotl64(s[3], 28);
    b[6] = rotl64(s[9], 20);
    b[7] = rotl64(s[10], 3);
    b[8] = rotl64(s[16], 45);
    b[9] = rotl64(s[22], 61);
    b[10] = rotl64(s[1], 1);
    b[11] = rotl64(s[7], 6);
    b[12] = rotl64(s[13], 25);
    b[13] = rotl64(s[19], 8);
    b[14] = rotl64(s[20], 18);
    b[15] = rotl64(s[4], 27);
    b[16] = rotl64(s[5], 36);
    b[17] = rotl64(s[11], 10);
    b[18] = rotl64(s[17], 15);
    b[19] = rotl64(s[23], 56);
    b[20] = rotl64(s[2], 62);
    b[21] = rotl64(s[8], 55);
    b[22] = rotl64(s[14], 39);
    b[23] = rotl64(s[15], 41);
    b[24] = rotl64(s[21], 2);
    // chi
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; ++x) {
        s[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
      }
    }
    // iota
    s[0] ^= kKeccakRC[r];
  }
}

// Lane `base / 8` of the padded message: bytes of `msg` below `len`, the
// domain byte at `len`, 0x80 in the last byte of the last block.
__device__ __forceinline__ uint64_t padded_lane(const uint8_t* __restrict__ msg,
                                                int len, int base, uint8_t ds,
                                                int padded_len) {
  uint64_t lane = 0;
  if (base + 8 <= len) {
#pragma unroll
    for (int j = 0; j < 8; ++j) lane |= (uint64_t)__ldg(msg + base + j) << (8 * j);
    return lane;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int idx = base + j;
    uint64_t byte = idx < len ? (uint64_t)__ldg(msg + idx) : 0;
    if (idx == len) byte ^= ds;
    if (idx == padded_len - 1) byte ^= 0x80;
    lane |= byte << (8 * j);
  }
  return lane;
}

// Zero the state, absorb a message of LEN < RATE bytes (one padded block)
// and permute: the seed absorb of every XOF/PRF call in ML-KEM.
template <int RATE, int LEN>
__device__ __forceinline__ void absorb_short(uint64_t s[25],
                                             const uint8_t* __restrict__ msg,
                                             uint8_t ds) {
  static_assert(LEN < RATE, "one-block absorb only");
#pragma unroll
  for (int i = 0; i < 25; ++i) s[i] = 0;
#pragma unroll
  for (int w = 0; w < RATE / 8; ++w) s[w] = padded_lane(msg, LEN, 8 * w, ds, RATE);
  keccak_f1600(s);
}

// One whole sponge: absorb in_len bytes of msg at RATE bytes per block
// (domain byte ds, pad10*1), squeeze out_len bytes into dst.  No limit on
// either length.
template <int RATE>
__device__ __forceinline__ void sponge(const uint8_t* __restrict__ msg, int in_len,
                                       uint8_t ds, uint8_t* __restrict__ dst,
                                       int out_len) {
  uint64_t s[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) s[i] = 0;
  const int n_abs = in_len / RATE + 1;
  const int padded_len = n_abs * RATE;
  for (int blk = 0; blk < n_abs; ++blk) {
#pragma unroll
    for (int w = 0; w < RATE / 8; ++w) {
      s[w] ^= padded_lane(msg, in_len, blk * RATE + 8 * w, ds, padded_len);
    }
    keccak_f1600(s);
  }
  for (int off = 0; off < out_len; off += RATE) {
    if (off) keccak_f1600(s);
#pragma unroll
    for (int w = 0; w < RATE / 8; ++w) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int idx = off + 8 * w + j;
        if (idx < out_len) dst[idx] = (uint8_t)(s[w] >> (8 * j));
      }
    }
  }
}

// Byte p of the rate part of the state (little-endian lanes).  Callers pass
// p from fully unrolled loops, so the lane index folds to a register.
__device__ __forceinline__ uint32_t state_byte(const uint64_t s[25], int p) {
  return (uint32_t)(s[p >> 3] >> (8 * (p & 7))) & 0xFFu;
}

}  // namespace qrp
