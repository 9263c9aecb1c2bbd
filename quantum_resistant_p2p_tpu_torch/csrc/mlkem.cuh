// Device functions of the ML-KEM kernels (mlkem.cu).
//
// Every polynomial is 256 int32 coefficients in [0, q), q = 3329.  K2 and
// K3 run one sponge per thread, 32 rows a warp, seeds staged through
// shared memory (stage_seeds, absorb_staged).  K2 compacts each row in its
// thread into a small ring and the warp copies the rings out row by row
// (append_block, flush_ring); K3 writes each squeezed block to the warp's
// staging buffer and the 32 lanes decode one row at a time (cbd2_word /
// cbd3_chunk).  K3's fused NTT takes K7's layout (mldsa.cuh): a half-warp
// a polynomial, 16 coefficients a lane in registers (kem_ntt_*).
#pragma once

#include <stdint.h>

#include "keccak.cuh"
#include "tile.cuh"  // kN

namespace qrp {

constexpr int kQ = 3329;
constexpr int kNInv = 3303;  // 128^-1 mod q
constexpr unsigned kFullMask = 0xffffffffu;

// zeta[i] = 17^bitrev7(i) mod q, loaded by qrp_mlkem_init (K4).
__constant__ int32_t c_zetas[128];

// ---------------------------------------------------------------------------
// Seeds in: a warp's rows staged through shared memory
// ---------------------------------------------------------------------------

// Copy the bytes of a warp's n_rows seed rows of LEN bytes (contiguous from
// `rows`, at any byte alignment) into sw, as the aligned 32-bit words that
// hold them: consecutive lanes load consecutive words, and no word holds
// none of the rows' bytes.  Row r's byte j then sits at byte
// (rows & 3) + r * LEN + j of sw.
template <int LEN>
__device__ __forceinline__ void stage_seeds(const uint8_t* __restrict__ rows, int n_rows,
                                            uint32_t* sw, int lane) {
  const uintptr_t begin = reinterpret_cast<uintptr_t>(rows);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(begin & ~uintptr_t(3));
  const int words = ((int)(begin & 3) + n_rows * LEN + 3) >> 2;
  for (int i = lane; i < words; i += 32) sw[i] = __ldg(w + i);
  __syncwarp();
}

// Zero the state, absorb this lane's staged seed of LEN bytes (32 < LEN <
// 40, one padded block of RATE bytes) and permute.  Reads 10 words from
// word (skew + lane * LEN) / 4 of sw on.
template <int RATE, int LEN>
__device__ __forceinline__ void absorb_staged(uint64_t s[25], const uint32_t* sw, int skew,
                                              int lane, uint8_t ds) {
  static_assert(32 < LEN && LEN < 40 && LEN < RATE, "a 33..39-byte seed in one block");
  const int o = skew + lane * LEN;
  const uint32_t* p = sw + (o >> 2);
  const int sh = 8 * (o & 3);
  uint32_t w[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) w[k] = p[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = (uint64_t)__funnelshift_r(w[2 * k], w[2 * k + 1], sh) |
           ((uint64_t)__funnelshift_r(w[2 * k + 1], w[2 * k + 2], sh) << 32);
  }
  const uint32_t tail = __funnelshift_r(w[8], w[9], sh) & ((1u << (8 * (LEN - 32))) - 1);
  s[4] = tail | ((uint64_t)ds << (8 * (LEN - 32)));
#pragma unroll
  for (int k = 5; k < 25; ++k) s[k] = 0;
  s[RATE / 8 - 1] ^= 0x80ull << 56;
  keccak_f1600(s);
}

// ---------------------------------------------------------------------------
// SampleNTT (K2).  SHAKE-128(rho || j || i), at most 4 squeezed blocks (672
// bytes, 448 12-bit candidates, 112 a block: candidate c is bits [12 c,
// 12 c + 12) of the block).  The candidates < q are kept in order up to
// 256; where fewer than 256 of the 448 pass, the rejected ones follow in
// order (a second pass), which is what the reference's sort key (accepted
// before rejected, index order within each) puts in the tail.  Two blocks
// hold only 224 candidates, so every row squeezes at least three; 336
// candidates give 256 accepted but for ~0.8% of rows.
//
// A thread compacts its own row's block into its column of the warp's
// ring (append_block), and the warp then copies each row's new run to the
// output row, coalesced (flush_ring).
// ---------------------------------------------------------------------------

constexpr int kXofRate = 168;
constexpr int kXofSeedLen = 34;
constexpr int kSqueezeBlocks = 4;
constexpr int kRingSlots = kXofRate * 8 / 12;  // 112 candidates a block
constexpr int kRingStride = 33;                // uint16 slots a ring row (slot i of lane l at 33 i + l)

// Candidate c of the squeezed block in s (compile-time c: the lane index
// and shift fold away).
__device__ __forceinline__ uint32_t block_candidate(const uint64_t s[25], int c) {
  const int w = (12 * c) >> 6, sh = (12 * c) & 63;
  const uint64_t v = sh <= 52 ? s[w] >> sh : (s[w] >> sh) | (s[w + 1] << (64 - sh));
  return (uint32_t)v & 0xFFFu;
}

// Append the block's wanted candidates (accepted: < q; in the second pass
// rejected) to ring column `lane` in order: each candidate is stored at the
// column's next slot, which moves on (by a predicated add to a byte offset:
// five instructions a candidate) only past a wanted one, so no branch and no
// slot past 111.  Returns how many were wanted.
template <bool WANT_ACCEPTED>
__device__ __forceinline__ int append_block(const uint64_t s[25], uint16_t* ring, int lane) {
  char* base = reinterpret_cast<char*>(ring);
  int off = 2 * lane;
#pragma unroll
  for (int c = 0; c < kRingSlots; ++c) {
    const uint32_t d = block_candidate(s, c);
    *reinterpret_cast<uint16_t*>(base + off) = (uint16_t)d;
    if ((d < (uint32_t)kQ) == WANT_ACCEPTED) off += 2 * kRingStride;
  }
  return (off - 2 * lane) / (2 * kRingStride);
}

// Copy each row of `rows` from the ring to its output row: lane r appended
// k (its row's run) after cnt coefficients, of which the first 256 - cnt
// are kept.  Two rows a step, a half-warp each: lane t copies slots t + 16 j
// (j < 7) of its half's row, consecutive lanes to consecutive addresses;
// a slot past the run is clamped to the run's last, so every store is
// unconditional (it writes the value that slot's own lane writes) and no
// predicate splits the addressing.  Slot i of row r is word (33 i + r) / 2:
// 16 distinct banks a half-warp.
__device__ __forceinline__ void flush_ring(const uint16_t* ring, unsigned rows, int k, int cnt,
                                           int lane, int32_t* __restrict__ dst) {
  static_assert(kRingSlots <= 7 * 16, "seven slots a lane");
  const int t = lane & 15, half = lane >> 4;
  while (rows) {
    const int r0 = __ffs(rows) - 1;
    rows &= rows - 1;
    const int r1 = rows ? __ffs(rows) - 1 : -1;
    rows &= rows - 1;
    const int r = half ? r1 : r0;
    const int at = __shfl_sync(kFullMask, cnt, r & 31);  // every lane takes part
    const int run = __shfl_sync(kFullMask, k, r & 31);
    const int m = r < 0 ? 0 : min(run, kN - at);
    if (m > 0) {
      int32_t* d = dst + r * kN + at;
      const uint16_t* src = ring + r;
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        const int i = min(t + 16 * j, m - 1);
        d[i] = src[i * kRingStride];
      }
    }
  }
}

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
// NTT mod q in K7's layout (K3 with the NTT fused).  A half-warp holds one
// polynomial, 16 coefficients a lane in registers f[j]: in stage A lane t
// holds coefficient t + 16 j, in stage B 16 t + j.  Stage A runs the layers
// of length 128, 64, 32, 16 (registers j and j + h paired, h = 8, 4, 2, 1),
// stage B those of length 8, 4, 2 (h = 8, 4, 2); the pair's zeta sits at
// slot 8 / h - 1 + j / (2 h) of the stage's table (kem/mlkem_cuda.py builds
// both).  Butterflies are lazy Cooley-Tukey: t = w * b up to one q (Shoup),
// a' = a + t, b' = a + 2q - t.  The inputs are CBD values x - y + q < 2q,
// so after layer k every value is below (2 + 2k) q, 16 q = 53,264 < 2^16
// after the seventh; one Shoup reduction by 1 and a conditional subtract
// make them canonical.  No intermediate comes near 2^31.
// ---------------------------------------------------------------------------

constexpr int kKemNttRegs = 16;
constexpr int kKemNttSlotsB = 7;
// floor(2^32 / q): the Shoup companion of 1
constexpr uint32_t kShoupOne = 1290167u;

// c_kem_ntt_uniform[0 | 1][slot]: stage A's zetas and Shoup companions
// floor(w 2^32 / q), the same for every lane; g_kem_ntt_lanes[0 | 1][slot]
// [lane]: stage B's, one per lane.  Loaded by qrp_mlkem_init_ntt.
__constant__ uint32_t c_kem_ntt_uniform[2][16];
__device__ uint32_t g_kem_ntt_lanes[2][kKemNttSlotsB][16];

// a * w mod q up to one q: a * w - hi * q in [0, 2q) for any 32-bit a,
// exact modulo 2^32 (hi is floor(a w / q) or one less).
__device__ __forceinline__ uint32_t kem_mulmod_lazy(uint32_t a, uint32_t w, uint32_t w_shoup) {
  return a * w - __umulhi(a, w_shoup) * (uint32_t)kQ;
}

// Any 32-bit value -> [0, q).
__device__ __forceinline__ uint32_t kem_reduce(uint32_t x) {
  const uint32_t r = kem_mulmod_lazy(x, 1u, kShoupOne);
  return min(r, r - (uint32_t)kQ);
}

template <int H, class Zeta>
__device__ __forceinline__ void kem_ntt_layer(uint32_t f[kKemNttRegs], const Zeta& zeta) {
#pragma unroll
  for (int j = 0; j < kKemNttRegs; ++j) {
    if (j & H) continue;
    const int slot = 8 / H - 1 + j / (2 * H);
    const uint32_t t = kem_mulmod_lazy(f[j + H], zeta.w(slot), zeta.w_shoup(slot));
    f[j + H] = f[j] + 2 * (uint32_t)kQ - t;
    f[j] += t;
  }
}

struct KemUniformZetas {
  __device__ __forceinline__ uint32_t w(int slot) const { return c_kem_ntt_uniform[0][slot]; }
  __device__ __forceinline__ uint32_t w_shoup(int slot) const {
    return c_kem_ntt_uniform[1][slot];
  }
};

// Stage B's zetas: this lane's, loaded once into registers.
struct KemLaneZetas {
  uint32_t z[kKemNttSlotsB], z_shoup[kKemNttSlotsB];
  __device__ __forceinline__ void load(int lane) {
#pragma unroll
    for (int s = 0; s < kKemNttSlotsB; ++s) {
      z[s] = __ldg(&g_kem_ntt_lanes[0][s][lane]);
      z_shoup[s] = __ldg(&g_kem_ntt_lanes[1][s][lane]);
    }
  }
  __device__ __forceinline__ uint32_t w(int slot) const { return z[slot]; }
  __device__ __forceinline__ uint32_t w_shoup(int slot) const { return z_shoup[slot]; }
};

// The transposes of a half-warp's polynomial through its shared buffer, as
// K7's (mldsa.cuh): coefficient i at word i + 4 (i / 16), so lane t's
// stage-A words t + 20 j are 16 consecutive banks for each j (the other
// half-warp's buffer starts 336 words, 16 banks, on) and its stage-B words
// 20 t + 4 m four 16-byte vectors on disjoint banks.
constexpr int kKemNttHalfWords = 336;
constexpr int kKemNttWarpWords = 2 * kKemNttHalfWords;

__device__ __forceinline__ void kem_ntt_a_to_b(uint32_t f[kKemNttRegs], uint32_t* buf, int t) {
#pragma unroll
  for (int j = 0; j < kKemNttRegs; ++j) buf[t + 20 * j] = f[j];
  __syncwarp();
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const uint4 v = *reinterpret_cast<const uint4*>(buf + 20 * t + 4 * m);
    f[4 * m] = v.x, f[4 * m + 1] = v.y, f[4 * m + 2] = v.z, f[4 * m + 3] = v.w;
  }
}

__device__ __forceinline__ void kem_ntt_b_to_a(uint32_t f[kKemNttRegs], uint32_t* buf, int t) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    *reinterpret_cast<uint4*>(buf + 20 * t + 4 * m) =
        make_uint4(f[4 * m], f[4 * m + 1], f[4 * m + 2], f[4 * m + 3]);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kKemNttRegs; ++j) f[j] = buf[t + 20 * j];
}

// Forward NTT of the half-warp's polynomial, from stage-A registers (lazy
// values below 2q) to canonical coefficients in stage-A registers.
__device__ __forceinline__ void kem_ntt_forward(uint32_t f[kKemNttRegs], const KemLaneZetas& zb,
                                                uint32_t* buf, int t) {
  const KemUniformZetas za;
  kem_ntt_layer<8>(f, za);
  kem_ntt_layer<4>(f, za);
  kem_ntt_layer<2>(f, za);
  kem_ntt_layer<1>(f, za);
  kem_ntt_a_to_b(f, buf, t);
  kem_ntt_layer<8>(f, zb);
  kem_ntt_layer<4>(f, zb);
  kem_ntt_layer<2>(f, zb);
#pragma unroll
  for (int j = 0; j < kKemNttRegs; ++j) f[j] = kem_reduce(f[j]);
  kem_ntt_b_to_a(f, buf, t);
}

// ---------------------------------------------------------------------------
// K4: NTT mod q, the layer order of kem/mlkem.py:ntt / ntt_inv.
// Butterfly t (0..127) of the layer with butterfly groups of `len`.
// Forward layers run len = 128 .. 2 with groups = 128 / len; inverse
// layers len = 2 .. 128.
// ---------------------------------------------------------------------------

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
