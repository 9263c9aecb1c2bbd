// K12 and K13: the SHA-256 and SHA-512 compressions, batched, for Hopper.
//
// K12 replaces core/sha256_pallas.py:compress_words and K13
// core/sha512_pallas.py:compress_words.  Those Pallas kernels kept each of
// the 24 live words (8 state, 16 schedule) as an (8, 128) uint32 tile over
// 1024 instances, SHA-512's words as hi/lo uint32 pairs, and moved them
// through the shared sampler_call launcher split across its two operands.
// A launch here takes (S, 8) int64 states (the words as core/sha256.py and
// core/sha512.py hold them, SHA-512's as bit patterns) and N = S * r rows
// of k message blocks; each row compresses its k blocks, in order, from the
// state of its group of r consecutive rows (a SPHINCS+ pk_seed midstate
// serves all of a signature's hashes without a copy a row), and the launch
// writes (N, 8) int64 words.  SHA-512 uses native uint64_t words; the
// round constants live in __constant__ memory, where every lane of a warp
// reads the same K[t] in the same round and the constant cache broadcasts
// it; rotations are funnel shifts (SHF).  Two paths, chosen by the wrapper
// (core/sha256_cuda.py: split_rule, a rule of rows, blocks a row and SMs):
//
// * Rows path (sha256_kernel, sha512_kernel): one thread compresses one
//   row.  For each block it loads four (SHA-512: eight) 16-byte vectors,
//   turns each word big-endian with __byte_perm, and runs the fully
//   unrolled rounds with the 16-word schedule window and the 8 working
//   words in registers.  What bounds it is the integer pipe: a SHA-256
//   block is 1,286 integer-pipe instructions (3,421 for SHA-512) against
//   64 (128) bytes in, and wherever the rows give every SM partition a
//   warp (the SPHINCS+ chain steps, FORS leaves and levels) it runs within
//   1.13-1.40x of that bound on the H100.
//
// * Few-row path (sha256_split_kernel, sha512_split_kernel), for launches
//   of several blocks a row and too few rows to fill the card: SPHINCS+
//   T_l, one launch a hypertree layer over 8,192 (128f sign, B = 1024) or
//   2,048 (a 128s verify flush; 192f sign, B = 256) rows of 10 blocks.
//   There the rows path puts at most one warp on a partition, and a lone
//   warp's time is its own instruction stream (10 x 1,286 integer-pipe
//   instructions at 2 cycles each for K12), however few rows it holds.
//   This path shortens that stream.  Each group of 32 rows is a 2-warp
//   CTA, its warps on two partitions: the schedule warp loads each block
//   (the next one while it expands this one), expands the message
//   schedule and writes W[t] + K[t], [t][lane] so that a warp's access is
//   conflict-free, into a ring of two block slots in shared memory; the
//   round warp runs the rounds of the block before it from the ring, one
//   LDS a round and no schedule arithmetic, then the feedforward, and
//   writes the state.  Named barriers hand the slots over (slot s full:
//   1 + s, bar.arrive by the schedule warp and bar.sync by the round warp;
//   empty: 3 + s, the other way).  What bounds it is the round warp's
//   chain from e to e', three funnel shifts issued one after another on
//   the integer pipe, their XOR and an add, each waiting on the one
//   before: its adds run on the FMA pipe, its sums are ordered for that
//   chain, and on the H100 a round still takes about 1.3x its 10
//   integer-pipe instructions' issue time; then the first block's fill
//   (its load and schedule before any round).  Lanes past the last row run
//   it again and store nothing, so every warp stays converged at the
//   barriers.  The path rule's crossover is measured: see split_rule.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__constant__ uint32_t kK256[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__constant__ uint64_t kK512[80] = {
    0x428A2F98D728AE22ull, 0x7137449123EF65CDull, 0xB5C0FBCFEC4D3B2Full, 0xE9B5DBA58189DBBCull,
    0x3956C25BF348B538ull, 0x59F111F1B605D019ull, 0x923F82A4AF194F9Bull, 0xAB1C5ED5DA6D8118ull,
    0xD807AA98A3030242ull, 0x12835B0145706FBEull, 0x243185BE4EE4B28Cull, 0x550C7DC3D5FFB4E2ull,
    0x72BE5D74F27B896Full, 0x80DEB1FE3B1696B1ull, 0x9BDC06A725C71235ull, 0xC19BF174CF692694ull,
    0xE49B69C19EF14AD2ull, 0xEFBE4786384F25E3ull, 0x0FC19DC68B8CD5B5ull, 0x240CA1CC77AC9C65ull,
    0x2DE92C6F592B0275ull, 0x4A7484AA6EA6E483ull, 0x5CB0A9DCBD41FBD4ull, 0x76F988DA831153B5ull,
    0x983E5152EE66DFABull, 0xA831C66D2DB43210ull, 0xB00327C898FB213Full, 0xBF597FC7BEEF0EE4ull,
    0xC6E00BF33DA88FC2ull, 0xD5A79147930AA725ull, 0x06CA6351E003826Full, 0x142929670A0E6E70ull,
    0x27B70A8546D22FFCull, 0x2E1B21385C26C926ull, 0x4D2C6DFC5AC42AEDull, 0x53380D139D95B3DFull,
    0x650A73548BAF63DEull, 0x766A0ABB3C77B2A8ull, 0x81C2C92E47EDAEE6ull, 0x92722C851482353Bull,
    0xA2BFE8A14CF10364ull, 0xA81A664BBC423001ull, 0xC24B8B70D0F89791ull, 0xC76C51A30654BE30ull,
    0xD192E819D6EF5218ull, 0xD69906245565A910ull, 0xF40E35855771202Aull, 0x106AA07032BBD1B8ull,
    0x19A4C116B8D2D0C8ull, 0x1E376C085141AB53ull, 0x2748774CDF8EEB99ull, 0x34B0BCB5E19B48A8ull,
    0x391C0CB3C5C95A63ull, 0x4ED8AA4AE3418ACBull, 0x5B9CCA4F7763E373ull, 0x682E6FF3D6B2B8A3ull,
    0x748F82EE5DEFB2FCull, 0x78A5636F43172F60ull, 0x84C87814A1F0AB72ull, 0x8CC702081A6439ECull,
    0x90BEFFFA23631E28ull, 0xA4506CEBDE82BDE9ull, 0xBEF9A3F7B2C67915ull, 0xC67178F2E372532Bull,
    0xCA273ECEEA26619Cull, 0xD186B8C721C0C207ull, 0xEADA7DD6CDE0EB1Eull, 0xF57D4F7FEE6ED178ull,
    0x06F067AA72176FBAull, 0x0A637DC5A2C898A6ull, 0x113F9804BEF90DAEull, 0x1B710B35131C471Bull,
    0x28DB77F523047D84ull, 0x32CAAB7B40C72493ull, 0x3C9EBE0A15C9BEBCull, 0x431D67C49C100D4Cull,
    0x4CC5D4BECB3E42B6ull, 0x597F299CFC657E2Aull, 0x5FCB6FAB3AD6FAECull, 0x6C44198C4A475817ull,
};

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

// A little-endian load of bytes b0..b3 -> the big-endian word b0 b1 b2 b3.
__device__ __forceinline__ uint32_t be32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// ---------------------------------------------------------------------------
// Rows path: one thread a row

// 16-byte vectors: one SHA-256 block is four of them, a SHA-512 block eight.
__device__ __forceinline__ void load_be32x4(const uint4* src, uint32_t* w) {
  const uint4 v = __ldg(src);
  w[0] = be32(v.x); w[1] = be32(v.y); w[2] = be32(v.z); w[3] = be32(v.w);
}

__device__ __forceinline__ void load_be64x2(const uint4* src, uint64_t* w) {
  const uint4 v = __ldg(src);
  w[0] = ((uint64_t)be32(v.x) << 32) | be32(v.y);
  w[1] = ((uint64_t)be32(v.z) << 32) | be32(v.w);
}

__device__ __forceinline__ void sha256_block(uint32_t* s, const uint4* blk) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) load_be32x4(blk + i, w + 4 * i);
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t x15 = w[(t - 15) & 15], x2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr32(x15, 7) ^ rotr32(x15, 18) ^ (x15 >> 3);
      const uint32_t s1 = rotr32(x2, 17) ^ rotr32(x2, 19) ^ (x2 >> 10);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint32_t t1 = h + (rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25)) +
                        ((e & f) ^ (~e & g)) + kK256[t] + w[t & 15];
    const uint32_t t2 = (rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22)) +
                        ((a & b) ^ (a & c) ^ (b & c));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  s[0] += a; s[1] += b; s[2] += c; s[3] += d;
  s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

__device__ __forceinline__ void sha512_block(uint64_t* s, const uint4* blk) {
  uint64_t w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) load_be64x2(blk + i, w + 2 * i);
  uint64_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    if (t >= 16) {
      const uint64_t x15 = w[(t - 15) & 15], x2 = w[(t - 2) & 15];
      const uint64_t s0 = rotr64(x15, 1) ^ rotr64(x15, 8) ^ (x15 >> 7);
      const uint64_t s1 = rotr64(x2, 19) ^ rotr64(x2, 61) ^ (x2 >> 6);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint64_t t1 = h + (rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41)) +
                        ((e & f) ^ (~e & g)) + kK512[t] + w[t & 15];
    const uint64_t t2 = (rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39)) +
                        ((a & b) ^ (a & c) ^ (b & c));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  s[0] += a; s[1] += b; s[2] += c; s[3] += d;
  s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

// state: (n / rows_per_state, 8) int64; blocks: (n, 64 * n_blocks) bytes;
// out: (n, 8) int64.
__global__ void __launch_bounds__(kThreads)
    sha256_kernel(const int64_t* __restrict__ state, const uint4* __restrict__ blocks,
                  int64_t* __restrict__ out, int64_t n, int64_t rows_per_state, int n_blocks) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const int64_t* st = state + 8 * (row / rows_per_state);
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = (uint32_t)__ldg(st + i);
  const uint4* blk = blocks + row * (int64_t)n_blocks * 4;
#pragma unroll 1
  for (int k = 0; k < n_blocks; ++k) sha256_block(s, blk + 4 * k);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[8 * row + i] = (int64_t)s[i];
}

// state: (n / rows_per_state, 8) int64 (the words' bit patterns); blocks:
// (n, 128 * n_blocks) bytes; out: (n, 8) int64.
__global__ void __launch_bounds__(kThreads)
    sha512_kernel(const int64_t* __restrict__ state, const uint4* __restrict__ blocks,
                  int64_t* __restrict__ out, int64_t n, int64_t rows_per_state, int n_blocks) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const int64_t* st = state + 8 * (row / rows_per_state);
  uint64_t s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = (uint64_t)__ldg(st + i);
  const uint4* blk = blocks + row * (int64_t)n_blocks * 8;
#pragma unroll 1
  for (int k = 0; k < n_blocks; ++k) sha512_block(s, blk + 8 * k);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[8 * row + i] = (int64_t)s[i];
}

// ---------------------------------------------------------------------------
// Few-row path: a schedule warp and a round warp a group of 32 rows

// The few-row path's 32-bit adds run on the FMA pipe, as x * one + y
// where one (1, a kernel argument) cannot be folded away, and so does the
// schedule's x >> n, as the high word of x * (one << (32 - n)): a warp
// alone on its partition then issues them beside the integer pipe's logic
// ops and rotations.  SHA-512's 64-bit adds stay on the integer pipe (as
// wide multiply-adds they ran 1.4-1.5x slower).
__device__ __forceinline__ uint32_t add(uint32_t x, uint32_t y, uint32_t one) {
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(one), "r"(y));
  return r;
}

__device__ __forceinline__ uint64_t add(uint64_t x, uint64_t y, uint32_t) { return x + y; }

__device__ __forceinline__ uint32_t shr_fma(uint32_t x, int n, uint32_t one) {
  uint32_t r;
  asm("mul.hi.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(one << (32 - n)));
  return r;
}

// kUnroll: the round warp's rounds an iteration.  SHA-256 unrolls all 64
// (20 KB of code; loops of 8-32 rounds ran 8-12% slower); SHA-512 runs 16
// an iteration, since a fully unrolled block (38 KB of round code beside
// 26 KB of schedule code a CTA) outgrows the instruction cache and ran
// 1.1-1.6x slower, the more so the more SMs ran it.  kSlotRows pads each
// ring slot with the rows that the last iteration's prefetch reads.
struct Sha256 {
  using Word = uint32_t;
  static constexpr int kRounds = 64;
  static constexpr int kVecs = 4;  // 16-byte vectors a block
  static constexpr int kUnroll = 64;
  static constexpr int kSlotRows = kRounds + (kUnroll < kRounds ? kUnroll : 0);
  __device__ static Word k(int t) { return kK256[t]; }
  __device__ static void unpack(const uint4* v, Word* w) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      w[4 * i] = be32(v[i].x); w[4 * i + 1] = be32(v[i].y);
      w[4 * i + 2] = be32(v[i].z); w[4 * i + 3] = be32(v[i].w);
    }
  }
  __device__ static Word big0(Word a) { return rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22); }
  __device__ static Word big1(Word e) { return rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25); }
  __device__ static Word small0(Word x, uint32_t one) {
    return rotr32(x, 7) ^ rotr32(x, 18) ^ shr_fma(x, 3, one);
  }
  __device__ static Word small1(Word x, uint32_t one) {
    return rotr32(x, 17) ^ rotr32(x, 19) ^ shr_fma(x, 10, one);
  }
};

struct Sha512 {
  using Word = uint64_t;
  static constexpr int kRounds = 80;
  static constexpr int kVecs = 8;
  static constexpr int kUnroll = 16;
  static constexpr int kSlotRows = kRounds + (kUnroll < kRounds ? kUnroll : 0);
  __device__ static Word k(int t) { return kK512[t]; }
  __device__ static void unpack(const uint4* v, Word* w) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      w[2 * i] = ((uint64_t)be32(v[i].x) << 32) | be32(v[i].y);
      w[2 * i + 1] = ((uint64_t)be32(v[i].z) << 32) | be32(v[i].w);
    }
  }
  __device__ static Word big0(Word a) { return rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39); }
  __device__ static Word big1(Word e) { return rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41); }
  __device__ static Word small0(Word x, uint32_t) { return rotr64(x, 1) ^ rotr64(x, 8) ^ (x >> 7); }
  __device__ static Word small1(Word x, uint32_t) {
    return rotr64(x, 19) ^ rotr64(x, 61) ^ (x >> 6);
  }
};

template <class H>
__device__ __forceinline__ void load_block(const uint4* blk, uint4* v) {
#pragma unroll
  for (int i = 0; i < H::kVecs; ++i) v[i] = __ldg(blk + i);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

// The schedule of one block, from its 16 words, into a ring slot:
// slot[32 t] = W[t] + K[t] (the lane's column).  The expansion runs 16
// words an iteration, so that the loop's code stays small.
template <class H>
__device__ __forceinline__ void expand(typename H::Word (&w)[16], typename H::Word* slot,
                                       uint32_t one) {
#pragma unroll
  for (int t = 0; t < 16; ++t) slot[32 * t] = add(w[t], H::k(t), one);
#pragma unroll 1
  for (int t = 16; t < H::kRounds; t += 16) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      w[j] = add(add(w[j], H::small0(w[(j + 1) & 15], one), one),
                 add(w[(j + 9) & 15], H::small1(w[(j + 14) & 15], one), one), one);
      slot[32 * (t + j)] = add(w[j], H::k(t + j), one);
    }
  }
}

// One round, the working words named from a (the caller rotates the
// names): d becomes e' and h becomes a'.  The sums are ordered for a short
// chain from e to e': with y = h + W[t] + K[t] and y + d ready before e
// is, e' = ((y + d) + Ch(e, f, g)) + Sigma1(e) is two steps after Ch and
// one after Sigma1; t1 = (y + Ch) + Sigma1 and a' = (t1 + Maj) + Sigma0(a).
template <class H>
__device__ __forceinline__ void step(typename H::Word a, typename H::Word b,
                                      typename H::Word c, typename H::Word& d,
                                      typename H::Word e, typename H::Word f,
                                      typename H::Word g, typename H::Word& h,
                                      typename H::Word kw, uint32_t one) {
  using W = typename H::Word;
  const W y = add(h, kw, one);
  const W ch = (e & f) ^ (~e & g);
  const W s1 = H::big1(e);
  const W t1 = add(add(y, ch, one), s1, one);
  d = add(add(add(y, d, one), ch, one), s1, one);
  h = add(add(t1, (a & b) ^ (a & c) ^ (b & c), one), H::big0(a), one);
}

// The rounds of one block from a ring slot, H::kUnroll an iteration, and
// the feedforward.  Each iteration loads the next one's W[t] + K[t] before
// it runs its own rounds (the last one reads the slot's padding rows).
template <class H>
__device__ __forceinline__ void rounds(typename H::Word (&s)[8], const typename H::Word* slot,
                                       uint32_t one) {
  using W = typename H::Word;
  constexpr int U = H::kUnroll;
  W a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
  W kw[U];
#pragma unroll
  for (int j = 0; j < U; ++j) kw[j] = slot[32 * j];
#pragma unroll 1
  for (int t = 0; t < H::kRounds; t += U) {
    W next[U];
    if constexpr (U < H::kRounds) {
#pragma unroll
      for (int j = 0; j < U; ++j) next[j] = slot[32 * (t + U + j)];
    }
#pragma unroll
    for (int j = 0; j < U; j += 8) {
      step<H>(a, b, c, d, e, f, g, h, kw[j], one);
      step<H>(h, a, b, c, d, e, f, g, kw[j + 1], one);
      step<H>(g, h, a, b, c, d, e, f, kw[j + 2], one);
      step<H>(f, g, h, a, b, c, d, e, kw[j + 3], one);
      step<H>(e, f, g, h, a, b, c, d, kw[j + 4], one);
      step<H>(d, e, f, g, h, a, b, c, kw[j + 5], one);
      step<H>(c, d, e, f, g, h, a, b, kw[j + 6], one);
      step<H>(b, c, d, e, f, g, h, a, kw[j + 7], one);
    }
    if constexpr (U < H::kRounds) {
#pragma unroll
      for (int j = 0; j < U; ++j) kw[j] = next[j];
    }
  }
  s[0] += a; s[1] += b; s[2] += c; s[3] += d;
  s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

// One group of 32 rows a CTA: warp 0 runs the rounds, warp 1 the schedule,
// on two partitions of the SM.  Slot s is full at barrier 1 + s and empty
// at barrier 3 + s.
template <class H>
__device__ __forceinline__ void compress_split(const int64_t* state, const uint4* blocks,
                                               int64_t* out, int64_t n, int64_t rows_per_state,
                                               int n_blocks, uint32_t one) {
  using W = typename H::Word;
  __shared__ W ring[2][H::kSlotRows][32];
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * 32;
  const int64_t row = first + lane < n ? first + lane : n - 1;
  if (threadIdx.x >= 32) {
    const uint4* blk = blocks + row * (int64_t)n_blocks * H::kVecs;
    uint4 v[H::kVecs];
    load_block<H>(blk, v);
#pragma unroll 1
    for (int k = 0; k < n_blocks; ++k) {
      W w[16];
      H::unpack(v, w);
      if (k + 1 < n_blocks) load_block<H>(blk + H::kVecs * (k + 1), v);
      const int s = k & 1;
      if (k >= 2) bar_sync(3 + s);
      expand<H>(w, &ring[s][0][lane], one);
      bar_arrive(1 + s);
    }
  } else {
    const int64_t* st = state + 8 * (row / rows_per_state);
    W s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = (W)__ldg(st + i);
#pragma unroll 1
    for (int k = 0; k < n_blocks; ++k) {
      const int slot = k & 1;
      bar_sync(1 + slot);
      rounds<H>(s, &ring[slot][0][lane], one);
      if (k + 2 < n_blocks) bar_arrive(3 + slot);
    }
    if (first + lane < n) {
#pragma unroll
      for (int i = 0; i < 8; ++i) out[8 * (first + lane) + i] = (int64_t)s[i];
    }
  }
}

__global__ void __launch_bounds__(64)
    sha256_split_kernel(const int64_t* __restrict__ state, const uint4* __restrict__ blocks,
                        int64_t* __restrict__ out, int64_t n, int64_t rows_per_state,
                        int n_blocks, uint32_t one) {
  compress_split<Sha256>(state, blocks, out, n, rows_per_state, n_blocks, one);
}

__global__ void __launch_bounds__(64)
    sha512_split_kernel(const int64_t* __restrict__ state, const uint4* __restrict__ blocks,
                        int64_t* __restrict__ out, int64_t n, int64_t rows_per_state,
                        int n_blocks, uint32_t one) {
  compress_split<Sha512>(state, blocks, out, n, rows_per_state, n_blocks, one);
}

int launch(void (*rows_kernel)(const int64_t*, const uint4*, int64_t*, int64_t, int64_t, int),
           void (*split_kernel)(const int64_t*, const uint4*, int64_t*, int64_t, int64_t, int,
                                uint32_t),
           const void* state, const void* blocks, void* out, int64_t n_rows,
           int64_t rows_per_state, int n_blocks, int path, void* stream) {
  if (path != 0 && path != 1) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaSuccess;
  const auto st = static_cast<const int64_t*>(state);
  const auto blk = static_cast<const uint4*>(blocks);
  const auto o = static_cast<int64_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    const int64_t grid = (n_rows + kThreads - 1) / kThreads;
    rows_kernel<<<(unsigned)grid, kThreads, 0, s>>>(st, blk, o, n_rows, rows_per_state,
                                                    n_blocks);
  } else {
    const int64_t grid = (n_rows + 31) / 32;
    split_kernel<<<(unsigned)grid, 64, 0, s>>>(st, blk, o, n_rows, rows_per_state, n_blocks, 1u);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t.  blocks must be 16-byte aligned; n_rows is a
// multiple of rows_per_state >= 1; n_blocks >= 1; path 0 runs the rows
// path, 1 the few-row path (the wrapper's rule picks it).
int qrp_sha256_compress(const void* state, const void* blocks, void* out, int64_t n_rows,
                        int64_t rows_per_state, int n_blocks, int path, void* stream) {
  return launch(sha256_kernel, sha256_split_kernel, state, blocks, out, n_rows, rows_per_state,
                n_blocks, path, stream);
}

int qrp_sha512_compress(const void* state, const void* blocks, void* out, int64_t n_rows,
                        int64_t rows_per_state, int n_blocks, int path, void* stream) {
  return launch(sha512_kernel, sha512_split_kernel, state, blocks, out, n_rows, rows_per_state,
                n_blocks, path, stream);
}

const char* qrp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
