// K12 and K13: the SHA-256 and SHA-512 compressions, batched, for Hopper.
//
// K12 replaces core/sha256_pallas.py:compress_words and K13
// core/sha512_pallas.py:compress_words.  Those Pallas kernels kept each of
// the 24 live words (8 state, 16 schedule) as an (8, 128) uint32 tile over
// 1024 instances, SHA-512's words as hi/lo uint32 pairs, and moved them
// through the shared sampler_call launcher split across its two operands.
// Here one thread compresses one row: it reads its state (8 int64 words as
// core/sha256.py and core/sha512.py hold them), then for each of the row's
// k message blocks loads the block as 16-byte vectors, turns each word
// big-endian with __byte_perm, runs the fully unrolled rounds with the
// 16-word schedule window and the 8 working words in registers, and adds
// the feedforward.  It writes 8 int64 words.  SHA-512 uses native
// uint64_t words.
//
// The round constants live in __constant__ memory: every thread of a warp
// reads the same K[t] in the same round, so the constant cache broadcasts
// it.  Rotations are funnel shifts (SHF).  Rows that share a state (a
// SPHINCS+ pk_seed midstate over all of a signature's hashes) read it from
// row / rows_per_state, so the state is not copied out per row.
//
// What bounds it: the integer pipe.  A SHA-256 block is ~2,000 32-bit
// instructions against 64 bytes in and (for k = 1) 64 bytes of state in
// and out; chip_smoke.py counts them from this kernel's SASS.
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

}  // namespace

extern "C" {

// Each returns a cudaError_t.  blocks must be 16-byte aligned; n_rows is a
// multiple of rows_per_state >= 1; n_blocks >= 1.
int qrp_sha256_compress(const void* state, const void* blocks, void* out, int64_t n_rows,
                        int64_t rows_per_state, int n_blocks, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  const int64_t grid = (n_rows + kThreads - 1) / kThreads;
  sha256_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(state), static_cast<const uint4*>(blocks),
      static_cast<int64_t*>(out), n_rows, rows_per_state, n_blocks);
  return (int)cudaGetLastError();
}

int qrp_sha512_compress(const void* state, const void* blocks, void* out, int64_t n_rows,
                        int64_t rows_per_state, int n_blocks, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  const int64_t grid = (n_rows + kThreads - 1) / kThreads;
  sha512_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(state), static_cast<const uint4*>(blocks),
      static_cast<int64_t*>(out), n_rows, rows_per_state, n_blocks);
  return (int)cudaGetLastError();
}

const char* qrp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
