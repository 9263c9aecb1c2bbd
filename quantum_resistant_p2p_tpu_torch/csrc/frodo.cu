// FrodoKEM kernels for Hopper: K9, K10, K11.
//
// K9  frodo_a_times_s    replaces kem/frodo_pallas.py:a_times_s_words (body
//                        _a_times_s_kernel, tiles _a_times_s_tiles)
// K10 frodo_s_times_a    replaces kem/frodo_pallas.py:s_times_a_words (body
//                        _s_times_a_kernel, tiles _s_times_a_tiles)
// K11 frodo_cdf_sample   replaces kem/frodo_pallas.py:cdf_sample_words (body
//                        _cdf_kernel, tiles _cdf_tiles)
//
// K9 and K10 multiply by FrodoKEM's n x n matrix A (n = 640, 976, 1344)
// without A ever reaching device memory: row i of A is the first n
// little-endian 16-bit words of SHAKE-128(le16(i) || seed_A) (SHAKE-128 for
// every parameter set), and a thread makes its row with the Keccak
// permutation of keccak.cuh, one 168-byte block (84 values) at a time, and
// uses each block at once.  All arithmetic is uint32, wrapping mod 2^32,
// which is exact mod q because q = 2^15 or 2^16 divides 2^32; outputs are
// masked to [0, q) when they are written.  Operands are reduced mod 2^32
// (the bits of the int32 inputs) and A's values masked to q - 1, as the
// reference does.
//
// What bounds K9 and K10 on the card: integer issue for the Keccak rows.  A
// row of A is ceil(2n / 168) = 8, 12 or 16 permutations of ~4,300 32-bit
// integer instructions each; the products are n x 8 multiply-adds a row,
// which issue as IMAD on the FMA pipe beside the logic ops.  The bytes are
// small: S or S' in (n x 8 int32 a lane) and the n x 8 product out.
//
// K9 (A.S, keygen): a block is one lane and 128 rows of A, one row a
// thread.  The lane's S (n x 8, 20 / 31 / 43 KB as uint32) is staged in
// shared memory; after each squeezed block a thread multiplies its 84
// values against the matching rows of S, which every thread of a warp reads
// at the same address (a broadcast), and keeps its 8 sums in registers.  An
// output row is complete in its thread: no reduction across threads.
//
// K10 (S'.A, encaps and decaps): each row of A adds to every output
// column, so the sum runs across threads.  On the TPU the output block
// stayed resident across a sequential grid axis; Hopper runs blocks in no
// order, so here one block owns one lane and loops over A in groups of 168
// rows, one row a thread.  After each squeezed block the 168 threads write
// their 84 values to a shared tile, and then each thread takes one product
// task, one column of the strip and one half of S' (4 of its 8 rows), and
// sums 168 rows of tile x S' into 4 registers, which it adds to the lane's
// output in device memory.  A task belongs to the same thread in every
// group, so the running sums need no atomics and no second pass, and the
// order of the sum is fixed.  Two shared loads feed 4 multiply-adds.
//
// K11 (the CDF sampler, every keygen, encaps and decaps): one thread a
// sample.  The table rides in the kernel's parameters, which live in the
// card's constant memory, padded to 16 entries with INT32_MAX; the sample
// is a compare-sum over all 16 entries with no early exit and no search,
// and the sign is applied by arithmetic, so the time does not depend on the
// random input (the reference's sampler is constant-time).  4 bytes in and
// 4 out a sample against ~40 instructions: bytes bound it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak.cuh"

namespace {

constexpr int kNbar = 8;
constexpr int kRateWords = 21;  // SHAKE-128: 168-byte blocks
constexpr int kBlockVals = 84;  // 16-bit values in one squeezed block
constexpr int kRowThreads = 128;  // K9: rows of A a block
constexpr int kGroupRows = 2 * kBlockVals;  // K10: rows a pass, = product tasks
constexpr int kCdfMax = 16;
constexpr int kSampleThreads = 256;

// Absorb the row message le16(row) || seed_A (18 bytes; domain byte 0x1F,
// pad10*1 at byte 167) into a fresh state and permute: the state then holds
// the row's first squeezed block.
__device__ __forceinline__ void absorb_row(uint64_t st[25], uint32_t row,
                                           const uint8_t* __restrict__ seed) {
  uint64_t w0 = 0, w1 = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    w0 |= (uint64_t)__ldg(seed + j) << (8 * j);
    w1 |= (uint64_t)__ldg(seed + 8 + j) << (8 * j);
  }
#pragma unroll
  for (int i = 0; i < 25; ++i) st[i] = 0;
  st[0] = (uint64_t)(row & 0xFFFFu) | (w0 << 16);
  st[1] = (w0 >> 48) | (w1 << 16);
  st[2] = (w1 >> 48) | (0x1FULL << 16);
  st[kRateWords - 1] = 0x80ULL << 56;
  qrp::keccak_f1600(st);
}

// q - 1 in each 16-bit field of a lane: masks four of A's values at once.
__device__ __forceinline__ uint64_t lane_mask(uint32_t q_mask) {
  const uint64_t m = q_mask & 0xFFFFu;
  return m | (m << 16) | (m << 32) | (m << 48);
}

// K9's multiply-accumulate of the first COUNT values of a squeezed block
// against S rows col0 .. col0 + COUNT - 1 (each row 8 values, two uint4).
template <int COUNT>
__device__ __forceinline__ void mac_block(const uint64_t st[25], uint64_t lmask,
                                          const uint4* __restrict__ s_rows, uint32_t acc[8]) {
#pragma unroll
  for (int v = 0; v < COUNT; ++v) {
    const uint32_t a = (uint32_t)((st[v / 4] & lmask) >> (16 * (v % 4))) & 0xFFFFu;
    const uint4 lo = s_rows[2 * v], hi = s_rows[2 * v + 1];
    acc[0] += a * lo.x;
    acc[1] += a * lo.y;
    acc[2] += a * lo.z;
    acc[3] += a * lo.w;
    acc[4] += a * hi.x;
    acc[5] += a * hi.y;
    acc[6] += a * hi.z;
    acc[7] += a * hi.w;
  }
}

// K9: out[lane, i, :] = (sum_k A[i, k] * S[lane, k, :]) & q_mask for the 128
// rows i of this block.  s, out: (batch, N, 8) int32; seed_a: (batch, 16).
template <int N>
__global__ void __launch_bounds__(kRowThreads)
    a_times_s_kernel(const uint8_t* __restrict__ seed_a, const int32_t* __restrict__ s,
                     int32_t* __restrict__ out, uint32_t q_mask) {
  __shared__ uint4 s_tile[2 * N];  // row k of S: s_tile[2k], s_tile[2k + 1]
  const int64_t lane = blockIdx.x;
  const int32_t* s_lane = s + lane * N * kNbar;
  for (int k = threadIdx.x; k < 2 * N; k += kRowThreads) {
    const int32_t* src = s_lane + 4 * k;
    s_tile[k] = make_uint4((uint32_t)__ldg(src), (uint32_t)__ldg(src + 1),
                           (uint32_t)__ldg(src + 2), (uint32_t)__ldg(src + 3));
  }
  __syncthreads();
  const int row = blockIdx.y * kRowThreads + threadIdx.x;
  if (row >= N) return;
  uint64_t st[25];
  absorb_row(st, (uint32_t)row, seed_a + 16 * lane);
  const uint64_t lmask = lane_mask(q_mask);
  uint32_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  constexpr int kFull = N / kBlockVals;  // whole squeezed blocks (7, 11, 16)
#pragma unroll 1
  for (int blk = 0; blk < kFull; ++blk) {
    if (blk) qrp::keccak_f1600(st);
    mac_block<kBlockVals>(st, lmask, s_tile + 2 * kBlockVals * blk, acc);
  }
  if (N % kBlockVals) {  // the row's last, partial block
    qrp::keccak_f1600(st);
    mac_block<N % kBlockVals>(st, lmask, s_tile + 2 * kBlockVals * kFull, acc);
  }
  int4* dst = reinterpret_cast<int4*>(out + (lane * N + row) * kNbar);
  dst[0] = make_int4((int)(acc[0] & q_mask), (int)(acc[1] & q_mask), (int)(acc[2] & q_mask),
                     (int)(acc[3] & q_mask));
  dst[1] = make_int4((int)(acc[4] & q_mask), (int)(acc[5] & q_mask), (int)(acc[6] & q_mask),
                     (int)(acc[7] & q_mask));
}

// K10: out[lane, j, :] = (sum_r S'[lane, j, r] * A[r, :]) & q_mask.
// sp, out: (batch, 8, N) int32; seed_a: (batch, 16).  One block a lane.
template <int N>
__global__ void __launch_bounds__(kGroupRows)
    s_times_a_kernel(const uint8_t* __restrict__ seed_a, const int32_t* __restrict__ sp,
                     int32_t* __restrict__ out, uint32_t q_mask) {
  __shared__ uint64_t tile[kGroupRows * kRateWords];  // one squeezed block a row
  __shared__ uint4 sp_tile[kGroupRows * 2];  // S'[0..3][r], S'[4..7][r]
  const uint16_t* tile16 = reinterpret_cast<const uint16_t*>(tile);
  const int t = threadIdx.x;
  const int col = t % kBlockVals, half = t / kBlockVals;  // this thread's product task
  const int64_t lane = blockIdx.x;
  const uint8_t* seed = seed_a + 16 * lane;
  const int32_t* sp_lane = sp + lane * kNbar * N;
  int32_t* out_lane = out + lane * kNbar * N;
  const uint64_t lmask = lane_mask(q_mask);
  constexpr int kGroups = (N + kGroupRows - 1) / kGroupRows;  // 4, 6, 8
  constexpr int kStrips = (N + kBlockVals - 1) / kBlockVals;  // squeezed blocks a row
#pragma unroll 1
  for (int g = 0; g < kGroups; ++g) {
    // the last strip of the previous group ended with a barrier, so
    // sp_tile and tile are free
    const int row = g * kGroupRows + t;
    const bool live = row < N;
    uint32_t v[kNbar];
#pragma unroll
    for (int j = 0; j < kNbar; ++j) v[j] = live ? (uint32_t)__ldg(sp_lane + j * N + row) : 0u;
    sp_tile[2 * t] = make_uint4(v[0], v[1], v[2], v[3]);
    sp_tile[2 * t + 1] = make_uint4(v[4], v[5], v[6], v[7]);
    uint64_t st[25];
    if (live) absorb_row(st, (uint32_t)row, seed);
#pragma unroll 1
    for (int sb = 0; sb < kStrips; ++sb) {
      if (live && sb) qrp::keccak_f1600(st);
#pragma unroll
      for (int w = 0; w < kRateWords; ++w) tile[t * kRateWords + w] = live ? st[w] & lmask : 0;
      __syncthreads();
      uint32_t acc[4] = {0, 0, 0, 0};
#pragma unroll 4
      for (int r = 0; r < kGroupRows; ++r) {
        const uint32_t a = tile16[r * kBlockVals + col];
        const uint4 s4 = sp_tile[2 * r + half];
        acc[0] += a * s4.x;
        acc[1] += a * s4.y;
        acc[2] += a * s4.z;
        acc[3] += a * s4.w;
      }
      const int k = sb * kBlockVals + col;
      if (k < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int32_t* o = out_lane + (4 * half + j) * N + k;
          uint32_t x = acc[j] + (g ? (uint32_t)*o : 0u);
          if (g == kGroups - 1) x &= q_mask;
          *o = (int32_t)x;
        }
      }
      __syncthreads();  // the next strip overwrites tile
    }
  }
}

struct CdfTable {
  int32_t v[kCdfMax];  // thresholds, padded with INT32_MAX
};

// K11: e = #{k : (r >> 1) > cdf[k]}, negated when r is odd, & q_mask.
__global__ void __launch_bounds__(kSampleThreads)
    cdf_kernel(const int32_t* __restrict__ r, int32_t* __restrict__ out, int64_t m,
               const CdfTable cdf, int32_t q_mask) {
  const int64_t i = (int64_t)blockIdx.x * kSampleThreads + threadIdx.x;
  if (i >= m) return;
  const int32_t x = __ldg(r + i);
  const int32_t t = x >> 1;
  int32_t e = 0;
#pragma unroll
  for (int k = 0; k < kCdfMax; ++k) e += (int32_t)(t > cdf.v[k]);
  const int32_t neg = -(x & 1);  // 0 or -1: (e ^ neg) - neg is e or -e
  out[i] = ((e ^ neg) - neg) & q_mask;
}

template <int N>
void launch_a_times_s(const uint8_t* seed_a, const int32_t* s, int32_t* out, int64_t batch,
                      uint32_t q_mask, cudaStream_t st) {
  const dim3 grid((unsigned)batch, (N + kRowThreads - 1) / kRowThreads);
  a_times_s_kernel<N><<<grid, kRowThreads, 0, st>>>(seed_a, s, out, q_mask);
}

template <int N>
void launch_s_times_a(const uint8_t* seed_a, const int32_t* sp, int32_t* out, int64_t batch,
                      uint32_t q_mask, cudaStream_t st) {
  s_times_a_kernel<N><<<(unsigned)batch, kGroupRows, 0, st>>>(seed_a, sp, out, q_mask);
}

}  // namespace

extern "C" {

// seed_a: (batch, 16) uint8; s, out: (batch, n, 8) int32, out 16-byte
// aligned; n is 640, 976 or 1344.  Returns a cudaError_t.
int qrp_frodo_a_times_s(const void* seed_a, const void* s, void* out, int64_t batch, int n,
                        int q_mask, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  const auto* seed = static_cast<const uint8_t*>(seed_a);
  const auto* src = static_cast<const int32_t*>(s);
  auto* dst = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 640: launch_a_times_s<640>(seed, src, dst, batch, (uint32_t)q_mask, st); break;
    case 976: launch_a_times_s<976>(seed, src, dst, batch, (uint32_t)q_mask, st); break;
    case 1344: launch_a_times_s<1344>(seed, src, dst, batch, (uint32_t)q_mask, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// seed_a: (batch, 16) uint8; sp, out: (batch, 8, n) int32.
int qrp_frodo_s_times_a(const void* seed_a, const void* sp, void* out, int64_t batch, int n,
                        int q_mask, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  const auto* seed = static_cast<const uint8_t*>(seed_a);
  const auto* src = static_cast<const int32_t*>(sp);
  auto* dst = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 640: launch_s_times_a<640>(seed, src, dst, batch, (uint32_t)q_mask, st); break;
    case 976: launch_s_times_a<976>(seed, src, dst, batch, (uint32_t)q_mask, st); break;
    case 1344: launch_s_times_a<1344>(seed, src, dst, batch, (uint32_t)q_mask, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// r, out: (m,) int32; cdf: n_cdf <= 16 host int32 thresholds (the table
// without its last entry).
int qrp_frodo_cdf_sample(const void* r, void* out, int64_t m, const int32_t* cdf, int n_cdf,
                         int q_mask, void* stream) {
  if (n_cdf < 0 || n_cdf > kCdfMax) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaSuccess;
  CdfTable table;
  for (int k = 0; k < kCdfMax; ++k) table.v[k] = k < n_cdf ? cdf[k] : INT32_MAX;
  const int64_t blocks = (m + kSampleThreads - 1) / kSampleThreads;
  cdf_kernel<<<(unsigned)blocks, kSampleThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(r), static_cast<int32_t*>(out), m, table, q_mask);
  return (int)cudaGetLastError();
}

const char* qrp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
