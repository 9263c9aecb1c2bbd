// K1: batched Keccak sponge (SHA3-256/512, SHAKE-128/256) for Hopper.
//
// Replaces core/keccak_pallas.py:sponge_words (body _sponge_kernel), the
// Pallas sponge that kept 1024 sponges on (8, 128) uint32 tiles with each
// lane split into hi/lo words, and was capped at MAX_BLOCKS_FUSED = 16
// blocks by TPU compile time.  Neither the split nor the cap exists here:
// a sponge loops over as many absorb and squeeze blocks as the lengths
// need, on native 64-bit lanes.
//
// What bounds it on the card: integer issue.  A permutation is 24 rounds
// of ~180 32-bit logic and shift instructions on 200 bytes of state, while
// the bytes moved are only the message in and the digest out; every call
// on the ML-KEM path is compute-bound by a wide margin.  So the card has
// to be full: each of the 4 x 132 schedulers needs a warp of rounds to
// issue, and a serial chain of permutations must not leave SMs idle.
// The launcher takes one of two paths by the row count and the device's
// SM count (launch below):
//
// * Rows path (kRowsPerSm rows or more an SM): one thread runs one sponge
//   with its 25 lanes in registers (keccak.cuh's keccak_f1600).  A warp
//   stages the current block of its 32 rows in shared memory, each lane
//   assembled from aligned 32-bit loads that consecutive threads take
//   along a row (load_lane), and reads its own row's lanes from there (odd
//   row strides of 9, 17 or 21 lanes: no bank conflicts); digests go back
//   out the same way, a whole lane a store where the row allows.
//
// * Split path (fewer rows: a sponge a thread makes a 4096-row call 128
//   warps, a quarter of the card's 528 schedulers): five lanes of a warp
//   run one sponge, six sponges a warp, so 4096 rows are 342 blocks of two
//   warps on all 132 SMs.  Lane p of a group holds column x = p (its slot y is
//   lane p + 5y) at the start of a round.  theta's column parity is local
//   and D takes two shuffles; rho rotates each slot by its own amount; pi
//   is five shuffles, step k pulling slot k from group lane 3p + k (mod
//   5), after which lane p holds row y = p; chi is local on that row; iota
//   goes to group lane 0; and the row goes back to columns through the
//   group's 25 lanes in shared memory (double-buffered, one __syncwarp a
//   round).  Every register index is a compile-time constant: the per-lane
//   sources, amounts and buffer slots sit in registers, loaded once from
//   g_split, a table built and loaded by core/keccak_cuda.py.  A round is
//   ~82 instructions a lane (SASS: 28 LOP3, 14 SHFL, 12 SHF, 10 SEL for
//   the rotations by per-lane amounts, 5 STS, 5 LDS), and its chain of
//   shuffles and the exchange sets its latency.  That latency, not issue,
//   bounds a split launch, which has too few warps to hide it; it is still
//   about two thirds of a sponge-a-thread round's, and the split path
//   keeps 5x the schedulers busy (PERF.md has the measurements).  A round
//   that kept the column layout, pi stored to shared memory and chi
//   reading three columns back, was slower: 3x the shared reads.
//
// The varlen entry is the same sponge with a true length per row: rows of
// LMAX bytes, of which row r absorbs lengths[r] (the fused handshake's
// transcripts, whose JSON tails differ per lane).  The padding is made in
// registers (load_lane: domain byte at the length, 0x80 at the end of its
// block), bytes past the length are never read, and a sponge permutes only
// the blocks its own message needs; the threads of a warp loop to the
// longest of their rows, and a split group whose message has ended leaves
// the shuffle mask.
#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak.cuh"

namespace {

using qrp::keccak_f1600;
using qrp::kKeccakRC;
using qrp::rotl64;

// ---------------------------------------------------------------------------
// Message lanes in, digest lanes out
// ---------------------------------------------------------------------------

// Bytes [base, base + 8) of row `msg`'s padded message (len bytes, padded
// to padded_len): message bytes from the aligned 32-bit words that hold
// them (never a word past the message), the domain byte at len, 0x80 in
// the last byte of the last block.
__device__ __forceinline__ uint64_t load_lane(const uint8_t* __restrict__ msg, int len,
                                              int base, uint8_t ds, int padded_len) {
  uint64_t lane = 0;
  if (base < len) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(msg + base);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(addr & ~uintptr_t(3));
    const int skew = (int)(addr & 3);
    const int avail = skew + len - base;  // message bytes from w[0] on
    const uint32_t w0 = __ldg(w);
    const uint32_t w1 = avail > 4 ? __ldg(w + 1) : 0u;
    const uint32_t w2 = avail > 8 ? __ldg(w + 2) : 0u;
    lane = (uint64_t)__funnelshift_r(w0, w1, 8 * skew) |
           ((uint64_t)__funnelshift_r(w1, w2, 8 * skew) << 32);
    if (len - base < 8) lane &= (1ull << (8 * (len - base))) - 1;
  }
  if ((unsigned)(len - base) < 8u) lane ^= (uint64_t)ds << (8 * (len - base));
  if ((unsigned)(padded_len - 1 - base) < 8u) lane ^= 0x80ull << (8 * (padded_len - 1 - base));
  return lane;
}

// Bytes [pos, pos + 8) of a digest row of out_len bytes, as far as it goes:
// one 64-bit or two 32-bit stores where aligned, else byte by byte.
__device__ __forceinline__ void store_lane(uint8_t* __restrict__ row, int out_len, int pos,
                                           uint64_t v) {
  if (pos >= out_len) return;
  uint8_t* d = row + pos;
  const int nb = min(8, out_len - pos);
  const uintptr_t a = reinterpret_cast<uintptr_t>(d);
  if (nb == 8 && (a & 7) == 0) {
    *reinterpret_cast<uint64_t*>(d) = v;
  } else if (nb == 8 && (a & 3) == 0) {
    reinterpret_cast<uint32_t*>(d)[0] = (uint32_t)v;
    reinterpret_cast<uint32_t*>(d)[1] = (uint32_t)(v >> 32);
  } else {
    for (int j = 0; j < nb; ++j) d[j] = (uint8_t)(v >> (8 * j));
  }
}

__device__ __forceinline__ int row_length(const int32_t* __restrict__ lengths, int64_t row,
                                          int lmax) {
  return min(max(__ldg(lengths + row), 0), lmax);
}

// ---------------------------------------------------------------------------
// Rows path: one sponge a thread, a warp's I/O staged in shared memory
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 4;
constexpr int kRowThreads = 32 * kRowWarps;
constexpr unsigned kFull = 0xffffffffu;

template <int RATE, bool VARLEN>
__global__ void __launch_bounds__(kRowThreads)
    sponge_rows_kernel(const uint8_t* __restrict__ in, const int32_t* __restrict__ lengths,
                       uint8_t* __restrict__ out, int64_t n_rows, int stride, int fixed_len,
                       uint8_t ds, int out_len) {
  constexpr int NW = RATE / 8;  // 9, 17 or 21: odd, so lane-by-row reads hit 16 banks
  __shared__ uint64_t stage_all[kRowWarps][32 * NW];
  const int lane = threadIdx.x & 31;
  uint64_t* stage = stage_all[threadIdx.x >> 5];
  const int64_t row0 = ((int64_t)blockIdx.x * kRowWarps + (threadIdx.x >> 5)) * 32;
  const bool live = row0 + lane < n_rows;
  const int len = !live ? 0 : VARLEN ? row_length(lengths, row0 + lane, stride) : fixed_len;
  const int n_abs = live ? len / RATE + 1 : 0;
  const int n_max = __reduce_max_sync(kFull, n_abs);
  uint64_t s[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) s[i] = 0;
  for (int blk = 0; blk < n_max; ++blk) {
    for (int idx = lane; idx < 32 * NW; idx += 32) {
      const int r = idx / NW, w = idx - r * NW;
      const int r_len = VARLEN ? __shfl_sync(kFull, len, r) : fixed_len;
      const int r_abs = VARLEN ? __shfl_sync(kFull, n_abs, r)
                               : row0 + r < n_rows ? fixed_len / RATE + 1 : 0;
      stage[idx] = blk < r_abs ? load_lane(in + (row0 + r) * stride, r_len, blk * RATE + 8 * w,
                                           ds, r_abs * RATE)
                               : 0;
    }
    __syncwarp();
    if (blk < n_abs) {
#pragma unroll
      for (int w = 0; w < NW; ++w) s[w] ^= stage[lane * NW + w];
      keccak_f1600(s);
    }
    __syncwarp();
  }
  for (int off = 0; off < out_len; off += RATE) {
    if (off && live) keccak_f1600(s);
#pragma unroll
    for (int w = 0; w < NW; ++w) stage[lane * NW + w] = s[w];
    __syncwarp();
    for (int idx = lane; idx < 32 * NW; idx += 32) {
      const int r = idx / NW, w = idx - r * NW;
      if (row0 + r < n_rows) {
        store_lane(out + (row0 + r) * out_len, out_len, off + 8 * w, stage[idx]);
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Split path: five lanes of a warp per sponge
// ---------------------------------------------------------------------------

constexpr int kSplitStates = 6;  // groups of five lanes a warp (lanes 30, 31 idle)
constexpr int kSplitWarps = 2;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kSplitTable = 22;

// Per group lane p (core/keccak_cuda.py builds it): [0, 5) rho amount of
// column slot y; [5, 10) group lane that pi's step k pulls slot k from;
// [10, 12) group lanes of theta's C[x - 1] and C[x + 1]; [12, 17) buffer
// lane that row slot x goes to; [17, 22) buffer lane that column slot y
// comes from.  Loaded by qrp_keccak_init.
__device__ int32_t g_split[5][kSplitTable];

struct SplitLane {
  int rot[5];     // rho amount mod 32
  bool swap[5];   // rho amount >= 32: swap the halves first
  int pi_src[5], theta_m1, theta_p1, wr[5], rd[5];
  uint64_t iota_mask;

  __device__ __forceinline__ void load(int g, int p) {
    const int32_t* t = g_split[p];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int r = __ldg(t + i);
      rot[i] = r & 31;
      swap[i] = r >= 32;
      pi_src[i] = 5 * g + __ldg(t + 5 + i);
      wr[i] = __ldg(t + 12 + i);
      rd[i] = __ldg(t + 17 + i);
    }
    theta_m1 = 5 * g + __ldg(t + 10);
    theta_p1 = 5 * g + __ldg(t + 11);
    iota_mask = p == 0 ? ~0ull : 0ull;
  }
};

__device__ __forceinline__ uint64_t rotl64_var(uint64_t x, int n, bool swap) {
  const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  const uint32_t a = swap ? hi : lo, b = swap ? lo : hi;
  return (uint64_t)__funnelshift_l(b, a, n) | ((uint64_t)__funnelshift_l(a, b, n) << 32);
}

// One round on a group; buf is the group's 25 exchange lanes.
__device__ __forceinline__ void split_round(uint64_t a[5], const SplitLane& sp, unsigned mask,
                                            uint64_t* buf, uint64_t rc) {
  const uint64_t c = a[0] ^ a[1] ^ a[2] ^ a[3] ^ a[4];
  const uint64_t d =
      __shfl_sync(mask, c, sp.theta_m1) ^ rotl64(__shfl_sync(mask, c, sp.theta_p1), 1);
#pragma unroll
  for (int y = 0; y < 5; ++y) a[y] = rotl64_var(a[y] ^ d, sp.rot[y], sp.swap[y]);
  uint64_t b[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) b[k] = __shfl_sync(mask, a[k], sp.pi_src[k]);
  uint64_t e[5];
#pragma unroll
  for (int x = 0; x < 5; ++x) e[x] = b[x] ^ (~b[(x + 1) % 5] & b[(x + 2) % 5]);
  e[0] ^= rc & sp.iota_mask;
#pragma unroll
  for (int x = 0; x < 5; ++x) buf[sp.wr[x]] = e[x];
  __syncwarp(mask);
#pragma unroll
  for (int y = 0; y < 5; ++y) a[y] = buf[sp.rd[y]];
}

__device__ __forceinline__ void split_f1600(uint64_t a[5], const SplitLane& sp, unsigned mask,
                                            uint64_t* buf0, uint64_t* buf1) {
#pragma unroll 1
  for (int r = 0; r < 24; r += 2) {
    split_round(a, sp, mask, buf0, kKeccakRC[r]);
    split_round(a, sp, mask, buf1, kKeccakRC[r + 1]);
  }
}

template <int RATE, bool VARLEN>
__global__ void __launch_bounds__(kSplitThreads)
    sponge_split_kernel(const uint8_t* __restrict__ in, const int32_t* __restrict__ lengths,
                        uint8_t* __restrict__ out, int64_t n_rows, int stride, int fixed_len,
                        uint8_t ds, int out_len) {
  constexpr int NW = RATE / 8;
  __shared__ uint64_t xbuf[kSplitWarps][2][kSplitStates * 25];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / 5, p = lane - 5 * g;
  const int64_t row = ((int64_t)blockIdx.x * kSplitWarps + warp) * kSplitStates + g;
  const bool live = g < kSplitStates && row < n_rows;
  SplitLane sp;
  sp.load(g, p);
  const int gs = g < kSplitStates ? g : 0;
  uint64_t* buf0 = xbuf[warp][0] + 25 * gs;
  uint64_t* buf1 = xbuf[warp][1] + 25 * gs;
  const int len = !live ? 0 : VARLEN ? row_length(lengths, row, stride) : fixed_len;
  const int n_abs = live ? len / RATE + 1 : 0;
  const int padded_len = n_abs * RATE;
  const int n_max = __reduce_max_sync(kFull, n_abs);
  const uint8_t* msg = in + (live ? row : 0) * stride;
  uint64_t a[5] = {0, 0, 0, 0, 0}, nxt[5];
#pragma unroll
  for (int y = 0; y < 5; ++y) {
    const int l = p + 5 * y;
    nxt[y] = live && l < NW ? load_lane(msg, len, 8 * l, ds, padded_len) : 0;
  }
  for (int blk = 0; blk < n_max; ++blk) {
    const bool act = blk < n_abs;
    const unsigned mask = __ballot_sync(kFull, act);
    if (act) {
#pragma unroll
      for (int y = 0; y < 5; ++y) a[y] ^= nxt[y];
      if (blk + 1 < n_abs) {  // the next block's loads fly during this permutation
#pragma unroll
        for (int y = 0; y < 5; ++y) {
          const int l = p + 5 * y;
          nxt[y] = l < NW ? load_lane(msg, len, (blk + 1) * RATE + 8 * l, ds, padded_len) : 0;
        }
      }
      split_f1600(a, sp, mask, buf0, buf1);
    }
  }
  const unsigned mask = __ballot_sync(kFull, live);
  if (!live) return;
  uint8_t* dst = out + row * out_len;
  for (int off = 0;;) {
#pragma unroll
    for (int y = 0; y < 5; ++y) {
      const int l = p + 5 * y;
      if (l < NW) store_lane(dst, out_len, off + 8 * l, a[y]);
    }
    off += RATE;
    if (off >= out_len) break;
    split_f1600(a, sp, mask, buf0, buf1);
  }
}

// ---------------------------------------------------------------------------
// Launch: the split path below kRowsPerSm rows an SM
// ---------------------------------------------------------------------------

// Below 64 rows an SM, a sponge a thread leaves most of the SM's four
// schedulers without a warp, and five lanes a sponge finish first; above
// it, a sponge a thread does less work a round and the rows fill the card.
// Measured on the H100 (132 SMs, PERF.md): rows of one absorb block cross
// over between 8,192 and 12,288 rows, and 9-block rows near 12,288; at
// 20,480 and 40,960 rows the split path takes 1.3-1.6x the rows path's time.
constexpr int64_t kRowsPerSm = 64;

// SM count of each device, read once by qrp_keccak_init
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];

int use_split(int64_t n_rows, bool* split) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || g_sms[dev] == 0) return (int)cudaErrorInitializationError;
  *split = n_rows < kRowsPerSm * g_sms[dev];
  return 0;
}

template <int RATE, bool VARLEN>
int launch(const uint8_t* in, const int32_t* lengths, uint8_t* out, int64_t n_rows, int stride,
           int fixed_len, int ds, int out_len, cudaStream_t stream) {
  bool split = false;
  const int err = use_split(n_rows, &split);
  if (err) return err;
  if (split) {
    const int64_t per_block = (int64_t)kSplitStates * kSplitWarps;
    sponge_split_kernel<RATE, VARLEN>
        <<<(unsigned)((n_rows + per_block - 1) / per_block), kSplitThreads, 0, stream>>>(
            in, lengths, out, n_rows, stride, fixed_len, (uint8_t)ds, out_len);
  } else {
    sponge_rows_kernel<RATE, VARLEN>
        <<<(unsigned)((n_rows + kRowThreads - 1) / kRowThreads), kRowThreads, 0, stream>>>(
            in, lengths, out, n_rows, stride, fixed_len, (uint8_t)ds, out_len);
  }
  return (int)cudaGetLastError();
}

template <bool VARLEN>
int launch_rate(const void* in, const void* lengths, void* out, int64_t n_rows, int stride,
                int fixed_len, int rate, int ds, int out_len, void* stream) {
  if (n_rows <= 0 || out_len <= 0) return (int)cudaSuccess;
  const auto* src = static_cast<const uint8_t*>(in);
  const auto* lens = static_cast<const int32_t*>(lengths);
  auto* dst = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (rate) {
    case 72: return launch<72, VARLEN>(src, lens, dst, n_rows, stride, fixed_len, ds, out_len, st);
    case 136:
      return launch<136, VARLEN>(src, lens, dst, n_rows, stride, fixed_len, ds, out_len, st);
    case 168:
      return launch<168, VARLEN>(src, lens, dst, n_rows, stride, fixed_len, ds, out_len, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Load the split path's table (5 x 22 int32, core/keccak_cuda.py) into the
// current device and read its SM count; the wrapper calls this once for
// each device.
int qrp_keccak_init(const int32_t* table) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(g_split, table, sizeof(g_split));
}

// in: (n_rows, in_len) uint8, out: (n_rows, out_len) uint8, both row-major
// on the device.  rate is 72, 136 or 168 bytes.  Returns a cudaError_t.
int qrp_keccak_sponge(const void* in, void* out, int64_t n_rows, int in_len,
                      int rate, int ds, int out_len, void* stream) {
  return launch_rate<false>(in, nullptr, out, n_rows, in_len, in_len, rate, ds, out_len, stream);
}

// in: (n_rows, lmax) uint8, lengths: (n_rows,) int32 (clamped to
// [0, lmax]), out: (n_rows, out_len) uint8, all row-major on the device.
// Returns a cudaError_t.
int qrp_keccak_sponge_varlen(const void* in, const void* lengths, void* out, int64_t n_rows,
                             int lmax, int rate, int ds, int out_len, void* stream) {
  return launch_rate<true>(in, lengths, out, n_rows, lmax, 0, rate, ds, out_len, stream);
}

const char* qrp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
