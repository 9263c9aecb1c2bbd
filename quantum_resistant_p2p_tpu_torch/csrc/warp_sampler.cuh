// A warp of sponge-a-thread samplers, shared by K2 and K3 (mlkem.cu) and
// K5 (mldsa.cu).
//
// One warp a block, one sponge a thread, 32 rows a warp.  The warp's seed
// rows are staged through shared memory as aligned 32-bit words, loaded
// coalesced whatever the rows' byte offset (stage_seeds), and each thread
// assembles its seed's lanes from there (absorb_staged).  A rejection
// sampler (K2, K5) then keeps its row's candidates in order: after each
// permutation each thread compacts its own squeezed block from its state
// registers into its column of the warp's ring (append_block: store at the
// column's next slot, move on only past a wanted candidate, no branch),
// and the warp copies the 32 new runs to the output rows, two rows a step,
// consecutive lanes to consecutive addresses, every store unconditional
// (flush_ring).  sample_rows drives both.  A sampler's candidates are a
// traits class C:
//
//   using Value             ring slot type (wide enough for a candidate)
//   kSlots                  candidates a squeezed block
//   kBlocks                 blocks the reference squeezes at most
//   kRate, kSeedLen         SHAKE rate and seed bytes (one padded block)
//   kBound                  a candidate is accepted below it
//   at(s, c)                candidate c of the block in state s (c is a
//                           compile-time constant wherever it is called)
#pragma once

#include <stdint.h>

#include "keccak.cuh"

namespace qrp {

constexpr int kN = 256;
constexpr int kWarpRows = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// This block's rows: [row0, row0 + rows) of n.
__device__ __forceinline__ int warp_rows(int64_t row0, int64_t n) {
  return n - row0 < kWarpRows ? (int)(n - row0) : kWarpRows;
}

// ---------------------------------------------------------------------------
// Seeds in
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
// The ring: C::kSlots * kRingStride values, slot i of lane l at 33 i + l
// ---------------------------------------------------------------------------

constexpr int kRingStride = 33;

// Append the block's wanted candidates (accepted: below kBound; in the
// second pass rejected) to ring column `lane` in order: each candidate is
// stored at the column's next slot, which moves on (by a predicated add to
// a byte offset) only past a wanted one, so no branch and no slot past
// kSlots - 1.  Returns how many were wanted.
template <class C, bool WANT_ACCEPTED>
__device__ __forceinline__ int append_block(const uint64_t s[25], typename C::Value* ring,
                                            int lane) {
  using V = typename C::Value;
  char* base = reinterpret_cast<char*>(ring);
  int off = (int)sizeof(V) * lane;
#pragma unroll
  for (int c = 0; c < C::kSlots; ++c) {
    const uint32_t d = C::at(s, c);
    *reinterpret_cast<V*>(base + off) = (V)d;
    if ((d < C::kBound) == WANT_ACCEPTED) off += (int)sizeof(V) * kRingStride;
  }
  return (off - (int)sizeof(V) * lane) / ((int)sizeof(V) * kRingStride);
}

// Copy each row of `rows` from the ring to its output row: lane r appended
// k (its row's run) after cnt coefficients, of which the first 256 - cnt
// are kept.  Two rows a step, a half-warp each: lane t copies slots t + 16 j
// of its half's row, consecutive lanes to consecutive addresses; a slot
// past the run is clamped to the run's last, so every store is
// unconditional (it writes the value that slot's own lane writes) and no
// predicate splits the addressing.  A half-warp reads Value indices
// 33 (t + 16 j) + r: 16 consecutive banks for 32-bit values, 16 distinct
// ones for 16-bit.
template <class C>
__device__ __forceinline__ void flush_ring(const typename C::Value* ring, unsigned rows, int k,
                                           int cnt, int lane, int32_t* __restrict__ dst) {
  constexpr int kSteps = (C::kSlots + 15) / 16;
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
      const typename C::Value* src = ring + r;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int i = min(t + 16 * j, m - 1);
        d[i] = (int32_t)src[i * kRingStride];
      }
    }
  }
}

// A rejection sampler's block: SHAKE(seed) of each of its 32 rows, squeezed
// a block at a time while the row has fewer than 256 coefficients, at most
// kBlocks blocks; accepted candidates in order, and where kBlocks blocks
// give fewer than 256, a second pass that appends the rejected ones in
// order, as the reference's sort key (accepted before rejected, index order
// within each) puts them in the tail.  A row whose count is full permutes
// no more blocks.  `ring` is the block's ring; the seeds are staged in it
// first.
template <class C>
__device__ __forceinline__ void sample_rows(const uint8_t* __restrict__ seeds,
                                            int32_t* __restrict__ out, int64_t n,
                                            typename C::Value* ring) {
  static_assert(C::kSlots * kRingStride * sizeof(typename C::Value) >=
                    4 * ((3 + kWarpRows * C::kSeedLen + 3) / 4 + 10),
                "the staged seeds fit in the ring");
  uint32_t* sw = reinterpret_cast<uint32_t*>(ring);
  const int lane = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * kWarpRows;
  const int rows = warp_rows(row0, n);
  const uint8_t* src = seeds + row0 * C::kSeedLen;
  const int skew = (int)(reinterpret_cast<uintptr_t>(src) & 3);
  int32_t* dst = out + row0 * kN;
  int cnt = lane < rows ? 0 : kN;  // coefficients of this lane's row so far
  for (int pass = 0; pass < 2; ++pass) {  // 0: accepted candidates, 1: rejected ones
    if (!__ballot_sync(kFullMask, cnt < kN)) break;
    stage_seeds<C::kSeedLen>(src, rows, sw, lane);
    uint64_t s[25];
    absorb_staged<C::kRate, C::kSeedLen>(s, sw, skew, lane, 0x1F);
    __syncwarp();
    for (int blk = 0; blk < C::kBlocks; ++blk) {
      const unsigned todo = __ballot_sync(kFullMask, cnt < kN);
      if (!todo) break;
      int k = 0;
      if (cnt < kN) {
        if (blk) keccak_f1600(s);
        k = pass == 0 ? append_block<C, true>(s, ring, lane)
                      : append_block<C, false>(s, ring, lane);
      }
      __syncwarp();
      flush_ring<C>(ring, todo, k, cnt, lane, dst);
      cnt += k;
      __syncwarp();
    }
  }
}

}  // namespace qrp
