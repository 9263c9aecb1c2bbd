// A warp of sponge-a-thread samplers, shared by K2 and K3 (mlkem.cu) and
// K5 and K6 (mldsa.cu).
//
// One warp a block, one sponge a thread, 32 rows a warp.  The warp's seed
// rows are staged through shared memory as aligned 32-bit words, loaded
// coalesced whatever the rows' byte offset (stage_seeds), and each thread
// assembles its seed's lanes from there (absorb_staged).  A rejection
// sampler (K2, K5, K6) then keeps its row's candidates in order: after
// each permutation each thread compacts its own squeezed block from its
// state registers into its column of the warp's ring (append_block: store
// at the column's next slot, move on only past a wanted candidate, no
// branch), and the warp copies the runs to the output rows, two rows a
// step, consecutive lanes to consecutive addresses, every store
// unconditional (flush_ring): after each block, or once a pass where the
// ring holds a row's whole run (K6).  sample_rows drives them.  A
// sampler's candidates are a traits class C:
//
//   using Value             ring slot type (wide enough for a candidate)
//   kSlots                  candidates a squeezed block
//   kLastSlots              candidates of the last block the reference
//                           reads (optional; kSlots if absent)
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

// The staged words one lane reads for a seed of LEN bytes at any byte
// offset: the words that hold it and one more for the funnel shifts.
__host__ __device__ constexpr int staged_seed_words(int len) { return (len + 3) / 4 + 1; }

// Zero the state, absorb this lane's staged seed of LEN bytes (LEN < RATE:
// one padded block of RATE bytes) and permute.  Reads
// staged_seed_words(LEN) words from word (skew + lane * LEN) / 4 of sw on;
// seed word j is the funnel of words j and j + 1, and the lane that holds
// the seed's last bytes takes them masked, with the domain byte after them.
template <int RATE, int LEN>
__device__ __forceinline__ void absorb_staged(uint64_t s[25], const uint32_t* sw, int skew,
                                              int lane, uint8_t ds) {
  static_assert(0 < LEN && LEN < RATE && RATE % 8 == 0, "a seed in one padded block");
  constexpr int kWords = staged_seed_words(LEN), kSeedWords = kWords - 1;
  constexpr int kFull = LEN / 8, kTail = LEN % 8;  // whole 64-bit lanes, bytes after them
  const int o = skew + lane * LEN;
  const uint32_t* p = sw + (o >> 2);
  const int sh = 8 * (o & 3);
  uint32_t w[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) w[k] = p[k];
  uint32_t x[kSeedWords + 2];  // the seed's words, then zeros
#pragma unroll
  for (int k = 0; k < kSeedWords; ++k) x[k] = __funnelshift_r(w[k], w[k + 1], sh);
  x[kSeedWords] = x[kSeedWords + 1] = 0;
#pragma unroll
  for (int k = 0; k < kFull; ++k) s[k] = (uint64_t)x[2 * k] | ((uint64_t)x[2 * k + 1] << 32);
  const uint64_t tail = (uint64_t)x[2 * kFull] | ((uint64_t)x[2 * kFull + 1] << 32);
  s[kFull] = (tail & ((uint64_t{1} << (8 * kTail)) - 1)) | ((uint64_t)ds << (8 * kTail));
#pragma unroll
  for (int k = kFull + 1; k < 25; ++k) s[k] = 0;
  s[RATE / 8 - 1] ^= 0x80ull << 56;
  keccak_f1600(s);
}

// ---------------------------------------------------------------------------
// The ring: C::kSlots * kRingStride values, slot i of lane l at 33 i + l
// ---------------------------------------------------------------------------

constexpr int kRingStride = 33;

// C::kLastSlots where the traits name one, else C::kSlots.
template <class C, class = void>
struct LastSlots {
  static constexpr int value = C::kSlots;
};
template <class C>
struct LastSlots<C, decltype(void(C::kLastSlots))> {
  static constexpr int value = C::kLastSlots;
};

// Whether the ring holds a row's whole run, 256 slots and a block's worth
// of 16 past them: then a pass appends block after block to one run a
// row, copied out once at the pass's end; else each block's run is
// copied out after it.
template <class C>
struct RowRing {
  static constexpr bool value = C::kSlots >= kN + 16;
};

// Append the block's wanted candidates (accepted: below kBound; in the
// second pass rejected) to ring column `lane` from slot `first` on, in
// order: each candidate is stored at the column's next slot, which moves
// on (by a predicated add to a byte offset) only past a wanted one, so no
// branch.  In the `last` block no candidate from kLastSlots on is wanted (a
// compile-time test below it, one more predicate above).  Where the ring
// holds a row's whole run (RowRing), every 16 candidates the next slot is
// clamped to kSlots - 16 (>= 256): no store lands past slot kSlots - 1, and
// the clamp never moves the next slot below 256, so slots 0..255 hold the
// run's first 256.  Returns the slot after the last wanted candidate
// (clamped likewise: past 255 whenever the run is).
template <class C, bool WANT_ACCEPTED>
__device__ __forceinline__ int append_block(const uint64_t s[25], typename C::Value* ring,
                                            int lane, bool last, int first) {
  using V = typename C::Value;
  constexpr int kLast = LastSlots<C>::value, kStride = (int)sizeof(V) * kRingStride;
  static_assert(0 < kLast && kLast <= C::kSlots, "the last block holds at most kSlots");
  // The lane's column is in the base, not in the running offset: each
  // store then takes its address from an add of its own (base + off), and
  // the predicated add to off need not wait for the store to read off.
  // With the column in off (one register for both), K6 ran 10% and K5 3%
  // slower on an H100.
  char* base = reinterpret_cast<char*>(ring) + (int)sizeof(V) * lane;
  int off = first * kStride;
#pragma unroll
  for (int c = 0; c < C::kSlots; ++c) {
    if (RowRing<C>::value && c % 16 == 0) off = min(off, (C::kSlots - 16) * kStride);
    const uint32_t d = C::at(s, c);
    *reinterpret_cast<V*>(base + off) = (V)d;
    if ((d < C::kBound) == WANT_ACCEPTED && (c < kLast || !last)) off += kStride;
  }
  return off / kStride;
}

// Copy each row of `rows` from the ring to its output row: lane r appended
// k (its row's run) after cnt coefficients, of which the first m = 256 -
// cnt at most are kept.  Two rows a step, a half-warp each: lane t copies
// slots t + 16 j of its half's row, consecutive lanes to consecutive
// addresses; a slot past the run is clamped to the run's last, so every
// store is unconditional (it writes the value that slot's own lane writes)
// and no predicate splits the addressing.  A half-warp reads Value indices
// 33 (t + 16 j) + r: 16 consecutive banks for 32-bit values, 16 distinct
// ones for 16-bit and for 8-bit (word (33 (t + 16 j) + r) / 4: t and
// t + 4 are 33 words apart, so the 16 words fall in 16 banks).  A ring
// that holds whole rows (RowRing) copies a full one (m = 256) 64
// coefficients a step, 4 a lane in one 16-byte store: lane t reads slots
// 64 j + 4 t + i, words 33 (16 j + t) + (33 i + r) / 4, again 16 banks a
// half-warp.
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
    if (RowRing<C>::value && m == kN && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      // a whole row (at = 0): 4 coefficients a lane a step, one 16-byte store
      int4* d = reinterpret_cast<int4*>(dst + r * kN) + t;
      const typename C::Value* src = ring + r + 4 * t * kRingStride;
#pragma unroll
      for (int j = 0; j < kN / 64; ++j) {
        const typename C::Value* v = src + 64 * j * kRingStride;
        d[16 * j] = make_int4(v[0], v[kRingStride], v[2 * kRingStride], v[3 * kRingStride]);
      }
    } else if (m > 0) {
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
// no more blocks.  The runs are copied out after each block, or, where the
// ring holds a row's whole run (RowRing), once at the end of the pass.
// `ring` is the block's ring; the seeds are staged in it first.
template <class C>
__device__ __forceinline__ void sample_rows(const uint8_t* __restrict__ seeds,
                                            int32_t* __restrict__ out, int64_t n,
                                            typename C::Value* ring) {
  // the staged seed words, and those lane 31 reads past them (at most one)
  static_assert(C::kSlots * kRingStride * sizeof(typename C::Value) >=
                    4 * ((3 + kWarpRows * C::kSeedLen + 3) / 4 + 1),
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
    const unsigned in_pass = __ballot_sync(kFullMask, cnt < kN);
    if (!in_pass) break;
    stage_seeds<C::kSeedLen>(src, rows, sw, lane);
    uint64_t s[25];
    absorb_staged<C::kRate, C::kSeedLen>(s, sw, skew, lane, 0x1F);
    __syncwarp();
    const int at = cnt;  // where this pass's run starts in the row
    int next = 0;        // the run's next slot in this lane's ring column
    for (int blk = 0; blk < C::kBlocks; ++blk) {
      const unsigned todo = __ballot_sync(kFullMask, cnt < kN);
      if (!todo) break;
      if (cnt < kN) {
        if (blk) keccak_f1600(s);
        const bool last = blk == C::kBlocks - 1;
        next = pass == 0 ? append_block<C, true>(s, ring, lane, last, next)
                         : append_block<C, false>(s, ring, lane, last, next);
      }
      if (!RowRing<C>::value) {  // copy this block's runs out, then start the ring over
        __syncwarp();
        flush_ring<C>(ring, todo, next, cnt, lane, dst);
        __syncwarp();
        cnt += next;
        next = 0;
      } else {
        cnt = at + next;
      }
    }
    if (RowRing<C>::value) {
      __syncwarp();
      flush_ring<C>(ring, in_pass, next, at, lane, dst);
      __syncwarp();
    }
  }
}

}  // namespace qrp
