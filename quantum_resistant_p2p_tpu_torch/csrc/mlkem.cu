// ML-KEM (FIPS 203) sampling and NTT kernels for Hopper: K2, K3, K4.
//
// K2 mlkem_sample_ntt   replaces kem/mlkem_pallas.py:sample_ntt_words
// K3 mlkem_prf_cbd      replaces kem/mlkem_pallas.py:cbd_words (fuse_ntt 0)
//                       and :cbd_ntt_words (fuse_ntt 1)
// K4 mlkem_ntt          replaces kem/mlkem_pallas.py:ntt_words
//
// K2 and K3: one warp a block, one sponge a thread (state in registers,
// keccak.cuh), 32 rows a warp.  What bounds them is integer issue: a
// Keccak-f is 24 rounds of 200 SASS instructions (136 LOP3, 58 SHF, all on
// the integer pipe), 3-4 of them a K2 row and 1-2 a K3 row, with the NTT
// fused 896 butterflies a polynomial more, against 33-34 seed bytes in and
// 1 KB out.  One warp a scheduler already fills the pipe with the rounds
// (K2 without its parse takes 2.3x as long at 36,864 rows as at 16,896), so
// what the design controls is the instructions around the rounds:
//
// * Seeds in: the warp loads its rows' bytes as consecutive aligned 32-bit
//   words into shared memory (coalesced, rows at any byte offset), and each
//   thread assembles its seed's lanes from there (warp_sampler.cuh:
//   stage_seeds, absorb_staged).
// * K2: each thread compacts its own row's block from its state registers
//   into its column of a 112-slot uint16 ring (warp_sampler.cuh:
//   append_block, five instructions a candidate, no branch), then the warp
//   copies the 32 new runs to the output rows, two rows a step, consecutive
//   lanes to consecutive addresses (flush_ring), each row's running count
//   held by its own lane.  Rows that need a 4th block permute under a
//   mask; a row short of 256 after 448 candidates takes a second pass for
//   the rejected ones.  A first version staged each block and parsed it with all 32
//   lanes, ranking candidates by ballots: ~65 warp instructions a row and
//   block (4 VOTE, 8 POPC, scattered predicated stores), 0.093 ms at 36,864
//   rows on the H100 against 0.081 for the ring.
// * K3: after each permutation every thread writes its rate block to the
//   warp's staging buffer (an odd number of 64-bit lanes a row: no bank
//   conflicts); positions are fixed, so the 32 lanes take one row at a
//   time, each decoding 8 coefficients (4 or 6 bytes) and storing them
//   with two 16-byte stores, a whole row a warp instruction pair.
// * K3 with the NTT fused: a half-warp a polynomial in K7's layout
//   (mlkem.cuh: kem_ntt_forward, on ntt_halfwarp.cuh): the decoded
//   coefficients go straight into registers (lane t coefficient t + 16 j),
//   four layers in registers, one transpose, three layers, a Shoup
//   reduction, a transpose back, and coalesced 32-bit stores; lazy Shoup
//   butterflies (no % anywhere).
//
// No 32 x 256 shared tile: a warp holds 4.3-7.4 KB (+2.6 KB of transpose
// buffer when fused), so registers, not shared memory, set how many warps
// an SM keeps.
//
// K4 takes K7's design (mldsa.cu) on the same half-warp NTT as K3's fused
// one (ntt_halfwarp.cuh): a half-warp a polynomial, 16 coefficients a lane
// in registers, coalesced 32-bit loads and stores, lazy Shoup butterflies
// (no %), one transpose each way under __syncwarp() (no block barrier),
// stage B's zetas in registers; the inverse's scaling by 128^-1 is folded
// into its last layer.  It reads and writes 1 KB per polynomial against
// ~5,500 integer operations, so device-memory bytes bound it.  The grid is
// at most one wave of resident blocks; each warp loops over polynomial
// pairs.  The first design (a block of 128 threads a polynomial in shared
// memory, a barrier between layers, % after every product, zetas from
// constant memory at lane-dependent indices) ran at ~3x the bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlkem.cuh"

namespace {

using qrp::kN;

constexpr int kWarp = qrp::kWarpRows;

__global__ void __launch_bounds__(kWarp)
    sample_ntt_kernel(const uint8_t* __restrict__ seeds, int32_t* __restrict__ out,
                      int64_t n) {
  __shared__ __align__(16)
      qrp::SampleNttCands::Value ring[qrp::SampleNttCands::kSlots * qrp::kRingStride];
  qrp::sample_rows<qrp::SampleNttCands>(seeds, out, n, ring);
}

template <int ETA, bool FUSE_NTT>
__global__ void __launch_bounds__(kWarp)
    prf_cbd_kernel(const uint8_t* __restrict__ seeds, int32_t* __restrict__ out,
                   int64_t n) {
  using Stage = qrp::PrfStage<ETA>;
  __shared__ uint64_t stage[kWarp * Stage::kStride];
  __shared__ __align__(16) uint32_t ntt_buf[FUSE_NTT ? qrp::kNttWarpWords : 4];
  uint32_t* sw = reinterpret_cast<uint32_t*>(stage);
  const int lane = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * kWarp;
  const int rows = qrp::warp_rows(row0, n);
  const uint8_t* src = seeds + row0 * qrp::kPrfSeedLen;
  int32_t* dst = out + row0 * kN;
  qrp::stage_seeds<qrp::kPrfSeedLen>(src, rows, sw, lane);
  uint64_t s[25];
  qrp::absorb_staged<qrp::kPrfRate, qrp::kPrfSeedLen>(
      s, sw, (int)(reinterpret_cast<uintptr_t>(src) & 3), lane, 0x1F);
  __syncwarp();
  // the row's 64 eta bytes: eta 2 the first 128 bytes of the first block;
  // eta 3 all 136 and the second block's first 56 (chunk 45 spans the two)
#pragma unroll
  for (int w = 0; w < (ETA == 2 ? 16 : 17); ++w) stage[lane * Stage::kStride + w] = s[w];
  if (ETA == 3) {
    qrp::keccak_f1600(s);
#pragma unroll
    for (int w = 0; w < 7; ++w) stage[lane * Stage::kStride + 17 + w] = s[w];
  }
  __syncwarp();
  if (!FUSE_NTT) {
    // lane l: coefficients 8 l .. 8 l + 7, from bytes 4 l (eta 2) or 6 l (eta 3)
    for (int r = 0; r < rows; ++r) {
      const uint32_t* row = sw + r * Stage::kWords;
      int32_t c[8];
      if (ETA == 2) {
        qrp::cbd2_word(row[lane], c);
      } else {
        uint32_t c0, c1;
        qrp::row_six_bytes(row, lane, &c0, &c1);
        qrp::cbd3_chunk(c0, c);
        qrp::cbd3_chunk(c1, c + 4);
      }
      int4* d = reinterpret_cast<int4*>(dst + r * kN + 8 * lane);
      d[0] = make_int4(c[0], c[1], c[2], c[3]);
      d[1] = make_int4(c[4], c[5], c[6], c[7]);
    }
  } else {
    // half-warp h: rows r0 + h, two rows a step
    const int t = lane & 15, half = lane >> 4;
    uint32_t* buf = ntt_buf + half * qrp::kNttHalfWords;
    const auto zb = qrp::kem_lane_zetas<false>(t);
    for (int r0 = 0; r0 < rows; r0 += 2) {
      const int r = r0 + half;
      const uint32_t* row = sw + r * Stage::kWords;
      uint32_t f[qrp::kNttRegs];
      // lane t's coefficient t + 16 j: bits [2 eta (t + 16 j), + 2 eta)
#pragma unroll
      for (int j = 0; j < qrp::kNttRegs; ++j) {
        if (ETA == 2) {
          f[j] = qrp::cbd_lazy<2>((row[2 * j + (t >> 3)] >> (4 * (t & 7))) & 0xFu);
        } else {
          const int a = 3 * j + ((6 * t) >> 5);
          f[j] = qrp::cbd_lazy<3>(__funnelshift_r(row[a], row[a + 1], (6 * t) & 31) & 63u);
        }
      }
      qrp::kem_ntt_forward(f, zb, buf, t);
      if (r < rows) {
        int32_t* d = dst + r * kN + t;
#pragma unroll
        for (int j = 0; j < qrp::kNttRegs; ++j) d[16 * j] = (int32_t)f[j];
      }
    }
  }
}

template <bool INVERSE>
__global__ void __launch_bounds__(qrp::kNttThreads, 2)
    kem_ntt_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t bufs[qrp::kNttWarps * qrp::kNttWarpWords];
  const auto zb = qrp::kem_lane_zetas<INVERSE>(threadIdx.x & 15);
  qrp::ntt_pairs(in, out, n, bufs, [&](uint32_t f[qrp::kNttRegs], uint32_t* buf, int t) {
    if (!INVERSE) qrp::kem_ntt_forward(f, zb, buf, t);
    else qrp::kem_ntt_inverse(f, zb, buf, t);
  });
}

// One wave of K4 blocks on each device, set by qrp_mlkem_init_ntt.
qrp::NttWaves g_ntt_wave;

unsigned blocks_for(int64_t n) { return (unsigned)((n + kWarp - 1) / kWarp); }

}  // namespace

extern "C" {

// Load the NTT tables of K3's fused NTT and K4 (kem/mlkem_cuda.py builds
// them) into the current device: `uniform` 2 x 2 x 16 words (direction,
// stage A's zetas then their Shoup companions, slot) into constant memory,
// `lanes` 2 x 2 x 7 x 16 (direction, zeta or companion, stage B's slot,
// lane) into a device table; and size K4's grid for the device.  All are
// per device: the wrapper calls this once for each device, before the
// first kernel that runs there.
int qrp_mlkem_init_ntt(const uint32_t* uniform, const uint32_t* lanes) {
  cudaError_t err = qrp::size_ntt_waves(g_ntt_wave, kem_ntt_kernel<false>, kem_ntt_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbol(qrp::c_kem_ntt_uniform, uniform, sizeof(qrp::c_kem_ntt_uniform));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(qrp::g_kem_ntt_lanes, lanes, sizeof(qrp::g_kem_ntt_lanes));
}

// seeds: (n, 34) uint8 rows rho || j || i; out: (n, 256) int32.
int qrp_mlkem_sample_ntt(const void* seeds, void* out, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  sample_ntt_kernel<<<blocks_for(n), kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seeds), static_cast<int32_t*>(out), n);
  return (int)cudaGetLastError();
}

// seeds: (n, 33) uint8 rows s || b; out: (n, 256) int32 in [0, q).
int qrp_mlkem_prf_cbd(const void* seeds, void* out, int64_t n, int eta, int fuse_ntt,
                      void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const auto* src = static_cast<const uint8_t*>(seeds);
  auto* dst = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n);
  if (eta == 2 && !fuse_ntt) prf_cbd_kernel<2, false><<<blocks, kWarp, 0, st>>>(src, dst, n);
  else if (eta == 2) prf_cbd_kernel<2, true><<<blocks, kWarp, 0, st>>>(src, dst, n);
  else if (eta == 3 && !fuse_ntt) prf_cbd_kernel<3, false><<<blocks, kWarp, 0, st>>>(src, dst, n);
  else if (eta == 3) prf_cbd_kernel<3, true><<<blocks, kWarp, 0, st>>>(src, dst, n);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// in, out: (n, 256) int32 in [0, q).
int qrp_mlkem_ntt(const void* in, void* out, int64_t n, int inverse, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const auto* src = static_cast<const int32_t*>(in);
  auto* dst = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  unsigned grid = 0;
  const int err = qrp::ntt_grid(g_ntt_wave, n, inverse ? 1 : 0, &grid);
  if (err) return err;
  if (inverse) kem_ntt_kernel<true><<<grid, qrp::kNttThreads, 0, st>>>(src, dst, n);
  else kem_ntt_kernel<false><<<grid, qrp::kNttThreads, 0, st>>>(src, dst, n);
  return (int)cudaGetLastError();
}

const char* qrp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
