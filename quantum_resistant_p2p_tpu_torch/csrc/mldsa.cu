// ML-DSA (FIPS 204) sampling and NTT kernels for Hopper: K5, K6, K7.
//
// K5 mldsa_rej_ntt      replaces sig/mldsa_pallas.py:rej_ntt_words
// K6 mldsa_rej_bounded  replaces sig/mldsa_pallas.py:rej_bounded_words
// K7 mldsa_ntt          replaces sig/mldsa_pallas.py:ntt_words (forward
//                       and inverse)
//
// The TPU kernels put the accepted candidates in order with 512- and
// 1024-wide bitonic networks; a thread that appends them as it parses gets
// that order for free, and stops squeezing once it has 256.  What bounds
// K5 and K6 is integer throughput: ExpandA needs 5 Keccak-f per polynomial
// and ExpandS 1-3 (4,800 SASS instructions each on the integer pipe),
// against 34 or 66 seed bytes in and 1 KB out.
//
// K5 and K6 run on K2's design (warp_sampler.cuh, mlkem.cu): one warp a
// block, one sponge a thread with its state in registers (keccak.cuh), 32
// rows a warp, the seeds staged coalesced through shared memory; after
// each permutation each thread appends its block's candidates to its
// column of the warp's ring, and the warp copies the runs out, two rows a
// step, with unconditional stores; a row permutes a block only while it
// lacks coefficients.  K5 appends 56 23-bit candidates to a 56-slot
// uint32 ring (7,392 B a warp) and copies each block's runs out after it.
// K6 appends 272 nibbles to a 272-slot uint8 ring (8,976 B), which holds a
// row's whole run, so the warp copies each row out once a pass, a full row
// in 16-byte stores.  With no tile, registers set how many warps an SM
// keeps.  The first design built each polynomial in a 33.8 KB shared tile
// column, reading each candidate byte by byte, which held an SM to 6
// one-warp blocks.
//
// K7 gives each polynomial to a half-warp, 16 coefficients a lane in
// registers, 16 polynomials a block of 256 threads (ntt_halfwarp.cuh holds
// the schedule, which K3's fused NTT and K4 share): stage A runs the layers
// of length 128..16 in registers, one transpose through the half-warp's
// shared buffer under __syncwarp() turns the layout, stage B runs the
// layers of length 8..1 in registers, and a second transpose brings the
// coefficients back to the layout of the coalesced 32-bit loads and
// stores.  No layer crosses lanes, so no shuffle and no block-wide
// barrier.  Stage A's zetas are the same for every lane and come from
// constant memory at compile-time slots; stage B's differ per lane and are
// loaded once per thread into registers from a device table (reading them
// from constant memory at lane-dependent indices would serialise a warp's
// reads).  Both tables are built in Python (sig/mldsa_cuda.py).
// Butterflies are lazy, 5 integer operations each: one reduction at the
// end of the forward, and the inverse's last layer carries the scaling by
// 256^-1.  What bounds K7 is bytes: 1 KB in and 1 KB out per polynomial
// against ~6,100 integer operations, about 0.75 of the 8,192 that the
// bound counts per transform.  The grid is at most one wave of resident
// blocks; each warp loops over polynomial pairs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mldsa.cuh"

namespace {

__global__ void __launch_bounds__(qrp::kWarpRows)
    rej_ntt_kernel(const uint8_t* __restrict__ seeds, int32_t* __restrict__ out,
                   int64_t n) {
  __shared__ __align__(16)
      qrp::RejNttCands::Value ring[qrp::RejNttCands::kSlots * qrp::kRingStride];
  qrp::sample_rows<qrp::RejNttCands>(seeds, out, n, ring);
}

template <int ETA>
__global__ void __launch_bounds__(qrp::kWarpRows)
    rej_bounded_kernel(const uint8_t* __restrict__ seeds, int32_t* __restrict__ out,
                       int64_t n) {
  using Cands = qrp::RejBoundedCands<ETA>;
  using Slot = typename Cands::Value;
  __shared__ __align__(16) Slot ring[Cands::kSlots * qrp::kRingStride];
  qrp::sample_rows<Cands>(seeds, out, n, ring);
}

template <bool INVERSE>
__global__ void __launch_bounds__(qrp::kNttThreads, 2)
    ntt_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t bufs[qrp::kNttWarps * qrp::kNttWarpWords];
  const auto zb = qrp::dsa_lane_zetas<INVERSE>(threadIdx.x & 15);
  qrp::ntt_pairs(in, out, n, bufs, [&](uint32_t f[qrp::kNttRegs], uint32_t* buf, int t) {
    if (!INVERSE) {
      qrp::ntt_stage_fwd<qrp::kDsaQ, 1>(f, qrp::UniformZetas<false>());
      qrp::ntt_a_to_b(f, buf, t);
      qrp::ntt_stage_fwd<qrp::kDsaQ, 1>(f, zb);
#pragma unroll
      for (int j = 0; j < qrp::kNttRegs; ++j) f[j] = qrp::reduce_dsa(f[j]);
      qrp::ntt_b_to_a(f, buf, t);
    } else {
      qrp::ntt_a_to_b(f, buf, t);
      qrp::ntt_stage_inv<qrp::kDsaQ, 1>(f, zb, qrp::kDsaQ);
      qrp::ntt_b_to_a(f, buf, t);
      qrp::ntt_stage_a_inv_scaled<qrp::kDsaQ>(f, qrp::UniformZetas<true>(), 16 * qrp::kDsaQ);
    }
  });
}

// One wave of K7 blocks on each device, set by qrp_mldsa_init.
qrp::NttWaves g_ntt_wave;

unsigned blocks_for(int64_t n) { return (unsigned)((n + qrp::kWarpRows - 1) / qrp::kWarpRows); }

}  // namespace

extern "C" {

// Load K7's zeta tables into the current device (sig/mldsa_cuda.py builds
// them): `uniform` is 2 x 2 x 16 words into constant memory, `lanes`
// 2 x 2 x 15 x 16 words into a device table; and size K7's grid for the
// device.  All are per device: the wrapper calls this once for each
// device, before the first kernel that runs there.
int qrp_mldsa_init(const uint32_t* uniform, const uint32_t* lanes) {
  cudaError_t err = qrp::size_ntt_waves(g_ntt_wave, ntt_kernel<false>, ntt_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbol(qrp::c_dsa_ntt_uniform, uniform, sizeof(qrp::c_dsa_ntt_uniform));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(qrp::g_dsa_ntt_lanes, lanes, sizeof(qrp::g_dsa_ntt_lanes));
}

// seeds: (n, 34) uint8 rows rho || s || r; out: (n, 256) int32.
int qrp_mldsa_rej_ntt(const void* seeds, void* out, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  rej_ntt_kernel<<<blocks_for(n), qrp::kWarpRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seeds), static_cast<int32_t*>(out), n);
  return (int)cudaGetLastError();
}

// seeds: (n, 66) uint8 rows rho' || n; out: (n, 256) int32 raw nibbles.
int qrp_mldsa_rej_bounded(const void* seeds, void* out, int64_t n, int eta, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const auto* src = static_cast<const uint8_t*>(seeds);
  auto* dst = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (eta == 2) rej_bounded_kernel<2><<<blocks_for(n), qrp::kWarpRows, 0, st>>>(src, dst, n);
  else if (eta == 4) rej_bounded_kernel<4><<<blocks_for(n), qrp::kWarpRows, 0, st>>>(src, dst, n);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// in, out: (n, 256) int32 in [0, q).
int qrp_mldsa_ntt(const void* in, void* out, int64_t n, int inverse, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const auto* src = static_cast<const int32_t*>(in);
  auto* dst = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  unsigned grid = 0;
  const int err = qrp::ntt_grid(g_ntt_wave, n, inverse ? 1 : 0, &grid);
  if (err) return err;
  if (inverse) ntt_kernel<true><<<grid, qrp::kNttThreads, 0, st>>>(src, dst, n);
  else ntt_kernel<false><<<grid, qrp::kNttThreads, 0, st>>>(src, dst, n);
  return (int)cudaGetLastError();
}

const char* qrp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
