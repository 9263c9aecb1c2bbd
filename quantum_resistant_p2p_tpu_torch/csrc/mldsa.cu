// ML-DSA (FIPS 204) sampling and NTT kernels for Hopper: K5, K6, K7.
//
// K5 mldsa_rej_ntt      replaces sig/mldsa_pallas.py:rej_ntt_words
// K6 mldsa_rej_bounded  replaces sig/mldsa_pallas.py:rej_bounded_words
// K7 mldsa_ntt          replaces sig/mldsa_pallas.py:ntt_words (forward
//                       and inverse)
//
// K5 and K6 follow K2 (mlkem.cu): one sponge per thread with its state in
// registers (keccak.cuh), the thread's polynomial built in a shared tile
// column and copied out in whole rows (tile.cuh).  The TPU kernels put the
// accepted candidates in order with 512- and 1024-wide bitonic networks;
// a thread that appends them as it parses gets that order for free, and
// stops squeezing once it has 256.  What bounds both is integer throughput:
// ExpandA needs 5 Keccak-f per polynomial and ExpandS 2-3, against 34 or
// 66 seed bytes in and 1 KB out.
//
// K7 gives each polynomial to a half-warp, 16 coefficients a lane in
// registers, 16 polynomials a block of 256 threads (mldsa.cuh holds the
// schedule): stage A runs the layers of length 128..16 in registers, one
// transpose through the half-warp's shared buffer under __syncwarp() turns
// the layout, stage B runs the layers of length 8..1 in registers, and a
// second transpose brings the coefficients back to the layout of the
// coalesced 32-bit loads and stores.  No layer crosses lanes, so no
// shuffle and no block-wide barrier.  Stage A's zetas are the same for
// every lane and come from constant memory at compile-time slots; stage
// B's differ per lane and are loaded once per thread into registers from a
// device table (reading them from constant memory at lane-dependent
// indices would serialise a warp's reads).  Both tables are built in
// Python (sig/mldsa_cuda.py).  Butterflies are lazy, 5 integer operations
// each: one reduction at the end of the forward, and the inverse's last
// layer carries the scaling by 256^-1.  What bounds K7 is bytes: 1 KB in
// and 1 KB out per polynomial against ~6,100 integer operations, about
// 0.75 of the 8,192 that the bound counts per transform.  The grid is at
// most one wave of resident blocks; each warp loops over polynomial pairs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mldsa.cuh"

namespace {

using qrp::kN;
using qrp::kPolys;
using qrp::kTileRows;
using qrp::store_tile;

__global__ void __launch_bounds__(kPolys)
    rej_ntt_kernel(const uint8_t* __restrict__ seeds, int32_t* __restrict__ out,
                   int64_t n) {
  __shared__ int32_t tile[kN * kTileRows];
  const int64_t row0 = (int64_t)blockIdx.x * kPolys;
  const int64_t row = row0 + threadIdx.x;
  if (row < n) qrp::rej_ntt_poly(seeds + row * qrp::kRejNttSeedLen, tile + threadIdx.x);
  __syncthreads();
  store_tile(tile, out, row0, n);
}

template <int ETA>
__global__ void __launch_bounds__(kPolys)
    rej_bounded_kernel(const uint8_t* __restrict__ seeds, int32_t* __restrict__ out,
                       int64_t n) {
  __shared__ int32_t tile[kN * kTileRows];
  const int64_t row0 = (int64_t)blockIdx.x * kPolys;
  const int64_t row = row0 + threadIdx.x;
  if (row < n) {
    qrp::rej_bounded_poly<ETA>(seeds + row * qrp::kRejBoundedSeedLen, tile + threadIdx.x);
  }
  __syncthreads();
  store_tile(tile, out, row0, n);
}

constexpr int kNttWarps = 8;
constexpr int kNttThreads = 32 * kNttWarps;
// words of a warp's transpose buffers: 320 for each half-warp's
// polynomial (256 + 4 every 16), the second one 16 banks after the first
constexpr int kNttHalfWords = 336;
constexpr int kNttWarpWords = 672;

template <bool INVERSE>
__global__ void __launch_bounds__(kNttThreads, 2)
    ntt_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t bufs[kNttWarps * kNttWarpWords];
  const int lane = threadIdx.x & 31, t = lane & 15, half = lane >> 4;
  const int warp = threadIdx.x >> 5;
  uint32_t* buf = bufs + warp * kNttWarpWords + half * kNttHalfWords;
  qrp::LaneZetas zb;
  zb.load<INVERSE>(t);
  const int64_t pairs = (n + 1) / 2;
  for (int64_t pair = (int64_t)blockIdx.x * kNttWarps + warp; pair < pairs;
       pair += (int64_t)gridDim.x * kNttWarps) {
    const int64_t poly = 2 * pair + half;
    const bool live = poly < n;
    const int32_t* src = in + poly * kN + t;
    uint32_t f[qrp::kNttRegs];
#pragma unroll
    for (int j = 0; j < qrp::kNttRegs; ++j) f[j] = live ? (uint32_t)__ldg(src + 16 * j) : 0u;
    if (!INVERSE) {
      qrp::ntt_stage_fwd(f, qrp::UniformZetas<false>());
      qrp::ntt_a_to_b(f, buf, t);
      qrp::ntt_stage_fwd(f, zb);
#pragma unroll
      for (int j = 0; j < qrp::kNttRegs; ++j) f[j] = qrp::reduce_dsa(f[j]);
      qrp::ntt_b_to_a(f, buf, t);
    } else {
      qrp::ntt_a_to_b(f, buf, t);
      qrp::ntt_stage_inv(f, zb, qrp::kDsaQ);
      qrp::ntt_b_to_a(f, buf, t);
      qrp::ntt_stage_a_inv_scaled(f);
    }
    if (live) {
      int32_t* dst = out + poly * kN + t;
#pragma unroll
      for (int j = 0; j < qrp::kNttRegs; ++j) dst[16 * j] = (int32_t)f[j];
    }
  }
}

// One wave of K7 blocks on each device, forward and inverse: the blocks
// that fit on its SMs at once, read once by qrp_mldsa_init.
constexpr int kMaxDevices = 64;
int64_t g_ntt_wave[kMaxDevices][2];

template <bool INVERSE>
cudaError_t ntt_wave(int dev, int sms) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ntt_kernel<INVERSE>, kNttThreads, 0);
  g_ntt_wave[dev][INVERSE] = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

// Blocks of a K7 launch: enough for every polynomial pair, at most one wave.
int ntt_grid(int64_t n, int inverse, unsigned* grid) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || g_ntt_wave[dev][inverse] == 0) {
    return (int)cudaErrorInitializationError;
  }
  const int64_t want = (n + 2 * kNttWarps - 1) / (2 * kNttWarps);
  const int64_t wave = g_ntt_wave[dev][inverse];
  *grid = (unsigned)(want < wave ? want : wave);
  return 0;
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kPolys - 1) / kPolys); }

}  // namespace

extern "C" {

// Load K7's zeta tables into the current device (sig/mldsa_cuda.py builds
// them): `uniform` is 2 x 2 x 16 words into constant memory, `lanes`
// 2 x 2 x 15 x 16 words into a device table; and size K7's grid for the
// device.  All are per device: the wrapper calls this once for each
// device, before the first kernel that runs there.
int qrp_mldsa_init(const uint32_t* uniform, const uint32_t* lanes) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = ntt_wave<false>(dev, sms);
  if (err == cudaSuccess) err = ntt_wave<true>(dev, sms);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbol(qrp::c_dsa_ntt_uniform, uniform, sizeof(qrp::c_dsa_ntt_uniform));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(qrp::g_dsa_ntt_lanes, lanes, sizeof(qrp::g_dsa_ntt_lanes));
}

// seeds: (n, 34) uint8 rows rho || s || r; out: (n, 256) int32.
int qrp_mldsa_rej_ntt(const void* seeds, void* out, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  rej_ntt_kernel<<<blocks_for(n), kPolys, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seeds), static_cast<int32_t*>(out), n);
  return (int)cudaGetLastError();
}

// seeds: (n, 66) uint8 rows rho' || n; out: (n, 256) int32 raw nibbles.
int qrp_mldsa_rej_bounded(const void* seeds, void* out, int64_t n, int eta, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const auto* src = static_cast<const uint8_t*>(seeds);
  auto* dst = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (eta == 2) rej_bounded_kernel<2><<<blocks_for(n), kPolys, 0, st>>>(src, dst, n);
  else if (eta == 4) rej_bounded_kernel<4><<<blocks_for(n), kPolys, 0, st>>>(src, dst, n);
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
  const int err = ntt_grid(n, inverse ? 1 : 0, &grid);
  if (err) return err;
  if (inverse) ntt_kernel<true><<<grid, kNttThreads, 0, st>>>(src, dst, n);
  else ntt_kernel<false><<<grid, kNttThreads, 0, st>>>(src, dst, n);
  return (int)cudaGetLastError();
}

const char* qrp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
