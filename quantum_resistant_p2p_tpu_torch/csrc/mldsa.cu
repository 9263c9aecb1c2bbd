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
// K7 gives each polynomial to a block of 128 threads: one butterfly per
// thread per layer, the polynomial in shared memory, a barrier between
// layers, as K4 does.  The zeta products are Shoup products in 32 bits
// (mldsa.cuh), which need no 64-bit multiply or division; zetas and their
// Shoup companions come from constant memory, and in the layers whose
// groups are shorter than a warp the threads of a warp read different
// zetas, which the constant cache serialises.  It reads and writes 1 KB
// per polynomial against ~11k integer operations: bytes and operations
// bound it about equally.
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

constexpr int kNttThreads = 128;

template <bool INVERSE>
__global__ void __launch_bounds__(kNttThreads)
    ntt_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out) {
  __shared__ uint32_t f[kN];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kN;
  f[t] = (uint32_t)in[base + t];
  f[t + kNttThreads] = (uint32_t)in[base + t + kNttThreads];
  __syncthreads();
  if (!INVERSE) {
#pragma unroll
    for (int len = 128; len >= 1; len >>= 1) {
      qrp::dsa_ntt_butterfly<false>(f, t, len);
      __syncthreads();
    }
    out[base + t] = (int32_t)f[t];
    out[base + t + kNttThreads] = (int32_t)f[t + kNttThreads];
  } else {
#pragma unroll
    for (int len = 1; len <= 128; len <<= 1) {
      qrp::dsa_ntt_butterfly<true>(f, t, len);
      __syncthreads();
    }
    out[base + t] = (int32_t)qrp::mulmod_shoup(f[t], qrp::kDsaNInv, qrp::kDsaNInvShoup);
    out[base + t + kNttThreads] =
        (int32_t)qrp::mulmod_shoup(f[t + kNttThreads], qrp::kDsaNInv, qrp::kDsaNInvShoup);
  }
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kPolys - 1) / kPolys); }

}  // namespace

extern "C" {

// Load the 256 zetas (1753^bitrev8(i) mod q) and their Shoup companions
// floor(zeta * 2^32 / q) into the constant memory of the current device.
// __constant__ memory is per device: the wrapper calls this once for each
// device, before the first kernel that runs there.
int qrp_mldsa_init(const uint32_t* zetas, const uint32_t* zetas_shoup) {
  cudaError_t err = cudaMemcpyToSymbol(qrp::c_dsa_zetas, zetas, sizeof(uint32_t) * 256);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(qrp::c_dsa_zetas_shoup, zetas_shoup, sizeof(uint32_t) * 256);
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
  if (inverse) ntt_kernel<true><<<(unsigned)n, kNttThreads, 0, st>>>(src, dst);
  else ntt_kernel<false><<<(unsigned)n, kNttThreads, 0, st>>>(src, dst);
  return (int)cudaGetLastError();
}

const char* qrp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
