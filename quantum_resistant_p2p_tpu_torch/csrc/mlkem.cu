// ML-KEM (FIPS 203) sampling and NTT kernels for Hopper: K2, K3, K4.
//
// K2 mlkem_sample_ntt   replaces kem/mlkem_pallas.py:sample_ntt_words
// K3 mlkem_prf_cbd      replaces kem/mlkem_pallas.py:cbd_words (fuse_ntt 0)
//                       and :cbd_ntt_words (fuse_ntt 1)
// K4 mlkem_ntt          replaces kem/mlkem_pallas.py:ntt_words
//
// K2 and K3 run one sponge per thread (state in registers, keccak.cuh) and
// build their thread's polynomial in a shared-memory tile column
// (tile.cuh), copied out to whole coalesced rows.  The TPU kernels needed a 512-wide bitonic network
// to put SampleNTT's accepted candidates in order; a thread that appends
// them as it parses gets the same order for free.  What bounds K2 and K3
// is integer issue (Keccak rounds, and with the fused NTT 896 butterflies
// per polynomial), not bytes: a seed is 33-34 bytes and a polynomial 1 KB.
// The 33.8 KB tile per 32-thread block limits an SM to 6 such blocks.
//
// K4 gives each polynomial to a block of 128 threads: one butterfly per
// thread per layer, the polynomial in shared memory, a barrier between
// layers.  It reads and writes 1 KB per polynomial against ~6k integer
// operations, so device-memory bytes bound it.  zeta comes from constant
// memory; in the layers whose butterfly groups are shorter than a warp the
// threads of a warp read different zetas and the constant cache
// serialises them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlkem.cuh"

namespace {

using qrp::kN;
using qrp::kPolys;
using qrp::kTileRows;
using qrp::store_tile;

__global__ void __launch_bounds__(kPolys)
    sample_ntt_kernel(const uint8_t* __restrict__ seeds, int32_t* __restrict__ out,
                      int64_t n) {
  __shared__ int32_t tile[kN * kTileRows];
  const int64_t row0 = (int64_t)blockIdx.x * kPolys;
  const int64_t row = row0 + threadIdx.x;
  if (row < n) qrp::sample_ntt_poly(seeds + row * qrp::kXofSeedLen, tile + threadIdx.x);
  __syncthreads();
  store_tile(tile, out, row0, n);
}

template <int ETA, bool FUSE_NTT>
__global__ void __launch_bounds__(kPolys)
    prf_cbd_kernel(const uint8_t* __restrict__ seeds, int32_t* __restrict__ out,
                   int64_t n) {
  __shared__ int32_t tile[kN * kTileRows];
  const int64_t row0 = (int64_t)blockIdx.x * kPolys;
  const int64_t row = row0 + threadIdx.x;
  if (row < n) {
    int32_t* col = tile + threadIdx.x;
    qrp::prf_cbd_poly<ETA>(seeds + row * qrp::kPrfSeedLen, col);
    if (FUSE_NTT) qrp::ntt_column(col);
  }
  __syncthreads();
  store_tile(tile, out, row0, n);
}

constexpr int kNttThreads = 128;

template <bool INVERSE>
__global__ void __launch_bounds__(kNttThreads)
    ntt_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out) {
  __shared__ int32_t f[kN];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kN;
  f[t] = in[base + t];
  f[t + kNttThreads] = in[base + t + kNttThreads];
  __syncthreads();
  if (!INVERSE) {
#pragma unroll
    for (int len = 128; len >= 2; len >>= 1) {
      qrp::ntt_butterfly<false>(f, t, len);
      __syncthreads();
    }
    out[base + t] = f[t];
    out[base + t + kNttThreads] = f[t + kNttThreads];
  } else {
#pragma unroll
    for (int len = 2; len <= 128; len <<= 1) {
      qrp::ntt_butterfly<true>(f, t, len);
      __syncthreads();
    }
    out[base + t] = (f[t] * qrp::kNInv) % qrp::kQ;
    out[base + t + kNttThreads] = (f[t + kNttThreads] * qrp::kNInv) % qrp::kQ;
  }
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kPolys - 1) / kPolys); }

}  // namespace

extern "C" {

// Load the 128 zetas (17^bitrev7(i) mod q) into the constant memory of the
// current device.  __constant__ memory is per device: the wrapper calls this
// once for each device, before the first kernel that runs there.
int qrp_mlkem_init(const int32_t* zetas) {
  return (int)cudaMemcpyToSymbol(qrp::c_zetas, zetas, sizeof(int32_t) * 128);
}

// seeds: (n, 34) uint8 rows rho || j || i; out: (n, 256) int32.
int qrp_mlkem_sample_ntt(const void* seeds, void* out, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  sample_ntt_kernel<<<blocks_for(n), kPolys, 0, static_cast<cudaStream_t>(stream)>>>(
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
  if (eta == 2 && !fuse_ntt) prf_cbd_kernel<2, false><<<blocks, kPolys, 0, st>>>(src, dst, n);
  else if (eta == 2) prf_cbd_kernel<2, true><<<blocks, kPolys, 0, st>>>(src, dst, n);
  else if (eta == 3 && !fuse_ntt) prf_cbd_kernel<3, false><<<blocks, kPolys, 0, st>>>(src, dst, n);
  else if (eta == 3) prf_cbd_kernel<3, true><<<blocks, kPolys, 0, st>>>(src, dst, n);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// in, out: (n, 256) int32 in [0, q).
int qrp_mlkem_ntt(const void* in, void* out, int64_t n, int inverse, void* stream) {
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
