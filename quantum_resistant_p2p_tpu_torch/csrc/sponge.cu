// K1: batched Keccak sponge (SHA3-256/512, SHAKE-128/256) for Hopper.
//
// Replaces core/keccak_pallas.py:sponge_words (body _sponge_kernel), the
// Pallas sponge that kept 1024 sponges on (8, 128) uint32 tiles with each
// lane split into hi/lo words, and was capped at MAX_BLOCKS_FUSED = 16
// blocks by TPU compile time.  Neither the split nor the cap exists here:
// one thread runs one whole sponge on 25 uint64_t lanes in registers and
// loops over as many absorb and squeeze blocks as the lengths need.
//
// What bounds it on the card: integer issue.  A permutation is 24 rounds
// of ~155 64-bit logical operations (two 32-bit instructions each) on
// 200 bytes of state, while the bytes moved are only the message in and
// the digest out; every call on the ML-KEM path is compute-bound by a wide
// margin.
//
// The varlen entry is the same sponge with a true length per row: rows of
// LMAX bytes, of which row r absorbs lengths[r] (the fused handshake's
// transcripts, whose JSON tails differ per lane).  The padding is made in
// registers by qrp::padded_lane (domain byte at the length, 0x80 at the end
// of its block), bytes past the length are never read, and each thread
// permutes only the blocks its own message needs, so a batch of short and
// long transcripts costs what its lengths need, not LMAX for every row.
// The reference's jnp sponge_varlen (core/keccak.py:308) scanned every row
// over LMAX // rate + 1 blocks.  The design keeps the state in registers (no shared or local
// memory) and runs one sponge per thread so warps issue independent
// rounds.  Message bytes are read straight from the caller's row-major
// rows through the read-only cache; threads of a warp read different rows,
// which wastes sector bandwidth, but the bytes are few next to the
// permutation work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak.cuh"

namespace {

constexpr int kThreads = 128;

template <int RATE>
__global__ void __launch_bounds__(kThreads)
    sponge_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                  int64_t n_rows, int in_len, uint8_t ds, int out_len) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n_rows) return;
  qrp::sponge<RATE>(in + row * in_len, in_len, ds, out + row * out_len, out_len);
}

template <int RATE>
__global__ void __launch_bounds__(kThreads)
    sponge_varlen_kernel(const uint8_t* __restrict__ in, const int32_t* __restrict__ lengths,
                         uint8_t* __restrict__ out, int64_t n_rows, int lmax, uint8_t ds,
                         int out_len) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n_rows) return;
  const int len = min(max(__ldg(lengths + row), 0), lmax);
  qrp::sponge<RATE>(in + row * lmax, len, ds, out + row * out_len, out_len);
}

template <int RATE>
void launch(const uint8_t* in, uint8_t* out, int64_t n_rows, int in_len,
            int ds, int out_len, cudaStream_t stream) {
  const int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  sponge_kernel<RATE><<<(unsigned)blocks, kThreads, 0, stream>>>(
      in, out, n_rows, in_len, (uint8_t)ds, out_len);
}

template <int RATE>
void launch_varlen(const uint8_t* in, const int32_t* lengths, uint8_t* out, int64_t n_rows,
                   int lmax, int ds, int out_len, cudaStream_t stream) {
  const int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  sponge_varlen_kernel<RATE><<<(unsigned)blocks, kThreads, 0, stream>>>(
      in, lengths, out, n_rows, lmax, (uint8_t)ds, out_len);
}

}  // namespace

extern "C" {

// in: (n_rows, in_len) uint8, out: (n_rows, out_len) uint8, both row-major
// on the device.  rate is 72, 136 or 168 bytes.  Returns a cudaError_t.
int qrp_keccak_sponge(const void* in, void* out, int64_t n_rows, int in_len,
                      int rate, int ds, int out_len, void* stream) {
  if (n_rows <= 0 || out_len <= 0) return (int)cudaSuccess;
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (rate) {
    case 72: launch<72>(src, dst, n_rows, in_len, ds, out_len, st); break;
    case 136: launch<136>(src, dst, n_rows, in_len, ds, out_len, st); break;
    case 168: launch<168>(src, dst, n_rows, in_len, ds, out_len, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// in: (n_rows, lmax) uint8, lengths: (n_rows,) int32 (clamped to
// [0, lmax]), out: (n_rows, out_len) uint8, all row-major on the device.
// Returns a cudaError_t.
int qrp_keccak_sponge_varlen(const void* in, const void* lengths, void* out, int64_t n_rows,
                             int lmax, int rate, int ds, int out_len, void* stream) {
  if (n_rows <= 0 || out_len <= 0) return (int)cudaSuccess;
  const auto* src = static_cast<const uint8_t*>(in);
  const auto* lens = static_cast<const int32_t*>(lengths);
  auto* dst = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (rate) {
    case 72: launch_varlen<72>(src, lens, dst, n_rows, lmax, ds, out_len, st); break;
    case 136: launch_varlen<136>(src, lens, dst, n_rows, lmax, ds, out_len, st); break;
    case 168: launch_varlen<168>(src, lens, dst, n_rows, lmax, ds, out_len, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* qrp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
