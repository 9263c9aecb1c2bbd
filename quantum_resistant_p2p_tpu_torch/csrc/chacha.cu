// K8: the RFC 8439 ChaCha20 block function, batched, for Hopper.
//
// Replaces core/chacha_pallas.py:chacha_blocks (body _chacha_stream_kernel),
// the Pallas kernel that kept each of the 16 state words as one (8, 128)
// uint32 tile across 1024 block instances.  Here one thread computes one
// block: it loads the block's 12 input words (8 key, 1 counter, 3 nonce),
// runs the 20 rounds (80 quarter rounds) on 16 words in registers and
// writes the 16 words of the state after the feedforward add.  Hopper is
// little-endian, so the (N, 16) output viewed as bytes is the keystream.
//
// What bounds it on the card: the integer pipe, by a small margin over the
// bytes.  A block is 976 32-bit instructions (80 quarter rounds of 4 adds,
// 4 xors and 4 rotates, plus 16 feedforward adds) against 112 bytes moved
// (48 in, 64 out); the 640 xors and rotates run only on the 64-lane
// integer pipe, while the adds run as IMAD on the FMA pipe beside them.
// The design keeps the state in registers, makes every rotate one SHF
// (__funnelshift_l), and moves the rows as 16-byte vectors: a warp's
// threads hold adjacent rows, so its three loads and four stores cover
// contiguous 1.5 KiB and 2 KiB spans.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  a += b; d = rotl32(d ^ a, 16);
  c += d; b = rotl32(b ^ c, 12);
  a += b; d = rotl32(d ^ a, 8);
  c += d; b = rotl32(b ^ c, 7);
}

__global__ void __launch_bounds__(kThreads)
    chacha_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, int64_t n) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const uint4 k0 = __ldg(in + 3 * row), k1 = __ldg(in + 3 * row + 1);
  const uint4 cn = __ldg(in + 3 * row + 2);  // counter, nonce
  const uint32_t s[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                          k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w,
                          cn.x, cn.y, cn.z, cn.w};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = s[i];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[1], x[5], x[9], x[13]);
    quarter(x[2], x[6], x[10], x[14]);
    quarter(x[3], x[7], x[11], x[15]);
    quarter(x[0], x[5], x[10], x[15]);
    quarter(x[1], x[6], x[11], x[12]);
    quarter(x[2], x[7], x[8], x[13]);
    quarter(x[3], x[4], x[9], x[14]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] += s[i];
  uint4* dst = out + 4 * row;
  dst[0] = make_uint4(x[0], x[1], x[2], x[3]);
  dst[1] = make_uint4(x[4], x[5], x[6], x[7]);
  dst[2] = make_uint4(x[8], x[9], x[10], x[11]);
  dst[3] = make_uint4(x[12], x[13], x[14], x[15]);
}

}  // namespace

extern "C" {

// in: (n, 12) 32-bit words, out: (n, 16) 32-bit words, both row-major on
// the device and 16-byte aligned.  Returns a cudaError_t.
int qrp_chacha_blocks(const void* in, void* out, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  chacha_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), n);
  return (int)cudaGetLastError();
}

const char* qrp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
