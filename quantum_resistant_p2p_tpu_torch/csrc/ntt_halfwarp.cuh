// The half-warp NTT shared by K3's fused NTT and K4 (mod 3329, mlkem.cuh)
// and K7 (mod 8380417, mldsa.cuh).
//
// A half-warp holds one polynomial, 16 coefficients a lane in registers
// f[j]: in stage A lane t holds coefficient t + 16 j, in stage B 16 t + j
// (utils/ntt_layout.py builds the tables on the same layout).  In a
// layer, registers j and j + h of one lane are a butterfly pair (h = 8, 4,
// 2, 1 for a layer of length 16 h in stage A, h in stage B), whose zeta
// sits at slot 8 / h - 1 + j / (2 h) of the stage's table.  Stage A's
// zetas are the same in every lane (each kernel reads its own constant
// table at compile-time slots); stage B's differ by lane and are loaded
// once a thread into registers (LaneZetas).  One transpose through a
// padded shared buffer under __syncwarp() turns one layout into the other.
//
// Every zeta product is Shoup's: w comes with w' = floor(w 2^32 / q), and
// a * w mod q costs one high multiply and two low ones in 32 bits, with a
// result in [0, 2q) for any 32-bit a.  Butterflies are lazy.  Forward
// (Cooley-Tukey): t = w b up to one q, a' = a + t, b' = a + 2q - t.
// Inverse (Gentleman-Sande): a' = a + b, b' = w (b - a + M) up to one q,
// where M bounds the layer's inputs; a layer whose inputs are below M
// leaves them below 2M.
//
// A kernel runs kNttWarps warps a block, each warp transforming polynomial
// pairs (a half-warp each) with coalesced 32-bit loads and stores
// (ntt_pairs), over a grid of at most one wave of resident blocks
// (size_ntt_waves at a library's init, ntt_grid at each launch).
#pragma once

#include <stdint.h>

namespace qrp {

constexpr int kNttRegs = 16;
constexpr int kNttCoeffs = 16 * kNttRegs;  // a polynomial, over 16 lanes
// Words of a half-warp's transpose buffer (256 + 4 every 16 = 320, padded
// so that the other half-warp's starts 16 banks on), and of a warp's.
constexpr int kNttHalfWords = 336;
constexpr int kNttWarpWords = 2 * kNttHalfWords;

// a * w mod Q up to one Q: a * w - hi * Q in [0, 2Q) for any 32-bit a and
// w in [0, Q) with its Shoup companion (hi is floor(a w / Q) or one less),
// exact modulo 2^32.
template <uint32_t Q>
__device__ __forceinline__ uint32_t mulmod_lazy(uint32_t a, uint32_t w, uint32_t w_shoup) {
  return a * w - __umulhi(a, w_shoup) * Q;
}

// The same, canonical in [0, Q): min(r, r - Q) (unsigned) subtracts Q
// once where r >= Q.  With w = 1 and the Shoup companion of 1 it reduces
// any 32-bit value.
template <uint32_t Q>
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t w, uint32_t w_shoup) {
  const uint32_t r = mulmod_lazy<Q>(a, w, w_shoup);
  return min(r, r - Q);
}

// One layer of pair distance H; `bias` is the inverse's M.
template <int H, bool INVERSE, uint32_t Q, class Zeta>
__device__ __forceinline__ void ntt_layer(uint32_t f[kNttRegs], const Zeta& zeta,
                                          uint32_t bias) {
#pragma unroll
  for (int j = 0; j < kNttRegs; ++j) {
    if (j & H) continue;
    const int slot = 8 / H - 1 + j / (2 * H);
    const uint32_t w = zeta.w(slot), w_shoup = zeta.w_shoup(slot);
    if (!INVERSE) {
      const uint32_t t = mulmod_lazy<Q>(f[j + H], w, w_shoup);
      f[j + H] = f[j] + 2 * Q - t;
      f[j] += t;
    } else {
      const uint32_t a = f[j], b = f[j + H];
      f[j] = a + b;
      f[j + H] = mulmod_lazy<Q>(b + bias - a, w, w_shoup);
    }
  }
}

// Forward layers h = 8, 4, 2 and, where LAST is 1, 1.  Inputs below c q
// leave below (c + 2 k) q after k layers.
template <uint32_t Q, int LAST, class Zeta>
__device__ __forceinline__ void ntt_stage_fwd(uint32_t f[kNttRegs], const Zeta& zeta) {
  static_assert(LAST == 1 || LAST == 2, "a stage ends at h = 2 or 1");
  ntt_layer<8, false, Q>(f, zeta, 0);
  ntt_layer<4, false, Q>(f, zeta, 0);
  ntt_layer<2, false, Q>(f, zeta, 0);
  if (LAST == 1) ntt_layer<1, false, Q>(f, zeta, 0);
}

// Inverse layers h = FIRST, .., 8, whose inputs are below `bound` at the
// first and below twice the last's at each next: outputs below
// bound * 16 / FIRST.
template <uint32_t Q, int FIRST, class Zeta>
__device__ __forceinline__ void ntt_stage_inv(uint32_t f[kNttRegs], const Zeta& zeta,
                                              uint32_t bound) {
  static_assert(FIRST == 1 || FIRST == 2, "a stage starts at h = 1 or 2");
  if (FIRST == 1) ntt_layer<1, true, Q>(f, zeta, bound);
  ntt_layer<2, true, Q>(f, zeta, bound * 2 / FIRST);
  ntt_layer<4, true, Q>(f, zeta, bound * 4 / FIRST);
  ntt_layer<8, true, Q>(f, zeta, bound * 8 / FIRST);
}

// The inverse's stage A with the scaling by n^-1 folded into its last
// layer (length 128): layers h = 1, 2, 4 on inputs below `bound`, then
// a' = n^-1 (a + b) and b' = zeta n^-1 (b - a + 8 bound), canonical.  The
// stage's table holds zeta n^-1 at slot 0 and n^-1 at slot 15.
template <uint32_t Q, class Zeta>
__device__ __forceinline__ void ntt_stage_a_inv_scaled(uint32_t f[kNttRegs], const Zeta& zeta,
                                                       uint32_t bound) {
  ntt_layer<1, true, Q>(f, zeta, bound);
  ntt_layer<2, true, Q>(f, zeta, 2 * bound);
  ntt_layer<4, true, Q>(f, zeta, 4 * bound);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t a = f[j], b = f[j + 8];
    f[j] = mulmod<Q>(a + b, zeta.w(15), zeta.w_shoup(15));
    f[j + 8] = mulmod<Q>(b + 8 * bound - a, zeta.w(0), zeta.w_shoup(0));
  }
}

// Stage B's zetas: this lane's, loaded once into registers from a device
// table of SLOTS x 16 zetas (slot, lane) followed by their companions.
template <int SLOTS>
struct LaneZetas {
  uint32_t z[SLOTS], z_shoup[SLOTS];
  __device__ __forceinline__ void load(const uint32_t* table, int lane) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      z[s] = __ldg(table + 16 * s + lane);
      z_shoup[s] = __ldg(table + 16 * (SLOTS + s) + lane);
    }
  }
  __device__ __forceinline__ uint32_t w(int slot) const { return z[slot]; }
  __device__ __forceinline__ uint32_t w_shoup(int slot) const { return z_shoup[slot]; }
};

// A half-warp's transposes through its shared buffer.  Coefficient i sits
// at word i + 4 (i / 16): lane t's stage-A words t + 20 j are 16
// consecutive banks for each j (the other half-warp's buffer starts 16
// banks on), and its stage-B words 20 t + 4 m are four 16-byte vectors
// that eight lanes read or write on disjoint banks.  A lane writes the
// words it read itself in the other transpose, so one __syncwarp() each
// way is enough.
__device__ __forceinline__ void ntt_a_to_b(uint32_t f[kNttRegs], uint32_t* buf, int t) {
#pragma unroll
  for (int j = 0; j < kNttRegs; ++j) buf[t + 20 * j] = f[j];
  __syncwarp();
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const uint4 v = *reinterpret_cast<const uint4*>(buf + 20 * t + 4 * m);
    f[4 * m] = v.x, f[4 * m + 1] = v.y, f[4 * m + 2] = v.z, f[4 * m + 3] = v.w;
  }
}

__device__ __forceinline__ void ntt_b_to_a(uint32_t f[kNttRegs], uint32_t* buf, int t) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    *reinterpret_cast<uint4*>(buf + 20 * t + 4 * m) =
        make_uint4(f[4 * m], f[4 * m + 1], f[4 * m + 2], f[4 * m + 3]);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kNttRegs; ++j) f[j] = buf[t + 20 * j];
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

constexpr int kNttWarps = 8;
constexpr int kNttThreads = 32 * kNttWarps;

// The body of an NTT kernel over n polynomials: each warp takes pairs 2 p,
// 2 p + 1 (a half-warp each) for p = its global warp index, then a grid of
// warps on, and applies transform(f, buf, t) to stage-A registers, where
// `bufs` is the block's kNttWarps * kNttWarpWords words of shared memory.
// A half-warp past n transforms zeros and stores nothing.
template <class Transform>
__device__ __forceinline__ void ntt_pairs(const int32_t* __restrict__ in,
                                          int32_t* __restrict__ out, int64_t n, uint32_t* bufs,
                                          const Transform& transform) {
  const int lane = threadIdx.x & 31, t = lane & 15, half = lane >> 4;
  const int warp = threadIdx.x >> 5;
  uint32_t* buf = bufs + warp * kNttWarpWords + half * kNttHalfWords;
  const int64_t pairs = (n + 1) / 2;
  for (int64_t pair = (int64_t)blockIdx.x * kNttWarps + warp; pair < pairs;
       pair += (int64_t)gridDim.x * kNttWarps) {
    const int64_t poly = 2 * pair + half;
    const bool live = poly < n;
    const int32_t* src = in + poly * kNttCoeffs + t;
    uint32_t f[kNttRegs];
#pragma unroll
    for (int j = 0; j < kNttRegs; ++j) f[j] = live ? (uint32_t)__ldg(src + 16 * j) : 0u;
    transform(f, buf, t);
    if (live) {
      int32_t* dst = out + poly * kNttCoeffs + t;
#pragma unroll
      for (int j = 0; j < kNttRegs; ++j) dst[16 * j] = (int32_t)f[j];
    }
  }
}

// One wave of a library's NTT kernels on each device, forward and inverse:
// the blocks that fit on its SMs at once.  The library's init entry sizes
// it for the current device (size_ntt_waves); each launch reads it
// (ntt_grid).
constexpr int kMaxDevices = 64;
using NttWaves = int64_t[kMaxDevices][2];

template <class Kernel>
cudaError_t size_ntt_waves(NttWaves& waves, Kernel forward, Kernel inverse) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const Kernel kernels[2] = {forward, inverse};
  for (int d = 0; d < 2 && err == cudaSuccess; ++d) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernels[d], kNttThreads, 0);
    waves[dev][d] = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  }
  return err;
}

// Blocks of a launch over n polynomials: enough for every pair, at most
// one wave of the current device.
inline int ntt_grid(const NttWaves& waves, int64_t n, int inverse, unsigned* grid) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || waves[dev][inverse] == 0) return (int)cudaErrorInitializationError;
  const int64_t want = (n + 2 * kNttWarps - 1) / (2 * kNttWarps);
  *grid = (unsigned)(want < waves[dev][inverse] ? want : waves[dev][inverse]);
  return 0;
}

}  // namespace qrp
