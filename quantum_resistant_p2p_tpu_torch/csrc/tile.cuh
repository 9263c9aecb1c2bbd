// The shared-memory polynomial tile of K6 (mldsa.cu).
//
// A sampler thread builds one whole polynomial while it parses its sponge's
// output.  The block's 32 polynomials live in one shared tile laid out
// coefficient-major with a padded row, tile[i * kTileRows + t]: a warp
// writing coefficient i of its 32 polynomials hits 32 banks, and the
// copy-out below reads each polynomial's coefficients in order and writes
// whole 1 KB output rows, so the global stores are coalesced although each
// thread owns one row.  The tile is 33.8 KB per 32-thread block.
#pragma once

#include <stdint.h>

#include "warp_sampler.cuh"  // kN

namespace qrp {

// Polynomials (threads) per sampler block, and the padded tile row.
constexpr int kPolys = 32;
constexpr int kTileRows = kPolys + 1;

// Copy the block's finished polynomials from the tile to out rows
// [row0, row0 + rows), coalesced: consecutive threads write consecutive
// coefficients of one row.
__device__ __forceinline__ void store_tile(const int32_t* tile, int32_t* out,
                                           int64_t row0, int64_t n) {
  const int rows = n - row0 < kPolys ? (int)(n - row0) : kPolys;
  for (int idx = threadIdx.x; idx < rows * kN; idx += kPolys) {
    const int r = idx >> 8, i = idx & (kN - 1);
    out[(row0 + r) * kN + i] = tile[i * kTileRows + r];
  }
}

}  // namespace qrp
