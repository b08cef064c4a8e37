// K13: the per-tile generator behind K5's hw_prng=True, Philox4x32-10
// (Salmon, Moraes, Dror and Shaw, "Parallel random numbers: as easy as 1, 2,
// 3", SC'11; the constants of Random123), written here by hand.
//
// Replaces the TPU kernel repro/fusion/rng.py:212 `hw_tile_bits`, which
// re-seeds the TPU's hardware generator per tile on (seed, salt, row0, col0)
// (pltpu.prng_seed) and draws the tile's bits as one stream
// (pltpu.prng_random_bits), inside K5's body (repro/fusion/graph.py:272).  A
// GPU has no such generator; the counter-based Philox keeps the contract:
// key = (seed, salt), counter = (row0, col0, q, 0), and element (r, c) of a
// tile of width tile_w takes word local % 4 of block q = local / 4, with
// local = r * tile_w + c.  The bits depend on the tile's origin and shape
// and on nothing else, so they equal repro_torch/fusion/rng.py hw_tile_bits
// (the plain version) bit for bit, whichever CTA computes the element.
//
// What bounds it on an H100: integer operations.  One Philox4x32-10 call is
// ten rounds of two mul.lo, two mul.hi and three xors, plus the key bumps:
// about 90 integer instructions for four words, where threefry2x32-20 on
// the counter path takes about 75 for its one used word.  Drawn in K5's
// epilogue after the mainloop, one call an element, the bits cost more than
// the GEMM (PERF.md's split: 0.16 of 0.18 ms over rate 0 at
// minicpm-2b's attention output projection).
//
// What the design does about it: where the plan's PRNG tile width is a
// multiple of 4, columns 4q..4q+3 of a row are the four words of one call,
// and K5's wgmma tile shares it: lanes t and t ^ 1 hold those columns for
// rows r and r + 8, each draws one row's call and hands the other two
// words, a quarter of the calls, all drawn before the mainloop while the
// ring fills (csrc/fused_gemm.cuh draw_ahead, in the source the plan picks:
// kernels/fused_gemm.py shares_draw).  Elsewhere each element runs one call
// (fg_hw_tile_bits), spread over the mainloop's k-steps on the wgmma tile.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint4 fg_philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
  }
  return ctr;
}

// The bits of element (gm, gn) of its 2-D problem under the plan's PRNG tile
// (tm, tn): the tile at (row0, col0) is the stream (seed, salt, row0, col0).
__device__ __forceinline__ uint32_t fg_hw_tile_bits(uint32_t seed, uint32_t salt, int gm, int gn,
                                                    int tm, int tn) {
  const int row0 = gm - gm % tm, col0 = gn - gn % tn;
  const uint32_t local = static_cast<uint32_t>(gm - row0) * static_cast<uint32_t>(tn) +
                         static_cast<uint32_t>(gn - col0);
  const uint4 w = fg_philox4x32_10(
      make_uint4(static_cast<uint32_t>(row0), static_cast<uint32_t>(col0), local >> 2, 0u), seed,
      salt);
  const uint32_t lane = local & 3u;
  return lane == 0 ? w.x : lane == 1 ? w.y : lane == 2 ? w.z : w.w;
}
