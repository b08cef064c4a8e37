// One GEMM mainloop for Hopper, on wgmma fed by a TMA ring, shared by K1
// (csrc/gemm.cu: the flat product, its transposed reads and the split-K
// weight stream for decode) and K11 (csrc/brgemm_blocked.cu: Listing 1's
// blocked layouts).  Only the producer's addressing differs between them: a
// kernel passes a Policy that names, for k-step `it` of its tile, the (row,
// k, outer) coordinates of each operand's TMA box.
//
// Replaces the mainloop of the TPU kernels repro/kernels/brgemm.py:58
// matmul_pallas and :152 brgemm_blocked_pallas (both launched through
// repro/core/pallas_lowering.py:238), whose BlockSpecs double-buffer each
// (bm, bk) x (bk, bn) block pair into VMEM while the MXU works on the last.
//
// What bounds a GEMM on an H100: above the card's ~295 flop/byte ridge
// (prefill and training: M in the thousands) the tensor cores' rate, which
// only wgmma reaches, and only if the operand tiles arrive in shared memory
// ahead of the products; below it (decode, M <= 16) HBM bytes: one pass over
// the weight, which needs tens of KB in flight on every SM to hide the
// memory's latency.
//
// What the design does about it: a CTA is C::WG consumer warpgroups, each
// owning 64 rows of wgmma's M axis by C::BN of its N axis in fp32
// registers, plus one producer warp whose lane 0 issues TMA loads into a
// ring of C::STAGES stages.  A stage holds both operands' BK = 64 deep
// tiles (128-byte rows, the 128-byte swizzle wgmma reads), in the stored
// layout: a K-major operand (k along the stored row) as one panel, an
// MN-major one (its M or N axis along the stored row) as panels of
// SW = min(rows, 64) columns read with wgmma's transpose bit, so neither
// operand is ever copied or transposed in device memory.  Each stage has a
// "full" mbarrier (the producer's expected bytes, completed by the TMA
// unit) and an "empty" one (one arrival per consumer warpgroup once the
// products that read it have finished); consumers keep one wgmma group in
// flight behind the one they issue, so the tensor cores see the next k-step
// as soon as its tile has landed.  Loads past the operands' extents arrive
// as zeros (the tensor maps' bounds), so a ragged M, N or K needs no branch
// in the mainloop; the caller's epilogue masks the store.  The sum over k
// is taken in one order (k-step by k-step, k16 by k16) whatever the tile's
// position or the number of rows, so the same inputs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace gemm_ml {

constexpr int BK = 64;  // k elements a stage: one 128-byte row of a K-major tile

// One operand's tile of ROWS (wgmma's M or N extent) by BK in a ring stage,
// as its TMA loads write it.  K-major: one panel of ROWS rows of 128 bytes.
// MN-major: ROWS / SW panels of BK k-rows by SW columns, each row SW * 2
// bytes (the swizzle span).
template <int ROWS, bool MN>
struct Operand {
  static constexpr bool kMN = MN;
  static constexpr int kRows = ROWS;
  static constexpr int SW = MN ? (ROWS < 64 ? ROWS : 64) : BK;
  static constexpr int PITCH = 2 * SW;
  static constexpr int PANELS = MN ? ROWS / SW : 1;
  static constexpr int PANEL_BYTES = MN ? BK * PITCH : ROWS * PITCH;
  static constexpr int BYTES = ROWS * BK * 2;
  static_assert((MN ? ROWS % SW : ROWS % 8) == 0 && (SW == 16 || SW == 32 || SW == 64),
                "whole swizzled panels");
  static_assert(BYTES % 1024 == 0, "each tile keeps the next one 1024-byte aligned");

  // wgmma's descriptor of k16 step `ks` for the rows from `r0` (a multiple
  // of 64 for the M operand, 0 for the N operand).
  static __device__ __forceinline__ uint64_t desc(uint32_t tile, int r0, int ks) {
    if constexpr (MN)
      return hopper::desc(tile + (r0 / SW) * PANEL_BYTES + ks * 16 * PITCH, PANEL_BYTES, 8 * PITCH,
                          PITCH);
    else
      return hopper::desc(tile + r0 * PITCH + ks * 32, 16, 8 * PITCH, PITCH);
  }

  // The TMA loads of one stage: rows [row, row + ROWS) and k [k, k + BK)
  // at outer coordinates (z, w) of `map`, whose innermost axis is k
  // (K-major) or the rows (MN-major); an MN-major operand's upper half of
  // panels comes from outer coordinate z_hi instead (rows from `row`
  // again), so a tile may join two matrices.  They complete on `bar`.
  static __device__ __forceinline__ void load(uint32_t tile, const CUtensorMap* map, uint32_t bar,
                                              int row, int k, int z, int z_hi, int w = 0) {
    if constexpr (MN) {
#pragma unroll
      for (int p = 0; p < PANELS; ++p) {
        const bool hi = z_hi != z && p >= PANELS / 2;
        hopper::tma_load_4d(tile + p * PANEL_BYTES, map, bar,
                            row + (hi ? p - PANELS / 2 : p) * SW, k, hi ? z_hi : z, w);
      }
    } else {
      hopper::tma_load_4d(tile, map, bar, k, row, z, w);
    }
  }

};

// A CTA's shape: WG consumer warpgroups of 64 MB M rows by BN (MB m64
// blocks a warpgroup: consume for one, consume_blocks for more), a ring of
// STAGES stages; A_MN / B_MN: whether wgmma's A (M rows) and B (N columns)
// operands are stored MN-major.
template <int WG_, int BN_, int STAGES_, bool A_MN, bool B_MN, int MB_ = 1>
struct Config {
  static constexpr int WG = WG_, MB = MB_, BM = 64 * WG_ * MB_, BN = BN_, STAGES = STAGES_;
  static constexpr bool kAMN = A_MN, kBMN = B_MN;
  using A = Operand<BM, A_MN>;
  using B = Operand<BN, B_MN>;
  static constexpr int STAGE_BYTES = A::BYTES + B::BYTES;
  static constexpr int THREADS = 128 * WG + 32;  // the consumers, then the producer warp
  // 1024 bytes of slack to align the ring, the ring, a full and an empty
  // mbarrier a stage, and one int the epilogue may use
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES + 16;
  static_assert(SMEM <= 232448, "a CTA's shared memory");
};

// Where a CTA's ring and barriers are in its dynamic shared memory.
template <class C>
struct Smem {
  uint32_t ring, full, empty;
  int* flag;
  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    const uint32_t at = hopper::smem_u32(raw);
    ring = (at + 1023u) & ~1023u;
    full = ring + C::STAGES * C::STAGE_BYTES;
    empty = full + 8 * C::STAGES;
    flag = reinterpret_cast<int*>(raw + (empty + 8 * C::STAGES - at));
  }
  __device__ __forceinline__ uint32_t a(int s) const { return ring + s * C::STAGE_BYTES; }
  __device__ __forceinline__ uint32_t b(int s) const { return a(s) + C::A::BYTES; }
};

// Thread 0 sets up the barriers; every thread of the CTA waits for it.
template <class C>
__device__ __forceinline__ void init(const Smem<C>& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(sm.full + 8 * s, 1);
      hopper::mbar_init(sm.empty + 8 * s, C::WG);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
}

// This thread's warpgroup, as a value the compiler knows to be the same
// across the warp (a shuffle from lane 0), so that the role branch and the
// loops under it are not divergent paths to ptxas, which would otherwise
// serialize the wgmma (its warning C7518).
__device__ __forceinline__ int warpgroup() { return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0); }

// Wait until the barrier's phase `parity` has completed, spinning in PTX
// (no branch the compiler could call divergent); like hopper::mbar_wait, a
// wait of more than about 2^33 cycles traps instead of hanging.
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\nmov.u64 t0, %%clock64;\n"
      "GEMM_ML_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra GEMM_ML_DONE;\n"
      "mov.u64 t1, %%clock64;\nsub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 8589934592;\n@p trap;\n"
      "bra GEMM_ML_WAIT;\n"
      "GEMM_ML_DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One arrival on `bar` from the threads whose `pred` is set (a predicated
// instruction, not a branch).
__device__ __forceinline__ void arrive_if(uint32_t bar, bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
               ::"r"(bar), "r"((int)pred)
               : "memory");
}

// The producer (lane 0 of the warp after the consumers): for each of the tile's `n`
// k-steps, wait until its stage is free, expect its bytes and issue both
// operands' loads at the coordinates the Policy gives:
//   void coords(int it, int& a_row, int& a_k, int& a_z,
//               int& b_row, int& b_k, int& b_z, int& b_z_hi) const;
// (b_z_hi: the outer coordinate of B's upper half of panels; b_z for one
// matrix.)  A CTA that walks several tiles through one ring passes the
// ring step of the tile's first k-step as `it0` (the Policy still sees
// the tile's own steps 0 .. n - 1), as its consumers pass it to consume.
template <class C, class Policy>
__device__ __forceinline__ void produce(const Smem<C>& sm, const CUtensorMap* ta,
                                        const CUtensorMap* tb, const Policy& pol, int n,
                                        int it0 = 0) {
  if (threadIdx.x != 128 * C::WG) return;
  for (int step = 0; step < n; ++step) {
    const int it = it0 + step;
    const int s = it % C::STAGES;
    if (it >= C::STAGES) wait(sm.empty + 8 * s, ((it / C::STAGES) - 1) & 1);
    const uint32_t bar = sm.full + 8 * s;
    int ar, ak, az, br, bk, bz, bz_hi;
    pol.coords(step, ar, ak, az, br, bk, bz, bz_hi);
    hopper::mbar_expect_tx(bar, C::STAGE_BYTES);
    C::A::load(sm.a(s), ta, bar, ar, ak, az, az);
    C::B::load(sm.b(s), tb, bar, br, bk, bz, bz_hi);
  }
}

// A consumer warpgroup `wg`: acc[j] (rows 64 (MB wg + j) of the tile and
// on, by BN, wgmma's layout: thread lane of warp w holds row 16 w + lane / 4
// + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (lane % 4) + i % 2 in
// acc[j][i]) = the sum over the `n` k-steps of the ring, each k16 step
// issued for every block before the next, one wgmma group in flight behind
// the next.  A CTA that walks several tiles through one ring (K7's row
// band, K9's persistent dW) passes the ring step of the tile's first
// k-step as `it0` and `release_last`, so the stage of the tile's last
// k-step is freed for the next tile's loads.
template <class C>
__device__ __forceinline__ void consume_blocks(float (&acc)[C::MB][C::BN / 2], const Smem<C>& sm,
                                               int n, int wg, int it0 = 0,
                                               bool release_last = false) {
#pragma unroll
  for (int j = 0; j < C::MB; ++j)
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) acc[j][i] = 0.0f;
  for (int step = 0; step < n; ++step) {
    const int it = it0 + step;
    const int s = it % C::STAGES;
    wait(sm.full + 8 * s, (it / C::STAGES) & 1);
    const uint32_t a_s = sm.a(s), b_s = sm.b(s);
#pragma unroll
    for (int j = 0; j < C::MB; ++j) hopper::fence_regs(acc[j]);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
      for (int j = 0; j < C::MB; ++j)
        hopper::Wgmma<C::BN>::template ss<C::kAMN ? 1 : 0, C::kBMN ? 1 : 0>(
            acc[j], C::A::desc(a_s, 64 * (C::MB * wg + j), ks), C::B::desc(b_s, 0, ks), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the group of step it - 1 is done: free its stage
#pragma unroll
    for (int j = 0; j < C::MB; ++j) hopper::fence_regs(acc[j]);
    if (step > 0) arrive_if(sm.empty + 8 * ((it - 1) % C::STAGES), threadIdx.x % 128 == 0);
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < C::MB; ++j) hopper::fence_regs(acc[j]);
  if (release_last && n > 0)
    arrive_if(sm.empty + 8 * ((it0 + n - 1) % C::STAGES), threadIdx.x % 128 == 0);
}

// consume_blocks for a Config of one m64 block a warpgroup: acc holds its
// 64 rows by BN.
template <class C>
__device__ __forceinline__ void consume(float (&acc)[C::BN / 2], const Smem<C>& sm, int n,
                                        int wg, int it0 = 0, bool release_last = false) {
  static_assert(C::MB == 1, "consume takes one m64 block a warpgroup");
  consume_blocks<C>(reinterpret_cast<float (&)[1][C::BN / 2]>(acc), sm, n, wg, it0,
                    release_last);
}

// The (row, column) of wgmma's output that acc[i] of this thread holds,
// relative to its warpgroup's first row.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return 8 * (i / 4) + 2 * (threadIdx.x % 4) + (i & 1); }

}  // namespace gemm_ml
