// The attention backward for Hopper: dq, dk and dv of softmax(pre(q k^T)) v,
// templated on an epilogue struct `Epi`, so that one mainloop serves K6
// (csrc/flash_attention_bwd.cu: the fixed scale and causal/window masks of
// K2's forward) and K5's chained backward (kernels/fused_gemm.py generates
// one source per chained TppGraph, whose Epi is the graph's own pre-reduce
// nodes and their derivative).
//
// Replaces the TPU backward that repro/fusion/autodiff.py derives for a
// chained-root graph (ChainedBackwardPlan, :236, run by
// _run_backward_chained, :689): six graphs, each a pallas_call, that
// materialise P, dP and dZ as (Sq, Skv) panels.  Here P and dS never leave
// the chip: the flash identity dZ = P * (dP - D), with P = exp(pre(S) - lse)
// rebuilt from the forward's row log-sum-exp and D = rowsum(dO * O).
//
// The Epi a source defines:
//   pre(s, gm, gn, p)      the forward's map from the raw score s = q k^T at
//                          (query gm, key gn) to the softmax input; a masked
//                          pair gives -inf or the mask fill (-1e30), so P = 0;
//   grad(dz, s, gm, gn, p) the derivative of pre applied to dz, the
//                          cotangent of the softmax input: dS = dz pre'(s);
//   tile_dead(m0, bm, n0, bn, p)
//                          true for a tile of queries [m0, m0 + bm) and keys
//                          [n0, n0 + bn) whose every pair pre masks: skipped.
// Semantics kept from K6 (PR 13): q, o, do (B, H, Sq, D), k and v (B, Hk,
// Skv, D) by (batch, head, seq) strides; query head h reads kv head
// h / (H / Hk), so dk and dv sum over the group's query heads; a row with
// every key masked (lse = -inf) gets zero gradients; no float atomics, so a
// step's gradients are the same bits from run to run.
//
// What bounds it on an H100: at minicpm-2b's training shape (B 4, H 36,
// S 1024, D 64, causal) five products of the live score tiles' size, 2.5x
// the forward's 19.3 GFLOP, about 0.049 ms at the bf16 tensor-core peak
// against ~0.03 ms for the bytes of q, k, v, o, do and the gradients:
// operations bound it, reachable only on the tensor cores.
//
// What the design does about it.  bf16 runs three kernels, every product on
// wgmma (csrc/wgmma.cuh) with operands in swizzled shared-memory panels
// filled by TMA (one tensor map per operand and box, built per call from the
// wrapper's strides):
//   1. stats: one warp a row writes D = rowsum(dO * O) and lse * log2(e)
//      (+inf for a row with no live key and for the rows padding Sq to a
//      whole number of tiles, so P is 0 there without a test) into an fp32
//      scratch of (B * H, Sq_pad) rows;
//   2. dk/dv: one CTA per (key block of BN keys, kv head, batch) holds its
//      K and V in shared memory and walks the live query tiles of every head
//      of the GQA group through a ring of STAGES (Q, dO, lse, D) tiles, the
//      lse and D rows arriving by bulk copy on the same mbarrier.  A
//      warpgroup owns 64 keys (at D 256 two warpgroups share them, each
//      holding half of dK's and dV's columns, so the accumulators fit in
//      registers); per tile S^T = K Q^T and dP^T = V dO^T run as ss wgmma,
//      P^T and dS^T are formed in the fp32 accumulators, packed to bf16 in
//      registers (the accumulator layout is wgmma's A fragment) and
//      dV += P^T dO, dK += dS^T Q run as rs wgmma with dO and Q read
//      MN-major; dK and dV stay in fp32 registers and are written once;
//      each of P^T and dS^T goes in as two bf16 operands, hi + lo (split),
//      since one bf16 rounding of P and dS put dK and dV 3e-2 from the fp32
//      plain version where they sum thousands of terms (GQA, D 128);
//   3. dq: one CTA per (64 x QWG query rows, head, batch) holds its Q and dO
//      and walks the live key tiles through a ring of (K, V) tiles: S and dP
//      as ss wgmma, dS in registers, dQ += dS K as rs wgmma (dS as hi + lo)
//      with K read MN-major.
// Kernels 2 and 3 both recompute S and dP (seven products where FA2's
// atomic dQ takes five): the price of a deterministic dQ without atomics;
// the hi + lo operands run each of the three register-A products twice.
// The ring is released as in K2's forward: the last warpgroup done with a
// stage loads the tile STAGES ahead into it, so warpgroups never wait for
// each other.  fp32 keeps PR 13's SIMT kernels (32 x 32 tiles in shared
// memory, fp32 FMA, no TF32), behind the same Epi.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace attn_bwd {

typedef __nv_bfloat16 bf16;

// What an Epi may read besides the coordinates: the call's shapes and the
// caller's masks and scale (a generated Epi has its own baked in).
struct Params {
  int H, Hk, Sq, Skv, causal, window;
  float scale;
};

// (batch, head, seq) strides of q, k, v, o, do, dq, dk, dv, in that order.
struct Strides {
  long long v[24];
};
enum { SQ = 0, SK = 3, SV = 6, SO = 9, SDO = 12, SDQ = 15, SDK = 18, SDV = 21 };

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The live key tiles [lo, hi) of `bn` keys for query rows [m0, m0 + bm):
// from the first tile Epi does not call dead to the last (a dead tile
// between them, which no mask of the paths makes, would be computed and
// add nothing).
template <class E>
__device__ __forceinline__ void key_range(int m0, int bm, int bn, const Params& p, int& lo,
                                          int& hi) {
  const int nt = (p.Skv + bn - 1) / bn;
  lo = nt;
  hi = 0;
  for (int t = 0; t < nt; ++t)
    if (!E::tile_dead(m0, bm, t * bn, bn, p)) {
      lo = min(lo, t);
      hi = t + 1;
    }
  if (hi <= lo) lo = hi = 0;
}

// The live query tiles [lo, hi) of `bm` rows for keys [n0, n0 + bn).
template <class E>
__device__ __forceinline__ void query_range(int n0, int bn, int bm, const Params& p, int& lo,
                                            int& hi) {
  const int nt = (p.Sq + bm - 1) / bm;
  lo = nt;
  hi = 0;
  for (int t = 0; t < nt; ++t)
    if (!E::tile_dead(t * bm, bm, n0, bn, p)) {
      lo = min(lo, t);
      hi = t + 1;
    }
  if (hi <= lo) lo = hi = 0;
}

// ---------------------------------------------------------------------------
// 1. stats.  Row r of the (B * H, Sq_pad) scratch: lse2 = lse * log2(e)
//    (+inf where lse is -inf and past Sq), delta = rowsum(dO * O) (0 past
//    Sq).  One warp a row, 4 rows a block.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(128)
stats_kernel(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ lse2, float* __restrict__ delta, int H, int Sq, int sq_pad,
             int D, long long rows, Strides st) {
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = row % sq_pad;
  const long long bh = row / sq_pad;
  const int h = bh % H, b = bh / H;
  float s = 0.0f, l2 = INFINITY;
  if (i < Sq) {
    const T* op = o + b * st.v[SO] + h * st.v[SO + 1] + i * st.v[SO + 2];
    const T* dp = dout + b * st.v[SDO] + h * st.v[SDO + 1] + i * st.v[SDO + 2];
    for (int d = lane; d < D; d += 32) s = fmaf(to_float(op[d]), to_float(dp[d]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float l = lse[bh * Sq + i];
    l2 = l == -INFINITY ? INFINITY : l * kLog2e;
  }
  if (lane == 0) {
    delta[row] = s;
    lse2[row] = l2;
  }
}

// ---------------------------------------------------------------------------
// bf16 tiles by head dim: the dk/dv kernel's warpgroups (WG), warpgroups
// sharing one 64-key block (DSPLIT; 2 at D 256, each holding half of dK's
// and dV's columns) and ring stages; the dq kernel's warpgroups of 64 query
// rows (QWG), keys a K/V tile (QBN) and ring stages.
// kernels/flash_attention.py::backward_plan repeats them (BWD_TILES) and the
// entry point refuses a plan that differs.
// ---------------------------------------------------------------------------
template <int D>
struct BwdConfig {
  static constexpr int WG = 2, DSPLIT = 1, STAGES = 4, QWG = 2, QBN = 64, QSTAGES = 4;
};
template <>
struct BwdConfig<128> {
  static constexpr int WG = 2, DSPLIT = 1, STAGES = 3, QWG = 2, QBN = 64, QSTAGES = 2;
};
template <>
struct BwdConfig<256> {
  static constexpr int WG = 2, DSPLIT = 2, STAGES = 2, QWG = 1, QBN = 64, QSTAGES = 2;
};

template <int D>
struct Panels {
  static constexpr int SW = D < 64 ? D : 64;  // columns of one swizzled panel
  static constexpr int PITCH = 2 * SW;        // bytes of a panel row: the swizzle span
  static constexpr int PANELS = D / SW;
};

template <int D>
struct KvTile : Panels<D> {
  using C = BwdConfig<D>;
  static constexpr int WG = C::WG, DSPLIT = C::DSPLIT, STAGES = C::STAGES;
  static constexpr int BN = 64 * WG / DSPLIT;   // keys a CTA
  static constexpr int BM = 64;                 // queries a ring tile
  static constexpr int NACC = D / DSPLIT;       // dK and dV columns a warpgroup holds
  static constexpr int KV_BYTES = BN * D * 2;   // K or V
  static constexpr int T_BYTES = BM * D * 2;    // Q or dO of one stage
  static constexpr int ST_BYTES = 2 * BM * 4;   // the lse2 and delta rows of one stage
  // 1024 bytes to align the panels, K, V, the ring, its stats rows, one
  // mbarrier for K/V and each stage, each stage's count of warpgroups done
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + STAGES * (2 * T_BYTES + ST_BYTES) +
                              8 * (STAGES + 1) + 4 * STAGES;
  static constexpr int THREADS = 128 * WG;
};

template <int D>
struct QTile : Panels<D> {
  using C = BwdConfig<D>;
  static constexpr int WG = C::QWG, BN = C::QBN, STAGES = C::QSTAGES;
  static constexpr int BM = 64 * WG;            // query rows a CTA
  static constexpr int Q_BYTES = BM * D * 2;    // Q or dO
  static constexpr int KV_BYTES = BN * D * 2;   // K or V of one stage
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (STAGES + 1) +
                              4 * STAGES;
  static constexpr int THREADS = 128 * WG;
};

// K-major descriptor of 64 rows starting at `row` of a `rows`-row tile at
// `base`, at k16 step `ks` of the D columns.
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int rows, int row, int ks) {
  using P = Panels<D>;
  const int panel = (ks * 16) / P::SW;
  const uint32_t col = ((ks * 16) % P::SW) * 2;
  return hopper::desc(base + panel * rows * P::PITCH + row * P::PITCH + col, 16, 8 * P::PITCH,
                      P::PITCH);
}

// MN-major descriptor (read with the transpose bit) of a `rows`-row tile at
// `base` whose 16 rows from k16 step `kk` are the reduction, from column
// `col0` on.
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int rows, int col0, int kk) {
  using P = Panels<D>;
  return hopper::desc(base + (col0 / P::SW) * rows * P::PITCH + kk * 16 * P::PITCH,
                      rows * P::PITCH, 8 * P::PITCH, P::PITCH);
}

// An fp32 accumulator as two bf16 A fragments, hi = bf16(x) and lo =
// bf16(x - hi): a product over hi and then lo carries ~16 bits of each x
// (a single bf16 operand, 8, missed the fp32 plain version's tolerance
// where dK and dV sum thousands of terms).
template <int NS>
__device__ __forceinline__ void split(const float (&x)[NS], uint32_t (&hi)[NS / 8][4],
                                      uint32_t (&lo)[NS / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = x[8 * kk + 2 * j], b = x[8 * kk + 2 * j + 1];
      const uint32_t h = hopper::pack_bf16(a, b);
      hi[kk][j] = h;
      lo[kk][j] = hopper::pack_bf16(a - __uint_as_float(h << 16), b - __uint_as_float(h & 0xffff0000u));
    }
}

// This warpgroup's four warps are past their products; the last
// warpgroup to arrive at `count` may refill the stage.
template <int WG>
__device__ __forceinline__ bool release(int* count, int tid) {
  if (tid / 128 == 0) hopper::named_sync<1, 128>();
  else hopper::named_sync<2, 128>();
  return tid % 128 == 0 && hopper::last_to_arrive(count, WG);
}

// Write a warpgroup's fp32 accumulator of 64 rows x N columns (rows
// row0 and row0 + 8 of each thread) as bf16 rows of `out` by stride ss,
// rows at or past `rows` skipped.
template <int N>
__device__ __forceinline__ void store_rows(bf16* out, long long ss, int row0, int rows,
                                           const float (&acc)[N / 2], int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    bf16* op = out + row * ss + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// 2. dk/dv on the tensor cores.  Grid (ceil(Skv / BN), Hk, B).
// tq, tdo: maps of q and do with (SW, 64) boxes; tk, tv: of k and v with
// (SW, BN) boxes.  lse2, delta: the stats rows, sq_pad a row.
// ---------------------------------------------------------------------------
template <int D, class E>
__global__ void __launch_bounds__(KvTile<D>::THREADS, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse2, const float* __restrict__ delta, int sq_pad,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, Params p, long long dk_sb,
                  long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
                  long long dv_ss) {
  using T = KvTile<D>;
  constexpr int BN = T::BN, BM = T::BM, SW = T::SW, PITCH = T::PITCH, STAGES = T::STAGES;
  constexpr int NACC = T::NACC, NS = BM / 2;  // fp32 registers a thread: dK or dV, S^T or dP^T
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = hopper::smem_u32(smem_raw);
  const uint32_t k_s = (base + 1023u) & ~1023u;
  const uint32_t v_s = k_s + T::KV_BYTES;
  const uint32_t ring = v_s + T::KV_BYTES;                    // stage s: Q, then dO
  const uint32_t stats = ring + STAGES * 2 * T::T_BYTES;      // stage s: lse2 (BM), delta (BM)
  const uint32_t bars = stats + STAGES * T::ST_BYTES;         // K/V's mbarrier, then each stage's
  int* released = reinterpret_cast<int*>(smem_raw + (bars + 8 * (STAGES + 1) - base));
  const float* stats_p = reinterpret_cast<const float*>(smem_raw + (stats - base));

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN, hk = blockIdx.y, b = blockIdx.z, G = p.H / p.Hk;
  const int key_w = T::DSPLIT == 1 ? 64 * wg : 0;   // this warpgroup's first key of the block
  const int col_w = T::DSPLIT == 1 ? 0 : wg * NACC; // and its first dK / dV column
  int lo, hi;
  query_range<E>(n0, BN, BM, p, lo, hi);
  const int nt = hi - lo, n = G * nt;                 // (head, query tile) items

  // Issue the loads of item `it` into ring stage `stage`.
  auto load_item = [&](int stage, int it) {
    const int h = hk * G + it / nt, t = lo + it % nt;
    const uint32_t bar = bars + 8 * (1 + stage), q_t = ring + stage * 2 * T::T_BYTES;
    hopper::mbar_expect_tx(bar, 2 * T::T_BYTES + T::ST_BYTES);
#pragma unroll
    for (int pn = 0; pn < T::PANELS; ++pn) {
      hopper::tma_load_4d(q_t + pn * BM * PITCH, &tq, bar, pn * SW, t * BM, h, b);
      hopper::tma_load_4d(q_t + T::T_BYTES + pn * BM * PITCH, &tdo, bar, pn * SW, t * BM, h, b);
    }
    const long long at = ((long long)b * p.H + h) * sq_pad + t * BM;
    const uint32_t st = stats + stage * T::ST_BYTES;
    hopper::bulk_load(st, lse2 + at, BM * 4, bar);
    hopper::bulk_load(st + BM * 4, delta + at, BM * 4, bar);
  };

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(bars + 8 * i, 1);
    for (int i = 0; i < STAGES; ++i) released[i] = 0;
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    // keys past Skv and queries past Sq arrive as zeros (the maps' bounds)
    hopper::mbar_expect_tx(bars, 2 * T::KV_BYTES);
#pragma unroll
    for (int pn = 0; pn < T::PANELS; ++pn) {
      hopper::tma_load_4d(k_s + pn * BN * PITCH, &tk, bars, pn * SW, n0, hk, b);
      hopper::tma_load_4d(v_s + pn * BN * PITCH, &tv, bars, pn * SW, n0, hk, b);
    }
    for (int st = 0; st < STAGES && st < n; ++st) load_item(st, st);
  }

  float dv_acc[NACC / 2], dk_acc[NACC / 2], s[NS], dp[NS];
  uint32_t ahi[BM / 16][4], alo[BM / 16][4];
#pragma unroll
  for (int i = 0; i < NACC / 2; ++i) dv_acc[i] = dk_acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.0f;
  const int key0 = n0 + key_w + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
  if (n > 0) hopper::mbar_wait(bars, 0);

  for (int it = 0; it < n; ++it) {
    const int stage = it % STAGES, m0 = (lo + it % nt) * BM;
    const uint32_t q_t = ring + stage * 2 * T::T_BYTES, do_t = q_t + T::T_BYTES;
    const float* ls = stats_p + stage * 2 * BM;
    const float* dl = ls + BM;
    hopper::mbar_wait(bars + 8 * (1 + stage), (it / STAGES) & 1);
    if (!E::tile_dead(m0, BM, n0 + key_w, 64, p)) {
      // S^T = K Q^T and dP^T = V dO^T over D in k16 steps, all K-major
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hopper::Wgmma<BM>::template ss<0, 0>(s, kmajor<D>(k_s, BN, key_w, ks),
                                             kmajor<D>(q_t, BM, 0, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hopper::Wgmma<BM>::template ss<0, 0>(dp, kmajor<D>(v_s, BN, key_w, ks),
                                             kmajor<D>(do_t, BM, 0, ks), ks > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // accumulator i: key key0 + 8 ((i / 2) % 2), query m0 + 8 (i / 4) +
      // 2 (lane % 4) + i % 2 of the tile
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int key = key0 + 8 * ((i >> 1) & 1), c = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const float z = E::pre(s[i], m0 + c, key, p);
        const float pr = fast_exp2(fmaf(z, kLog2e, -ls[c]));
        dp[i] = E::grad(pr * (dp[i] - dl[c]), s[i], m0 + c, key, p);
        s[i] = pr;
      }

      // dV += P^T dO, then dK += dS^T Q, over the tile's queries, each A
      // operand as hi + lo; dO and Q MN-major (transposed)
      split(s, ahi, alo);
      hopper::fence_regs(dv_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint64_t b_do = mnmajor<D>(do_t, BM, col_w, kk);
        hopper::Wgmma<NACC>::template rs<1>(dv_acc, ahi[kk], b_do, 1);
        hopper::Wgmma<NACC>::template rs<1>(dv_acc, alo[kk], b_do, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(ahi);
      hopper::fence_regs(alo);
      split(dp, ahi, alo);
      hopper::fence_regs(dk_acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint64_t b_q = mnmajor<D>(q_t, BM, col_w, kk);
        hopper::Wgmma<NACC>::template rs<1>(dk_acc, ahi[kk], b_q, 1);
        hopper::Wgmma<NACC>::template rs<1>(dk_acc, alo[kk], b_q, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(ahi);
      hopper::fence_regs(alo);
    }
    if (it + STAGES < n && release<T::WG>(released + stage, tid)) load_item(stage, it + STAGES);
  }

  const int row0 = n0 + key_w + 16 * warp + lane / 4;
  store_rows<NACC>(dk + b * dk_sb + hk * dk_sh + col_w, dk_ss, row0, p.Skv, dk_acc, lane);
  store_rows<NACC>(dv + b * dv_sb + hk * dv_sh + col_w, dv_ss, row0, p.Skv, dv_acc, lane);
}

// ---------------------------------------------------------------------------
// 3. dq on the tensor cores.  Grid (ceil(Sq / BM), H, B), the query tiles
// in reverse (under a causal mask the heaviest first).  tq, tdo: maps with
// (SW, BM) boxes; tk, tv: (SW, BN) boxes.
// ---------------------------------------------------------------------------
template <int D, class E>
__global__ void __launch_bounds__(QTile<D>::THREADS, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse2, const float* __restrict__ delta, int sq_pad,
                bf16* __restrict__ dq, Params p, long long dq_sb, long long dq_sh,
                long long dq_ss) {
  using T = QTile<D>;
  constexpr int BN = T::BN, BM = T::BM, SW = T::SW, PITCH = T::PITCH, STAGES = T::STAGES;
  constexpr int NS = BN / 2, NO = D / 2;  // fp32 registers a thread: S or dP, dQ
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = hopper::smem_u32(smem_raw);
  const uint32_t q_s = (base + 1023u) & ~1023u;
  const uint32_t do_s = q_s + T::Q_BYTES;
  const uint32_t ring = do_s + T::Q_BYTES;                    // stage s: K, then V
  const uint32_t bars = ring + STAGES * 2 * T::KV_BYTES;      // Q/dO's mbarrier, then each stage's
  int* released = reinterpret_cast<int*>(smem_raw + (bars + 8 * (STAGES + 1) - base));

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.H / p.Hk);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int row_w = q0 + 64 * wg;                   // this warpgroup's first query row
  const int row0 = row_w + 16 * warp + lane / 4;    // this thread's rows: row0 and row0 + 8
  int lo, hi, w_lo, w_hi;
  key_range<E>(q0, BM, BN, p, lo, hi);              // the CTA loads these
  key_range<E>(row_w, 64, BN, p, w_lo, w_hi);       // this warpgroup uses these
  const int n = hi - lo;

  auto load_kv = [&](int stage, int tile) {
    const uint32_t bar = bars + 8 * (1 + stage), k_t = ring + stage * 2 * T::KV_BYTES;
    hopper::mbar_expect_tx(bar, 2 * T::KV_BYTES);
#pragma unroll
    for (int pn = 0; pn < T::PANELS; ++pn) {
      hopper::tma_load_4d(k_t + pn * BN * PITCH, &tk, bar, pn * SW, tile * BN, hk, b);
      hopper::tma_load_4d(k_t + T::KV_BYTES + pn * BN * PITCH, &tv, bar, pn * SW, tile * BN, hk, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(bars + 8 * i, 1);
    for (int i = 0; i < STAGES; ++i) released[i] = 0;
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    hopper::mbar_expect_tx(bars, 2 * T::Q_BYTES);
#pragma unroll
    for (int pn = 0; pn < T::PANELS; ++pn) {
      hopper::tma_load_4d(q_s + pn * BM * PITCH, &tq, bars, pn * SW, q0, h, b);
      hopper::tma_load_4d(do_s + pn * BM * PITCH, &tdo, bars, pn * SW, q0, h, b);
    }
    for (int st = 0; st < STAGES && st < n; ++st) load_kv(st, lo + st);
  }

  // this thread's rows' statistics (the padding past Sq: lse2 +inf)
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = ((long long)b * p.H + h) * sq_pad + row0 + 8 * r;
    l2[r] = lse2[at];
    dl[r] = delta[at];
  }
  float s[NS], dp[NS], acc[NO];
  uint32_t ahi[BN / 16][4], alo[BN / 16][4];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  if (n > 0) hopper::mbar_wait(bars, 0);

  for (int it = 0; it < n; ++it) {
    const int tile = lo + it, stage = it % STAGES;
    const uint32_t k_t = ring + stage * 2 * T::KV_BYTES, v_t = k_t + T::KV_BYTES;
    hopper::mbar_wait(bars + 8 * (1 + stage), (it / STAGES) & 1);
    if (tile >= w_lo && tile < w_hi) {
      // S = Q K^T and dP = dO V^T over D in k16 steps, all K-major
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hopper::Wgmma<BN>::template ss<0, 0>(s, kmajor<D>(q_s, BM, 64 * wg, ks),
                                             kmajor<D>(k_t, BN, 0, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        hopper::Wgmma<BN>::template ss<0, 0>(dp, kmajor<D>(do_s, BM, 64 * wg, ks),
                                             kmajor<D>(v_t, BN, 0, ks), ks > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // accumulator i: row row0 + 8 ((i / 2) % 2), key j0 + 8 (i / 4) +
      // 2 (lane % 4) + i % 2; keys past Skv (zeros from the map) add nothing
      const int j0 = tile * BN;
      const bool edge = j0 + BN > p.Skv;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1, row = row0 + 8 * r;
        const int key = j0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const float z = E::pre(s[i], row, key, p);
        float pr = fast_exp2(fmaf(z, kLog2e, -l2[r]));
        if (edge && key >= p.Skv) pr = 0.0f;
        dp[i] = E::grad(pr * (dp[i] - dl[r]), s[i], row, key, p);
      }
      split(dp, ahi, alo);

      // dQ += dS K over the tile's keys, dS as hi + lo; K MN-major
      // (transposed)
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t b_k = mnmajor<D>(k_t, BN, 0, kk);
        hopper::Wgmma<D>::template rs<1>(acc, ahi[kk], b_k, 1);
        hopper::Wgmma<D>::template rs<1>(acc, alo[kk], b_k, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(ahi);
      hopper::fence_regs(alo);
    }
    if (it + STAGES < n && release<T::WG>(released + stage, tid)) load_kv(stage, tile + STAGES);
  }
  store_rows<D>(dq + b * dq_sb + h * dq_sh, dq_ss, row0, p.Sq, acc, lane);
}

// ---------------------------------------------------------------------------
// fp32 on the SIMT cores (PR 13's kernels behind Epi).  32-row query and
// 32-key tiles in shared memory; 128 threads.
// ---------------------------------------------------------------------------
constexpr int kBQ = 32, kBKV = 32, kThreads = 128, kPP = kBKV + 1;

// Copy rows [r0, r0 + 32) of one head of a (.., seq, D) tensor into an
// fp32 32 x (D + 1) tile, zero past ``rows``.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ss, int r0,
                                          int rows) {
  for (int i = threadIdx.x; i < 32 * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = (r0 + r < rows) ? src[(r0 + r) * ss + d] : 0.0f;
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float s = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

template <int D>
constexpr size_t dkdv_simt_smem() {
  return sizeof(float) * (4 * 32 * (D + 1) + 2 * kBQ * kPP + 2 * kBQ);
}
template <int D>
constexpr size_t dq_simt_smem() {
  return sizeof(float) * (4 * 32 * (D + 1) + kBQ * kPP + 2 * kBQ);
}

// P and dS of the pair (row, col) from the raw scores s (q k) and dp (dO v).
template <class E>
__device__ __forceinline__ void simt_pair(const Params& p, int row, int col, float s, float dp,
                                          float l2, float dl, float& pr, float& ds) {
  pr = ds = 0.0f;
  if (row < p.Sq && col < p.Skv) {
    pr = exp2f(fmaf(E::pre(s, row, col, p), kLog2e, -l2));
    ds = E::grad(pr * (dp - dl), s, row, col, p);
  }
}

// dk, dv.  Grid (ceil(Skv / 32), Hk, B).  Thread t owns key row c = t / 4
// of the tile and dims cg + 4i (cg = t % 4) of its dK and dV rows; for the
// score tile it computes rows cg + 4jj of column c.
template <int D, class E>
__global__ void __launch_bounds__(kThreads)
dkdv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse2, const float* __restrict__ delta, int sq_pad,
                 float* __restrict__ dk, float* __restrict__ dv, Params pb, Strides st) {
  constexpr int DP = D + 1, NA = D / 4;
  extern __shared__ float smem[];
  float* Ks = smem;                // kBKV x DP
  float* Vs = Ks + kBKV * DP;      // kBKV x DP
  float* Qs = Vs + kBKV * DP;      // kBQ x DP
  float* dOs = Qs + kBQ * DP;      // kBQ x DP
  float* Ps = dOs + kBQ * DP;      // kBQ x kPP
  float* dSs = Ps + kBQ * kPP;     // kBQ x kPP
  float* Ls = dSs + kBQ * kPP;     // kBQ
  float* Dl = Ls + kBQ;            // kBQ

  const int b = blockIdx.z, hk = blockIdx.y, j0 = blockIdx.x * kBKV;
  const int G = pb.H / pb.Hk;
  const int tid = threadIdx.x, c = tid / 4, cg = tid % 4;
  load_tile<D>(Ks, k + b * st.v[SK] + hk * st.v[SK + 1], st.v[SK + 2], j0, pb.Skv);
  load_tile<D>(Vs, v + b * st.v[SV] + hk * st.v[SV + 1], st.v[SV + 2], j0, pb.Skv);
  int lo, hi;
  query_range<E>(j0, kBKV, kBQ, pb, lo, hi);

  float dk_acc[NA], dv_acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) { dk_acc[i] = 0.0f; dv_acc[i] = 0.0f; }

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* qp = q + b * st.v[SQ] + h * st.v[SQ + 1];
    const float* dop = dout + b * st.v[SDO] + h * st.v[SDO + 1];
    const long long srow = ((long long)b * pb.H + h) * sq_pad;
    for (int i0 = lo * kBQ; i0 < hi * kBQ; i0 += kBQ) {
      __syncthreads();  // the previous tile's reads are done (and K, V loaded)
      load_tile<D>(Qs, qp, st.v[SQ + 2], i0, pb.Sq);
      load_tile<D>(dOs, dop, st.v[SDO + 2], i0, pb.Sq);
      if (tid < kBQ) {
        Ls[tid] = lse2[srow + i0 + tid];
        Dl[tid] = delta[srow + i0 + tid];
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < kBQ / 4; ++jj) {
        const int r = cg + 4 * jj;
        float pr, ds;
        simt_pair<E>(pb, i0 + r, j0 + c, dot_rows<D>(&Qs[r * DP], &Ks[c * DP]),
                     dot_rows<D>(&dOs[r * DP], &Vs[c * DP]), Ls[r], Dl[r], pr, ds);
        Ps[r * kPP + c] = pr;
        dSs[r * kPP + c] = ds;
      }
      __syncthreads();
      for (int r = 0; r < kBQ; ++r) {
        const float pr = Ps[r * kPP + c], ds = dSs[r * kPP + c];
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          dv_acc[i] = fmaf(pr, dOs[r * DP + cg + 4 * i], dv_acc[i]);
          dk_acc[i] = fmaf(ds, Qs[r * DP + cg + 4 * i], dk_acc[i]);
        }
      }
    }
  }

  if (j0 + c < pb.Skv) {
    float* dkp = dk + b * st.v[SDK] + hk * st.v[SDK + 1] + (j0 + c) * st.v[SDK + 2];
    float* dvp = dv + b * st.v[SDV] + hk * st.v[SDV + 1] + (j0 + c) * st.v[SDV + 2];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      dkp[cg + 4 * i] = dk_acc[i];
      dvp[cg + 4 * i] = dv_acc[i];
    }
  }
}

// dq.  Grid (ceil(Sq / 32), H, B).  Thread t owns query row r = t / 4 and
// dims cg + 4i of its dQ row; for the score tile it computes columns
// cg + 4jj of row r.
template <int D, class E>
__global__ void __launch_bounds__(kThreads)
dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse2, const float* __restrict__ delta, int sq_pad,
               float* __restrict__ dq, Params pb, Strides st) {
  constexpr int DP = D + 1, NA = D / 4;
  extern __shared__ float smem[];
  float* Qs = smem;                // kBQ x DP
  float* dOs = Qs + kBQ * DP;      // kBQ x DP
  float* Ks = dOs + kBQ * DP;      // kBKV x DP
  float* Vs = Ks + kBKV * DP;      // kBKV x DP
  float* dSs = Vs + kBKV * DP;     // kBQ x kPP
  float* Ls = dSs + kBQ * kPP;     // kBQ
  float* Dl = Ls + kBQ;            // kBQ

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (pb.H / pb.Hk);
  const int tid = threadIdx.x, r = tid / 4, cg = tid % 4;
  const float* kp = k + b * st.v[SK] + hk * st.v[SK + 1];
  const float* vp = v + b * st.v[SV] + hk * st.v[SV + 1];
  load_tile<D>(Qs, q + b * st.v[SQ] + h * st.v[SQ + 1], st.v[SQ + 2], q0, pb.Sq);
  load_tile<D>(dOs, dout + b * st.v[SDO] + h * st.v[SDO + 1], st.v[SDO + 2], q0, pb.Sq);
  if (tid < kBQ) {
    const long long at = ((long long)b * pb.H + h) * sq_pad + q0 + tid;
    Ls[tid] = lse2[at];
    Dl[tid] = delta[at];
  }
  int lo, hi;
  key_range<E>(q0, kBQ, kBKV, pb, lo, hi);

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;

  for (int j0 = lo * kBKV; j0 < hi * kBKV; j0 += kBKV) {
    __syncthreads();  // Q, dO loaded; the previous tile's reads are done
    load_tile<D>(Ks, kp, st.v[SK + 2], j0, pb.Skv);
    load_tile<D>(Vs, vp, st.v[SV + 2], j0, pb.Skv);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kBKV / 4; ++jj) {
      const int c = cg + 4 * jj;
      float pr, ds;
      simt_pair<E>(pb, q0 + r, j0 + c, dot_rows<D>(&Qs[r * DP], &Ks[c * DP]),
                   dot_rows<D>(&dOs[r * DP], &Vs[c * DP]), Ls[r], Dl[r], pr, ds);
      dSs[r * kPP + c] = ds;
    }
    __syncwarp();  // a row's dS values are written and read by the same warp
    for (int c = 0; c < kBKV; ++c) {
      const float ds = dSs[r * kPP + c];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = fmaf(ds, Ks[c * DP + cg + 4 * i], acc[i]);
    }
  }

  if (q0 + r < pb.Sq) {
    float* dqp = dq + b * st.v[SDQ] + h * st.v[SDQ + 1] + (q0 + r) * st.v[SDQ + 2];
#pragma unroll
    for (int i = 0; i < NA; ++i) dqp[cg + 4 * i] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// Launch: stats, then dk/dv, then dq, on one stream.
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The plan the wrapper (kernels/flash_attention.py::backward_plan) hands
// the entry point: keys a dk/dv CTA, its ring stages and dynamic shared
// memory; query rows a dq CTA, its keys a tile, ring stages and dynamic
// shared memory; Sq padded to whole tiles.
struct Plan {
  int kv_rows, kv_stages, kv_smem, q_rows, q_bn, q_stages, q_smem, sq_pad;
};

template <int D, class E>
cudaError_t launch_wgmma(const void* const* t, float* lse2, float* delta, const Plan& pl,
                         void* dq, void* dk, void* dv, int B, const Params& p, const Strides& st,
                         cudaStream_t s) {
  using KV = KvTile<D>;
  using QT = QTile<D>;
  if (pl.kv_rows != KV::BN || pl.kv_stages != KV::STAGES || pl.kv_smem != KV::SMEM ||
      pl.q_rows != QT::BM || pl.q_bn != QT::BN || pl.q_stages != QT::STAGES ||
      pl.q_smem != QT::SMEM)
    return cudaErrorInvalidConfiguration;
  // maps of q and do by the dk/dv kernel's (64-row) and the dq kernel's
  // boxes, of k and v by each kernel's key tile
  CUtensorMap q_kv, do_kv, k_kv, v_kv, q_q, do_q, k_q, v_q;
  const int SW = KV::SW;
  const long long* v = st.v;
  cudaError_t e = cudaSuccess;
  auto map = [&](CUtensorMap* m, const void* ptr, int S, int heads, int at, int rows) {
    if (e == cudaSuccess)
      e = hopper::tile_map(m, ptr, D, S, heads, B, v[at + 2], v[at + 1], v[at], SW, rows);
  };
  map(&q_kv, t[0], p.Sq, p.H, SQ, KV::BM);
  map(&do_kv, t[4], p.Sq, p.H, SDO, KV::BM);
  map(&k_kv, t[1], p.Skv, p.Hk, SK, KV::BN);
  map(&v_kv, t[2], p.Skv, p.Hk, SV, KV::BN);
  map(&q_q, t[0], p.Sq, p.H, SQ, QT::BM);
  map(&do_q, t[4], p.Sq, p.H, SDO, QT::BM);
  map(&k_q, t[1], p.Skv, p.Hk, SK, QT::BN);
  map(&v_q, t[2], p.Skv, p.Hk, SV, QT::BN);
  if (e != cudaSuccess) return e;
  auto kv = dkdv_wgmma_kernel<D, E>;
  if ((e = allow_smem(kv, KV::SMEM)) != cudaSuccess) return e;
  dim3 kv_grid((p.Skv + KV::BN - 1) / KV::BN, p.Hk, B);
  kv<<<kv_grid, KV::THREADS, KV::SMEM, s>>>(q_kv, k_kv, v_kv, do_kv, lse2, delta, pl.sq_pad,
                                            static_cast<bf16*>(dk), static_cast<bf16*>(dv), p,
                                            v[SDK], v[SDK + 1], v[SDK + 2], v[SDV], v[SDV + 1],
                                            v[SDV + 2]);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  auto qk = dq_wgmma_kernel<D, E>;
  if ((e = allow_smem(qk, QT::SMEM)) != cudaSuccess) return e;
  dim3 q_grid((p.Sq + QT::BM - 1) / QT::BM, p.H, B);
  qk<<<q_grid, QT::THREADS, QT::SMEM, s>>>(q_q, k_q, v_q, do_q, lse2, delta, pl.sq_pad,
                                           static_cast<bf16*>(dq), p, v[SDQ], v[SDQ + 1],
                                           v[SDQ + 2]);
  return cudaGetLastError();
}

template <int D, class E>
cudaError_t launch_simt(const void* const* t, float* lse2, float* delta, const Plan& pl,
                        void* dq, void* dk, void* dv, int B, const Params& p, const Strides& st,
                        cudaStream_t s) {
  if (pl.kv_rows != kBKV || pl.kv_stages != 1 || pl.kv_smem != (int)dkdv_simt_smem<D>() ||
      pl.q_rows != kBQ || pl.q_bn != kBKV || pl.q_stages != 1 ||
      pl.q_smem != (int)dq_simt_smem<D>())
    return cudaErrorInvalidConfiguration;
  const float* q = static_cast<const float*>(t[0]);
  const float* k = static_cast<const float*>(t[1]);
  const float* v = static_cast<const float*>(t[2]);
  const float* dO = static_cast<const float*>(t[4]);
  cudaError_t e;
  auto kv = dkdv_simt_kernel<D, E>;
  if ((e = allow_smem(kv, dkdv_simt_smem<D>())) != cudaSuccess) return e;
  dim3 kv_grid((p.Skv + kBKV - 1) / kBKV, p.Hk, B);
  kv<<<kv_grid, kThreads, dkdv_simt_smem<D>(), s>>>(q, k, v, dO, lse2, delta, pl.sq_pad,
                                                    static_cast<float*>(dk),
                                                    static_cast<float*>(dv), p, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  auto qk = dq_simt_kernel<D, E>;
  if ((e = allow_smem(qk, dq_simt_smem<D>())) != cudaSuccess) return e;
  dim3 q_grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
  qk<<<q_grid, kThreads, dq_simt_smem<D>(), s>>>(q, k, v, dO, lse2, delta, pl.sq_pad,
                                                 static_cast<float*>(dq), p, st);
  return cudaGetLastError();
}

template <int D, class E>
cudaError_t launch(int bf16_, const void* const* t, const float* lse, float* stats,
                   const Plan& pl, void* dq, void* dk, void* dv, int B, const Params& p,
                   const Strides& st, cudaStream_t s) {
  float* lse2 = stats;
  float* delta = stats + (long long)B * p.H * pl.sq_pad;
  const long long rows = (long long)B * p.H * pl.sq_pad;
  const unsigned blocks = static_cast<unsigned>((rows + 3) / 4);
  if (bf16_)
    stats_kernel<bf16><<<blocks, 128, 0, s>>>(static_cast<const bf16*>(t[3]),
                                              static_cast<const bf16*>(t[4]), lse, lse2, delta,
                                              p.H, p.Sq, pl.sq_pad, D, rows, st);
  else
    stats_kernel<float><<<blocks, 128, 0, s>>>(static_cast<const float*>(t[3]),
                                               static_cast<const float*>(t[4]), lse, lse2, delta,
                                               p.H, p.Sq, pl.sq_pad, D, rows, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return bf16_ ? launch_wgmma<D, E>(t, lse2, delta, pl, dq, dk, dv, B, p, st, s)
               : launch_simt<D, E>(t, lse2, delta, pl, dq, dk, dv, B, p, st, s);
}

// The body of a source's C entry point
//   extern "C" int attention_bwd(...)
// with the arguments below: q, k, v, o, do and dq, dk, dv of one dtype (bf16
// if bf16_, else fp32) with unit stride over D; lse: the forward's
// contiguous fp32 (B, H, Sq) row log-sum-exp; stats: a contiguous fp32
// scratch of 2 x B x H x sq_pad; plan: 8 host ints (Plan); strides: 24 host
// int64s (Strides).  Returns the first launch error, cudaErrorInvalidValue
// for a head dim the source does not build (a generated source builds its
// graph's own), cudaErrorInvalidConfiguration for a plan it does not.
template <class E, int... Ds>
int entry(const void* q, const void* k, const void* v, const void* o, const void* lse,
          const void* dout, void* stats, void* dq, void* dk, void* dv, int bf16_, int B, int H,
          int Hk, int Sq, int Skv, int D, const int* plan, const long long* strides, int causal,
          int window, float scale, void* stream) {
  Strides st;
  for (int i = 0; i < 24; ++i) st.v[i] = strides[i];
  const Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6], plan[7]};
  const Params p{H, Hk, Sq, Skv, causal, window, scale};
  const void* t[5] = {q, k, v, o, dout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(stats);
  cudaError_t e = cudaErrorInvalidValue;
  ((D == Ds ? (e = launch<Ds, E>(bf16_, t, l, sc, pl, dq, dk, dv, B, p, st, s), 0) : 0), ...);
  return static_cast<int>(e);
}

}  // namespace attn_bwd
