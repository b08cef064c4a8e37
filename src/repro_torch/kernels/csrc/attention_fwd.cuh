// The attention forward for Hopper: O = softmax(pre(q k^T)) v and each
// row's log-sum-exp, templated on an epilogue struct `Epi`, so that one
// mainloop serves K2 (csrc/flash_attention.cu: the caller's scale and the
// causal and window masks aligned at the ends) and K5's chained forward
// (kernels/fused_gemm.py generates one source per chained TppGraph, whose
// Epi is the graph's own pre-reduce nodes; csrc/fused_chain.cuh launches
// it), as csrc/attention_bwd.cuh serves both backwards.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py:35
// flash_attention_pallas (K2) and the chained branch of
// repro/fusion/lowering.py:330 _compile_pallas (K5's chained root).
//
// The Epi a source defines (p: the call's Params):
//   pre<MIXED>(s, gm, gn, p)
//       the raw score s = q.k at (query gm, key gn) mapped to the softmax
//       input, in natural units (the mainloop multiplies by log2 e); a
//       masked pair gives the fill -1e30 (or -inf), and any input at or
//       below -1e29 adds nothing.  With MIXED false the tile is one where
//       the mask tile_mixed describes keeps every pair, and pre skips its
//       test;
//   key_range(q0, rows, bn, lo, hi, p)
//       the contiguous key tiles [lo, hi) of bn keys that the query rows
//       [q0, q0 + rows) below Sq can see; every tile outside holds only
//       masked pairs, and neither its loads nor its products run;
//   tile_mixed(m0, bm, n0, bn, p)
//       true for a tile of rows [m0, m0 + bm) and keys [n0, n0 + bn) where
//       the mask drops some pair (of the tiles key_range visits, those the
//       mask cuts): only there the per-element mask runs.
// Keys past Skv are masked by the mainloop itself, in the last tile.
// Semantics kept from K2 and K5's chained root: online softmax in fp32
// (m, l, acc); l summed from the fp32 probabilities before P is rounded to
// bf16 for P V; a row with no live score outputs 0 (l floored at 1e-30) and
// lse -inf; no float atomics, so two calls give the same bits.
//
// What bounds it on an H100: at the training shapes (minicpm-2b B 4, H 36,
// S 1024, D 64, causal; bert-large B 16, H 16, S 512, D 64) bytes, about
// 75 MB of q, k, v and o against 19 GFLOP of live scores (0.022 ms against
// 0.020 at the bf16 peak); operations from about S = 1200 on (gpt-j-6b's
// B 2, H 16, S 2048, D 256: 69 GFLOP, 0.069 ms, against 134 MB).  Either is
// reachable only with both products on the tensor cores.
//
// What the design does about it (K2's bf16 kernel, moved here): both products on
// wgmma, K/V loads in flight behind them.  A CTA owns 64 query rows per
// consumer warpgroup (two warpgroups at D 16 to 64, one at D 128 and 256)
// and loads its Q tile once by TMA into the swizzled layout wgmma reads
// (csrc/wgmma.cuh).  K and V stream through a ring of STAGES tiles of BN
// keys (FwdConfig), each filled by TMA (one tensor map per operand, built
// per call by the launcher from the operands' strides; an operand every
// problem shares gets extent 1 on that axis and coordinate 0) and
// completed on an mbarrier.  Warpgroups never wait for each other: each
// counts itself done with a stage, and the last one to finish it loads the
// tile STAGES ahead into it.  S = Q K^T is m64 x BN x k16 wgmma from
// shared memory (both K-major); the online softmax runs on the fp32
// accumulator in registers (exp2, row max and sum over the quad of lanes
// that share a row), masks only the tiles tile_mixed names or that cross
// the end of Skv, and skips the tiles key_range leaves out (per CTA for the
// loads, per warpgroup for the products).  P is rounded to bf16 in
// registers, where the accumulator's layout is wgmma's A fragment, and
// O += P V reads V as an MN-major B operand (the transpose bit).  The
// fixed grid reverses the query tiles under a causal mask so the heaviest
// start first; under a schedule a CTA takes its query rows from the order
// table instead.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace attn_fwd {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskFloor = -1e29f;  // a softmax input at or below it adds nothing

// What an Epi may read besides the coordinates: the call's shapes and the
// caller's masks and scale (a generated Epi has its own baked in).
struct Params {
  int H, Hk, Sq, Skv, causal, window;
  float scale;
};

// Where one call's operands and results are: o (fp32 if out_f32, else
// bf16) by (batch, head, seq) strides; lse null or a contiguous fp32
// (B, H, Sq); the multipliers of each operand's (head, batch) coordinates
// in its tensor map (0 for an axis the operand shares, whose map has
// extent 1 there; k and v take query head h's kv head h / (H / Hk));
// order null (the fixed grid, reversed if `reverse`) or each CTA's first
// query row, as (row, column) pairs in a schedule's order.
struct Layout {
  void* o;
  float* lse;
  long long o_sb, o_sh, o_ss;
  int out_f32;
  int q_h, q_b, k_h, k_b, v_h, v_b;
  const int* order;
  int reverse;
};

// The key tiles [lo, hi) of `bn` keys that the query rows [q0, q0 + rows)
// (those below Sq) can see under causal and window masks aligned at the
// ends (row i at key position i + Skv - Sq); every tile outside holds only
// masked pairs.  kernels/flash_attention.py::key_tile_range is its spec,
// and the CPU tests hold that against brute-force masks; both K2 kernels
// follow it.
__host__ __device__ __forceinline__ void key_tiles(int q0, int rows, int Sq, int Skv, int causal,
                                                   int window, int bn, int& lo, int& hi) {
  const int last = (q0 + rows < Sq ? q0 + rows : Sq) - 1, off = Skv - Sq;
  const int end = causal ? (Skv < last + off + 1 ? Skv : last + off + 1) : Skv;
  const int begin = window > 0 ? (q0 + off - window + 1 > 0 ? q0 + off - window + 1 : 0) : 0;
  if (last < q0 || end <= begin) {
    lo = hi = 0;
    return;
  }
  lo = begin / bn;
  hi = (end + bn - 1) / bn;
}

// Tiles by head dim: consumer warpgroups (64 query rows each), keys a K/V
// tile, stages of the ring, and the CTAs an SM should hold at once (which
// sets the registers __launch_bounds__ leaves a thread).  D 64 and 128 are
// the paths' (the fastest of the shapes timed on an H100); at both, two
// CTAs share an SM (about 83 KB of shared memory each), so one CTA's loads
// and epilogue run beside the other's products.
// kernels/flash_attention.py::WGMMA_TILES repeats them; the launchers
// refuse a plan that differs.
template <int D>
struct FwdConfig {
  static constexpr int WG = 2, BN = 128, STAGES = 2, CTAS = 1;
};
template <>
struct FwdConfig<64> {
  static constexpr int WG = 2, BN = 64, STAGES = 4, CTAS = 1;
};
template <>
struct FwdConfig<128> {
  static constexpr int WG = 1, BN = 64, STAGES = 2, CTAS = 2;
};
template <>
struct FwdConfig<256> {
  static constexpr int WG = 1, BN = 64, STAGES = 2, CTAS = 1;
};

template <int D>
struct FwdTile {
  static constexpr int WG = FwdConfig<D>::WG, BN = FwdConfig<D>::BN;
  static constexpr int STAGES = FwdConfig<D>::STAGES, CTAS = FwdConfig<D>::CTAS;
  static constexpr int BM = 64 * WG;               // query rows a CTA
  static constexpr int SW = D < 64 ? D : 64;       // columns of one swizzled panel
  static constexpr int PITCH = 2 * SW;             // bytes of a panel row: the swizzle span
  static constexpr int PANELS = D / SW;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;      // K or V of one stage
  // 1024 bytes of slack to align the panels, Q, the ring, one mbarrier for
  // Q and for each stage, and each stage's count of warpgroups done with it
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (STAGES + 1) + 4 * STAGES;
  static constexpr int THREADS = 128 * WG;
};

// Whether `plan` (query rows a CTA, keys a tile, ring stages, dynamic
// shared memory) is the one this head dim builds.
template <int D>
inline bool plan_is(const int* plan) {
  using T = FwdTile<D>;
  return plan[0] == T::BM && plan[1] == T::BN && plan[2] == T::STAGES && plan[3] == T::SMEM;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Issue the TMA loads of key tile `tile` (K, then V, each in PANELS
// panels) into ring stage `stage`; they complete on the stage's mbarrier.
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t ring, uint32_t bars, int stage, int tile, int kh,
                                        int kb, int vh, int vb) {
  using T = FwdTile<D>;
  const uint32_t bar = bars + 8 * (1 + stage), k_s = ring + stage * 2 * T::KV_BYTES;
  hopper::mbar_expect_tx(bar, 2 * T::KV_BYTES);
#pragma unroll
  for (int pn = 0; pn < T::PANELS; ++pn) {
    const uint32_t at = pn * T::BN * T::PITCH;
    hopper::tma_load_4d(k_s + at, tk, bar, pn * T::SW, tile * T::BN, kh, kb);
    hopper::tma_load_4d(k_s + T::KV_BYTES + at, tv, bar, pn * T::SW, tile * T::BN, vh, vb);
  }
}

// One tile's scores into the softmax input in log2 units, and each of the
// thread's two rows' maximum over them.  Accumulator i holds row
// row0 + 8 r, r = (i / 2) % 2, and column 8 (i / 4) + 2 (lane % 4) + i % 2
// of the tile.  MIXED: the tile crosses the mask's edge or the end of the
// keys, so each pair is tested.
template <class E, bool MIXED, int NS>
__device__ __forceinline__ void scores(float (&s)[NS], float (&mx)[2], int row0, int j0, int lane,
                                       const Params& p) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    const int gm = row0 + 8 * r, gn = j0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
    float x;
    if (MIXED) {
      const float z = gn < p.Skv ? E::template pre<true>(s[i], gm, gn, p) : -INFINITY;
      x = z > kMaskFloor ? z * kLog2e : -INFINITY;
    } else {
      x = E::template pre<false>(s[i], gm, gn, p) * kLog2e;
    }
    s[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
}

// tq, tk, tv: 4-D tensor maps (D, S, heads, B) of q, k, v with boxes of
// (SW, BM) and (SW, BN).  Grid (query tiles or order entries, H, B),
// 128 threads a consumer warpgroup.
template <int D, class E>
__global__ void __launch_bounds__(FwdTile<D>::THREADS, FwdTile<D>::CTAS)
attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Layout L,
                           const Params p) {
  using T = FwdTile<D>;
  constexpr int BN = T::BN, BM = T::BM, SW = T::SW, PITCH = T::PITCH, STAGES = T::STAGES;
  constexpr int NS = BN / 2, NO = D / 2;  // fp32 accumulator registers a thread: S, O
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = q_s + T::Q_BYTES;                      // stage s: K, then V
  const uint32_t bars = ring + STAGES * 2 * T::KV_BYTES;       // Q's mbarrier, then each stage's
  // per stage, the warpgroups done with its tile (the last one refills it)
  int* released = reinterpret_cast<int*>(smem_raw + (bars + 8 * (STAGES + 1) -
                                                     hopper::smem_u32(smem_raw)));

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.H / p.Hk);
  // the heaviest tiles first under a causal mask; a schedule's order if given
  const int q0 = L.order != nullptr
                     ? L.order[2 * blockIdx.x]
                     : (L.reverse ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BM;
  const int kh = hk * L.k_h, kb = b * L.k_b, vh = hk * L.v_h, vb = b * L.v_b;
  const int row_w = q0 + 64 * wg;                  // this warpgroup's first query row
  const int row0 = row_w + 16 * warp + lane / 4;   // this thread's rows: row0 and row0 + 8
  int lo, hi, w_lo, w_hi;
  E::key_range(q0, BM, BN, lo, hi, p);             // the CTA loads these
  E::key_range(row_w, 64, BN, w_lo, w_hi, p);      // this warpgroup uses these
  const int n = hi - lo;

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(bars + 8 * i, 1);
    for (int i = 0; i < STAGES; ++i) released[i] = 0;
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    // rows past Sq and keys past Skv arrive as zeros (the maps' bounds)
    hopper::mbar_expect_tx(bars, T::Q_BYTES);
#pragma unroll
    for (int pn = 0; pn < T::PANELS; ++pn)
      hopper::tma_load_4d(q_s + pn * BM * PITCH, &tq, bars, pn * SW, q0, h * L.q_h, b * L.q_b);
    for (int st = 0; st < STAGES && st < n; ++st)
      load_kv<D>(&tk, &tv, ring, bars, st, lo + st, kh, kb, vh, vb);
  }

  float s[NS], acc[NO];
  uint32_t pf[BN / 16][4];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  // running max (in log2 units) and this thread's share of the row sums
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  if (n > 0) hopper::mbar_wait(bars, 0);

  for (int it = 0; it < n; ++it) {
    const int tile = lo + it, stage = it % STAGES;
    const uint32_t k_s = ring + stage * 2 * T::KV_BYTES, v_s = k_s + T::KV_BYTES;
    hopper::mbar_wait(bars + 8 * (1 + stage), (it / STAGES) & 1);
    if (tile >= w_lo && tile < w_hi) {
      // S = Q K^T over D in k16 steps; Q and K both K-major
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int panel = (ks * 16) / SW;
        const uint32_t col = ((ks * 16) % SW) * 2;  // bytes into the panel's rows
        const uint64_t da = hopper::desc(q_s + panel * BM * PITCH + wg * 64 * PITCH + col, 16,
                                         8 * PITCH, PITCH);
        const uint64_t db = hopper::desc(k_s + panel * BN * PITCH + col, 16, 8 * PITCH, PITCH);
        hopper::Wgmma<BN>::template ss<0, 0>(s, da, db, ks > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // The softmax input in log2 units; the per-pair mask only on a tile
      // that crosses the mask's edge or the end of the keys.
      const int j0 = tile * BN;
      float mx[2] = {-INFINITY, -INFINITY};
      if (E::tile_mixed(row_w, 64, j0, BN, p) || j0 + BN > p.Skv)
        scores<E, true>(s, mx, row0, j0, lane, p);
      else
        scores<E, false>(s, mx, row0, j0, lane, p);
      float alpha[2], base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        base[r] = m_new == -INFINITY ? 0.0f : m_new;  // a row with no live key so far
        alpha[r] = fast_exp2(m[r] - base[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float pr = fast_exp2(s[i] - base[(i >> 1) & 1]);
        l[(i >> 1) & 1] += pr;  // summed in fp32, before P is rounded
        s[i] = pr;
      }
      // P in bf16: the accumulator's layout is wgmma's A fragment
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pf[kk][j] = hopper::pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V over the tile's keys in k16 steps; V MN-major (transposed)
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = hopper::desc(v_s + kk * 16 * PITCH, BN * PITCH, 8 * PITCH, PITCH);
        hopper::Wgmma<D>::template rs<1>(acc, pf[kk], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(pf);
    }
    // Release the stage: the last warpgroup done with it loads the tile
    // STAGES ahead into it, so neither warpgroup waits for the other.
    if (it + STAGES < n) {
      // this warpgroup's four warps are past their products
      if (wg == 0) hopper::named_sync<1, 128>();
      else hopper::named_sync<2, 128>();
      if (tid % 128 == 0 && hopper::last_to_arrive(released + stage, T::WG))
        load_kv<D>(&tk, &tv, ring, bars, stage, tile + STAGES, kh, kb, vh, vb);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const int row = row0 + 8 * r;
    if (row < p.Sq) {
      const float inv = 1.0f / fmaxf(sum, 1e-30f);
      const long long at = b * L.o_sb + h * L.o_sh + row * L.o_ss + 2 * (lane % 4);
      if (L.out_f32) {
        float* op = static_cast<float*>(L.o) + at;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<float2*>(op + 8 * i) =
              make_float2(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
      } else {
        bf16* op = static_cast<bf16*>(L.o) + at;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * i) =
              __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
      }
      if (L.lse != nullptr && lane % 4 == 0)
        L.lse[((long long)b * p.H + h) * p.Sq + row] =
            sum > 0.0f ? m[r] * 0.6931471805599453f + logf(sum) : -INFINITY;
    }
  }
}

// Launch on one stream: `tiles` CTAs of query rows (the order table's
// length under a schedule) for each of p.H heads and B batches.
template <int D, class E>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Layout& L, const Params& p, int tiles, int B, cudaStream_t s) {
  using T = FwdTile<D>;
  auto kern = attention_fwd_wgmma_kernel<D, E>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid(tiles, p.H, B);
  kern<<<grid, T::THREADS, T::SMEM, s>>>(tq, tk, tv, L, p);
  return cudaGetLastError();
}

}  // namespace attn_fwd
