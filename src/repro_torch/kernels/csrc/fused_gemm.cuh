// K5: the fused-TppGraph kernel templates.  kernels/fused_gemm.py generates
// one source per simplified graph, which includes this file, defines a
// struct `Epi` (the graph's roots, their operands' layouts and its epilogue
// DAG as straight-line fp32 C++) and the C entry point `fused_gemm` as
// `fg::entry<Epi>`, which instantiates the kernels below on it.  A graph
// with a chained root instantiates csrc/fused_chain.cuh instead (and
// through it the forward mainloop of csrc/attention_fwd.cuh).
//
// Replaces the TPU kernel repro/fusion/lowering.py:330 `_compile_pallas`
// (launched through repro/core/pallas_lowering.py `make_pallas_fn`): R <= 3
// GEMMs C_r[M, N_r] = op(A_l(r))[M, K] @ op(B_r)[K, N_r] sharing one (M, K)
// problem, each with an fp32 accumulator, and the epilogue DAG applied to the
// accumulators before anything is written.  op() reads an operand stored
// transposed (trans=True: lhs stored (K, M), rhs stored (N, K)) in place.
// Several outputs stack on a leading axis, (NOUT, M, N); a root narrower
// than N (GQA's k/v in fused_qkv) computes only its own columns and its
// stack slice is zero past its width.  Leading batch axes (up to two, each
// operand with its own strides, 0 for an operand every problem shares) run
// one problem per grid.z index: the reference's vmap over a 2-D graph.
//
// A graph with a reducing node (softmax, softmax_grad, layernorm, rmsnorm
// and their gradients) runs as a row panel: a block owns BM whole rows and
// walks every N tile of them; per tile it runs the pre-reduce nodes and
// writes the values the reducing node consumes (the staged panels) to an
// fp32 scratch in device memory; after the last tile it closes each row
// from that scratch (L2-resident: the block's rows only) with the row
// statistics strip (max and sum of exponentials, or sum and sum of squares)
// in shared memory, then runs the post-reduce nodes and writes the outputs.
// The reference stages the panel in VMEM; a block's 227 KB of shared memory
// holds 32 fp32 rows of 1024 but not one of 5120 x 64 rows, so the panel
// goes through device memory at every width, and only the strip stays on
// chip.  A row closes in a fixed order (one warp a row), so the kernel is
// deterministic: no float atomics.
//
// Coordinate-keyed ops (dropout_rng and its gradient: threefry2x32-20 on
// (seed, salt) keyed by the element's (row, column) in its 2-D problem;
// attn_mask and its gradient: causal / window / offset) evaluate at the
// element's global coordinates, so the bits equal repro_torch/fusion/rng.py
// tile_bits and a backward graph regenerates the forward's keep pattern.
// With the hw flag set (fusion.compile(..., hw_prng=True)) dropout_rng draws
// K13's bits instead, Philox4x32-10 per plan tile (csrc/philox.cuh).  The
// draws of a plain or pre-reduce body are taken by the template, not the
// body: E::apply and E::pre read a keep word (bit j: draw j kept) that
// keep_bits draws an element at a time, or that the wgmma tile draws ahead
// into a register fragment (KeepFrag, consume_and_draw: K13 one call for
// four columns in a DRAW4 source, other draws in the mainloop's shadow).
//
// A schedule (fusion.compile(..., spec_string=, tiles=, block_steps=))
// reaches the kernel as a table of tile origins in the plan's visit order
// (FusedArgs::order, built by kernels/fused_gemm.py from the PARLOOPER
// plan): block i computes the i-th tile, so the spec string sets the order
// the tiles are rasterised in.  A tile is computed the same way whichever
// block computes it, so every schedule gives the same bits.  Without a
// table the grid is the fixed 2-D raster, "bca"'s order.
//
// What bounds it on an H100: at prefill and training (M in the thousands
// against the 2304..13824-wide weights) tensor-core operations, which only
// wgmma fed ahead of time reaches; at decode (M <= 16) one pass over the R
// weight matrices, HBM bytes; a row panel adds two to four fp32 passes over
// its staged rows (L2).  Fusing saves bytes only: the lhs is read once per
// K step for all roots, the roots' accumulators never go to device memory,
// the output is written once.
//
// What the design does about it: five variants, which the wrapper's plan
// (kernels/fused_gemm.py gemm_plan) names from the operands' dtypes, M and
// layout, and the C entry launches or refuses (no fallback):
//   wgmma (bf16, M > 16, every operand TMA can read): the producer warp and
//     wgmma consumers of csrc/gemm_mainloop.cuh, with the distinct lhs
//     tiles and the R rhs tiles of a k-step in one ring stage, one tensor
//     map each (an axis every problem shares has extent 1), each read where
//     it lies (a transposed operand MN-major, with wgmma's transpose bit).
//     Two consumer warpgroups of 64 rows each run R wgmma groups a k16
//     step into R accumulators in registers: a 128 x 128 tile for one root,
//     128 x 64 for two or three (R x BN / 2 fp32 a thread: 64, 64, 96), two
//     CTAs an SM where 64 do (WTile).  A narrow root's tiles past its width
//     load nothing and run no product (the producer expects fewer bytes);
//     the fixed grid is rasterised in groups of 8 row tiles as K1's.  The
//     generated Epi::apply runs from the accumulator registers (acc_row /
//     acc_col), two adjacent columns a call, stored as pairs.
//   wgmma_decode (bf16, M <= 16): K1's weight stream (csrc/gemm.cu): the
//     operands swap so the R weight tiles are wgmma's 64-row side and the
//     rows its n 16; K is split by (K, N) alone into fp32 partials that the
//     last CTA of each 128-column panel sums in split order (a counter in
//     device memory it resets; no float atomics), so a decoded row has the
//     same bits at every M <= 16.
//   wgmma_split (an fp32 lhs against bf16 rhs, or a bf16 lhs against fp32
//     rhs: the derived backward graphs, which read fp32 dz): a pre-pass
//     (fg_split_bf16) writes each fp32 operand x as two bf16 pieces, hi =
//     bf16(x) and lo = bf16(x - hi), and the wgmma tile runs hi and lo
//     against the exact bf16 operand, hi first, a k16 step at a time, each
//     64-deep step into a fresh accumulator that the CUDA cores add to the
//     fp32 sum (the tensor cores truncate long partial sums): x = hi + lo
//     to about 2^-17 of |x|, so the product keeps the fp32 tolerance on the
//     tensor cores, with the transpose bit that TF32 wgmma lacks (x.T @ dz
//     reads dz MN-major).  One CTA an SM: a thread holds both sums.
//   wmma (bf16 operands TMA cannot read: a base or stride not a multiple
//     of 16 bytes): WMMA 16x16x16 fragments copied by threads, unpipelined:
//     128 x 128 (one root), 128 x 64 (two or three), 16 x 64 (M <= 16),
//     64 x 128 for a row panel.
//   simt (every operand fp32, the fp32 test configs; and mixed operands the
//     split does not take): full fp32 FMA, never TF32, 128 x 64 tiles.
// A row panel runs the wgmma tile (one consumer warpgroup, 64 rows) over its
// N tiles in PANEL mode, its producer walking every tile's k-steps through
// one ring, then closes its rows (four warps); wmma and simt keep their
// panels.  At M 4096 a 64-row band is 64 CTAs on 132 SMs.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_mainloop.cuh"
#include "philox.cuh"

#define FG_MAX_ROOTS 3
#define FG_MAX_EP 8
#define FG_MAX_SLOTS 6   // a wgmma ring stage's tiles of one side: 3 operands x 2 pieces

typedef __nv_bfloat16 fg_bf16;

// Everything a launch needs, filled by the wrapper (kernels/fused_gemm.py,
// class _Args) and passed by value.  Element strides; lhs[l] for the
// graph's distinct lhs operands, rhs[r] per root, crhs the chained root's
// rhs; ep[i] the epilogue operands in canonical order with their dtype
// (0 fp32, 1 bf16, 2 bool, 3 scalar held in ep_u32[i]).  s_*[2] are the
// strides of the two batch axes (B0, B1), grid.z = B0 * B1.  order: null
// (the fixed grid) or n_order (row, column) tile origins, block i taking
// entry i (a row panel or a chained root reads the rows only).  hw: draw
// dropout_rng from K13 on (prng_tm, prng_tn) tiles (full rows after the
// reducing node).  lse: null, or a chained root's (batch, M) fp32 row
// log-sum-exp output (the chained backward's row statistics).  chain_plan:
// a chained root's plan (kernels/fused_gemm.py::chain_plan): wgmma 1 or
// 0, rows a block, keys a tile, ring stages, dynamic shared memory.  The
// rest is a graph without a chained root's plan (fused_gemm.py gemm_plan):
// variant (enum Variant), the (rows, columns) tile the order table was made
// for (checked), wgmma_decode's partials (batch, splits, R, M, N) fp32 and
// counters (batch x 128-column panels, zero between launches) and its K
// split (splits parts of split_steps 64-deep steps), and wgmma_split's
// (2, B0 or 1, B1 or 1, rows, cols) bf16 pieces of each fp32 lhs and rhs.
struct FusedArgs {
  const void* lhs[FG_MAX_ROOTS];
  const void* rhs[FG_MAX_ROOTS];
  const void* crhs;
  const void* ep[FG_MAX_EP];
  void* out;
  float* scratch;
  long long lda[FG_MAX_ROOTS];
  long long ldb[FG_MAX_ROOTS];
  long long ldc;
  long long ld_ep[FG_MAX_EP];
  long long s_lhs[FG_MAX_ROOTS][2];
  long long s_rhs[FG_MAX_ROOTS][2];
  long long s_crhs[2];
  long long s_ep[FG_MAX_EP][2];
  long long s_out[2];
  long long s_scratch[2];
  int lhs_bf16[FG_MAX_ROOTS];
  int rhs_bf16[FG_MAX_ROOTS];
  int crhs_bf16;
  int ep_dtype[FG_MAX_EP];
  unsigned int ep_u32[FG_MAX_EP];
  int M, N, K, N2, R;
  int width[FG_MAX_ROOTS];
  int B1, batch;
  int all_bf16, out_bf16, vec;
  const int* order;
  int n_order;
  int prng_tm, prng_tn, hw;
  float* lse;
  int chain_plan[5];
  int variant;
  int cta_m, cta_n;
  float* ws;
  int* counters;
  int splits, split_steps;
  void* lhs_split[FG_MAX_ROOTS];
  void* rhs_split[FG_MAX_ROOTS];
};

// The block's problem: its two batch indices.
struct FgCtx {
  int b0, b1;
  __device__ __forceinline__ long long off(const long long (&s)[2]) const {
    return (long long)b0 * s[0] + (long long)b1 * s[1];
  }
};

// --- epilogue TPPs (fp32), the semantics of repro/core/tpp.py -------------
__device__ __forceinline__ float fg_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float fg_silu(float x) { return x * fg_sigmoid(x); }
__device__ __forceinline__ float fg_gelu(float x) {  // tanh approximation
  const float t = tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x));
  return 0.5f * x * (1.0f + t);
}
__device__ __forceinline__ float fg_gelu_grad(float dv, float x) {
  const float t = tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x));
  const float dt = (1.0f - t * t) * 0.7978845608028654f * (1.0f + 3.0f * 0.044715f * x * x);
  return dv * (0.5f * (1.0f + t) + 0.5f * x * dt);
}
__device__ __forceinline__ float fg_silu_grad(float dv, float x) {
  const float s = fg_sigmoid(x);
  return dv * s * (1.0f + x * (1.0f - s));
}
__device__ __forceinline__ float fg_sigmoid_grad(float dv, float x) {
  const float s = fg_sigmoid(x);
  return dv * s * (1.0f - s);
}

// threefry2x32-20 (repro_torch/fusion/rng.py threefry2x32), first word.
__device__ __forceinline__ uint32_t fg_rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}
__device__ __forceinline__ uint32_t fg_threefry(uint32_t k0, uint32_t k1, uint32_t x0,
                                                uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = fg_rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x0;
}
// Dropout at global (row, column): kept iff bits < threshold, kept values
// scaled in fp32 (fusion/graph.py _dropout_rng_apply).  The bits are the
// counter path's threefry, or with hw K13's Philox on (tm, tn) tiles.
__device__ __forceinline__ float fg_dropout_rng(float v, uint32_t seed, uint32_t salt,
                                                uint32_t thresh, float scale, int gm, int gn,
                                                int hw, int tm, int tn) {
  const uint32_t bits = hw ? fg_hw_tile_bits(seed, salt, gm, gn, tm, tn)
                           : fg_threefry(seed, salt, (uint32_t)gm, (uint32_t)gn);
  return bits < thresh ? v * scale : 0.0f;
}
// Causal / sliding-window keep test of attn_mask at (row gm, column gn).
__device__ __forceinline__ bool fg_attn_keep(int gm, int gn, bool causal, int window,
                                             int offset) {
  const int row = gm + offset;
  return (!causal || gn <= row) && (window <= 0 || gn > row - window);
}
#define FG_NEG_INF (-1e30f)
#define FG_MASK_FLOOR (-1e29f)

// An element of an operand as fp32 (dtype 0 fp32, 1 bf16), or a mask
// element as bool.
__device__ __forceinline__ float fg_load(const void* p, int dtype, long long i) {
  return dtype == 1 ? __bfloat162float(static_cast<const fg_bf16*>(p)[i])
                    : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ bool fg_mask(const void* p, long long i) {
  return static_cast<const uint8_t*>(p)[i] != 0;
}

namespace fg {

using namespace nvcuda;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ fg_bf16 from_float<fg_bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ FgCtx block_ctx(const FusedArgs& a) {
  return FgCtx{static_cast<int>(blockIdx.z) / a.B1, static_cast<int>(blockIdx.z) % a.B1};
}

// The block's tile origin (row, column): entry blockIdx.x of the order
// table (ORDERED), or the fixed grid's (blockIdx.y * bm, blockIdx.x * bn).
template <bool ORDERED>
__device__ __forceinline__ int2 tile_origin(const FusedArgs& a, int bm, int bn) {
  if constexpr (ORDERED)
    return make_int2(a.order[2 * blockIdx.x], a.order[2 * blockIdx.x + 1]);
  else
    return make_int2(static_cast<int>(blockIdx.y) * bm, static_cast<int>(blockIdx.x) * bn);
}

// The same, whether there is a table read at run time.  The bf16 pointwise
// kernel is instantiated on ORDERED instead: there the branch alone raised a
// three-root 128 x 64 tile's registers so far that one CTA fit an SM
// instead of two, and fused_qkv ran 1.6x slower on the fixed grid.
__device__ __forceinline__ int2 tile_origin(const FusedArgs& a, int bm, int bn) {
  return a.order != nullptr ? tile_origin<true>(a, bm, bn) : tile_origin<false>(a, bm, bn);
}

// The launch grid: one block per table entry, else tiles_n x tiles_m.
inline dim3 tile_grid(const FusedArgs& a, int bm, int bn) {
  if (a.order != nullptr) return dim3(a.n_order, 1, a.batch);
  return dim3((a.N + bn - 1) / bn, (a.M + bm - 1) / bm, a.batch);
}

// Where a tile's element goes: the plain epilogue (every node, every output
// stored), or a row panel's pre-reduce pass (the staged values to scratch).
enum Mode { PLAIN = 0, PANEL = 1 };

// A row panel's staged values of element (gm, gn) (`two`: and of gn + 1, v1)
// into its fp32 scratch panel, value j at ((j M + gm) N + gn) of the
// problem's slab; a pair as one 8-byte store where N is even.
template <int NS>
__device__ __forceinline__ void stage(const float* v0, const float* v1, int gm, int gn, bool two,
                                      const FusedArgs& a, const FgCtx& c) {
  float* s = a.scratch + c.off(a.s_scratch) + (long long)gm * a.N + gn;
  const long long slab = (long long)a.M * a.N;
  const bool pair = two && a.N % 2 == 0;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (pair) {
      *reinterpret_cast<float2*>(s + j * slab) = make_float2(v0[j], v1[j]);
    } else {
      s[j * slab] = v0[j];
      if (two) s[j * slab + 1] = v1[j];
    }
  }
}

// The keep word of element (gm, gn): bit j set where draw j of E's plain or
// pre-reduce body keeps it, one generator call an element (the counter
// path's threefry, or with hw K13's Philox on the plan's PRNG tile).
template <class E>
__device__ __forceinline__ uint32_t keep_bits(int gm, int gn, const FusedArgs& a) {
  uint32_t keep = 0;
#pragma unroll
  for (int j = 0; j < E::NDRAW; ++j) {
    uint32_t seed, salt, thresh;
    E::draw_key(j, a, seed, salt, thresh);
    const uint32_t bits = a.hw ? fg_hw_tile_bits(seed, salt, gm, gn, a.prng_tm, a.prng_tn)
                               : fg_threefry(seed, salt, (uint32_t)gm, (uint32_t)gn);
    keep |= (bits < thresh ? 1u : 0u) << j;
  }
  return keep;
}

template <class E, int MODE, typename TOut>
__device__ __forceinline__ void emit(const float* acc, int gm, int gn, const FusedArgs& a,
                                     const FgCtx& c) {
  if constexpr (MODE == PANEL) {
    float v[E::NSTAGED];
    E::pre(acc, keep_bits<E>(gm, gn, a), gm, gn, a, c, v);
    stage<E::NSTAGED>(v, v, gm, gn, false, a, c);
  } else {
    float out[E::NOUT];
    E::apply(acc, keep_bits<E>(gm, gn, a), gm, gn, a, c, out);
    TOut* o = static_cast<TOut*>(a.out) + c.off(a.s_out);
#pragma unroll
    for (int q = 0; q < E::NOUT; ++q)
      o[((long long)q * a.M + gm) * a.N + gn] = from_float<TOut>(out[q]);
  }
}

// The 8 bf16 at (r, c..c+7) of a rows x cols matrix with leading dimension
// ld into shared memory, zero outside it.
__device__ __forceinline__ void load8(fg_bf16* dst, const fg_bf16* src, int r, int c, int rows,
                                      int cols, long long ld, bool vec) {
  if (vec && r < rows && c + 8 <= cols) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src + r * ld + c);
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      dst[t] = (r < rows && c + t < cols) ? src[r * ld + c + t] : __float2bfloat16(0.0f);
  }
}

template <int BM_, int BN_, int WARPS_M, int WARPS_N>
struct Bf16Tiles {
  static constexpr int BM = BM_, BN = BN_, BK = 32;
  static constexpr int NT = WARPS_M * WARPS_N * 32, NW = WARPS_M * WARPS_N, WNS = WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int FM = WM / 16, FN = WN / 16;
  // A tile: BM x (BK + 8), or BK x (BM + 8) stored transposed; B likewise.
  // Rows padded by 8 elements: 16-byte aligned, fewer bank conflicts.
  static constexpr int AP = BK + 8, APT = BM + 8, BP = BN + 8, BPT = BK + 8;
  static constexpr int A_ELEMS = BM * AP > BK * APT ? BM * AP : BK * APT;
  static constexpr int B_ELEMS = BK * BP > BN * BPT ? BK * BP : BN * BPT;
};

// One root's products over a BK slice of shared memory, in the layouts its
// operands are stored in, then the next root's.
template <class E, class T, int Q>
struct RootMma {
  template <class Acc>
  __device__ __forceinline__ static void run(Acc& acc, const fg_bf16* As, const fg_bf16* Bs,
                                             int wm, int wn, const bool* live) {
    if constexpr (Q < E::R) {
      if (live[Q]) {
        constexpr int L = E::lhs_of(Q);
        constexpr bool TA = E::trans_lhs(L), TB = E::trans_rhs(Q);
        using LA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
        using LB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
        const fg_bf16* A = As + L * T::A_ELEMS;
        const fg_bf16* B = Bs + Q * T::B_ELEMS;
#pragma unroll
        for (int kk = 0; kk < T::BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, fg_bf16, LA> af[T::FM];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, fg_bf16, LB> bfr[T::FN];
#pragma unroll
          for (int i = 0; i < T::FM; ++i) {
            const int mm = wm * T::WM + i * 16;
            wmma::load_matrix_sync(af[i], TA ? &A[kk * T::APT + mm] : &A[mm * T::AP + kk],
                                   TA ? T::APT : T::AP);
          }
#pragma unroll
          for (int j = 0; j < T::FN; ++j) {
            const int nn = wn * T::WN + j * 16;
            wmma::load_matrix_sync(bfr[j], TB ? &B[nn * T::BPT + kk] : &B[kk * T::BP + nn],
                                   TB ? T::BPT : T::BP);
          }
#pragma unroll
          for (int i = 0; i < T::FM; ++i)
#pragma unroll
            for (int j = 0; j < T::FN; ++j)
              wmma::mma_sync(acc[Q][i][j], af[i], bfr[j], acc[Q][i][j]);
        }
      }
      RootMma<E, T, Q + 1>::run(acc, As, Bs, wm, wn, live);
    }
  }
};

template <class T, int R, int NL>
struct Bf16Smem {
  static constexpr int STAGE = (NL * T::A_ELEMS + R * T::B_ELEMS) * 2;
  static constexpr int EPI = T::NW * R * 256 * 4;
  static constexpr int BYTES = STAGE > EPI ? STAGE : EPI;
};

// One BM x BN output tile at (m0, n0), bf16 x bf16 -> fp32 on the tensor
// cores, then each element through emit<MODE>.
template <class E, class T, int MODE, typename TOut>
__device__ __forceinline__ void bf16_tile(const FusedArgs& a, const FgCtx& c, int m0, int n0,
                                          unsigned char* smem) {
  constexpr int R = E::R, NL = E::NLHS, BK = T::BK, NT = T::NT;
  static_assert(T::WM % 16 == 0 && T::WN % 16 == 0, "warp tile must be whole fragments");
  fg_bf16* As = reinterpret_cast<fg_bf16*>(smem);
  fg_bf16* Bs = As + NL * T::A_ELEMS;
  const int M = a.M, N = a.N, K = a.K;
  const bool vec = a.vec != 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / T::WNS, wn = warp % T::WNS;
  bool live[R];   // a narrow root's tiles past its width stay zero
  const fg_bf16* lhs[NL];
  const fg_bf16* rhs[R];
#pragma unroll
  for (int l = 0; l < NL; ++l) lhs[l] = static_cast<const fg_bf16*>(a.lhs[l]) + c.off(a.s_lhs[l]);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    live[r] = n0 < a.width[r];
    rhs[r] = static_cast<const fg_bf16*>(a.rhs[r]) + c.off(a.s_rhs[r]);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[R][T::FM][T::FN];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < T::FM; ++i)
#pragma unroll
      for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[r][i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      fg_bf16* dst = As + l * T::A_ELEMS;
      if (E::trans_lhs(l)) {   // stored (K, M): vectors along M
        for (int i = threadIdx.x; i < BK * T::BM / 8; i += NT) {
          const int r = i / (T::BM / 8), cc = (i % (T::BM / 8)) * 8;
          load8(&dst[r * T::APT + cc], lhs[l], k0 + r, m0 + cc, K, M, a.lda[l], vec);
        }
      } else {                 // stored (M, K): vectors along K
        for (int i = threadIdx.x; i < T::BM * BK / 8; i += NT) {
          const int r = i / (BK / 8), cc = (i % (BK / 8)) * 8;
          load8(&dst[r * T::AP + cc], lhs[l], m0 + r, k0 + cc, M, K, a.lda[l], vec);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!live[q]) continue;
      fg_bf16* dst = Bs + q * T::B_ELEMS;
      if (E::trans_rhs(q)) {   // stored (N, K): vectors along K
        for (int i = threadIdx.x; i < T::BN * BK / 8; i += NT) {
          const int r = i / (BK / 8), cc = (i % (BK / 8)) * 8;
          load8(&dst[r * T::BPT + cc], rhs[q], n0 + r, k0 + cc, a.width[q], K, a.ldb[q], vec);
        }
      } else {                 // stored (K, N): vectors along N
        for (int i = threadIdx.x; i < BK * T::BN / 8; i += NT) {
          const int r = i / (T::BN / 8), cc = (i % (T::BN / 8)) * 8;
          load8(&dst[r * T::BP + cc], rhs[q], k0 + r, n0 + cc, K, a.width[q], a.ldb[q], vec);
        }
      }
    }
    __syncthreads();
    RootMma<E, T, 0>::run(acc, As, Bs, wm, wn, live);
    __syncthreads();
  }

  // Epilogue: each warp stages one fragment position of every root in its
  // R x 16 x 16 slice of shared memory, then each lane runs the element.
  float* cs = reinterpret_cast<float*>(smem) + warp * R * 256;
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
#pragma unroll
      for (int q = 0; q < R; ++q)
        wmma::store_matrix_sync(cs + q * 256, acc[q][i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * T::WM + i * 16 + e / 16;
        const int gn = n0 + wn * T::WN + j * 16 + e % 16;
        if (gm < M && gn < N) {
          float v[R];
#pragma unroll
          for (int q = 0; q < R; ++q) v[q] = cs[q * 256 + e];
          emit<E, MODE, TOut>(v, gm, gn, a, c);
        }
      }
      __syncwarp();
    }
  __syncthreads();   // the staging space is the next tile's operand space
}

// SIMT fp32: a 128 x 64 tile with 256 threads, each an 8 x 4 micro-tile per
// root strided by 16 so shared reads do not conflict; every operand
// converted to fp32 as it is copied in (bf16 products are exact in fp32).
struct SimtTiles {
  static constexpr int BM = 128, BN = 64, BK = 16, NT = 256, TM = BM / 16, TN = BN / 16;
};

template <int R, int NL>
struct SimtSmem {
  float As[NL][SimtTiles::BK][SimtTiles::BM + 4];   // k-major
  float Bs[R][SimtTiles::BK][SimtTiles::BN + 4];
};

template <class E, int MODE, typename TOut>
__device__ __forceinline__ void simt_tile(const FusedArgs& a, const FgCtx& c, int m0, int n0,
                                          SimtSmem<E::R, E::NLHS>& sm) {
  using T = SimtTiles;
  constexpr int R = E::R, NL = E::NLHS, BK = T::BK, NT = T::NT, TM = T::TM, TN = T::TN;
  const int M = a.M, N = a.N, K = a.K;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  bool live[R];
  const void* lhs[NL];
  const void* rhs[R];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const long long o = c.off(a.s_lhs[l]);
    lhs[l] = a.lhs_bf16[l] ? static_cast<const void*>(static_cast<const fg_bf16*>(a.lhs[l]) + o)
                           : static_cast<const void*>(static_cast<const float*>(a.lhs[l]) + o);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    live[r] = n0 < a.width[r];
    const long long o = c.off(a.s_rhs[r]);
    rhs[r] = a.rhs_bf16[r] ? static_cast<const void*>(static_cast<const fg_bf16*>(a.rhs[r]) + o)
                           : static_cast<const void*>(static_cast<const float*>(a.rhs[r]) + o);
  }
  float acc[R][TM][TN];
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[q][i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int dt = a.lhs_bf16[l];
      if (E::trans_lhs(l)) {   // stored (K, M): M fastest
        for (int i = threadIdx.x; i < BK * T::BM; i += NT) {
          const int kk = i / T::BM, mm = i % T::BM, gk = k0 + kk, gm = m0 + mm;
          sm.As[l][kk][mm] = (gm < M && gk < K) ? fg_load(lhs[l], dt, gk * a.lda[l] + gm) : 0.0f;
        }
      } else {                 // stored (M, K): K fastest
        for (int i = threadIdx.x; i < BK * T::BM; i += NT) {
          const int mm = i / BK, kk = i % BK, gk = k0 + kk, gm = m0 + mm;
          sm.As[l][kk][mm] = (gm < M && gk < K) ? fg_load(lhs[l], dt, gm * a.lda[l] + gk) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!live[q]) continue;
      const int dt = a.rhs_bf16[q], w = a.width[q];
      if (E::trans_rhs(q)) {   // stored (N, K): K fastest
        for (int i = threadIdx.x; i < BK * T::BN; i += NT) {
          const int nn = i / BK, kk = i % BK, gk = k0 + kk, gn = n0 + nn;
          sm.Bs[q][kk][nn] = (gn < w && gk < K) ? fg_load(rhs[q], dt, gn * a.ldb[q] + gk) : 0.0f;
        }
      } else {                 // stored (K, N): N fastest
        for (int i = threadIdx.x; i < BK * T::BN; i += NT) {
          const int kk = i / T::BN, nn = i % T::BN, gk = k0 + kk, gn = n0 + nn;
          sm.Bs[q][kk][nn] = (gn < w && gk < K) ? fg_load(rhs[q], dt, gk * a.ldb[q] + gn) : 0.0f;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (!live[q]) continue;
        float x[TM], y[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) x[i] = sm.As[E::lhs_of(q)][kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) y[j] = sm.Bs[q][kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[q][i][j] = fmaf(x[i], y[j], acc[q][i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        float v[R];
#pragma unroll
        for (int q = 0; q < R; ++q) v[q] = acc[q][i][j];
        emit<E, MODE, TOut>(v, gm, gn, a, c);
      }
    }
}

// --- the row panel's close --------------------------------------------------
// Reducers, as E::RED: the close formulas of repro/fusion/lowering.py
// (_ln_close .. _rms_gamma_close over the (sum, sum-of-squares) strip) and
// the full-row softmax and softmax_grad.
enum Red {
  RED_SOFTMAX = 1, RED_SOFTMAX_GRAD = 2, RED_LAYERNORM = 3, RED_RMSNORM = 4, RED_LN_GRAD = 5,
  RED_LN_GAMMA_GRAD = 6, RED_RMS_GRAD = 7, RED_RMS_GAMMA_GRAD = 8
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
// Merge of running (max, sum of exp(x - max)) pairs.
__device__ __forceinline__ void online_merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}
__device__ __forceinline__ void warp_online(float& m, float& l) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    online_merge(m, l, m2, l2);
  }
}

// Close the block's rows m0 .. m0+rows-1 with its first `nw` warps: one warp
// a row, in a fixed order.  The strip (two floats a row) lives in shared
// memory between the passes.
template <class E, typename TOut>
__device__ void close_rows(const FusedArgs& a, const FgCtx& c, int m0, int rows, float* strip,
                           int nw) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= nw) return;
  const int N = a.N;
  const float n = static_cast<float>(N);
  TOut* o = static_cast<TOut*>(a.out) + c.off(a.s_out);
  for (int r = warp; r < rows; r += nw) {
    const int gm = m0 + r;
    if (gm >= a.M) break;
    float s0, s1, t0 = 0.0f, t1 = 0.0f;
    if constexpr (E::RED == RED_SOFTMAX || E::RED == RED_SOFTMAX_GRAD) {
      constexpr int Z = E::RED == RED_SOFTMAX ? 0 : 1;   // the softmax input
      float m = -3.0e38f, l = 0.0f;
      for (int gn = lane; gn < N; gn += 32) online_merge(m, l, E::red_in(Z, gm, gn, a, c), 1.0f);
      warp_online(m, l);
      s0 = m;
      s1 = l;
    } else {
      constexpr int Z = (E::RED == RED_LAYERNORM || E::RED == RED_RMSNORM) ? 0 : 1;
      float s = 0.0f, ss = 0.0f;
      for (int gn = lane; gn < N; gn += 32) {
        const float z = E::red_in(Z, gm, gn, a, c);
        s += z;
        ss += z * z;
      }
      s0 = warp_sum(s);
      s1 = warp_sum(ss);
    }
    if (lane == 0) {
      strip[2 * r] = s0;
      strip[2 * r + 1] = s1;
    }
    __syncwarp();
    s0 = strip[2 * r];
    s1 = strip[2 * r + 1];
    const float mu = s0 / n, var = fmaxf(s1 / n - mu * mu, 0.0f);
    const float rstd = rsqrtf(var + E::EPS), rms = rsqrtf(s1 / n + E::EPS);
    // a second pass where the close needs another row sum
    if constexpr (E::RED == RED_SOFTMAX_GRAD || E::RED == RED_LN_GRAD ||
                  E::RED == RED_RMS_GRAD) {
      for (int gn = lane; gn < N; gn += 32) {
        const float dv = E::red_in(0, gm, gn, a, c), z = E::red_in(1, gm, gn, a, c);
        if constexpr (E::RED == RED_SOFTMAX_GRAD) {
          t0 += dv * (expf(z - s0) / s1);
        } else {
          const float g = dv * E::red_param(0, gn, a);
          if constexpr (E::RED == RED_LN_GRAD) {
            t0 += g;
            t1 += g * ((z - mu) * rstd);
          } else {
            t0 += g * z;
          }
        }
      }
      t0 = warp_sum(t0);
      t1 = warp_sum(t1);
    }
    for (int gn = lane; gn < N; gn += 32) {
      float y;
      if constexpr (E::RED == RED_SOFTMAX) {
        y = expf(E::red_in(0, gm, gn, a, c) - s0) / s1;
      } else if constexpr (E::RED == RED_SOFTMAX_GRAD) {
        const float p = expf(E::red_in(1, gm, gn, a, c) - s0) / s1;
        y = p * (E::red_in(0, gm, gn, a, c) - t0);
      } else if constexpr (E::RED == RED_LAYERNORM) {
        y = (E::red_in(0, gm, gn, a, c) - mu) * rstd * E::red_param(0, gn, a) +
            E::red_param(1, gn, a);
      } else if constexpr (E::RED == RED_RMSNORM) {
        y = E::red_in(0, gm, gn, a, c) * rms * E::red_param(0, gn, a);
      } else if constexpr (E::RED == RED_LN_GRAD) {
        const float g = E::red_in(0, gm, gn, a, c) * E::red_param(0, gn, a);
        const float xhat = (E::red_in(1, gm, gn, a, c) - mu) * rstd;
        y = rstd * (g - t0 / n - xhat * (t1 / n));
      } else if constexpr (E::RED == RED_LN_GAMMA_GRAD) {
        y = E::red_in(0, gm, gn, a, c) * (E::red_in(1, gm, gn, a, c) - mu) * rstd;
      } else if constexpr (E::RED == RED_RMS_GRAD) {
        const float g = E::red_in(0, gm, gn, a, c) * E::red_param(0, gn, a);
        y = rms * g - (rms * rms * rms) * E::red_in(1, gm, gn, a, c) * (t0 / n);
      } else {   // RED_RMS_GAMMA_GRAD
        y = E::red_in(0, gm, gn, a, c) * E::red_in(1, gm, gn, a, c) * rms;
      }
      float out[E::NOUT];
      E::post(y, gm, gn, a, c, out);
#pragma unroll
      for (int q = 0; q < E::NOUT; ++q)
        o[((long long)q * a.M + gm) * N + gn] = from_float<TOut>(out[q]);
    }
  }
}

// --- the tensor-core variants on csrc/gemm_mainloop.cuh ----------------------
enum Variant { V_CLASSIC = 0, V_WGMMA = 1, V_DECODE = 2, V_SPLIT = 3 };

constexpr int kBK = gemm_ml::BK;        // k elements a ring stage
constexpr int kDecodeRows = 16;         // wgmma_decode: M <= 16, wgmma's n
constexpr int kDecodeCols = 128;        // wgmma_decode: columns of C a CTA

// f(std::integral_constant<int, I>{}) for I = 0 .. N-1, each a compile-time
// index (an operand's layout is a template argument).
template <int... I>
struct Seq {};
template <int N, int... I>
struct MakeSeq : MakeSeq<N - 1, N - 1, I...> {};
template <int... I>
struct MakeSeq<0, I...> {
  using type = Seq<I...>;
};
template <class F, int... I>
__device__ __forceinline__ void each_impl(F& f, Seq<I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void each(F f) {
  each_impl(f, typename MakeSeq<N>::type{});
}

constexpr int clamp_int(int x, int lo, int hi) { return x < lo ? lo : x > hi ? hi : x; }

// One tensor map a ring slot: a[] for wgmma's M side, b[] for its N side.
struct FusedMaps {
  CUtensorMap a[FG_MAX_SLOTS];
  CUtensorMap b[FG_MAX_SLOTS];
};

// A ring of STAGES stages of NA tiles of AR rows then NB tiles of BR rows,
// each BK deep, behind WG consumer warpgroups and one producer warp; the
// full and empty mbarriers of each stage after it.
template <int WG_, int AR, int BR, int NA_, int NB_, int STAGES_>
struct Ring {
  static constexpr int WG = WG_, NA = NA_, NB = NB_, STAGES = STAGES_;
  static constexpr int A_BYTES = AR * kBK * 2, B_BYTES = BR * kBK * 2;
  static constexpr int STAGE_BYTES = NA * A_BYTES + NB * B_BYTES;
  static constexpr int THREADS = 128 * WG + 32;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES + 16;
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "1024-byte aligned tiles");
  static_assert(SMEM <= 232448, "a CTA's shared memory");
  static_assert(NA <= FG_MAX_SLOTS && NB <= FG_MAX_SLOTS, "tensor maps a side");
};

template <class RG>
struct RingSmem {
  uint32_t ring, full, empty;
  int* flag;
  __device__ __forceinline__ explicit RingSmem(unsigned char* raw) {
    const uint32_t at = hopper::smem_u32(raw);
    ring = (at + 1023u) & ~1023u;
    full = ring + RG::STAGES * RG::STAGE_BYTES;
    empty = full + 8 * RG::STAGES;
    flag = reinterpret_cast<int*>(raw + (empty + 8 * RG::STAGES - at));
  }
  __device__ __forceinline__ uint32_t a(int s, int j) const {
    return ring + s * RG::STAGE_BYTES + j * RG::A_BYTES;
  }
  __device__ __forceinline__ uint32_t b(int s, int j) const {
    return ring + s * RG::STAGE_BYTES + RG::NA * RG::A_BYTES + j * RG::B_BYTES;
  }
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < RG::STAGES; ++s) {
        hopper::mbar_init(full + 8 * s, 1);
        hopper::mbar_init(empty + 8 * s, RG::WG);
      }
      hopper::mbar_init_fence();
    }
    __syncthreads();
  }
  // the producer: wait until the stage of ring step `it` is free and
  // expect `bytes` on its full barrier; → that barrier
  __device__ __forceinline__ uint32_t acquire(int it, uint32_t bytes) const {
    const int s = it % RG::STAGES;
    if (it >= RG::STAGES) gemm_ml::wait(empty + 8 * s, ((it / RG::STAGES) - 1) & 1);
    hopper::mbar_expect_tx(full + 8 * s, bytes);
    return full + 8 * s;
  }
  // a consumer warpgroup: wait until ring step `it` has landed
  __device__ __forceinline__ void landed(int it) const {
    gemm_ml::wait(full + 8 * (it % RG::STAGES), (it / RG::STAGES) & 1);
  }
  // a consumer warpgroup: the products that read ring step `it` are done
  __device__ __forceinline__ void release(int it) const {
    gemm_ml::arrive_if(empty + 8 * (it % RG::STAGES), threadIdx.x % 128 == 0);
  }
};

// The M > 16 tile of a graph E: WG consumer warpgroups of 64 rows by BN
// columns of every root (128 for one root, 64 for two or three); PA bf16
// pieces of each lhs, PB of each rhs (2: an fp32 operand's hi and lo).  The
// ring holds the pieces of the distinct lhs operands (A slot l PA + p) and
// of each root's rhs (B slot r PB + p).  Two CTAs an SM where a thread's
// accumulators are at most 64 and the ring fits twice, else one with a
// deeper ring (and for the split a second, per-step set of accumulators).
template <class E, int WG_, int PA_, int PB_>
struct WTile {
  static constexpr int R = E::R, NL = E::NLHS, WG = WG_, PA = PA_, PB = PB_;
  static constexpr int BM = 64 * WG, BN = R == 1 ? 128 : 64;
  static constexpr bool SMALL = R * BN <= 128;
  static constexpr int STAGE_BYTES = (NL * PA * BM + R * PB * BN) * kBK * 2;
  static constexpr int STAGES = clamp_int((SMALL ? 112 : 224) * 1024 / STAGE_BYTES, 2, 4);
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES + 16;
  static constexpr bool FITS = SMEM <= 232448;  // else the plan runs the graph elsewhere
  // two CTAs an SM where a thread holds at most 64 accumulators (the split's
  // second, per-step set rules that out) and the ring fits twice
  static constexpr int CTAS = SMALL && PA * PB == 1 && 2 * SMEM <= 227 * 1024 ? 2 : 1;
  using RG = Ring<WG, BM, BN, NL * PA, R * PB, STAGES>;
  template <int L>
  using A = gemm_ml::Operand<BM, E::trans_lhs(L)>;   // stored (K, M): MN-major
  template <int Q>
  using B = gemm_ml::Operand<BN, !E::trans_rhs(Q)>;  // stored (K, N): MN-major
};

// wgmma_decode's tile: the R weight tiles (op(B_r)^T, 128 columns of C on
// wgmma's M side) and the NL row tiles (op(A_l)^T, 16 rows on its n side)
// of a k-step in one stage, two CTAs an SM.
template <class E>
struct DTile {
  static constexpr int R = E::R, NL = E::NLHS, WG = 2;
  static constexpr int STAGE_BYTES = (R * 128 + NL * kDecodeRows) * kBK * 2;
  static constexpr int STAGES = clamp_int(112 * 1024 / STAGE_BYTES, 2, 6);
  using RG = Ring<WG, 128, kDecodeRows, R, NL, STAGES>;
  template <int Q>
  using A = gemm_ml::Operand<128, !E::trans_rhs(Q)>;
  template <int L>
  using B = gemm_ml::Operand<kDecodeRows, E::trans_lhs(L)>;
};

// An operand's outer TMA coordinates for problem c: its B1 and B0 indices,
// 0 along an axis it shares (its map has extent 1 there).
__device__ __forceinline__ int2 batch_coords(const long long (&s)[2], const FgCtx& c) {
  return make_int2(s[1] != 0 ? c.b1 : 0, s[0] != 0 ? c.b0 : 0);
}

// The roots whose tiles from column n0 hold some column: bit r set while n0
// is under root r's width (a narrow root's tiles past it load and multiply
// nothing).
template <int R>
__device__ __forceinline__ unsigned live_roots(const FusedArgs& a, int n0) {
  unsigned live = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) live |= (n0 < a.width[r] ? 1u : 0u) << r;
  return live;
}

// The producer's k-steps it0 .. it0 + n - 1 of an M > 16 tile at (m0, n0):
// every lhs piece at rows m0, every live root's rhs pieces at rows n0.
template <class E, class T>
__device__ __forceinline__ void produce_tile(const RingSmem<typename T::RG>& sm,
                                             const FusedMaps& maps, const FusedArgs& a,
                                             const FgCtx& c, int m0, int n0, unsigned live,
                                             int it0, int n) {
  const uint32_t bytes = T::RG::NA * T::RG::A_BYTES + __popc(live) * T::PB * T::RG::B_BYTES;
  for (int i = 0; i < n; ++i) {
    const int it = it0 + i, s = it % T::STAGES, k = i * kBK;
    const uint32_t bar = sm.acquire(it, bytes);
    each<T::NL>([&](auto l_) {
      constexpr int L = decltype(l_)::value;
      const int2 z = batch_coords(a.s_lhs[L], c);
      each<T::PA>([&](auto p_) {
        constexpr int J = L * T::PA + decltype(p_)::value;
        T::template A<L>::load(sm.a(s, J), &maps.a[J], bar, m0, k, z.x, z.x, z.y);
      });
    });
    each<T::R>([&](auto q_) {
      constexpr int Q = decltype(q_)::value;
      if (live >> Q & 1u) {
        const int2 z = batch_coords(a.s_rhs[Q], c);
        each<T::PB>([&](auto p_) {
          constexpr int J = Q * T::PB + decltype(p_)::value;
          T::template B<Q>::load(sm.b(s, J), &maps.b[J], bar, n0, k, z.x, z.x, z.y);
        });
      }
    });
  }
}

// The products of one ring stage into d: every live root's pieces, k16 by
// k16 (lhs pieces outer, rhs pieces inner: hi before lo); FRESH: the first
// product overwrites d instead of adding to it.
template <class E, class T, bool FRESH>
__device__ __forceinline__ void stage_products(float (&d)[T::R][T::BN / 2],
                                               const RingSmem<typename T::RG>& sm, int s,
                                               unsigned live, int wg) {
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    each<T::R>([&](auto q_) {
      constexpr int Q = decltype(q_)::value, L = E::lhs_of(Q);
      using OA = typename T::template A<L>;
      using OB = typename T::template B<Q>;
      if (live >> Q & 1u) {
        each<T::PA>([&](auto pa_) {
          each<T::PB>([&](auto pb_) {
            constexpr int PA = decltype(pa_)::value, PB = decltype(pb_)::value;
            hopper::Wgmma<T::BN>::template ss<OA::kMN ? 1 : 0, OB::kMN ? 1 : 0>(
                d[Q], OA::desc(sm.a(s, L * T::PA + PA), 64 * wg, ks),
                OB::desc(sm.b(s, Q * T::PB + PB), 0, ks), !FRESH || ks > 0 || PA > 0 || PB > 0);
          });
        });
      }
    });
  }
}

// A consumer warpgroup's k-steps it0 .. it0 + n - 1: acc[r] (its 64 rows by
// BN, wgmma's layout) = the sum over them of every piece product of root r,
// k16 by k16 (lhs pieces outer, rhs pieces inner: hi before lo); each step's
// stage is released once the products that read it are done, the last one
// too (a row panel's ring goes on into its next tile).  `live` must be the
// same across the warp.  With one piece a side, one wgmma group stays in
// flight behind the next and the tensor cores accumulate all of K.  With
// wgmma_split's pieces each 64-deep step is summed into a fresh
// accumulator, then added to acc in fp32 on the CUDA cores: the tensor
// cores' own accumulation truncates its partial sums, which over K 4096
// moved a unit-scale product by 2.4e-3, past the fp32 tolerance.
template <class E, class T, class Step>
__device__ __forceinline__ void consume_tile(float (&acc)[T::R][T::BN / 2],
                                             const RingSmem<typename T::RG>& sm, unsigned live,
                                             int it0, int n, int wg, const Step& step) {
#pragma unroll
  for (int q = 0; q < T::R; ++q)
#pragma unroll
    for (int i = 0; i < T::BN / 2; ++i) acc[q][i] = 0.0f;
  if constexpr (T::PA * T::PB > 1) {
    float part[T::R][T::BN / 2];
    for (int i = 0; i < n; ++i) {
      const int it = it0 + i;
      sm.landed(it);
#pragma unroll
      for (int q = 0; q < T::R; ++q) hopper::fence_regs(part[q]);
      hopper::wgmma_fence();
      stage_products<E, T, true>(part, sm, it % T::STAGES, live, wg);
      hopper::wgmma_commit();
      step(i);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < T::R; ++q) hopper::fence_regs(part[q]);
      sm.release(it);
#pragma unroll
      for (int q = 0; q < T::R; ++q)
        if (live >> q & 1u)
#pragma unroll
          for (int j = 0; j < T::BN / 2; ++j) acc[q][j] += part[q][j];
    }
  } else {
    for (int i = 0; i < n; ++i) {
      const int it = it0 + i;
      sm.landed(it);
#pragma unroll
      for (int q = 0; q < T::R; ++q) hopper::fence_regs(acc[q]);
      hopper::wgmma_fence();
      stage_products<E, T, false>(acc, sm, it % T::STAGES, live, wg);
      hopper::wgmma_commit();
      step(i);                  // integer work while the tensor cores run
      hopper::wgmma_wait<1>();  // the group of step it - 1 is done: free its stage
#pragma unroll
      for (int q = 0; q < T::R; ++q) hopper::fence_regs(acc[q]);
      if (i > 0) sm.release(it - 1);
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < T::R; ++q) hopper::fence_regs(acc[q]);
    if (n > 0) sm.release(it0 + n - 1);
  }
}

// A consumer thread's keep bits of the BN / 2 accumulators of its tile
// (acc[i]: bit i % 32 of word i / 32), for each draw of E, drawn in the
// mainloop (consume_and_draw), before the epilogue's first divergent branch.
template <class E, class T>
struct KeepFrag {
  static constexpr int ND = E::NDRAW > 0 ? E::NDRAW : 1, W = T::BN / 64;
  uint32_t w[ND][W];
  // the keep word (bit j: draw j) of acc[i]
  __device__ __forceinline__ uint32_t at(int i) const {
    uint32_t k = 0;
#pragma unroll
    for (int j = 0; j < E::NDRAW; ++j) k |= ((w[j][i / 32] >> (i % 32)) & 1u) << j;
    return k;
  }
};

// Draw the keep bits of column group g (acc[4 g .. 4 g + 3]: columns
// 8 g + 2 (lane % 4) + {0, 1} of rows r and r + 8) of a consumer thread's 64
// rows from row0 of the tile at column n0, one generator call an element
// (keep_bits): the counter path, or K13 on a plan tile whose width is not a
// multiple of 4.
template <class E, class T>
__device__ __forceinline__ void draw_group(KeepFrag<E, T>& f, const FusedArgs& a, int row0,
                                           int n0, int g) {
  const int i0 = 4 * g;
  uint32_t bits[KeepFrag<E, T>::ND];   // bit e: acc[i0 + e] kept, for each draw
#pragma unroll
  for (int j = 0; j < KeepFrag<E, T>::ND; ++j) bits[j] = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t k =
        keep_bits<E>(row0 + gemm_ml::acc_row(i0 + e), n0 + gemm_ml::acc_col(i0 + e), a);
#pragma unroll
    for (int j = 0; j < E::NDRAW; ++j) bits[j] |= ((k >> j) & 1u) << e;
  }
  // into word i0 / 32 (a compare a word, so a runtime g keeps f in registers)
#pragma unroll
  for (int j = 0; j < E::NDRAW; ++j)
#pragma unroll
    for (int q = 0; q < KeepFrag<E, T>::W; ++q)
      if (q == i0 / 32) f.w[j][q] |= bits[j] << (i0 % 32);
}

// The keep bits of a consumer thread's tile, drawn before its epilogue's
// first divergent branch.  K13's shared draw goes first, while the ring
// fills (draw_ahead, DRAW4: 16 Philox calls a thread for a 128-column
// tile; every lane of the warp calls it together).  The four columns
// 4q..4q+3 of a row are the four words of one Philox call (counter (row0,
// col0, local / 4, 0), local a multiple of 4 at the first, as the plan's
// PRNG tile width is), and in wgmma's layout lanes t and t ^ 1 hold them
// for rows r and r + 8: the even lane draws row r's block, the odd lane row
// r + 8's, and one shuffle each way hands over the other's two words, a
// quarter of the calls.  One call an element (the counter path's threefry, or K13 on
// a tile width that is not a multiple of 4: 64 calls) is spread over the
// mainloop's shadow: group g after the products of k-step g are issued
// (consume_tile's step), and the groups a short K leaves after it.  On an
// H100 each placement measured faster than the other for its draw
// (PERF.md).
template <class E, class T>
__device__ __forceinline__ void draw_ahead(KeepFrag<E, T>& f, const FusedArgs& a, int row0,
                                           int n0) {
  // draw_group's shared draw for every group, the row's terms taken once
  const bool even = (threadIdx.x & 1) == 0;
  const int gm = row0 + gemm_ml::acc_row(even ? 0 : 2);   // the row this lane draws
  const int tm = a.prng_tm, tn = a.prng_tn, r0 = gm - gm % tm;
  const uint32_t row_local = static_cast<uint32_t>(gm - r0) * static_cast<uint32_t>(tn);
#pragma unroll
  for (int i0 = 0; i0 < T::BN / 2; i0 += 4) {
    const int cb = n0 + gemm_ml::acc_col(i0) - (even ? 0 : 2);   // the first of the four
    const int c0 = cb - cb % tn;
    const uint4 ctr = make_uint4(static_cast<uint32_t>(r0), static_cast<uint32_t>(c0),
                                 (row_local + static_cast<uint32_t>(cb - c0)) >> 2, 0u);
#pragma unroll
    for (int j = 0; j < E::NDRAW; ++j) {
      uint32_t seed, salt, th;
      E::draw_key(j, a, seed, salt, th);
      const uint4 w = fg_philox4x32_10(ctr, seed, salt);
      const uint32_t got0 = __shfl_xor_sync(0xffffffffu, even ? w.z : w.x, 1);
      const uint32_t got1 = __shfl_xor_sync(0xffffffffu, even ? w.w : w.y, 1);
      const uint32_t b0 = even ? w.x : got0, b1 = even ? w.y : got1;
      const uint32_t b2 = even ? got0 : w.z, b3 = even ? got1 : w.w;
      f.w[j][i0 / 32] |= ((b0 < th ? 1u : 0u) | (b1 < th ? 2u : 0u) | (b2 < th ? 4u : 0u) |
                          (b3 < th ? 8u : 0u))
                         << (i0 % 32);
    }
  }
}

// consume_tile's step where nothing is drawn in the mainloop
struct NoStep {
  __device__ __forceinline__ void operator()(int) const {}
};

// A consumer warpgroup's k-steps it0 .. it0 + n - 1 of the tile at
// (row0, n0) with its keep bits (KeepFrag) drawn: ahead (DRAW4), in the
// mainloop (other draws) or not at all.
template <class E, class T>
__device__ __forceinline__ void consume_and_draw(float (&acc)[T::R][T::BN / 2], KeepFrag<E, T>& kf,
                                                 const RingSmem<typename T::RG>& sm,
                                                 unsigned live, int it0, int n, int wg,
                                                 const FusedArgs& a, int row0, int n0) {
  constexpr int GROUPS = T::BN / 8;
#pragma unroll
  for (int j = 0; j < KeepFrag<E, T>::ND; ++j)
#pragma unroll
    for (int q = 0; q < KeepFrag<E, T>::W; ++q) kf.w[j][q] = 0u;
  if constexpr (E::NDRAW == 0) {
    consume_tile<E, T>(acc, sm, live, it0, n, wg, NoStep{});
  } else if constexpr (E::DRAW4) {   // a DRAW4 source launches only under hw
    draw_ahead<E, T>(kf, a, row0, n0);
    consume_tile<E, T>(acc, sm, live, it0, n, wg, NoStep{});
  } else {
    consume_tile<E, T>(acc, sm, live, it0, n, wg, [&](int g) {
      if (g < GROUPS) draw_group<E, T>(kf, a, row0, n0, g);
    });
    for (int g = n; g < GROUPS; ++g) draw_group<E, T>(kf, a, row0, n0, g);
  }
}

// The plain epilogue of two adjacent columns (gn, and gn + 1 when `two`) of
// row gm, with their keep words k0 and k1: every output stored, as one pair
// where N is even; or a row panel's pre-reduce pass.
template <class E, int MODE>
__device__ __forceinline__ void emit2(const float* v0, const float* v1, uint32_t k0, uint32_t k1,
                                      int gm, int gn, bool two, const FusedArgs& a,
                                      const FgCtx& c) {
  if constexpr (MODE == PANEL) {
    float s0[E::NSTAGED], s1[E::NSTAGED];
    E::pre(v0, k0, gm, gn, a, c, s0);
    if (two) E::pre(v1, k1, gm, gn + 1, a, c, s1);
    stage<E::NSTAGED>(s0, s1, gm, gn, two, a, c);
  } else {
    float o0[E::NOUT], o1[E::NOUT];
    E::apply(v0, k0, gm, gn, a, c, o0);
    if (two) E::apply(v1, k1, gm, gn + 1, a, c, o1);
    const long long base = c.off(a.s_out) + (long long)gm * a.N + gn;
    const bool pair = two && a.N % 2 == 0;
#pragma unroll
    for (int q = 0; q < E::NOUT; ++q) {
      const long long at = base + (long long)q * a.M * a.N;
      if (a.out_bf16) {
        fg_bf16* o = static_cast<fg_bf16*>(a.out) + at;
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(o0[q], o1[q]);
        } else {
          o[0] = __float2bfloat16(o0[q]);
          if (two) o[1] = __float2bfloat16(o1[q]);
        }
      } else {
        float* o = static_cast<float*>(a.out) + at;
        if (pair) {
          *reinterpret_cast<float2*>(o) = make_float2(o0[q], o1[q]);
        } else {
          o[0] = o0[q];
          if (two) o[1] = o1[q];
        }
      }
    }
  }
}

// A consumer warpgroup's epilogue of its 64 rows of the tile at (m0, n0),
// with the keep bits consume_and_draw drew for them.
template <class E, class T, int MODE>
__device__ __forceinline__ void epilogue_tile(const float (&acc)[T::R][T::BN / 2],
                                              const KeepFrag<E, T>& kf, const FusedArgs& a,
                                              const FgCtx& c, int m0, int n0, int wg) {
  const int row0 = m0 + 64 * wg;
#pragma unroll
  for (int i = 0; i < T::BN / 2; i += 2) {
    const int gm = row0 + gemm_ml::acc_row(i), gn = n0 + gemm_ml::acc_col(i);
    if (gm < a.M && gn < a.N) {
      float v0[T::R], v1[T::R];
#pragma unroll
      for (int q = 0; q < T::R; ++q) {
        v0[q] = acc[q][i];
        v1[q] = acc[q][i + 1];
      }
      emit2<E, MODE>(v0, v1, kf.at(i), kf.at(i + 1), gm, gn, gn + 1 < a.N, a, c);
    }
  }
}

// The tile origin of an M > 16 launch: the order table's entry, or the fixed
// grid rasterised in groups of 8 row tiles (the CTAs on the card at once
// share their lhs and rhs tiles in L2), as K1's.
__device__ __forceinline__ int2 wgmma_origin(const FusedArgs& a, int bm, int bn) {
  if (a.order != nullptr) return make_int2(a.order[2 * blockIdx.x], a.order[2 * blockIdx.x + 1]);
  constexpr int G = 8;
  const int cols = gridDim.x, rows = gridDim.y;
  const int id = blockIdx.y * cols + blockIdx.x, group = id / (G * cols);
  const int first = group * G, in_group = min(G, rows - first), local = id % (G * cols);
  return make_int2((first + local % in_group) * bm, (local / in_group) * bn);
}

// wgmma and wgmma_split: one tile of every root.
template <class E, class T>
__global__ void __launch_bounds__(T::RG::THREADS, T::CTAS)
fused_gemm_bf16_wgmma(const __grid_constant__ FusedArgs a, const __grid_constant__ FusedMaps maps) {
  extern __shared__ unsigned char smem_raw[];
  const RingSmem<typename T::RG> sm(smem_raw);
  const FgCtx c = block_ctx(a);
  const int2 org = wgmma_origin(a, T::BM, T::BN);
  // the same in every lane (a shuffle), so that the products' branches are
  // uniform to ptxas (which would otherwise serialize the wgmma)
  const unsigned live = __shfl_sync(0xffffffffu, live_roots<T::R>(a, org.y), 0);
  const int n = (a.K + kBK - 1) / kBK;
  sm.init();
  const int wg = gemm_ml::warpgroup();
  if (wg == T::WG) {
    if (threadIdx.x == 128 * T::WG) produce_tile<E, T>(sm, maps, a, c, org.x, org.y, live, 0, n);
    return;
  }
  KeepFrag<E, T> kf;
  float acc[T::R][T::BN / 2];
  consume_and_draw<E, T>(acc, kf, sm, live, 0, n, wg, a, org.x + 64 * wg, org.y);
  epilogue_tile<E, T, PLAIN>(acc, kf, a, c, org.x, org.y, wg);
}

// A row panel: one band of BM rows walks its N tiles (the producer ahead
// through one ring), stages each tile's pre-reduce values, then its
// consumer warps close the rows.
template <class E, class T, typename TOut>
__global__ void __launch_bounds__(T::RG::THREADS, 1)
fused_panel_bf16_wgmma(const __grid_constant__ FusedArgs a, const __grid_constant__ FusedMaps maps) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float strip[2 * T::BM];
  const RingSmem<typename T::RG> sm(smem_raw);
  const FgCtx c = block_ctx(a);
  const int m0 = tile_origin(a, T::BM, 0).x;
  const int n = (a.K + kBK - 1) / kBK, tiles = (a.N + T::BN - 1) / T::BN;
  sm.init();
  const int wg = gemm_ml::warpgroup();
  if (wg == T::WG) {
    if (threadIdx.x == 128 * T::WG)
      for (int t = 0; t < tiles; ++t)
        produce_tile<E, T>(sm, maps, a, c, m0, t * T::BN, live_roots<T::R>(a, t * T::BN), t * n, n);
    return;
  }
  float acc[T::R][T::BN / 2];
  KeepFrag<E, T> kf;
  for (int t = 0; t < tiles; ++t) {
    consume_and_draw<E, T>(acc, kf, sm, live_roots<T::R>(a, t * T::BN), t * n, n, wg, a,
                           m0 + 64 * wg, t * T::BN);
    epilogue_tile<E, T, PANEL>(acc, kf, a, c, m0, t * T::BN, wg);
  }
  hopper::named_sync<1, 128 * T::WG>();   // the staged panel is complete (and visible)
  close_rows<E, TOut>(a, c, m0, T::BM, strip, 4 * T::WG);
}

// wgmma_decode: C^T = op(B_r)^T op(A_l)^T for each root, the weight tiles
// on wgmma's M side; this CTA's split of K, into the partials or (one
// split) straight through the epilogue.
template <class E, class T>
__global__ void __launch_bounds__(T::RG::THREADS, 2)
fused_gemm_bf16_wgmma_decode(const __grid_constant__ FusedArgs a,
                             const __grid_constant__ FusedMaps maps) {
  extern __shared__ unsigned char smem_raw[];
  const RingSmem<typename T::RG> sm(smem_raw);
  const FgCtx c = block_ctx(a);
  const int n0 = a.order != nullptr ? a.order[2 * blockIdx.x + 1] : blockIdx.x * kDecodeCols;
  const int steps = (a.K + kBK - 1) / kBK, t0 = blockIdx.y * a.split_steps;
  const int n = max(0, min(t0 + a.split_steps, steps) - t0);
  const unsigned live = __shfl_sync(0xffffffffu, live_roots<T::R>(a, n0), 0);
  sm.init();
  const int wg = gemm_ml::warpgroup();
  if (wg == T::WG) {
    if (threadIdx.x != 128 * T::WG) return;
    const uint32_t bytes = __popc(live) * T::RG::A_BYTES + T::NL * T::RG::B_BYTES;
    for (int i = 0; i < n; ++i) {
      const int s = i % T::STAGES, k = (t0 + i) * kBK;
      const uint32_t bar = sm.acquire(i, bytes);
      each<T::R>([&](auto q_) {
        constexpr int Q = decltype(q_)::value;
        if (live >> Q & 1u) {
          const int2 z = batch_coords(a.s_rhs[Q], c);
          T::template A<Q>::load(sm.a(s, Q), &maps.a[Q], bar, n0, k, z.x, z.x, z.y);
        }
      });
      each<T::NL>([&](auto l_) {
        constexpr int L = decltype(l_)::value;
        const int2 z = batch_coords(a.s_lhs[L], c);
        T::template B<L>::load(sm.b(s, L), &maps.b[L], bar, 0, k, z.x, z.x, z.y);
      });
    }
    return;
  }
  float acc[T::R][8];
#pragma unroll
  for (int q = 0; q < T::R; ++q)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[q][i] = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int s = i % T::STAGES;
    sm.landed(i);
#pragma unroll
    for (int q = 0; q < T::R; ++q) hopper::fence_regs(acc[q]);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      each<T::R>([&](auto q_) {
        constexpr int Q = decltype(q_)::value, L = E::lhs_of(Q);
        using OA = typename T::template A<Q>;
        using OB = typename T::template B<L>;
        if (live >> Q & 1u)
          hopper::Wgmma<kDecodeRows>::template ss<OA::kMN ? 1 : 0, OB::kMN ? 1 : 0>(
              acc[Q], OA::desc(sm.a(s, Q), 64 * wg, ks), OB::desc(sm.b(s, L), 0, ks), 1);
      });
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
#pragma unroll
    for (int q = 0; q < T::R; ++q) hopper::fence_regs(acc[q]);
    if (i > 0) sm.release(i - 1);
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < T::R; ++q) hopper::fence_regs(acc[q]);
  // acc[q][i]: root q at C's column n0 + 64 wg + acc_row(i), row acc_col(i)
  const int col0 = n0 + 64 * wg, M = a.M, N = a.N;
  if (a.splits == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = col0 + gemm_ml::acc_row(i), m = gemm_ml::acc_col(i);
      if (m < M && col < N) {
        float v[T::R];
#pragma unroll
        for (int q = 0; q < T::R; ++q) v[q] = acc[q][i];
        emit2<E, PLAIN>(v, v, keep_bits<E>(m, col, a), 0u, m, col, false, a, c);
      }
    }
    return;
  }
  const long long slab = (long long)M * N;
  float* part = a.ws + ((long long)blockIdx.z * a.splits + blockIdx.y) * T::R * slab;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = col0 + gemm_ml::acc_row(i), m = gemm_ml::acc_col(i);
    if (m < M && col < N)
#pragma unroll
      for (int q = 0; q < T::R; ++q) __stcg(part + q * slab + (long long)m * N + col, acc[q][i]);
  }
  __threadfence();
  hopper::named_sync<1, 128 * T::WG>();
  const int panels = (N + kDecodeCols - 1) / kDecodeCols;
  int* counter = a.counters + (long long)blockIdx.z * panels + n0 / kDecodeCols;
  if (threadIdx.x == 0) *sm.flag = atomicAdd(counter, 1) == a.splits - 1;
  hopper::named_sync<1, 128 * T::WG>();
  if (!*sm.flag) return;
  // the last split to arrive: every split's partials, in split order
  __threadfence();
  const float* ws = a.ws + (long long)blockIdx.z * a.splits * T::R * slab;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = col0 + gemm_ml::acc_row(i), m = gemm_ml::acc_col(i);
    if (m < M && col < N) {
      float v[T::R];
#pragma unroll
      for (int q = 0; q < T::R; ++q) v[q] = 0.0f;
      for (int sp = 0; sp < a.splits; ++sp)
#pragma unroll
        for (int q = 0; q < T::R; ++q)
          v[q] += __ldcg(ws + ((long long)sp * T::R + q) * slab + (long long)m * N + col);
      emit2<E, PLAIN>(v, v, keep_bits<E>(m, col, a), 0u, m, col, false, a, c);
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

// wgmma_split's pre-pass: an fp32 operand (B0 x B1 problems of rows x cols,
// leading dimension ld, problem strides s0 and s1) as two bf16 pieces, hi =
// bf16(x) and lo = bf16(x - hi), each contiguous (B0, B1, rows, cols).
__global__ void __launch_bounds__(256)
fg_split_bf16(const float* __restrict__ x, long long ld, long long s0, long long s1, int B1,
              int rows, int cols, fg_bf16* __restrict__ hi, fg_bf16* __restrict__ lo) {
  const int b0 = blockIdx.z / B1, b1 = blockIdx.z % B1;
  const float* src = x + b0 * s0 + b1 * s1;
  const long long out0 = (long long)blockIdx.z * rows * cols;
  for (int r = blockIdx.y; r < rows; r += gridDim.y)
    for (int col = blockIdx.x * 256 + threadIdx.x; col < cols; col += gridDim.x * 256) {
      const float v = src[(long long)r * ld + col];
      const fg_bf16 h = __float2bfloat16_rn(v);
      const long long at = out0 + (long long)r * cols + col;
      hi[at] = h;
      lo[at] = __float2bfloat16_rn(v - __bfloat162float(h));
    }
}

// The stored (rows, cols) matrix of lhs l or of root r's rhs, as the
// wrapper binds it: base, leading dimension, problem strides (B0, B1).
struct Stored {
  const void* p;
  int rows, cols;
  long long ld, s0, s1;
};
inline Stored stored_lhs(const FusedArgs& a, int l, bool trans) {
  return {a.lhs[l], trans ? a.K : a.M, trans ? a.M : a.K, a.lda[l], a.s_lhs[l][0], a.s_lhs[l][1]};
}
inline Stored stored_rhs(const FusedArgs& a, int r, bool trans) {
  return {a.rhs[r], trans ? a.width[r] : a.K, trans ? a.K : a.width[r], a.ldb[r], a.s_rhs[r][0],
          a.s_rhs[r][1]};
}

// Piece p of an operand split into `pieces` (contiguous over the problems
// it has), or the operand itself where `pieces` is null.
inline Stored piece(const FusedArgs& a, const Stored& o, void* pieces, int p) {
  if (pieces == nullptr) return o;
  const int B1 = a.B1, B0 = a.batch / a.B1;
  const int nb1 = o.s1 != 0 ? B1 : 1, nb0 = o.s0 != 0 ? B0 : 1;
  const long long per = (long long)o.rows * o.cols;
  const fg_bf16* base = static_cast<const fg_bf16*>(pieces) + (long long)p * nb0 * nb1 * per;
  return {base, o.rows, o.cols, o.cols, nb0 > 1 ? nb1 * per : 0, nb1 > 1 ? per : 0};
}

// The tensor map of a stored bf16 matrix read as an operand Op (ROWS rows
// of wgmma's M or N extent by BK, K-major or MN-major): an axis of problem
// stride 0 has extent 1.
template <class Op>
inline cudaError_t operand_map(CUtensorMap* map, const Stored& o, const FusedArgs& a) {
  const int B1 = a.B1, B0 = a.batch / a.B1;
  const int panel = Op::kMN ? Op::SW : kBK, box_rows = Op::kMN ? kBK : Op::kRows;
  return hopper::tile_map(map, o.p, o.cols, o.rows, o.s1 != 0 ? B1 : 1, o.s0 != 0 ? B0 : 1, o.ld,
                          o.s1, o.s0, panel, box_rows);
}
template <int ROWS>
inline cudaError_t slot_map(CUtensorMap* map, const Stored& o, const FusedArgs& a, bool mn) {
  return mn ? operand_map<gemm_ml::Operand<ROWS, true>>(map, o, a)
            : operand_map<gemm_ml::Operand<ROWS, false>>(map, o, a);
}

// The pre-pass of each fp32 operand of wgmma_split, into its pieces.
template <class E>
cudaError_t split_operands(const FusedArgs& a, cudaStream_t s) {
  auto run = [&](const Stored& o, void* pieces) -> cudaError_t {
    if (pieces == nullptr) return cudaErrorInvalidValue;
    const int B1 = a.B1, B0 = a.batch / a.B1;
    const int nb1 = o.s1 != 0 ? B1 : 1, nb0 = o.s0 != 0 ? B0 : 1;
    fg_bf16* hi = static_cast<fg_bf16*>(pieces);
    const dim3 grid((o.cols + 255) / 256, o.rows < 65535 ? o.rows : 65535, nb0 * nb1);
    fg_split_bf16<<<grid, 256, 0, s>>>(static_cast<const float*>(o.p), o.ld, o.s0, o.s1, nb1,
                                       o.rows, o.cols, hi,
                                       hi + (long long)nb0 * nb1 * o.rows * o.cols);
    return cudaGetLastError();
  };
  for (int l = 0; l < E::NLHS; ++l)
    if (!a.lhs_bf16[l]) {
      const cudaError_t e = run(stored_lhs(a, l, E::trans_lhs(l)), a.lhs_split[l]);
      if (e != cudaSuccess) return e;
    }
  for (int r = 0; r < E::R; ++r)
    if (!a.rhs_bf16[r]) {
      const cudaError_t e = run(stored_rhs(a, r, E::trans_rhs(r)), a.rhs_split[r]);
      if (e != cudaSuccess) return e;
    }
  return cudaSuccess;
}

template <class Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The maps of an M > 16 tile or a panel: A slot l PA + p, B slot r PB + p.
template <class E, class T>
cudaError_t tile_maps(FusedMaps& maps, const FusedArgs& a) {
  cudaError_t e = cudaSuccess;
  for (int l = 0; l < T::NL && e == cudaSuccess; ++l) {
    const Stored o = stored_lhs(a, l, E::trans_lhs(l));
    for (int p = 0; p < T::PA && e == cudaSuccess; ++p)
      e = slot_map<T::BM>(&maps.a[l * T::PA + p],
                             piece(a, o, T::PA > 1 ? a.lhs_split[l] : nullptr, p), a,
                             E::trans_lhs(l));
  }
  for (int r = 0; r < T::R && e == cudaSuccess; ++r) {
    const Stored o = stored_rhs(a, r, E::trans_rhs(r));
    for (int p = 0; p < T::PB && e == cudaSuccess; ++p)
      e = slot_map<T::BN>(&maps.b[r * T::PB + p],
                             piece(a, o, T::PB > 1 ? a.rhs_split[r] : nullptr, p), a,
                             !E::trans_rhs(r));
  }
  return e;
}

template <class E, class T>
cudaError_t launch_wgmma(const FusedArgs& a, cudaStream_t s) {
  if (a.order != nullptr && (a.cta_m != T::BM || a.cta_n != T::BN)) return cudaErrorInvalidValue;
  FusedMaps maps;
  const cudaError_t e = tile_maps<E, T>(maps, a);
  if (e != cudaSuccess) return e;
  const auto kern = &fused_gemm_bf16_wgmma<E, T>;
  static const cudaError_t attr = allow_smem(kern, T::RG::SMEM);
  if (attr != cudaSuccess) return attr;
  kern<<<tile_grid(a, T::BM, T::BN), T::RG::THREADS, T::RG::SMEM, s>>>(a, maps);
  return cudaGetLastError();
}

template <class E, class T, typename TOut>
cudaError_t launch_panel_wgmma(const FusedArgs& a, cudaStream_t s) {
  if (a.order != nullptr && (a.cta_m != T::BM || a.cta_n != a.N)) return cudaErrorInvalidValue;
  FusedMaps maps;
  const cudaError_t e = tile_maps<E, T>(maps, a);
  if (e != cudaSuccess) return e;
  const auto kern = &fused_panel_bf16_wgmma<E, T, TOut>;
  static const cudaError_t attr = allow_smem(kern, T::RG::SMEM);
  if (attr != cudaSuccess) return attr;
  kern<<<tile_grid(a, T::BM, a.N), T::RG::THREADS, T::RG::SMEM, s>>>(a, maps);
  return cudaGetLastError();
}

template <class E>
cudaError_t launch_decode(const FusedArgs& a, cudaStream_t s) {
  using T = DTile<E>;
  if (a.M > kDecodeRows || a.splits < 1 || a.split_steps < 1 ||
      (a.splits > 1 && (a.ws == nullptr || a.counters == nullptr)) ||
      (a.order != nullptr && (a.cta_m != kDecodeRows || a.cta_n != kDecodeCols)))
    return cudaErrorInvalidValue;
  FusedMaps maps;
  cudaError_t e = cudaSuccess;
  for (int r = 0; r < T::R && e == cudaSuccess; ++r)
    e = slot_map<128>(&maps.a[r], stored_rhs(a, r, E::trans_rhs(r)), a, !E::trans_rhs(r));
  for (int l = 0; l < T::NL && e == cudaSuccess; ++l)
    e = slot_map<kDecodeRows>(&maps.b[l], stored_lhs(a, l, E::trans_lhs(l)), a,
                                 E::trans_lhs(l));
  if (e != cudaSuccess) return e;
  const auto kern = &fused_gemm_bf16_wgmma_decode<E, T>;
  static const cudaError_t attr = allow_smem(kern, T::RG::SMEM);
  if (attr != cudaSuccess) return attr;
  const int panels = a.order != nullptr ? a.n_order : (a.N + kDecodeCols - 1) / kDecodeCols;
  kern<<<dim3(panels, a.splits, a.batch), T::RG::THREADS, T::RG::SMEM, s>>>(a, maps);
  return cudaGetLastError();
}

// wgmma_split: every lhs fp32 against bf16 rhs (PA 2), or the reverse (PB 2).
template <class E>
cudaError_t launch_split(const FusedArgs& a, cudaStream_t s) {
  bool lhs_f32 = true, lhs_bf16 = true, rhs_f32 = true, rhs_bf16 = true;
  for (int l = 0; l < E::NLHS; ++l) {
    lhs_f32 = lhs_f32 && !a.lhs_bf16[l];
    lhs_bf16 = lhs_bf16 && a.lhs_bf16[l];
  }
  for (int r = 0; r < E::R; ++r) {
    rhs_f32 = rhs_f32 && !a.rhs_bf16[r];
    rhs_bf16 = rhs_bf16 && a.rhs_bf16[r];
  }
  if (!((lhs_f32 && rhs_bf16) || (lhs_bf16 && rhs_f32))) return cudaErrorInvalidValue;
  const cudaError_t e = split_operands<E>(a, s);
  if (e != cudaSuccess) return e;
  using TA = WTile<E, 2, 2, 1>;
  using TB = WTile<E, 2, 1, 2>;
  if (lhs_f32) {
    if constexpr (TA::FITS) return launch_wgmma<E, TA>(a, s);
  } else {
    if constexpr (TB::FITS) return launch_wgmma<E, TB>(a, s);
  }
  return cudaErrorInvalidValue;
}

// --- kernels ------------------------------------------------------------------
template <class E, class T, typename TOut, bool ORDERED>
__global__ void __launch_bounds__(T::NT)
fused_gemm_bf16_wmma(FusedArgs a) {
  __shared__ __align__(128) unsigned char smem[Bf16Smem<T, E::R, E::NLHS>::BYTES];
  const int2 t = tile_origin<ORDERED>(a, T::BM, T::BN);
  bf16_tile<E, T, PLAIN, TOut>(a, block_ctx(a), t.x, t.y, smem);
}

template <class E, typename TOut>
__global__ void __launch_bounds__(256)
fused_gemm_f32_simt(FusedArgs a) {
  __shared__ SimtSmem<E::R, E::NLHS> sm;
  const int2 t = tile_origin(a, SimtTiles::BM, SimtTiles::BN);
  simt_tile<E, PLAIN, TOut>(a, block_ctx(a), t.x, t.y, sm);
}

template <class E, class T, typename TOut>
__global__ void __launch_bounds__(T::NT)
fused_panel_bf16_wmma(FusedArgs a) {
  __shared__ __align__(128) unsigned char smem[Bf16Smem<T, E::R, E::NLHS>::BYTES];
  __shared__ float strip[2 * T::BM];
  const FgCtx c = block_ctx(a);
  const int m0 = tile_origin(a, T::BM, 0).x;
  for (int n0 = 0; n0 < a.N; n0 += T::BN) bf16_tile<E, T, PANEL, TOut>(a, c, m0, n0, smem);
  __syncthreads();   // the staged panel is complete (and visible to the block)
  close_rows<E, TOut>(a, c, m0, T::BM, strip, T::NW);
}

template <class E, typename TOut>
__global__ void __launch_bounds__(256)
fused_panel_f32_simt(FusedArgs a) {
  __shared__ SimtSmem<E::R, E::NLHS> sm;
  __shared__ float strip[2 * SimtTiles::BM];
  const FgCtx c = block_ctx(a);
  const int m0 = tile_origin(a, SimtTiles::BM, 0).x;
  for (int n0 = 0; n0 < a.N; n0 += SimtTiles::BN) {
    simt_tile<E, PANEL, TOut>(a, c, m0, n0, sm);
    __syncthreads();
  }
  close_rows<E, TOut>(a, c, m0, SimtTiles::BM, strip, SimtTiles::NT / 32);
}

template <class E, class T, typename TOut>
void launch_bf16(const FusedArgs& a, cudaStream_t s) {
  if (a.order != nullptr)
    fused_gemm_bf16_wmma<E, T, TOut, true><<<tile_grid(a, T::BM, T::BN), T::NT, 0, s>>>(a);
  else
    fused_gemm_bf16_wmma<E, T, TOut, false><<<tile_grid(a, T::BM, T::BN), T::NT, 0, s>>>(a);
}

template <class E, typename TOut>
cudaError_t dispatch(const FusedArgs& a, cudaStream_t s) {
  if (a.variant == V_WGMMA || a.variant == V_DECODE || a.variant == V_SPLIT) {
    if (a.K < 1) return cudaErrorInvalidValue;
    if constexpr (E::PANEL) {
      if (a.variant != V_WGMMA || !a.all_bf16) return cudaErrorInvalidValue;
      return launch_panel_wgmma<E, WTile<E, 1, 1, 1>, TOut>(a, s);
    } else {
      if (a.variant == V_SPLIT) return a.all_bf16 ? cudaErrorInvalidValue : launch_split<E>(a, s);
      if (!a.all_bf16) return cudaErrorInvalidValue;
      if (a.variant == V_DECODE) return launch_decode<E>(a, s);
      return launch_wgmma<E, WTile<E, 2, 1, 1>>(a, s);
    }
  }
  if (a.variant != V_CLASSIC) return cudaErrorInvalidValue;
  if constexpr (E::PANEL) {
    // one block a row band: the grid's N extent is one tile of all of N
    if (a.all_bf16) {
      using T = Bf16Tiles<64, 128, 2, 4>;
      fused_panel_bf16_wmma<E, T, TOut><<<tile_grid(a, T::BM, a.N), T::NT, 0, s>>>(a);
    } else {
      fused_panel_f32_simt<E, TOut><<<tile_grid(a, SimtTiles::BM, a.N), 256, 0, s>>>(a);
    }
  } else if (!a.all_bf16) {
    fused_gemm_f32_simt<E, TOut><<<tile_grid(a, SimtTiles::BM, SimtTiles::BN), 256, 0, s>>>(a);
  } else if (a.M <= 16) {
    launch_bf16<E, Bf16Tiles<16, 64, 1, 4>, TOut>(a, s);
  } else if (E::R == 1) {
    launch_bf16<E, Bf16Tiles<128, 128, 2, 4>, TOut>(a, s);
  } else {
    launch_bf16<E, Bf16Tiles<128, 64, 4, 2>, TOut>(a, s);
  }
  return cudaGetLastError();
}

// The body of the C entry point every generated source of a graph without a
// chained root defines:
//   extern "C" int fused_gemm(const FusedArgs* args, void* stream)
// The output (batch, NOUT, M, N) contiguous, bf16 if out_bf16 else fp32;
// R must be the graph's root count, and hw set for a DRAW4 source (the
// plan's choice: kernels/fused_gemm.py shares_draw).  variant: the wrapper's plan (enum
// Variant): wgmma, wgmma_decode (M <= 16) and wgmma_split run on the
// tensor-core mainloop (bf16 operands TMA reads: 16-byte aligned bases and
// strides), V_CLASSIC the WMMA kernel (all_bf16) or the SIMT one; order (if
// not null): the origins of the variant's CTA tiles (cta_m x cta_n, as
// kernels/fused_gemm.py cta_tile gives them); vec: every lhs and rhs row of
// every problem starts 16-byte aligned (WMMA's vector loads).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue without
// launching for an R that is not the graph's, a DRAW4 source without hw, or
// a call the variant does not take.
template <class E>
int entry(const FusedArgs* args, void* stream) {
  // R must be the graph's; a DRAW4 source draws K13's bits only
  if (args->R != E::R || (E::DRAW4 && !args->hw)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      args->out_bf16 ? dispatch<E, fg_bf16>(*args, s) : dispatch<E, float>(*args, s);
  return static_cast<int>(e);
}

}  // namespace fg
