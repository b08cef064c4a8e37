// K5: the fused-TppGraph kernel templates.  kernels/fused_gemm.py generates
// one source per simplified graph, which includes this file, defines a
// struct `Epi` (the graph's roots, their operands' layouts and its epilogue
// DAG as straight-line fp32 C++) and the C entry point `fused_gemm` as
// `fg::entry<Epi>`, which instantiates the kernels below on it.  A graph
// with a chained root instantiates csrc/fused_chain.cuh instead.
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
// K13's bits instead, Philox4x32-10 per plan tile (csrc/philox.cuh).
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
// against the 2304..13824-wide weights) tensor-core operations; at decode
// (M <= 16) one pass over the R weight matrices, HBM bytes; a row panel
// adds two to four fp32 passes over its staged rows (L2).  Fusing saves
// bytes only: the lhs is read once per K step for all roots, the roots'
// accumulators never go to device memory, the output is written once.
//
// What the design does about it: K1's mainloop (csrc/gemm.cu) with R
// accumulators.  All-bf16 operands run WMMA 16x16x16 fragments on the tensor
// cores: BM x BN = 128 x 128 tiles for one root, 128 x 64 for two or three
// (so the R accumulators stay in registers), 16 x 64 for M <= 16 (a row's
// sums do not depend on M there, so a decoded row is the same at any batch
// of up to 16 rows), 64 x 128 for a row panel.  Each K step copies the
// distinct lhs tiles to shared memory once and the R rhs tiles beside them,
// in their stored layouts with 16-byte loads where aligned (a transposed
// tile is read by column-major fragments); ragged M, N and K are
// zero-filled.  At the end of K each warp stages its fragments through
// shared memory and each lane evaluates the generated epilogue per element.
// Any fp32 operand (the fp32 test configs, and the backward graphs that
// read fp32 panels against bf16 weights, where the reference promotes the
// product to fp32) runs a SIMT mainloop in full fp32 FMA (no TF32): a
// 128 x 64 tile, an 8 x 4 micro-tile a thread, each operand converted to
// fp32 as it is copied to shared memory.  Loads are not pipelined (no
// cp.async, TMA or wgmma): left for the PR that makes K1 and K5 fast.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

#define FG_MAX_ROOTS 3
#define FG_MAX_EP 8

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
// log-sum-exp output (the chained backward's row statistics).
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

template <class E, int MODE, typename TOut>
__device__ __forceinline__ void emit(const float* acc, int gm, int gn, const FusedArgs& a,
                                     const FgCtx& c) {
  if constexpr (MODE == PANEL) {
    E::pre(acc, gm, gn, a, c);
  } else {
    float out[E::NOUT];
    E::apply(acc, gm, gn, a, c, out);
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

// Close the block's rows m0 .. m0+rows-1: one warp a row, in a fixed order.
// The strip (two floats a row) lives in shared memory between the passes.
template <class E, typename TOut>
__device__ void close_rows(const FusedArgs& a, const FgCtx& c, int m0, int rows, float* strip) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
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
  close_rows<E, TOut>(a, c, m0, T::BM, strip);
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
  close_rows<E, TOut>(a, c, m0, SimtTiles::BM, strip);
}

template <class E, class T, typename TOut>
void launch_bf16(const FusedArgs& a, cudaStream_t s) {
  if (a.order != nullptr)
    fused_gemm_bf16_wmma<E, T, TOut, true><<<tile_grid(a, T::BM, T::BN), T::NT, 0, s>>>(a);
  else
    fused_gemm_bf16_wmma<E, T, TOut, false><<<tile_grid(a, T::BM, T::BN), T::NT, 0, s>>>(a);
}

template <class E, typename TOut>
void dispatch(const FusedArgs& a, cudaStream_t s) {
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
}

// The body of the C entry point every generated source of a graph without a
// chained root defines:
//   extern "C" int fused_gemm(const FusedArgs* args, void* stream)
// The output (batch, NOUT, M, N) contiguous, bf16 if out_bf16 else fp32;
// order (if not null): the tile origins of the CTA tile the dispatch below
// picks, as kernels/fused_gemm.py cta_tile gives it;
// R must be the graph's root count; all_bf16 picks the tensor-core
// mainloop; vec: every lhs and rhs row of every problem starts 16-byte
// aligned.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an R that is not the graph's.
template <class E>
int entry(const FusedArgs* args, void* stream) {
  if (args->R != E::R) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->out_bf16)
    dispatch<E, fg_bf16>(*args, s);
  else
    dispatch<E, float>(*args, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fg
