// K1: GEMM with a fused bias + activation epilogue,
//     C[M,N] = act(op(A) @ op(B) + bias), fp32 accumulator, cast at the end,
//     where op(A) is A (M,K) or the transpose of a stored (K,M) matrix, and
//     op(B) is B (K,N) or the transpose of a stored (N,K) matrix.
//
// Replaces the TPU kernel repro/kernels/brgemm.py::matmul_pallas (launched
// through repro/core/pallas_lowering.py::make_pallas_fn): output-stationary,
// K innermost (every legal spec string keeps the reduction inside), the
// accumulator zeroed before the first K step, bias then activation applied
// once after the last one.  The transposed reads carry the backward of a
// projection Y = X W: dX = dY W^T reads W in place (trans_b), and
// dW = X^T dY reads X in place (trans_a), with an fp32 output for dW.
//
// The spec string: without one the grid is 2-D, blockIdx.x over column
// tiles and blockIdx.y over row tiles, so blocks are rasterised row-tile
// by row-tile, "bca"'s order.  With one, kernels/brgemm.py plans the
// reference's nest, maps its output visit order onto the variant's CTA
// tiles (kernels/brgemm.py::cta_tile names the tile each variant below
// computes; the entry point refuses a table made for another) and passes
// the (row, column) origins as an int32 table; the grid is then 1-D over
// the table (by the K splits for wgmma_decode) and block i computes the
// tile at table entry i.  A tile is computed the same way under any table,
// so every legal spec gives the same bits.
//
// What bounds it on an H100: at prefill or training (M = 2048..4096 rows
// against 2304x5760-class or 5120x13824-class weights) the work is far above
// the card's ~295 flop/byte ridge in bf16, so tensor-core operations bound
// it, and only wgmma fed ahead of time reaches their rate; at decode
// (M <= 16) it is one pass over the weight matrix, bound by HBM bytes, and
// the weight stream needs tens of KB in flight on every SM.
//
// What the design does about it: four variants, chosen by
// kernels/brgemm.py::gemm_variant from the dtype, M and the operands'
// layout alone.
//   wgmma (bf16, M > 16, operands TMA can read: 16-byte aligned base and
//     strides): csrc/gemm_mainloop.cuh with two consumer warpgroups, a
//     128 x 128 tile and a 3-deep TMA ring of 32 KB stages, two CTAs an SM,
//     so that one CTA's ring fill and epilogue run under the other's
//     products; the fixed grid is rasterised in groups of 8 row tiles, so
//     the CTAs on the card at once share their A and B tiles in L2.  Each
//     operand is read where it lies (A K-major, or MN-major with trans_a;
//     B MN-major, or K-major with trans_b) through a tensor map encoded
//     here per call.
//   wgmma_decode (bf16, M <= 16, TMA-readable): the weight stream.  The
//     operands swap: C^T = op(B)^T op(A)^T, so the weight tile is wgmma's
//     64-row operand (N on wgmma's M axis, 128 columns of C a CTA) and the
//     M <= 16 activation rows its B operand, always at n = 16 (TMA
//     zero-fills the rows past M, so M 3 and M 8 run the same
//     instructions).  K is split into `splits` parts of `split_steps`
//     64-deep steps, fixed from (K, N) alone (never M) so that the grid
//     covers the SMs about twice with two CTAs each, every CTA keeping a
//     K1_DECODE_STAGES-deep ring of 18 KB stages in flight.  Each split
//     writes its fp32 partials to the wrapper's workspace; the last CTA of
//     a column panel to arrive (a counter in global memory, reset by that
//     CTA) sums the splits in split order and runs the epilogue.  No float
//     atomics: a row of C has the same bits whatever M is (<= 16), and from
//     run to run.
//   wmma (bf16 operands TMA cannot read, e.g. an odd leading dimension):
//     WMMA 16x16x16 fragments on csrc/gemm_tile.cuh::bf16_wmma_tile, 128x128
//     tiles (16x64 for M <= 16), 16-byte or scalar loads, unpipelined.
//   simt (fp32, the reduced test configs): full fp32 FMA, never TF32,
//     64x64 tiles.
// The epilogue runs on the fp32 accumulator: bias, gemm_tile::activate,
// cast to bf16 or fp32, a store masked at the ragged edge.
#include "gemm_mainloop.cuh"
#include "gemm_tile.cuh"

// The wgmma variants' tiles, the fastest of those chip_smoke.py --gemm-tiles
// timed on an H100 (PERF.md); -D overrides them for that sweep.
#ifndef K1_WG  // wgmma: consumer warpgroups a CTA, 64 rows each
#define K1_WG 2
#endif
#ifndef K1_BN
#define K1_BN 128
#endif
#ifndef K1_STAGES
#define K1_STAGES 3
#endif
#ifndef K1_DECODE_STAGES
#define K1_DECODE_STAGES 6
#endif
#ifndef K1_CTAS  // wgmma: CTAs an SM should hold at once (__launch_bounds__)
#define K1_CTAS 2
#endif
#ifndef K1_GROUP  // wgmma's fixed grid: row tiles a group of the raster
#define K1_GROUP 8
#endif

namespace {

using namespace gemm_tile;

enum Variant { V_WMMA_OR_SIMT = 0, V_WGMMA = 1, V_WGMMA_DECODE = 2 };
constexpr int kDecodeWG = 2;  // wgmma_decode: 128 columns of C a CTA

template <bool A_MN, bool B_MN>
using TileCfg = gemm_ml::Config<K1_WG, K1_BN, K1_STAGES, A_MN, B_MN>;
template <bool A_MN, bool B_MN>
using DecodeCfg = gemm_ml::Config<kDecodeWG, 16, K1_DECODE_STAGES, A_MN, B_MN>;

// Where the epilogue writes: C (M, N) contiguous, fp32 if out_f32 else
// bf16; bias (N,) bf16 or null; the activation code.
struct Out {
  void* c;
  const bf16* bias;
  int act, out_f32;
};

// act(x + bias[n]) cast and stored at C[m][n]; and the pair (n, n + 1) when
// `two` (one vector store when `pair`: N even, so the pair is aligned).
__device__ __forceinline__ void put(const Out& o, size_t at, int n, float x) {
  if (o.bias != nullptr) x += __bfloat162float(o.bias[n]);
  x = activate(x, o.act);
  if (o.out_f32) static_cast<float*>(o.c)[at] = x;
  else static_cast<bf16*>(o.c)[at] = __float2bfloat16(x);
}
__device__ __forceinline__ void put2(const Out& o, size_t at, int n, float x0, float x1, bool two,
                                     bool pair) {
  if (!two || !pair) {
    put(o, at, n, x0);
    if (two) put(o, at + 1, n + 1, x1);
    return;
  }
  if (o.bias != nullptr) {
    x0 += __bfloat162float(o.bias[n]);
    x1 += __bfloat162float(o.bias[n + 1]);
  }
  x0 = activate(x0, o.act);
  x1 = activate(x1, o.act);
  if (o.out_f32) *reinterpret_cast<float2*>(static_cast<float*>(o.c) + at) = make_float2(x0, x1);
  else *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(o.c) + at) = __floats2bfloat162_rn(x0, x1);
}

// The (row, column) origin of this block's tile: from the order table when
// there is one (1-D grid), else from the 2-D grid.
__device__ __forceinline__ int2 tile_origin(const int* order, int BM, int BN) {
  if (order != nullptr) return make_int2(order[2 * blockIdx.x], order[2 * blockIdx.x + 1]);
  return make_int2(blockIdx.y * BM, blockIdx.x * BN);
}

// The wgmma variant's fixed grid, rasterised in groups of G row tiles: the
// blocks in launch order walk the columns of G row tiles together, so the
// CTAs on the card at once share B's column tiles and A's row tiles in L2
// (G = 1: row tile by row tile).
template <int G>
__device__ __forceinline__ int2 grouped_origin(const int* order, int BM, int BN) {
  if (order != nullptr || G <= 1) return tile_origin(order, BM, BN);
  const int cols = gridDim.x, rows = gridDim.y;
  const int id = blockIdx.y * cols + blockIdx.x, group = id / (G * cols);
  const int first = group * G, in_group = min(G, rows - first), local = id % (G * cols);
  return make_int2((first + local % in_group) * BM, (local / in_group) * BN);
}

// ---------------------------------------------------------------------------
// wgmma: the flat product on csrc/gemm_mainloop.cuh
// ---------------------------------------------------------------------------

// K1's addressing: A's rows from m0, B's from n0, k-step it at k = 64 it.
struct FlatCoords {
  int m0, n0;
  __device__ __forceinline__ void coords(int it, int& ar, int& ak, int& az, int& br, int& bk,
                                         int& bz, int& bz_hi) const {
    ar = m0, br = n0, ak = bk = it * gemm_ml::BK, az = bz = bz_hi = 0;
  }
};

template <class C>
__device__ __forceinline__ void wgmma_tile(const CUtensorMap* ta, const CUtensorMap* tb,
                                           const Out& o, int M, int N, int K, const int* order) {
  extern __shared__ unsigned char smem_raw[];
  const gemm_ml::Smem<C> sm(smem_raw);
  const int2 org = grouped_origin<K1_GROUP>(order, C::BM, C::BN);
  const int n = (K + gemm_ml::BK - 1) / gemm_ml::BK;
  gemm_ml::init<C>(sm);
  const int wg = gemm_ml::warpgroup();
  if (wg == C::WG) {
    gemm_ml::produce<C>(sm, ta, tb, FlatCoords{org.x, org.y}, n);
    return;
  }
  float acc[C::BN / 2];
  gemm_ml::consume<C>(acc, sm, n, wg);
  const int row0 = org.x + 64 * wg;
  const bool pair = N % 2 == 0;
#pragma unroll
  for (int i = 0; i < C::BN / 2; i += 2) {
    const int r = row0 + gemm_ml::acc_row(i), c = org.y + gemm_ml::acc_col(i);
    if (r < M && c < N) put2(o, (size_t)r * N + c, c, acc[i], acc[i + 1], c + 1 < N, pair);
  }
}

// Kernels of their own names for the plain layout and the transposed reads,
// so that a profile tells the backward's launches apart.
template <class C>
__global__ void __launch_bounds__(C::THREADS, K1_CTAS)
gemm_bf16_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const Out o, int M, int N, int K, const int* __restrict__ order) {
  wgmma_tile<C>(&ta, &tb, o, M, N, K, order);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, K1_CTAS)
gemm_transposed_bf16_wgmma(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tb, const Out o, int M, int N,
                           int K, const int* __restrict__ order) {
  wgmma_tile<C>(&ta, &tb, o, M, N, K, order);
}

// ---------------------------------------------------------------------------
// wgmma_decode: the split-K weight stream, C^T = op(B)^T op(A)^T
// ---------------------------------------------------------------------------

// The split's fp32 partials (splits, M, N), one int counter per 128-column
// panel (zero between launches), and the split of K: `split_steps` 64-deep
// steps a part, `splits` parts.
struct Split {
  float* ws;
  int* counters;
  int splits, split_steps;
};

// The weight's rows (wgmma's M: C's columns) from n0, the activations' (C's
// rows) from 0; k from this split's first step.
struct DecodeCoords {
  int n0, t0;
  __device__ __forceinline__ void coords(int it, int& ar, int& ak, int& az, int& br, int& bk,
                                         int& bz, int& bz_hi) const {
    ar = n0, br = 0, ak = bk = (t0 + it) * gemm_ml::BK, az = bz = bz_hi = 0;
  }
};

template <class C>
__device__ __forceinline__ void wgmma_decode(const CUtensorMap* tw, const CUtensorMap* tx,
                                             const Out& o, const Split& sp, int M, int N, int K,
                                             const int* order) {
  extern __shared__ unsigned char smem_raw[];
  const gemm_ml::Smem<C> sm(smem_raw);
  const int n0 = order != nullptr ? order[2 * blockIdx.x + 1] : blockIdx.x * C::BM;
  const int steps = (K + gemm_ml::BK - 1) / gemm_ml::BK;
  const int t0 = blockIdx.y * sp.split_steps;
  const int n = max(0, min(t0 + sp.split_steps, steps) - t0);
  gemm_ml::init<C>(sm);
  const int wg = gemm_ml::warpgroup();
  if (wg == C::WG) {
    gemm_ml::produce<C>(sm, tw, tx, DecodeCoords{n0, t0}, n);
    return;
  }
  float acc[8];
  gemm_ml::consume<C>(acc, sm, n, wg);
  // acc[i]: C's column n0 + 64 wg + acc_row(i), row acc_col(i)
  const int col0 = n0 + 64 * wg;
  if (sp.splits == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = col0 + gemm_ml::acc_row(i), m = gemm_ml::acc_col(i);
      if (m < M && col < N) put(o, (size_t)m * N + col, col, acc[i]);
    }
    return;
  }
  float* part = sp.ws + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = col0 + gemm_ml::acc_row(i), m = gemm_ml::acc_col(i);
    if (m < M && col < N) __stcg(part + (size_t)m * N + col, acc[i]);
  }
  __threadfence();
  hopper::named_sync<1, 128 * C::WG>();
  const int panel = n0 / C::BM;
  if (threadIdx.x == 0) *sm.flag = atomicAdd(sp.counters + panel, 1) == sp.splits - 1;
  hopper::named_sync<1, 128 * C::WG>();
  if (!*sm.flag) return;
  // The last split to arrive: every split's partials, in split order.
  __threadfence();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = col0 + gemm_ml::acc_row(i), m = gemm_ml::acc_col(i);
    if (m < M && col < N) {
      float x = 0.0f;
      for (int s = 0; s < sp.splits; ++s) x += __ldcg(sp.ws + ((size_t)s * M + m) * N + col);
      put(o, (size_t)m * N + col, col, x);
    }
  }
  if (threadIdx.x == 0) sp.counters[panel] = 0;
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 2)
gemm_bf16_wgmma_decode(const __grid_constant__ CUtensorMap tw,
                       const __grid_constant__ CUtensorMap tx, const Out o, const Split sp, int M,
                       int N, int K, const int* __restrict__ order) {
  wgmma_decode<C>(&tw, &tx, o, sp, M, N, K, order);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 2)
gemm_transposed_bf16_wgmma_decode(const __grid_constant__ CUtensorMap tw,
                                  const __grid_constant__ CUtensorMap tx, const Out o,
                                  const Split sp, int M, int N, int K,
                                  const int* __restrict__ order) {
  wgmma_decode<C>(&tw, &tx, o, sp, M, N, K, order);
}

// A 2-D bf16 matrix of `rows` x `cols` (unit column stride, row stride ld)
// as the 4-D tensor map hopper::tile_map builds, read in boxes of `box_rows`
// rows by `panel` columns.
inline cudaError_t matrix_map(CUtensorMap* map, const void* p, int rows, int cols, int ld,
                              int panel, int box_rows) {
  return hopper::tile_map(map, p, cols, rows, 1, 1, ld, 0, 0, panel, box_rows);
}

// The operand of `rows` (wgmma's M or N extent) by K stored `mn` (rows along
// the stored row: a (K, rows) matrix) or not (a (rows, K) matrix).
template <class Op>
inline cudaError_t operand_map(CUtensorMap* map, const void* p, int rows, int K, int ld) {
  if (Op::kMN) return matrix_map(map, p, K, rows, ld, Op::SW, gemm_ml::BK);
  return matrix_map(map, p, rows, K, ld, gemm_ml::BK, Op::kRows);
}

// The kernel of each name, instantiated only where it is launched.
template <class C, bool TRANSPOSED>
constexpr auto tile_kernel() {
  if constexpr (TRANSPOSED) return &gemm_transposed_bf16_wgmma<C>;
  else return &gemm_bf16_wgmma<C>;
}
template <class C, bool TRANSPOSED>
constexpr auto decode_kernel() {
  if constexpr (TRANSPOSED) return &gemm_transposed_bf16_wgmma_decode<C>;
  else return &gemm_bf16_wgmma_decode<C>;
}

template <class Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool TA, bool TB>
cudaError_t launch_wgmma(const bf16* A, const bf16* B, const Out& o, int M, int N, int K, int lda,
                         int ldb, const int* order, int n_order, cudaStream_t s) {
  using C = TileCfg<TA, !TB>;
  CUtensorMap ta, tb;
  cudaError_t e = operand_map<typename C::A>(&ta, A, M, K, lda);
  if (e == cudaSuccess) e = operand_map<typename C::B>(&tb, B, N, K, ldb);
  if (e != cudaSuccess) return e;
  const auto kern = tile_kernel<C, TA || TB>();
  static const cudaError_t attr = allow_smem(kern, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid = order != nullptr ? dim3(n_order)
                                     : dim3((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  kern<<<grid, C::THREADS, C::SMEM, s>>>(ta, tb, o, M, N, K, order);
  return cudaGetLastError();
}

template <bool TA, bool TB>
cudaError_t launch_decode(const bf16* A, const bf16* B, const Out& o, const Split& sp, int M, int N,
                          int K, int lda, int ldb, const int* order, int n_order, cudaStream_t s) {
  // wgmma's A is the weight op(B)^T: MN-major unless B is stored (N, K);
  // its B is op(A)^T: MN-major when A is stored (K, M)
  using C = DecodeCfg<!TB, TA>;
  CUtensorMap tw, tx;
  cudaError_t e = operand_map<typename C::A>(&tw, B, N, K, ldb);
  if (e == cudaSuccess) e = operand_map<typename C::B>(&tx, A, M, K, lda);
  if (e != cudaSuccess) return e;
  const auto kern = decode_kernel<C, TA || TB>();
  static const cudaError_t attr = allow_smem(kern, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const int panels = order != nullptr ? n_order : (N + C::BM - 1) / C::BM;
  kern<<<dim3(panels, sp.splits), C::THREADS, C::SMEM, s>>>(tw, tx, o, sp, M, N, K, order);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wmma and simt: csrc/gemm_tile.cuh's tile mainloops
// ---------------------------------------------------------------------------

template <int BM, int BN, int WARPS_M, int WARPS_N, typename TOut>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
gemm_bf16_wmma(const bf16* __restrict__ A, const bf16* __restrict__ B,
               const bf16* __restrict__ bias, TOut* __restrict__ C, int M, int N, int K,
               int lda, int ldb, int act, bool vec, const int* __restrict__ order) {
  const int2 o = tile_origin(order, BM, BN);
  bf16_wmma_tile<BM, BN, WARPS_M, WARPS_N, false, false>(A, B, bias, C, M, N, K, lda, ldb, act,
                                                         vec, o.x, o.y);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool TA, bool TB, typename TOut>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
gemm_transposed_bf16_wmma(const bf16* __restrict__ A, const bf16* __restrict__ B,
                          const bf16* __restrict__ bias, TOut* __restrict__ C, int M, int N,
                          int K, int lda, int ldb, int act, bool vec,
                          const int* __restrict__ order) {
  const int2 o = tile_origin(order, BM, BN);
  bf16_wmma_tile<BM, BN, WARPS_M, WARPS_N, TA, TB>(A, B, bias, C, M, N, K, lda, ldb, act, vec,
                                                   o.x, o.y);
}

template <typename TOut>
__global__ void __launch_bounds__(256)
gemm_f32_simt(const float* __restrict__ A, const float* __restrict__ B,
              const float* __restrict__ bias, TOut* __restrict__ C, int M, int N, int K,
              int lda, int ldb, int act, const int* __restrict__ order) {
  const int2 o = tile_origin(order, 64, 64);
  f32_simt_tile<false, false>(A, B, bias, C, M, N, K, lda, ldb, act, o.x, o.y);
}

template <bool TA, bool TB, typename TOut>
__global__ void __launch_bounds__(256)
gemm_transposed_f32_simt(const float* __restrict__ A, const float* __restrict__ B,
                         const float* __restrict__ bias, TOut* __restrict__ C, int M, int N,
                         int K, int lda, int ldb, int act, const int* __restrict__ order) {
  const int2 o = tile_origin(order, 64, 64);
  f32_simt_tile<TA, TB>(A, B, bias, C, M, N, K, lda, ldb, act, o.x, o.y);
}

// The grid: the order table's length (1-D) when there is one, else column
// tiles by row tiles.
inline dim3 grid_of(const int* order, int n_order, int M, int N, int BM, int BN) {
  if (order != nullptr) return dim3(n_order);
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool TA, bool TB, typename TOut>
void launch_bf16_tile(const bf16* A, const bf16* B, const bf16* bias, TOut* C, int M, int N,
                      int K, int lda, int ldb, int act, bool vec, const int* order, int n_order,
                      cudaStream_t s) {
  constexpr int NT = WARPS_M * WARPS_N * 32;
  const dim3 grid = grid_of(order, n_order, M, N, BM, BN);
  if constexpr (TA || TB)
    gemm_transposed_bf16_wmma<BM, BN, WARPS_M, WARPS_N, TA, TB, TOut>
        <<<grid, NT, 0, s>>>(A, B, bias, C, M, N, K, lda, ldb, act, vec, order);
  else
    gemm_bf16_wmma<BM, BN, WARPS_M, WARPS_N, TOut>
        <<<grid, NT, 0, s>>>(A, B, bias, C, M, N, K, lda, ldb, act, vec, order);
}

// The wmma variant's CTA tiles (16x64 for M <= 16, else 128x128), as
// kernels/brgemm.py::cta_tile names them for the order table.
template <bool TA, bool TB, typename TOut>
void launch_wmma(const bf16* A, const bf16* B, const bf16* bias, TOut* C, int M, int N, int K,
                 int lda, int ldb, int act, bool vec, const int* order, int n_order,
                 cudaStream_t s) {
  if (M <= 16)
    launch_bf16_tile<16, 64, 1, 4, TA, TB>(A, B, bias, C, M, N, K, lda, ldb, act, vec, order,
                                           n_order, s);
  else
    launch_bf16_tile<128, 128, 2, 4, TA, TB>(A, B, bias, C, M, N, K, lda, ldb, act, vec, order,
                                             n_order, s);
}

template <bool TA, bool TB, typename TOut>
void launch_f32(const float* A, const float* B, const float* bias, TOut* C, int M, int N,
                int K, int lda, int ldb, int act, const int* order, int n_order,
                cudaStream_t s) {
  const dim3 grid = grid_of(order, n_order, M, N, 64, 64);
  if constexpr (TA || TB)
    gemm_transposed_f32_simt<TA, TB, TOut><<<grid, 256, 0, s>>>(A, B, bias, C, M, N, K, lda, ldb,
                                                                act, order);
  else
    gemm_f32_simt<TOut><<<grid, 256, 0, s>>>(A, B, bias, C, M, N, K, lda, ldb, act, order);
}

struct Call {
  const void *a, *b, *bias;
  void* c;
  int in_bf16, out_bf16, M, N, K, lda, ldb, act, vec;
  const int* order;
  int n_order, variant, cta_n;
  Split split;
  cudaStream_t s;
};

template <bool TA, bool TB>
cudaError_t dispatch(const Call& k) {
  if (k.variant == V_WGMMA || k.variant == V_WGMMA_DECODE) {
    const bf16* A = static_cast<const bf16*>(k.a);
    const bf16* B = static_cast<const bf16*>(k.b);
    const Out o{k.c, static_cast<const bf16*>(k.bias), k.act, k.out_bf16 ? 0 : 1};
    if (k.variant == V_WGMMA) {
      if (k.order != nullptr && k.cta_n != K1_BN) return cudaErrorInvalidValue;
      return launch_wgmma<TA, TB>(A, B, o, k.M, k.N, k.K, k.lda, k.ldb, k.order, k.n_order, k.s);
    }
    if (k.order != nullptr && k.cta_n != 64 * kDecodeWG) return cudaErrorInvalidValue;
    return launch_decode<TA, TB>(A, B, o, k.split, k.M, k.N, k.K, k.lda, k.ldb, k.order,
                                 k.n_order, k.s);
  }
  if (k.in_bf16) {
    const bf16* A = static_cast<const bf16*>(k.a);
    const bf16* B = static_cast<const bf16*>(k.b);
    const bf16* bs = static_cast<const bf16*>(k.bias);
    if (k.out_bf16)
      launch_wmma<TA, TB>(A, B, bs, static_cast<bf16*>(k.c), k.M, k.N, k.K, k.lda, k.ldb, k.act,
                          k.vec != 0, k.order, k.n_order, k.s);
    else
      launch_wmma<TA, TB>(A, B, bs, static_cast<float*>(k.c), k.M, k.N, k.K, k.lda, k.ldb, k.act,
                          k.vec != 0, k.order, k.n_order, k.s);
  } else {
    const float* A = static_cast<const float*>(k.a);
    const float* B = static_cast<const float*>(k.b);
    const float* bs = static_cast<const float*>(k.bias);
    if (k.out_bf16)
      launch_f32<TA, TB>(A, B, bs, static_cast<bf16*>(k.c), k.M, k.N, k.K, k.lda, k.ldb, k.act,
                         k.order, k.n_order, k.s);
    else
      launch_f32<TA, TB>(A, B, bs, static_cast<float*>(k.c), k.M, k.N, k.K, k.lda, k.ldb, k.act,
                         k.order, k.n_order, k.s);
  }
  return cudaGetLastError();
}

}  // namespace

// op(A) (M,K) and op(B) (K,N), both of one dtype (bf16 if in_bf16, else
// fp32).  A is stored (M,K) with row stride lda, or (K,M) if trans_a; B is
// stored (K,N) with row stride ldb, or (N,K) if trans_b; unit column stride
// either way.  bias (N,) of the input dtype or null; C (M,N) contiguous, bf16
// if out_bf16 else fp32.  vec: stored rows of A and B start 16-byte aligned
// (wmma's vector loads).  order: null, or n_order (row, column) int32 tile
// origins on the device, every tile of C once, made for tiles of cta_n
// columns.  variant: 0 wmma (bf16) or simt (fp32), 1 wgmma, 2 wgmma_decode
// (bf16 operands TMA can read; 2 needs M <= 16); for 2, workspace (splits,
// M, N) fp32 when splits > 1, counters at least ceil(N / 128) zero ints,
// and K split into `splits` parts of `split_steps` 64-deep steps.  Returns
// cudaErrorInvalidValue without launching for a call the variant does not
// take, else cudaGetLastError() after the launch.
extern "C" int gemm(const void* a, const void* b, const void* bias, void* c, int in_bf16,
                    int out_bf16, int M, int N, int K, int lda, int ldb, int trans_a,
                    int trans_b, int act, int vec, const int* order, int n_order, int variant,
                    int cta_n, void* workspace, void* counters, int splits, int split_steps,
                    void* stream) {
  if (variant != V_WMMA_OR_SIMT &&
      (!in_bf16 || (variant == V_WGMMA_DECODE &&
                     (M > 16 || splits < 1 || split_steps < 1 ||
                      (splits > 1 && (workspace == nullptr || counters == nullptr))))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Call k{a, b, bias, c, in_bf16, out_bf16, M, N, K, lda, ldb, act, vec, order, n_order,
               variant, cta_n,
               Split{static_cast<float*>(workspace), static_cast<int*>(counters), splits,
                     split_steps},
               static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (trans_a && trans_b) e = dispatch<true, true>(k);
  else if (trans_a) e = dispatch<true, false>(k);
  else if (trans_b) e = dispatch<false, true>(k);
  else e = dispatch<false, false>(k);
  return static_cast<int>(e);
}

// The wgmma variants' tiles as built (K1_BN, K1_STAGES, K1_DECODE_STAGES may
// be set with -D): out[0..4] = the wgmma tile's rows, columns and stages,
// wgmma_decode's columns of C a CTA and stages.
extern "C" int gemm_tiles(int* out) {
  out[0] = TileCfg<false, true>::BM;
  out[1] = TileCfg<false, true>::BN;
  out[2] = TileCfg<false, true>::STAGES;
  out[3] = DecodeCfg<true, false>::BM;
  out[4] = DecodeCfg<true, false>::STAGES;
  return 0;
}
