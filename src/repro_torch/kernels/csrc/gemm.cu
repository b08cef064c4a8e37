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
// reference's nest, maps its output visit order onto this file's CTA tiles
// (kernels/brgemm.py::cta_tile must name the tile each launch below picks)
// and passes the (row, column) origins as an int32 table; the grid is then
// 1-D and block i computes the tile at table entry i.  A tile is computed
// the same way under any table, so every legal spec gives the same bits.
//
// What bounds it on an H100: at prefill or training (M = 2048..4096 rows
// against 2304x5760-class or 5120x13824-class weights) the work is far above
// the card's ~295 flop/byte ridge in bf16, so tensor-core operations bound
// it; at decode (M = 4) it is one pass over the weight matrix, bound by HBM
// bytes.
//
// What the design does about it: bf16 inputs run on the tensor cores through
// WMMA 16x16x16 fragments (mma.sync) with fp32 accumulators, 128x128 output
// tiles per block for large M; for M <= 16 a block holds a 16-row by 64-column
// tile, so the grid spreads over N and every weight tile is read once with
// 16-byte loads.  Each operand tile is copied to shared memory in its stored
// layout, 16-byte vectors along whichever axis is contiguous, and read by
// row-major or column-major fragments to match, so a transposed operand is
// never copied in device memory.  fp32 inputs (the reduced test configs) run
// a SIMT kernel in full fp32 FMA, never TF32.  Ragged M, N and K edges are
// zero-filled on load and masked on store.  Loads are not pipelined (no
// cp.async, TMA or wgmma) and K is not split: that is left for the PR that
// makes this kernel fast.
#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

// The (row, column) origin of this block's tile: from the order table when
// there is one (1-D grid), else from the 2-D grid.
__device__ __forceinline__ int2 tile_origin(const int* order, int BM, int BN) {
  if (order != nullptr) return make_int2(order[2 * blockIdx.x], order[2 * blockIdx.x + 1]);
  return make_int2(blockIdx.y * BM, blockIdx.x * BN);
}

// The kernels.  Row-major operands and transposed reads are kernels of
// their own names, so that a profile tells the backward's launches apart.
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

// The CTA tiles here (16x64 for M <= 16, else 128x128; 64x64 in fp32) are
// the ones kernels/brgemm.py::cta_tile names for the order table.
template <bool TA, bool TB, typename TOut>
void launch_bf16(const bf16* A, const bf16* B, const bf16* bias, TOut* C, int M, int N, int K,
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

template <bool TA, bool TB>
void dispatch(const void* a, const void* b, const void* bias, void* c, int in_bf16,
              int out_bf16, int M, int N, int K, int lda, int ldb, int act, bool vec,
              const int* order, int n_order, cudaStream_t s) {
  if (in_bf16) {
    const bf16* A = static_cast<const bf16*>(a);
    const bf16* B = static_cast<const bf16*>(b);
    const bf16* bs = static_cast<const bf16*>(bias);
    if (out_bf16)
      launch_bf16<TA, TB>(A, B, bs, static_cast<bf16*>(c), M, N, K, lda, ldb, act, vec, order,
                          n_order, s);
    else
      launch_bf16<TA, TB>(A, B, bs, static_cast<float*>(c), M, N, K, lda, ldb, act, vec, order,
                          n_order, s);
  } else {
    const float* A = static_cast<const float*>(a);
    const float* B = static_cast<const float*>(b);
    const float* bs = static_cast<const float*>(bias);
    if (out_bf16)
      launch_f32<TA, TB>(A, B, bs, static_cast<bf16*>(c), M, N, K, lda, ldb, act, order, n_order,
                         s);
    else
      launch_f32<TA, TB>(A, B, bs, static_cast<float*>(c), M, N, K, lda, ldb, act, order,
                         n_order, s);
  }
}

}  // namespace

// op(A) (M,K) and op(B) (K,N), both of one dtype (bf16 if in_bf16, else
// fp32).  A is stored (M,K) with row stride lda, or (K,M) if trans_a; B is
// stored (K,N) with row stride ldb, or (N,K) if trans_b; unit column stride
// either way.  bias (N,) of the input dtype or null; C (M,N) contiguous, bf16
// if out_bf16 else fp32.  vec: stored rows of A and B start 16-byte aligned.
// order: null, or n_order (row, column) int32 tile origins on the device,
// every tile of C once.  Returns cudaGetLastError() after the launch.
extern "C" int gemm(const void* a, const void* b, const void* bias, void* c, int in_bf16,
                    int out_bf16, int M, int N, int K, int lda, int ldb, int trans_a,
                    int trans_b, int act, int vec, const int* order, int n_order,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (trans_a && trans_b)
    dispatch<true, true>(a, b, bias, c, in_bf16, out_bf16, M, N, K, lda, ldb, act, v, order,
                         n_order, s);
  else if (trans_a)
    dispatch<true, false>(a, b, bias, c, in_bf16, out_bf16, M, N, K, lda, ldb, act, v, order,
                          n_order, s);
  else if (trans_b)
    dispatch<false, true>(a, b, bias, c, in_bf16, out_bf16, M, N, K, lda, ldb, act, v, order,
                          n_order, s);
  else
    dispatch<false, false>(a, b, bias, c, in_bf16, out_bf16, M, N, K, lda, ldb, act, v, order,
                           n_order, s);
  return static_cast<int>(cudaGetLastError());
}
