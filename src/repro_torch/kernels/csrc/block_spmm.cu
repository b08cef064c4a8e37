// K10: the block-sparse product C = A_sparse @ B (paper §III-C, Block-SpMM),
// and K9: the grouped (per-row-tile expert) product of a mixture of experts.
//
// K10 replaces repro/kernels/block_spmm.py::block_spmm_pallas.  A is a BCSR
// work list sorted row-major: blocks (nnzb, bm, bk), each at block row
// row_id[t] and block column col_id[t]; here the wrapper hands the kernel
// row_ptr (nrows + 1), the first item of every block row, derived on the
// device from the sorted row_id.  B is (K, N), read in place through its
// strides: row-major, or a transposed view (the Fig. 10 call passes x^T).
// C (nrows·bm, N) is contiguous; a block row with no items comes out zero.
//
// What bounds K10 on an H100: the least work is 2·bm·bk·N operations an
// item against the blocks, B and C each moved once.  Over the Fig. 8 sweep
// (M = K = N = 4096, 16x16 blocks) the bf16 operations bound it up to 70 %
// sparsity and the bytes at 90 %; bert-large's 80 % sparse FFN products
// (8x8 blocks, 4096 tokens) are bound by bytes.  What the kernel pays on
// top is each item's gather of bk rows of B (bm flop per byte gathered, 8
// or 16, far under the card's ~295 flop/byte ridge), from L2 when the rows
// of one N tile are in flight together.
//
// What the design does about it: the TPU kernel walks (N tiles, items) in
// order and flushes an fp32 VMEM accumulator when row_id changes.  Nothing
// carries between blocks here, so one block owns one (block row, 128-column
// tile) and loops over that row's items in registers, writing C once.
// Blocks of one N tile are launched together (grid.x walks the block rows),
// so that tile's columns of B stay in L2 while every row gathers from them.
// bf16 runs on the tensor cores through WMMA: a k-step is 16 deep, so a
// 16x16 block is one m16n16k16 step and two consecutive 8x8 items of a row
// make one m8n32k16 step (their B rows stacked, an odd last item padded with
// zeros).  fp32 runs in SIMT FMA, one thread per column, never TF32.  Loads
// are 16-byte vectors along B's contiguous axis (N, or K for x^T) and are
// not pipelined; that is left for the PR that makes the kernel fast.
//
// K9 replaces repro/kernels/block_spmm.py::grouped_matmul_pallas: x (T, d) in
// row tiles of T / tiles rows, group_id (tiles,) the expert of each tile,
// w (E, d, f) → out (T, f), fp32 accumulator.  At qwen3-moe's widths (d
// 4096, f 1536) an expert's slab is 12.6 MB of bf16 and a 64-row tile does
// 64 flop per byte of it, under the ridge: HBM bytes bound it (x, the
// distinct experts' slabs and out once).  The TPU kernel keeps the tile's
// whole d in VMEM; here a block computes a 64 x 128 (bf16) or 64 x 64
// (fp32) tile of one row tile with K1's own mainloop (csrc/gemm_tile.cuh),
// stepping d through shared memory, after reading its tile's group id
// itself.  Row tiles that share an expert read its slab from L2.
#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

constexpr int kBN = 128;      // K10: columns of C per block, one per thread (fp32)
constexpr int kKStep = 16;    // K10: WMMA depth

// K10 on the tensor cores.  A block is 4 warps, each 32 columns of the
// 128-column tile: two 16x16 fragments (BM 16) or one 8x32 fragment (BM 8).
// TB: B is a transposed view, stored (N, K) with row stride ldb; its panel
// is kept n-major and read by column-major fragments.
template <int BM, int BK, bool TB, typename TOut>
__global__ void __launch_bounds__(128)
block_spmm_bf16_wmma(const bf16* __restrict__ blocks, const int* __restrict__ row_ptr,
                     const int* __restrict__ col_id, const bf16* __restrict__ B,
                     TOut* __restrict__ C, int N, int K, int ldb, bool vec) {
  static_assert(BM == 8 || BM == 16, "block rows");
  static_assert(kKStep % BK == 0, "a k-step holds whole items");
  constexpr int IPS = kKStep / BK;            // items per k-step
  constexpr int FN = BM == 16 ? 16 : 32;      // fragment columns
  constexpr int NF = 32 / FN;                 // fragments per warp
  constexpr int AP = kKStep + 8;              // padded rows: 16-byte aligned, fewer conflicts
  constexpr int BP = TB ? kKStep + 8 : kBN + 8;
  constexpr int CP = kBN + 4;
  using LayoutB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
  __shared__ __align__(128) bf16 As[BM * AP];
  __shared__ __align__(128) bf16 Bs[(TB ? kBN : kKStep) * BP];
  __shared__ __align__(128) float Cs[BM * CP];

  const int r = blockIdx.x, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32;
  const int beg = row_ptr[r], end = row_ptr[r + 1];
  const bf16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, BM, FN, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int t = beg; t < end; t += IPS) {
    // A panel (BM x 16): item j of the step fills columns j*BK .. j*BK+BK-1.
    for (int i = threadIdx.x; i < BM * kKStep; i += 128) {
      const int row = i / kKStep, c = i % kKStep, item = t + c / BK;
      As[row * AP + c] = item < end ? blocks[(size_t)item * BM * BK + row * BK + c % BK] : zero;
    }
    // B panel (16 x 128): rows of item j from col_id[t + j]·BK; a missing
    // item's rows point past K and load as zeros.
    int k0[IPS];
#pragma unroll
    for (int j = 0; j < IPS; ++j) k0[j] = t + j < end ? col_id[t + j] * BK : K;
    if (TB) {   // stored (N, K): 8 consecutive k of one column per vector
      for (int i = threadIdx.x; i < kBN * 2; i += 128) {
        const int n = i / 2, seg = (i % 2) * 8, gk = k0[seg / BK] + seg % BK;
        load8(&Bs[n * BP + seg], B, n0 + n, k0[seg / BK] < K ? gk : K, N, K, ldb, vec);
      }
    } else {    // stored (K, N): 8 consecutive columns of one row per vector
      for (int i = threadIdx.x; i < kKStep * kBN / 8; i += 128) {
        const int kr = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
        const int base = k0[kr / BK];
        load8(&Bs[kr * BP + c], B, base < K ? base + kr % BK : K, n0 + c, K, N, ldb, vec);
      }
    }
    __syncthreads();
    wmma::fragment<wmma::matrix_a, BM, FN, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, As, AP);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int nn = warp * 32 + f * FN;
      wmma::fragment<wmma::matrix_b, BM, FN, 16, bf16, LayoutB> bfr;
      wmma::load_matrix_sync(bfr, TB ? &Bs[nn * BP] : &Bs[nn], BP);
      wmma::mma_sync(acc[f], af, bfr, acc[f]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(&Cs[warp * 32 + f * FN], acc[f], CP, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * kBN; i += 128) {
    const int row = i / kBN, c = i % kBN;
    if (n0 + c < N) C[(size_t)(r * BM + row) * N + n0 + c] = from_float<TOut>(Cs[row * CP + c]);
  }
}

// K10 in fp32 FMA: one thread per column of the 128-column tile, BM sums in
// registers; each item's block is staged in shared memory and read by all.
template <int BM, int BK, bool TB, typename TOut>
__global__ void __launch_bounds__(128)
block_spmm_f32_simt(const float* __restrict__ blocks, const int* __restrict__ row_ptr,
                    const int* __restrict__ col_id, const float* __restrict__ B,
                    TOut* __restrict__ C, int N, int K, int ldb) {
  __shared__ float As[BM * BK];
  const int r = blockIdx.x, n = blockIdx.y * kBN + threadIdx.x;
  const int beg = row_ptr[r], end = row_ptr[r + 1];
  float acc[BM] = {};
  for (int t = beg; t < end; ++t) {
    for (int i = threadIdx.x; i < BM * BK; i += 128) As[i] = blocks[(size_t)t * BM * BK + i];
    __syncthreads();
    const int k0 = col_id[t] * BK;
    if (n < N && k0 + BK <= K) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float b = B[TB ? (size_t)n * ldb + k0 + kk : (size_t)(k0 + kk) * ldb + n];
#pragma unroll
        for (int i = 0; i < BM; ++i) acc[i] = fmaf(As[i * BK + kk], b, acc[i]);
      }
    }
    __syncthreads();
  }
  if (n < N)
#pragma unroll
    for (int i = 0; i < BM; ++i) C[(size_t)(r * BM + i) * N + n] = from_float<TOut>(acc[i]);
}

template <int BM, int BK, bool TB>
void launch_spmm(const void* blocks, const int* row_ptr, const int* col_id, const void* b,
                 void* c, int in_bf16, int out_bf16, int nrows, int N, int K, int ldb, bool vec,
                 cudaStream_t s) {
  dim3 grid(nrows, (N + kBN - 1) / kBN);
  if (in_bf16) {
    const bf16* A = static_cast<const bf16*>(blocks);
    const bf16* Bm = static_cast<const bf16*>(b);
    if (out_bf16)
      block_spmm_bf16_wmma<BM, BK, TB><<<grid, 128, 0, s>>>(A, row_ptr, col_id, Bm,
                                                            static_cast<bf16*>(c), N, K, ldb, vec);
    else
      block_spmm_bf16_wmma<BM, BK, TB><<<grid, 128, 0, s>>>(A, row_ptr, col_id, Bm,
                                                            static_cast<float*>(c), N, K, ldb, vec);
  } else {
    const float* A = static_cast<const float*>(blocks);
    const float* Bm = static_cast<const float*>(b);
    if (out_bf16)
      block_spmm_f32_simt<BM, BK, TB><<<grid, 128, 0, s>>>(A, row_ptr, col_id, Bm,
                                                           static_cast<bf16*>(c), N, K, ldb);
    else
      block_spmm_f32_simt<BM, BK, TB><<<grid, 128, 0, s>>>(A, row_ptr, col_id, Bm,
                                                           static_cast<float*>(c), N, K, ldb);
  }
}

template <int BM, int BK>
void dispatch_spmm(const void* blocks, const int* row_ptr, const int* col_id, const void* b,
                   void* c, int in_bf16, int out_bf16, int nrows, int N, int K, int ldb,
                   int trans_b, bool vec, cudaStream_t s) {
  if (trans_b)
    launch_spmm<BM, BK, true>(blocks, row_ptr, col_id, b, c, in_bf16, out_bf16, nrows, N, K, ldb,
                              vec, s);
  else
    launch_spmm<BM, BK, false>(blocks, row_ptr, col_id, b, c, in_bf16, out_bf16, nrows, N, K,
                               ldb, vec, s);
}

// K9.  blockIdx: x the column tile, y the row tile, z the 64-row chunk of
// it; the tile's rows past its end are masked by the mainloop (M = rows).
template <typename TOut>
__global__ void __launch_bounds__(256)
grouped_matmul_bf16_wmma(const bf16* __restrict__ x, const int* __restrict__ group_id,
                         const bf16* __restrict__ w, TOut* __restrict__ out, int rows, int E,
                         int d, int f, bool vec) {
  const int g = min(max(group_id[blockIdx.y], 0), E - 1);
  const size_t row0 = (size_t)blockIdx.y * rows;
  bf16_wmma_tile<64, 128, 2, 4, false, false>(x + row0 * d, w + (size_t)g * d * f,
                                              static_cast<const bf16*>(nullptr), out + row0 * f,
                                              rows, f, d, d, f, ACT_NONE, vec, blockIdx.z * 64,
                                              blockIdx.x * 128);
}

template <typename TOut>
__global__ void __launch_bounds__(256)
grouped_matmul_f32_simt(const float* __restrict__ x, const int* __restrict__ group_id,
                        const float* __restrict__ w, TOut* __restrict__ out, int rows, int E,
                        int d, int f) {
  const int g = min(max(group_id[blockIdx.y], 0), E - 1);
  const size_t row0 = (size_t)blockIdx.y * rows;
  f32_simt_tile<false, false>(x + row0 * d, w + (size_t)g * d * f,
                              static_cast<const float*>(nullptr), out + row0 * f, rows, f, d, d,
                              f, ACT_NONE, blockIdx.z * 64, blockIdx.x * 64);
}

}  // namespace

// K10.  blocks (nnzb, bm, bk) contiguous, bf16 if in_bf16 else fp32, of
// 8x8 or 16x16; row_ptr (nrows + 1) and col_id (nnzb) int32 on the
// device; B (K, N) of the blocks' dtype, stored (K, N) with row stride ldb,
// or (N, K) if trans_b, unit stride along its rows either way; C
// (nrows·bm, N) contiguous, bf16 if out_bf16 else fp32.  vec: B's stored
// rows start 16-byte aligned.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a block size it has no kernel for.
extern "C" int block_spmm(const void* blocks, const void* row_ptr, const void* col_id,
                          const void* b, void* c, int in_bf16, int out_bf16, int nrows, int bm,
                          int bk, int N, int K, int ldb, int trans_b, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ci = static_cast<const int*>(col_id);
  const bool v = vec != 0;
  if (bm == 8 && bk == 8)
    dispatch_spmm<8, 8>(blocks, rp, ci, b, c, in_bf16, out_bf16, nrows, N, K, ldb, trans_b, v, s);
  else if (bm == 16 && bk == 16)
    dispatch_spmm<16, 16>(blocks, rp, ci, b, c, in_bf16, out_bf16, nrows, N, K, ldb, trans_b, v,
                          s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K9.  x (tiles·rows, d) and w (E, d, f) contiguous, bf16 if in_bf16 else
// fp32; group_id (tiles) int32 on the device, clamped into [0, E); out
// (tiles·rows, f) contiguous, bf16 if out_bf16 else fp32.  vec: x's and w's
// rows start 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int grouped_matmul(const void* x, const void* group_id, const void* w, void* out,
                              int in_bf16, int out_bf16, int tiles, int rows, int E, int d,
                              int f, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gid = static_cast<const int*>(group_id);
  const int chunks = (rows + 63) / 64;
  if (in_bf16) {
    dim3 grid((f + 127) / 128, tiles, chunks);
    const bf16* X = static_cast<const bf16*>(x);
    const bf16* W = static_cast<const bf16*>(w);
    if (out_bf16)
      grouped_matmul_bf16_wmma<<<grid, 256, 0, s>>>(X, gid, W, static_cast<bf16*>(out), rows, E,
                                                    d, f, vec != 0);
    else
      grouped_matmul_bf16_wmma<<<grid, 256, 0, s>>>(X, gid, W, static_cast<float*>(out), rows, E,
                                                    d, f, vec != 0);
  } else {
    dim3 grid((f + 63) / 64, tiles, chunks);
    const float* X = static_cast<const float*>(x);
    const float* W = static_cast<const float*>(w);
    if (out_bf16)
      grouped_matmul_f32_simt<<<grid, 256, 0, s>>>(X, gid, W, static_cast<bf16*>(out), rows, E, d,
                                                   f);
    else
      grouped_matmul_f32_simt<<<grid, 256, 0, s>>>(X, gid, W, static_cast<float*>(out), rows, E,
                                                   d, f);
  }
  return static_cast<int>(cudaGetLastError());
}
