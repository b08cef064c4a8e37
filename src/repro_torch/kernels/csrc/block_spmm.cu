// K10: the block-sparse product C = A_sparse @ B (paper §III-C, Block-SpMM),
// and K9: the grouped (per-row-tile expert) product of a mixture of experts.
//
// K10 replaces repro/kernels/block_spmm.py::block_spmm_pallas.  A is a BCSR
// work list sorted row-major: blocks (nnzb, bm, bk) of 8x8, 16x16, 64x8 or
// 64x16, each at block row row_id[t] and block column col_id[t]; here the
// wrapper hands the kernel row_ptr (nrows + 1), the first item of every
// block row, derived on the device from the sorted row_id.  B is (K, N),
// read in place through its strides: row-major, or a transposed view (the
// Fig. 10 call passes x^T).  C (nrows·bm, N) is contiguous; a block row with
// no items comes out zero.
//
// What bounds K10 on an H100: the least work is 2·bs²·N operations an item
// of the bs x bs blocks the matrix was pruned in, against those blocks, B
// and C each moved once.  Over the Fig. 8 sweep (M = K = N = 4096, 16x16
// blocks) the bf16 operations bound it up to 70 % sparsity and the bytes at
// 90 %; bert-large's 80 % sparse FFN products (8x8 blocks, 4096 tokens) are
// bound by bytes.  What the kernel pays on top is each item's gather of bk
// rows of B (bm flop per byte gathered, far under the card's ~295
// flop/byte ridge at bm 8 or 16), from L2 when the rows of one N tile are
// in flight together.
//
// What the design does about it: the TPU kernel walks (N tiles, items) in
// order and flushes an fp32 VMEM accumulator when row_id changes.  Nothing
// carries between CTAs here.  Three variants (kernels/block_spmm.py
// spmm_plan, from the dtype, the block shape and whether TMA reads B and
// the blocks):
//   wgmma (bf16, 64-row blocks): a matrix pruned in 8x8 or 16x16 blocks is
//     stored once in 64 x bk blocks (densify_to_bcsr(a, 64, bk), where the
//     weights are pruned): each block the union of 8 or 4 block rows' items
//     at one column, zeros where a row lacks it.  Each gathered B panel then
//     serves 64 rows: at 80 % of 8x8 blocks the 64-row list holds about half
//     the items of the 8x8 one, at 0 % a quarter of 16x16's, for products of
//     zeros (one block row of 8 or 16 a tile was slower at every Fig. 8 and
//     phase 7c row, PERF.md).  The operands swap, C^T = B^T A^T, so that
//     wgmma's 64-row side runs over B's columns (two consumer warpgroups:
//     128 columns of C a CTA) and its n over the block's 64 rows.  One
//     producer thread keeps a ring of 4 stages of 4 k16 steps in flight by
//     TMA: for each step the gathered B panel (bk rows of B at col_id * bk
//     by 128 columns: B (K, N) MN-major with wgmma's transpose bit, or B
//     stored (N, K) K-major, read in place for 16-deep items) and the
//     items' blocks, two 8-deep items filling one k16 (a stage's blocks one
//     bulk copy of consecutive unswizzled core matrices), a 16-deep item
//     one (a 32-byte swizzle); an odd last item of a block row pairs with a
//     box past the ends of B and the blocks, which TMA fills with zeros.
//     For 8-deep items B stored (N, K) (the Fig. 10 call's x^T) is first
//     transposed into a (K, N) workspace: read in place, each 8-k gather is
//     a 16-byte row of its own, and TMA moves boxes at about two rows a
//     cycle an SM, not by their bytes.  A CTA owns one 128-column tile of C
//     and walks a run of block rows through the one ring (spmm_plan sizes
//     the runs to about four CTAs an SM), writing each from the registers.
//     Gathered bytes bound it.
//   wmma (bf16 blocks of 8 or 16 rows, or operands TMA cannot read): one
//     block owns one (block row, 128-column tile) and loops over that row's
//     items in registers through WMMA (two consecutive 8-deep items of a row
//     make one k16 step, an odd last item padded with zeros); loads are
//     16-byte vectors along B's contiguous axis, not pipelined.
//   simt (fp32): the same blocks in SIMT FMA, one thread per column, never
//     TF32.

// K9 replaces repro/kernels/block_spmm.py:137 grouped_matmul_pallas
// (pallas_call at :174): x (T, d) in row tiles of T / tiles rows, group_id
// (tiles,) the expert of each tile (clamped into [0, E) here), w (E, d, f)
// → out (T, f), fp32 accumulator.
//
// What bounds K9 on an H100: at qwen3-moe's widths (d 4096, f 1536, 64-row
// tiles) an expert's slab is 12.6 MB of bf16 and a 64-row tile does 64 flop
// per byte of it, under the card's ~295 flop/byte ridge: HBM bytes bound it
// (x, the distinct experts' slabs and out once: 679 MB of weights for 54 of
// 128 experts, 0.2166 ms), and only a weight stream with tens of KB in
// flight on every SM comes near the rate.
//
// What the design does about it: three variants (kernels/block_spmm.py
// grouped_plan, from the dtype and whether TMA reads x and w):
//   wgmma (bf16, d and f multiples of 8, 16-byte aligned bases): the GEMM
//     mainloop of csrc/gemm_mainloop.cuh under a Policy for the expert's
//     rows, with one consumer warpgroup of 64 rows by 128 columns and a
//     4-deep TMA ring.  x is read K-major through a tensor map over
//     (d, rows, tiles), the expert's slab MN-major where it lies through one
//     over (f, d, E): for k-step it of the CTA at (row tile t, 64-row chunk
//     c, column tile n0) A's box is at (it·64, c·64, t) and B's at (n0, it·64,
//     g), g read from group_id[t] by the producer warp and clamped.  Rows
//     past a tile's end, a ragged d and a ragged f arrive as zeros from the
//     maps' bounds; the epilogue masks the store.  The grid runs the column
//     tiles of one row tile together, so x's chunk is read once, and adjacent
//     row tiles (sorted ids: the same expert) run together and share the
//     slab through L2.
//   wmma (other bf16 operands): K1's WMMA tile (csrc/gemm_tile.cuh), 64 x
//     128 a block, stepping d through shared memory, unpipelined.
//   simt (fp32): K1's SIMT tile, 64 x 64, never TF32.
#include "gemm_mainloop.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

constexpr int kBN = 128;      // K10: columns of C per block, one per thread (fp32)
constexpr int kKStep = 16;    // K10: WMMA depth

// K10 on the tensor cores.  A block is 4 warps, each 32 columns of the
// 128-column tile: one 8x32 fragment (BM 8) or two 16x16 fragments for each
// 16 rows (BM 16, 64).  TB: B is a transposed view, stored (N, K) with row
// stride ldb; its panel is kept n-major and read by column-major fragments.
template <int BM, int BK, bool TB, typename TOut>
__global__ void __launch_bounds__(128)
block_spmm_bf16_wmma(const bf16* __restrict__ blocks, const int* __restrict__ row_ptr,
                     const int* __restrict__ col_id, const bf16* __restrict__ B,
                     TOut* __restrict__ C, int N, int K, int ldb, bool vec) {
  static_assert(BM == 8 || BM == 16 || BM == 64, "block rows");
  static_assert(kKStep % BK == 0, "a k-step holds whole items");
  constexpr int IPS = kKStep / BK;            // items per k-step
  constexpr int FM = BM == 8 ? 8 : 16;        // fragment rows
  constexpr int MF = BM / FM;                 // fragments down the block row
  constexpr int FN = BM == 8 ? 32 : 16;       // fragment columns
  constexpr int NF = 32 / FN;                 // fragments across a warp's columns
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

  wmma::fragment<wmma::accumulator, FM, FN, 16, float> acc[MF][NF];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[i][f], 0.0f);

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
    wmma::fragment<wmma::matrix_a, FM, FN, 16, bf16, wmma::row_major> af[MF];
#pragma unroll
    for (int i = 0; i < MF; ++i) wmma::load_matrix_sync(af[i], &As[i * FM * AP], AP);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int nn = warp * 32 + f * FN;
      wmma::fragment<wmma::matrix_b, FM, FN, 16, bf16, LayoutB> bfr;
      wmma::load_matrix_sync(bfr, TB ? &Bs[nn * BP] : &Bs[nn], BP);
#pragma unroll
      for (int i = 0; i < MF; ++i) wmma::mma_sync(acc[i][f], af[i], bfr, acc[i][f]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f)
      wmma::store_matrix_sync(&Cs[i * FM * CP + warp * 32 + f * FN], acc[i][f], CP,
                              wmma::mem_row_major);
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

// K10 on the Hopper tensor cores (wgmma; csrc/gemm_mainloop.cuh's barrier
// waits), for a work list of 64-row blocks.
namespace spmm_wg {
constexpr int WG = 2;           // consumer warpgroups: 64 columns of C each
constexpr int BN = 64 * WG;     // columns of C a CTA (wgmma's M)
constexpr int BM = 64;          // rows of a block (wgmma's n)
constexpr int KS = 4;           // k16 steps a stage
constexpr int STAGES = 4;       // stages in the ring: two CTAs an SM

// Blocks of 64 rows by BK = 8 or 16.
template <int BK>
struct Cfg {
  static_assert(BK == 8 || BK == 16, "blocks");
  static constexpr int IPS = 16 / BK;            // items a k16 step
  static constexpr int ITEM = BM * BK * 2;       // one block's bytes
  static constexpr int B_STEP = BN * 16 * 2;     // B's 16 k by 128 columns
  static constexpr int A_STEP = 16 * BM * 2;     // the step's blocks
  static constexpr int STAGE = KS * (B_STEP + A_STEP);
  static constexpr int THREADS = 128 * WG + 32;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 16 * STAGES;
  static_assert(STAGE % 1024 == 0, "whole 1024-byte stages");
};

// wgmma's descriptor of B^T for the k16 step at `step` (warpgroup wg's 64
// columns): MN-major 64-column panels of 16 k-rows with the 128-byte
// swizzle (B (K, N)), or K-major (B stored (N, K): 32-byte swizzled rows of
// 16 k for 16-deep items, two unswizzled 8-k halves 2048 bytes apart).
template <int BK, bool TB>
__device__ __forceinline__ uint64_t b_desc(uint32_t step, int wg) {
  if constexpr (!TB) return hopper::desc(step + wg * 2048, 2048, 1024, 128);
  else if constexpr (BK == 16) return hopper::desc(step + wg * 64 * 32, 16, 256, 32);
  else return hopper::desc(step + wg * 64 * 16, 2048, 128, 16);
}
// ... of the step's blocks: a 16-deep item in 32-byte swizzled rows, or two
// 8-deep items as unswizzled core matrices (8 rows 128 bytes apart along N,
// the second item one block further along K).
template <int BK>
__device__ __forceinline__ uint64_t a_desc(uint32_t step) {
  if constexpr (BK == 16) return hopper::desc(step, 16, 256, 32);
  else return hopper::desc(step, BM * 16, 128, 16);
}

// C^T = B^T A^T: a CTA owns 128 columns of C (n0) and walks block rows r0
// .. r1 - 1 through one ring.
template <int BK, bool TB>
__global__ void __launch_bounds__(Cfg<BK>::THREADS, 2)
block_spmm_bf16_wgmma(const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap ta,
                      const bf16* __restrict__ blocks, const int* __restrict__ row_ptr,
                      const int* __restrict__ col_id, void* __restrict__ C, int out_bf16,
                      int nrows, int N, int K, int nnzb, int rows_per) {
  using G = Cfg<BK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t at = hopper::smem_u32(smem_raw);
  const uint32_t ring = (at + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * G::STAGE, empty = full + 8 * STAGES;
  const int n0 = blockIdx.y * BN, r0 = blockIdx.x * rows_per, r1 = min(nrows, r0 + rows_per);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, WG);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int wg = gemm_ml::warpgroup();
  if (wg == WG) {
    // one producer thread: a warp reading the work list 32 entries a load
    // was slower (PERF.md)
    if (threadIdx.x != 128 * WG) return;
    int it = 0;
    for (int r = r0; r < r1; ++r) {
      const int beg = row_ptr[r], end = row_ptr[r + 1];
      const int steps = (end - beg + G::IPS - 1) / G::IPS;
      for (int st = 0; st < steps; st += KS, ++it) {
        const int s = it % STAGES, ns = min(KS, steps - st);
        if (it >= STAGES) gemm_ml::wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
        const uint32_t bar = full + 8 * s, base = ring + s * G::STAGE;
        const uint32_t ablk = base + KS * G::B_STEP;
        // the stage's items: t0 .. t0 + items - 1 live, the rest of its
        // slots (an odd last item's pair) zeros
        const int t0 = beg + st * G::IPS, items = min(ns * G::IPS, end - t0);
        hopper::mbar_expect_tx(bar, ns * (G::B_STEP + G::A_STEP));
        if constexpr (BK == 8) {
          // 8-deep blocks are stacks of 128-byte core matrices, consecutive
          // in the work list: one bulk copy
          hopper::bulk_load(ablk, blocks + (size_t)t0 * BM * BK, items * G::ITEM, bar);
          if (items < ns * G::IPS)
            hopper::tma_load_4d(ablk + items * G::ITEM, &ta, bar, 0, nnzb * BM, 0, 0);
        }
        for (int j = 0; j < ns; ++j) {
          const uint32_t bdst = base + j * G::B_STEP, adst = ablk + j * G::A_STEP;
          for (int h = 0; h < G::IPS; ++h) {
            const int t = t0 + j * G::IPS + h;
            const bool live = t < end;
            const int k = live ? col_id[t] * BK : K;   // past K: zeros
            if constexpr (BK == 16)
              hopper::tma_load_4d(adst + h * G::ITEM, &ta, bar, 0, (live ? t : nnzb) * BM, 0, 0);
            if constexpr (TB) {
              hopper::tma_load_4d(bdst + h * 2048, &tb, bar, k, n0, 0, 0);
            } else {
#pragma unroll
              for (int w = 0; w < WG; ++w)
                hopper::tma_load_4d(bdst + w * 2048 + h * 1024, &tb, bar, n0 + 64 * w, k, 0, 0);
            }
          }
        }
      }
    }
    return;
  }
  float acc[BM / 2];
  int it = 0;
  for (int r = r0; r < r1; ++r) {
    // the same in every lane (a shuffle), so that the products' branches are
    // uniform to ptxas
    const int beg = __shfl_sync(0xffffffffu, row_ptr[r], 0);
    const int end = __shfl_sync(0xffffffffu, row_ptr[r + 1], 0);
    const int steps = (end - beg + G::IPS - 1) / G::IPS;
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.0f;
    for (int st = 0; st < steps; st += KS, ++it) {
      const int s = it % STAGES, ns = min(KS, steps - st);
      const uint32_t base = ring + s * G::STAGE;
      gemm_ml::wait(full + 8 * s, (it / STAGES) & 1);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < KS; ++j)
        if (j < ns)
          hopper::Wgmma<BM>::template ss<TB ? 0 : 1, 0>(
              acc, b_desc<BK, TB>(base + j * G::B_STEP, wg),
              a_desc<BK>(base + KS * G::B_STEP + j * G::A_STEP), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      gemm_ml::arrive_if(empty + 8 * s, threadIdx.x % 128 == 0);
    }
    // acc[i]: C's column n0 + 64 wg + acc_row(i) of the block row's row acc_col(i)
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      const int n = n0 + 64 * wg + gemm_ml::acc_row(i), m = r * BM + gemm_ml::acc_col(i);
      const size_t at = (size_t)m * N + n;
      if (n < N) {
        if (out_bf16) static_cast<bf16*>(C)[at] = __float2bfloat16(acc[i]);
        else static_cast<float*>(C)[at] = acc[i];
      }
    }
  }
}

// in (rows, cols) with row stride ld → out (cols, rows) with row stride
// ldo, through 32 x 32 tiles of shared memory.
__global__ void __launch_bounds__(256)
transpose_bf16(const bf16* __restrict__ in, int rows, int cols, int ld, bf16* __restrict__ out,
               int ldo) {
  __shared__ bf16 tile[32][34];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[i][threadIdx.x] = in[(size_t)r * ld + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (c < cols && r < rows) out[(size_t)c * ldo + r] = tile[threadIdx.x][i];
  }
}

// 2-D bf16 tensor maps as 4-D ones (unit outer extents): `cols` x `rows`,
// row stride `ld` elements, boxes of box_c x box_r, swizzled over `span`
// bytes (16: none).
inline cudaError_t map2d(CUtensorMap* map, const void* p, long long cols, long long rows,
                         long long ld, int box_c, int box_r, int span) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, 1, 1};
  const cuuint64_t strides[3] = {(cuuint64_t)ld * 2, 16, 16};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_r, 1, 1};
  return hopper::raw_map(map, p, 4, dims, strides, box, span);
}

template <int BK, bool TB>
cudaError_t launch(const bf16* blocks, const int* row_ptr, const int* col_id, const bf16* B,
                   void* C, int out_bf16, int nrows, int N, int K, int ldb, int nnzb, int rows_per,
                   cudaStream_t s) {
  using G = Cfg<BK>;
  CUtensorMap ta, tb;
  const int span = BK == 16 ? 32 : 16;
  cudaError_t e = map2d(&ta, blocks, BK, (long long)nnzb * BM, BK, BK, BM, span);
  if (e == cudaSuccess)
    e = TB ? map2d(&tb, B, K, N, ldb, BK, BN, span) : map2d(&tb, B, N, K, ldb, 64, BK, 128);
  if (e != cudaSuccess) return e;
  const auto kern = &block_spmm_bf16_wgmma<BK, TB>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((nrows + rows_per - 1) / rows_per, (N + BN - 1) / BN);
  kern<<<grid, G::THREADS, G::SMEM, s>>>(tb, ta, blocks, row_ptr, col_id, C, out_bf16, nrows, N,
                                         K, nnzb, rows_per);
  return cudaGetLastError();
}

// The kernels by block depth and B's layout (TB: stored (N, K)).
inline cudaError_t launch_shape(int bk, bool tb, const bf16* blocks, const int* row_ptr,
                                const int* col_id, const bf16* B, void* C, int out_bf16, int nrows,
                                int N, int K, int ldb, int nnzb, int rows_per, cudaStream_t s) {
  if (bk == 8 && !tb)
    return launch<8, false>(blocks, row_ptr, col_id, B, C, out_bf16, nrows, N, K, ldb, nnzb,
                            rows_per, s);
  if (bk == 16 && !tb)
    return launch<16, false>(blocks, row_ptr, col_id, B, C, out_bf16, nrows, N, K, ldb, nnzb,
                             rows_per, s);
  if (bk == 16 && tb)
    return launch<16, true>(blocks, row_ptr, col_id, B, C, out_bf16, nrows, N, K, ldb, nnzb,
                            rows_per, s);
  return cudaErrorInvalidValue;   // 8-deep blocks read B stored (N, K) from a (K, N) copy
}
}  // namespace spmm_wg

// K9 on csrc/gemm_mainloop.cuh: one consumer warpgroup (64 rows of a row
// tile) by 128 columns of out, a 4-stage ring: within 0.2 % of 256 x 3
// stages and 2 % faster than 128 x 3 on an H100 (PERF.md).
// kernels/block_spmm.py's GROUPED_TILE mirrors it and its wrapper checks it
// against grouped_tile() once.
namespace grouped_wg {
using Cfg = gemm_ml::Config<1, 128, 4, false, true>;

// K9's addressing: A is 64 rows of row tile t of x from row c0, B the
// expert g's slab from column n0; k-step it at d = 64 it.
struct Coords {
  int c0, n0, t, g;
  __device__ __forceinline__ void coords(int it, int& ar, int& ak, int& az, int& br, int& bk,
                                         int& bz, int& bz_hi) const {
    ar = c0, az = t, br = n0, bz = bz_hi = g, ak = bk = it * gemm_ml::BK;
  }
};

// out[at], and out[at + 1] when `two` (one vector store when `pair`: f even,
// so the pair is aligned).
__device__ __forceinline__ void store2(void* out, int out_bf16, size_t at, float x0, float x1,
                                       bool two, bool pair) {
  if (out_bf16) {
    bf16* o = static_cast<bf16*>(out) + at;
    if (two && pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x0, x1);
    } else {
      o[0] = __float2bfloat16(x0);
      if (two) o[1] = __float2bfloat16(x1);
    }
  } else {
    float* o = static_cast<float*>(out) + at;
    if (two && pair) {
      *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
    } else {
      o[0] = x0;
      if (two) o[1] = x1;
    }
  }
}

// One CTA of a per-row-tile product out (tiles·rows, N) = A_t (rows, K)
// times expert g's slab, on a C of one consumer warpgroup: A read K-major
// through `ta` (K, rows, tiles), the slab MN-major through `tb` (N, K, E).
// blockIdx: x the column tile, y the 64-row chunk of the row tile, z the
// row tile, so the column tiles of a row tile run together.
template <class C>
__device__ __forceinline__ void row_tile(const CUtensorMap* ta, const CUtensorMap* tb,
                                         const int* __restrict__ group_id, void* __restrict__ out,
                                         int out_bf16, int rows, int E, int K, int N) {
  static_assert(C::WG == 1, "one consumer warpgroup: 64 rows of a row tile");
  extern __shared__ unsigned char smem_raw[];
  const gemm_ml::Smem<C> sm(smem_raw);
  const int n0 = blockIdx.x * C::BN, c0 = blockIdx.y * 64, t = blockIdx.z;
  const int n = (K + gemm_ml::BK - 1) / gemm_ml::BK;
  gemm_ml::init<C>(sm);
  const int wg = gemm_ml::warpgroup();
  if (wg == C::WG) {
    const int g = min(max(group_id[t], 0), E - 1);
    gemm_ml::produce<C>(sm, ta, tb, Coords{c0, n0, t, g}, n);
    return;
  }
  float acc[C::BN / 2];
  gemm_ml::consume<C>(acc, sm, n, wg);
  // acc[i]: row c0 + acc_row(i) of row tile t, column n0 + acc_col(i)
  const size_t row0 = (size_t)t * rows;
  const bool pair = N % 2 == 0;
#pragma unroll
  for (int i = 0; i < C::BN / 2; i += 2) {
    const int r = c0 + gemm_ml::acc_row(i), c = n0 + gemm_ml::acc_col(i);
    if (r < rows && c < N)
      store2(out, out_bf16, (row0 + r) * N + c, acc[i], acc[i + 1], c + 1 < N, pair);
  }
}

__global__ void __launch_bounds__(Cfg::THREADS)
grouped_matmul_bf16_wgmma(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tw, const int* __restrict__ group_id,
                          void* __restrict__ out, int out_bf16, int rows, int E, int d, int f) {
  row_tile<Cfg>(&tx, &tw, group_id, out, out_bf16, rows, E, d, f);
}

cudaError_t launch(const bf16* x, const int* group_id, const bf16* w, void* out, int out_bf16,
                   int tiles, int rows, int E, int d, int f, cudaStream_t s) {
  CUtensorMap tx, tw;
  // x as (d, rows, tiles): a tile's rows past its end read as zeros
  cudaError_t e = hopper::tile_map(&tx, x, d, rows, tiles, 1, d, (long long)rows * d, 0,
                                   gemm_ml::BK, 64);
  // the experts as (f, d, E), in MN-major panels of 64 columns
  if (e == cudaSuccess)
    e = hopper::tile_map(&tw, w, f, d, E, 1, f, (long long)d * f, 0, Cfg::B::SW, gemm_ml::BK);
  if (e != cudaSuccess) return e;
  const auto kern = &grouped_matmul_bf16_wgmma;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((f + Cfg::BN - 1) / Cfg::BN, (rows + 63) / 64, tiles);
  kern<<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(tx, tw, group_id, out, out_bf16, rows, E, d, f);
  return cudaGetLastError();
}
}  // namespace grouped_wg

// K9's backward: the gradients of out = x_t w[g] for every row tile t,
//   dX_t = dY_t w[g]^T                  (T, d), in x's dtype;
//   dW[e] = sum over the tiles t of e, in tile order, of x_t^T dY_t
//                                        (E, d, f), fp32.
// No TPU kernel: the reference trains its MoE layer through jax.grad of
// repro/models/blocks.py:486 _expert_ffn's einsums, which these replace on
// the card, as K1's transposed reads carry a projection's backward.
//
// What bounds them on an H100: at qwen3-moe's training layer (4096 tokens,
// 128 experts' tiles of cap 320 rows, d 4096, f 1536) each is 515 GFLOP of
// bf16 products, 0.52 ms at the dense peak.  dX reads every expert's slab
// (1.61 GB), dY and writes dX: about 0.62 ms of HBM, so bytes bound it by a
// little; dW reads x and dY once (0.46 GB) and writes 3.22 GB of fp32
// slabs: about 1.10 ms, bound by its writes.
//
// What the design does about it: both run the GEMM mainloop of
// csrc/gemm_mainloop.cuh, every operand read in place through tensor maps
// (no transposed copy of w, x or dY) and zeros past every extent.
//   dX: what a CTA brings from L2 into shared memory for each product it
//     does holds it back, not HBM or the tensor cores: on the forward's 64
//     x 128 tile a k-step brings 24 KB for 0.5 M multiply-adds, 12 GB a
//     product at ~7.5 TB/s (PERF.md).  So the product is taken transposed,
//     dX_t^T = w[g] dY_t^T: wgmma's M runs along d, 256 rows a CTA (two
//     consumer warpgroups of two m64 blocks each, consume_blocks), A the
//     expert's slab read K-major where it lies (a map over w (f, d, E)),
//     and its N over 160 rows of the row tile (m64n160k16: two CTAs cover
//     a 320-row tile, no row wasted), B dY read K-major (a map over (f,
//     rows, tiles)); the k-steps walk f.  A k-step brings 52 KB for 2.6 M
//     multiply-adds: the slab is read twice and dY d / 256 times, about
//     5.2 GB a product.  One CTA an SM, a 4-stage ring.  The epilogue
//     stores the transpose: lanes l and l ^ 4 hold rows r and r + 1 of d
//     at the same two rows of the tile, trade one value, and each stores
//     two consecutive elements of a row of dX.
//   dW: a persistent grid, one CTA an SM, whose CTA c walks the units
//     (expert, 256-row tile of d, 128-column tile of f) c, c + grid, ...,
//     numbered with f fastest and the expert slowest, so that the CTAs
//     running at once share one expert's x and dY in L2 (DwCfg: two
//     consumer warpgroups of two m64 blocks each on m64n128k16, a 4-stage
//     ring of 48 KB stages; a 128 x 128 unit moved a third more bytes from
//     L2).  A is x read MN-major and B dY read MN-major, each through a map
//     over (width, rows, tiles), so the contraction runs over the rows of
//     each tile: ceil(rows / 64) k-steps a tile, rows past a tile's end
//     arriving as zeros.  For each unit the producer walks the expert's
//     tiles in tile order (DwCoords, from its first tile found by a
//     ballot) and the consumers sum every k-step into one fp32
//     accumulator, so the tiles of an expert may lie apart, their sum has
//     one order (each element's k16 steps as with a CTA a 128 x 128 tile:
//     the same bits), and no float atomics are used; an expert that owns
//     no tile runs no k-step and writes zeros.  The ring carries on from
//     one unit to the next, so the producer loads the next unit's k-steps
//     while the consumers finish this one, and the ring fills once a CTA.
//     Each warpgroup writes its 128 x 128 fp32 tile in parts of 64 x 32
//     (8 KB, the 128-byte swizzle, no bank conflicts) into two part
//     buffers in turn, one thread storing each part by TMA while the next
//     is written; the fp32 writes bound it at this shape.
//   wmma (bf16 operands TMA cannot read) and simt (fp32): the forward's
//     WMMA and SIMT tiles for dX (the slab read as a stored (N, K)
//     matrix), and tiles of their shape for dW that step the same tile
//     walk through shared memory, unpipelined.
// kernels/block_spmm.py's GROUPED_DX_TILE and GROUPED_DW_TILE mirror the
// two configs, and its wrappers check them against grouped_bwd_tile() once.
namespace grouped_bwd {
using DxCfg = gemm_ml::Config<2, 160, 4, false, false, 2>;
using DwCfg = gemm_ml::Config<2, 128, 4, true, true, 2>;

// Both kernels run one CTA an SM with the producer warp in a warpgroup of
// its own, so that the warpgroup can give its registers to the consumers'
// accumulators (setmaxnreg): the launch gives each of the 384 threads 168;
// the producers keep 40, the consumers take 232.
constexpr int THREADS = 128 * 3;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(DxCfg::WG == 2 && DwCfg::WG == 2, "two consumer warpgroups and the producer's");

// dW's staging: each consumer warpgroup writes its two m64 blocks of fp32
// out in parts of 64 rows by 32 columns (128-byte rows in the 128-byte
// swizzle), one TMA store each, through DW_BUFS part buffers in turn, so
// that a part is written while the last one's store reads.  The shared
// memory: 1024 bytes to align the ring, the ring, 1024 bytes that hold its
// barriers and keep the staging 1024-byte aligned, and the part buffers of
// each consumer warpgroup.
constexpr int DW_PART_COLS = 32;
constexpr int DW_BUFS = 2;
constexpr int DW_PART_BYTES = 64 * DW_PART_COLS * 4;
constexpr int DW_PARTS = DwCfg::BN / DW_PART_COLS;
constexpr int DW_STAGING = DW_BUFS * DW_PART_BYTES;
constexpr int DW_SMEM = 1024 + DwCfg::STAGES * DwCfg::STAGE_BYTES + 1024 + DwCfg::WG * DW_STAGING;
static_assert(16 * DwCfg::STAGES + 16 <= 1024, "the barriers fit before the staging");
static_assert(DW_SMEM <= 232448, "a CTA's shared memory");

// dX's addressing: A the expert g's slab at rows m0 of d, B dY's rows n0
// of row tile t; k-step it at f = 64 it.
struct DxCoords {
  int m0, n0, t, g;
  __device__ __forceinline__ void coords(int it, int& ar, int& ak, int& az, int& br, int& bk,
                                         int& bz, int& bz_hi) const {
    ar = m0, az = g, br = n0, bz = bz_hi = t, ak = bk = it * gemm_ml::BK;
  }
};

// blockIdx: x the 256-row tile of d, y the 160-row part of the row tile,
// z the row tile.
__global__ void __launch_bounds__(THREADS, 1)
grouped_matmul_dx_bf16_wgmma(const __grid_constant__ CUtensorMap tw,
                             const __grid_constant__ CUtensorMap tdy,
                             const int* __restrict__ group_id, void* __restrict__ dx,
                             int out_bf16, int rows, int E, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  const gemm_ml::Smem<DxCfg> sm(smem_raw);
  const int m0 = blockIdx.x * DxCfg::BM, n0 = blockIdx.y * DxCfg::BN, t = blockIdx.z;
  const int n = (f + gemm_ml::BK - 1) / gemm_ml::BK;
  gemm_ml::init<DxCfg>(sm);
  const int wg = gemm_ml::warpgroup();
  if (wg == DxCfg::WG) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    const int g = min(max(group_id[t], 0), E - 1);
    gemm_ml::produce<DxCfg>(sm, &tw, &tdy, DxCoords{m0, n0, t, g}, n);
    return;
  }
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int r0 = m0 + 64 * DxCfg::MB * wg;
  float acc[DxCfg::MB][DxCfg::BN / 2];
  gemm_ml::consume_blocks<DxCfg>(acc, sm, n, wg);
  // acc[j][i]: row r0 + 64 j + acc_row(i) of d, row n0 + acc_col(i) of
  // tile t (acc[j][i + 1] the next row of the tile).  Lane l holds an even
  // row r of d, lane l ^ 4 (l & 4 set) r + 1; the even lane sends its
  // next-tile-row value and takes the odd lane's this-tile-row one, so the
  // even lane stores dX[c][r, r + 1] and the odd one dX[c + 1][r, r + 1].
  const bool odd = threadIdx.x & 4;
  const size_t row0 = (size_t)t * rows;
#pragma unroll
  for (int j = 0; j < DxCfg::MB; ++j)
#pragma unroll
    for (int i = 0; i < DxCfg::BN / 2; i += 2) {
      const float got = __shfl_xor_sync(0xffffffffu, odd ? acc[j][i] : acc[j][i + 1], 4);
      const int r = r0 + 64 * j + gemm_ml::acc_row(i) - odd, c = n0 + gemm_ml::acc_col(i) + odd;
      if (c < rows && r < d)
        grouped_wg::store2(dx, out_bf16, (row0 + c) * d + r, odd ? got : acc[j][i],
                           odd ? acc[j][i + 1] : got, true, true);
    }
}

// The number of row tiles of expert e (ids clamped into [0, E)), the same
// value in every thread: a warp's sum, broadcast from lane 0 so that the
// k-step loops it bounds are not divergent paths to ptxas (C7518).
__device__ __forceinline__ int owned_tiles(const int* __restrict__ group_id, int tiles, int E,
                                           int e) {
  int c = 0;
  for (int t = threadIdx.x % 32; t < tiles; t += 32) c += min(max(group_id[t], 0), E - 1) == e;
#pragma unroll
  for (int s = 16; s > 0; s /= 2) c += __shfl_xor_sync(0xffffffffu, c, s);
  return __shfl_sync(0xffffffffu, c, 0);
}

// The first row tile of expert e (ids clamped into [0, E)), or `tiles` if
// it owns none: a ballot over a warp's 32 tiles at a time, the same value
// in every lane (one scan of the ids a unit, not one load a tile in one
// thread while the ring drains).
__device__ __forceinline__ int first_tile(const int* __restrict__ group_id, int tiles, int E,
                                          int e) {
  for (int t0 = 0; t0 < tiles; t0 += 32) {
    const int t = t0 + threadIdx.x % 32;
    const unsigned hit =
        __ballot_sync(0xffffffffu, t < tiles && min(max(group_id[t], 0), E - 1) == e);
    if (hit) return t0 + __ffs(hit) - 1;
  }
  return tiles;
}

// dW's addressing: k-step it covers rows [64 (it % kpt), + 64) of the
// (it / kpt)-th tile of expert e in tile order; A is x's box there at d
// m0, B dY's at f n0.  The producer asks for it = 0, 1, ... in order, so
// the walk keeps its tile and steps to the expert's next one, from the
// tile before its first.
struct DwCoords {
  const int* group_id;
  int E, e, kpt, m0, n0;
  mutable int tile;  // before the walk: the tile before the expert's first
  __device__ __forceinline__ void coords(int it, int& ar, int& ak, int& az, int& br, int& bk,
                                         int& bz, int& bz_hi) const {
    const int s = it % kpt;
    if (s == 0) {
      do {
        ++tile;
      } while (min(max(group_id[tile], 0), E - 1) != e);
    }
    ar = m0, br = n0, ak = bk = s * gemm_ml::BK, az = bz = bz_hi = tile;
  }
};

// Unit u of dW: expert e, rows [m0, + DwCfg::BM) of d, columns [n0, +
// DwCfg::BN) of f; nd and nf the tiles of d and f, f fastest.
struct DwUnit {
  int e, m0, n0;
  __device__ __forceinline__ DwUnit(int u, int nd, int nf) {
    e = u / (nd * nf);
    const int r = u - e * nd * nf;
    m0 = r / nf * DwCfg::BM;
    n0 = r % nf * DwCfg::BN;
  }
};

// The 128 threads of consumer warpgroup wg (named barrier 1 + wg).
__device__ __forceinline__ void sync_warpgroup(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ void st_shared2(uint32_t at, float x0, float x1) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at), "f"(x0), "f"(x1) : "memory");
}

// The persistent grid (gridDim.x CTAs, from the plan) over E · nd · nf
// units; tdw maps dW (f, d, E) fp32 in boxes of 32 columns by 64 rows.
// Only the producer warp of the producer warpgroup stays: the ids' scans
// (owned_tiles, first_tile) take its 32 lanes, the loads its lane 0.
__global__ void __launch_bounds__(THREADS, 1)
grouped_matmul_dw_bf16_wgmma(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tdy,
                             const __grid_constant__ CUtensorMap tdw,
                             const int* __restrict__ group_id, int tiles, int rows, int E, int d,
                             int f) {
  extern __shared__ unsigned char smem_raw[];
  const gemm_ml::Smem<DwCfg> sm(smem_raw);
  const int kpt = (rows + gemm_ml::BK - 1) / gemm_ml::BK;
  const int nd = (d + DwCfg::BM - 1) / DwCfg::BM, nf = (f + DwCfg::BN - 1) / DwCfg::BN;
  const int units = E * nd * nf;
  gemm_ml::init<DwCfg>(sm);
  const int wg = gemm_ml::warpgroup();
  int it = 0;  // the ring step of the unit's first k-step
  if (wg == DwCfg::WG) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 128 * DwCfg::WG + 32) return;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const DwUnit at(u, nd, nf);
      const int n = owned_tiles(group_id, tiles, E, at.e) * kpt;
      const int first = first_tile(group_id, tiles, E, at.e);
      gemm_ml::produce<DwCfg>(sm, &tx, &tdy,
                              DwCoords{group_id, E, at.e, kpt, at.m0, at.n0, first - 1}, n, it);
      it += n;
    }
    return;
  }
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const uint32_t staging = sm.ring + DwCfg::STAGES * DwCfg::STAGE_BYTES + 1024 + wg * DW_STAGING;
  const bool lead = threadIdx.x % 128 == 0;
  int part = 0;  // the parts this warpgroup has stored, for its buffers' turn
  float acc[DwCfg::MB][DwCfg::BN / 2];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const DwUnit at(u, nd, nf);
    const int n = owned_tiles(group_id, tiles, E, at.e) * kpt;
    gemm_ml::consume_blocks<DwCfg>(acc, sm, n, wg, it, true);
    it += n;
    // acc[j][i]: row acc_row(i) of block j's 64, column acc_col(i): in part
    // c / 32, its 16-byte chunk (c % 32) / 4 xor the row's low 3 bits
#pragma unroll
    for (int j = 0; j < DwCfg::MB; ++j)
#pragma unroll
      for (int p = 0; p < DW_PARTS; ++p) {
        const uint32_t buf = staging + ((part + j * DW_PARTS + p) % DW_BUFS) * DW_PART_BYTES;
        // the buffer is free once the stores of its last part have read it
        if (lead) hopper::bulk_wait_read<DW_BUFS - 1>();
        sync_warpgroup(wg);
#pragma unroll
        for (int q = 0; q < DW_PART_COLS / 2; q += 2) {
          const int i = p * DW_PART_COLS / 2 + q;
          const int r = gemm_ml::acc_row(i), c = gemm_ml::acc_col(i) % DW_PART_COLS;
          st_shared2(buf + r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2)),
                     acc[j][i], acc[j][i + 1]);
        }
        hopper::fence_async_smem();
        sync_warpgroup(wg);
        if (lead) {
          hopper::tma_store_3d(&tdw, buf, at.n0 + p * DW_PART_COLS,
                               at.m0 + 64 * (DwCfg::MB * wg + j), at.e);
          hopper::bulk_commit();
        }
      }
    part += DwCfg::MB * DW_PARTS;
  }
  if (lead) hopper::bulk_wait<0>();
}

template <class Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaError_t launch_dx(const bf16* dy, const int* group_id, const bf16* w, void* dx, int out_bf16,
                      int tiles, int rows, int E, int d, int f, cudaStream_t s) {
  CUtensorMap tw, tdy;
  // the experts as (f, d, E), K-major: boxes of 64 f by 256 rows of d
  cudaError_t e = hopper::tile_map(&tw, w, f, d, E, 1, f, (long long)d * f, 0, gemm_ml::BK,
                                   DxCfg::BM);
  // dY as (f, rows, tiles), K-major, boxes of 64 f by 160 rows: a tile's
  // rows past its end read as zeros
  if (e == cudaSuccess)
    e = hopper::tile_map(&tdy, dy, f, rows, tiles, 1, f, (long long)rows * f, 0, gemm_ml::BK,
                         DxCfg::BN);
  if (e != cudaSuccess) return e;
  static const cudaError_t attr = allow_smem(&grouped_matmul_dx_bf16_wgmma, DxCfg::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((d + DxCfg::BM - 1) / DxCfg::BM, (rows + DxCfg::BN - 1) / DxCfg::BN, tiles);
  grouped_matmul_dx_bf16_wgmma<<<grid, THREADS, DxCfg::SMEM, s>>>(tw, tdy, group_id, dx,
                                                                   out_bf16, rows, E, d, f);
  return cudaGetLastError();
}

cudaError_t launch_dw(const bf16* x, const int* group_id, const bf16* dy, float* dw, int tiles,
                      int rows, int E, int d, int f, int ctas, cudaStream_t s) {
  CUtensorMap tx, tdy, tdw;
  // x as (d, rows, tiles) and dY as (f, rows, tiles), MN-major: panels of
  // 64 columns by 64 rows of a tile, zeros past its end
  cudaError_t e = hopper::tile_map(&tx, x, d, rows, tiles, 1, d, (long long)rows * d, 0,
                                   DwCfg::A::SW, gemm_ml::BK);
  if (e == cudaSuccess)
    e = hopper::tile_map(&tdy, dy, f, rows, tiles, 1, f, (long long)rows * f, 0, DwCfg::B::SW,
                         gemm_ml::BK);
  // dW as (f, d, E) fp32, stored in boxes of 32 columns by 64 rows in the
  // 128-byte swizzle; nothing past d or f is written
  const cuuint64_t dims[3] = {(cuuint64_t)f, (cuuint64_t)d, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)f * 4, (cuuint64_t)d * f * 4};
  const cuuint32_t box[3] = {DW_PART_COLS, 64, 1};
  if (e == cudaSuccess)
    e = hopper::raw_map(&tdw, dw, 3, dims, strides, box, 128, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e != cudaSuccess) return e;
  static const cudaError_t attr = allow_smem(&grouped_matmul_dw_bf16_wgmma, DW_SMEM);
  if (attr != cudaSuccess) return attr;
  if (ctas < 1) return cudaErrorInvalidConfiguration;
  grouped_matmul_dw_bf16_wgmma<<<ctas, THREADS, DW_SMEM, s>>>(tx, tdy, tdw, group_id, tiles, rows,
                                                              E, d, f);
  return cudaGetLastError();
}
}  // namespace grouped_bwd

// K9 on wmma, for bf16 operands TMA cannot read (a base not 16-byte
// aligned, d or f not a multiple of 8), so with scalar loads.  blockIdx: x
// the column tile, y the row tile, z the 64-row chunk of it; the tile's rows
// past its end are masked by the mainloop (M = rows).
template <typename TOut>
__global__ void __launch_bounds__(256)
grouped_matmul_bf16_wmma(const bf16* __restrict__ x, const int* __restrict__ group_id,
                         const bf16* __restrict__ w, TOut* __restrict__ out, int rows, int E,
                         int d, int f) {
  const int g = min(max(group_id[blockIdx.y], 0), E - 1);
  const size_t row0 = (size_t)blockIdx.y * rows;
  bf16_wmma_tile<64, 128, 2, 4, false, false>(x + row0 * d, w + (size_t)g * d * f,
                                              static_cast<const bf16*>(nullptr), out + row0 * f,
                                              rows, f, d, d, f, ACT_NONE, false, blockIdx.z * 64,
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

// K9's dX on wmma (bf16 operands TMA cannot read) and simt (fp32): the
// forward's tiles with the expert's slab (d, f) read as a stored (N, K)
// matrix.  blockIdx: x the column tile of d, y the row tile, z the 64-row
// chunk of it.
template <typename TOut>
__global__ void __launch_bounds__(256)
grouped_matmul_dx_bf16_wmma(const bf16* __restrict__ dy, const int* __restrict__ group_id,
                            const bf16* __restrict__ w, TOut* __restrict__ dx, int rows, int E,
                            int d, int f) {
  const int g = min(max(group_id[blockIdx.y], 0), E - 1);
  const size_t row0 = (size_t)blockIdx.y * rows;
  bf16_wmma_tile<64, 128, 2, 4, false, true>(dy + row0 * f, w + (size_t)g * d * f,
                                             static_cast<const bf16*>(nullptr), dx + row0 * d,
                                             rows, d, f, f, f, ACT_NONE, false, blockIdx.z * 64,
                                             blockIdx.x * 128);
}

template <typename TOut>
__global__ void __launch_bounds__(256)
grouped_matmul_dx_f32_simt(const float* __restrict__ dy, const int* __restrict__ group_id,
                           const float* __restrict__ w, TOut* __restrict__ dx, int rows, int E,
                           int d, int f) {
  const int g = min(max(group_id[blockIdx.y], 0), E - 1);
  const size_t row0 = (size_t)blockIdx.y * rows;
  f32_simt_tile<false, true>(dy + row0 * f, w + (size_t)g * d * f,
                             static_cast<const float*>(nullptr), dx + row0 * d, rows, d, f, f, f,
                             ACT_NONE, blockIdx.z * 64, blockIdx.x * 64);
}

// K9's dW on wmma: the (64 x 128) tile at (m0 along d, n0 along f) of
// expert e's slab, 8 warps of 32 x 32, over the expert's tiles in tile
// order and each tile's rows 32 at a time through shared memory (scalar
// loads, zeros past the tile's rows, d and f).  blockIdx: x the column
// tile of f, y the row tile of d, z the expert.
__global__ void __launch_bounds__(256)
grouped_matmul_dw_bf16_wmma(const bf16* __restrict__ x, const int* __restrict__ group_id,
                            const bf16* __restrict__ dy, float* __restrict__ dw, int tiles,
                            int rows, int E, int d, int f) {
  constexpr int BM = 64, BN = 128, BK = 32, AP = BM + 8, BP = BN + 8;
  __shared__ __align__(128) bf16 As[BK * AP];   // x^T's tile, k-major
  __shared__ __align__(128) bf16 Bs[BK * BP];
  __shared__ __align__(128) float Cs[8][16 * 16];
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wm = warp / 4, wn = warp % 4;
  const bf16 zero = __float2bfloat16(0.0f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int t = 0; t < tiles; ++t) {
    if (min(max(group_id[t], 0), E - 1) != e) continue;
    const bf16* xt = x + (size_t)t * rows * d;
    const bf16* yt = dy + (size_t)t * rows * f;
    for (int k0 = 0; k0 < rows; k0 += BK) {
      for (int i = threadIdx.x; i < BK * BM; i += 256) {
        const int r = i / BM, c = i % BM;
        As[r * AP + c] = k0 + r < rows && m0 + c < d ? xt[(size_t)(k0 + r) * d + m0 + c] : zero;
      }
      for (int i = threadIdx.x; i < BK * BN; i += 256) {
        const int r = i / BN, c = i % BN;
        Bs[r * BP + c] = k0 + r < rows && n0 + c < f ? yt[(size_t)(k0 + r) * f + n0 + c] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], &As[kk * AP + wm * 32 + i * 16], AP);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bfr[j], &Bs[kk * BP + wn * 32 + j * 16], BP);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  float* cs = Cs[warp];
  float* out = dw + (size_t)e * d * f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int q = lane; q < 256; q += 32) {
        const int gm = m0 + wm * 32 + i * 16 + q / 16, gn = n0 + wn * 32 + j * 16 + q % 16;
        if (gm < d && gn < f) out[(size_t)gm * f + gn] = cs[q];
      }
      __syncwarp();
    }
}

// K9's dW in fp32 FMA (never TF32): the 64 x 64 tile at (m0, n0) of expert
// e's slab, 256 threads of 4 x 4, the same tile walk 16 rows at a time.
__global__ void __launch_bounds__(256)
grouped_matmul_dw_f32_simt(const float* __restrict__ x, const int* __restrict__ group_id,
                           const float* __restrict__ dy, float* __restrict__ dw, int tiles,
                           int rows, int E, int d, int f) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int t = 0; t < tiles; ++t) {
    if (min(max(group_id[t], 0), E - 1) != e) continue;
    const float* xt = x + (size_t)t * rows * d;
    const float* yt = dy + (size_t)t * rows * f;
    for (int k0 = 0; k0 < rows; k0 += BK) {
      for (int i = threadIdx.x; i < BK * BM; i += 256) {
        const int r = i / BM, c = i % BM;
        As[r][c] = k0 + r < rows && m0 + c < d ? xt[(size_t)(k0 + r) * d + m0 + c] : 0.0f;
        Bs[r][c] = k0 + r < rows && n0 + c < f ? yt[(size_t)(k0 + r) * f + n0 + c] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  float* out = dw + (size_t)e * d * f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < d && gn < f) out[(size_t)gm * f + gn] = acc[i][j];
    }
}

}  // namespace

// K10.  blocks (nnzb, bm, bk) contiguous, bf16 if in_bf16 else fp32, of
// 8x8, 16x16, 64x8 or 64x16; row_ptr (nrows + 1) and col_id (nnzb) int32
// on the device; B (K, N) of the blocks' dtype, stored (K, N) with row
// stride ldb, or (N, K) if trans_b, unit stride along its rows either way;
// C (nrows·bm, N) contiguous, bf16 if out_bf16 else fp32.  variant 1: wgmma
// (bf16, 64-row blocks, nnzb > 0; B's base and row stride and the blocks'
// base 16-byte aligned), rows_per block rows a CTA, with for 64x8 blocks
// against B stored (N, K) a (K, N rounded up to 8) bf16 workspace the
// kernel transposes B into.  0: wmma (bf16) or simt (fp32).  vec: B's
// stored rows start 16-byte aligned (wmma's vector loads).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// block shape or variant it has no kernel for.
extern "C" int block_spmm(const void* blocks, const void* row_ptr, const void* col_id,
                          const void* b, void* c, int in_bf16, int out_bf16, int nrows, int bm,
                          int bk, int N, int K, int ldb, int trans_b, int vec, int variant,
                          int nnzb, int rows_per, void* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ci = static_cast<const int*>(col_id);
  const bool v = vec != 0;
  if (variant == 1) {
    if (!in_bf16 || bm != spmm_wg::BM || (bk != 8 && bk != 16) || nnzb < 1 || rows_per < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const bf16* Bm = static_cast<const bf16*>(b);
    if (bk == 8 && trans_b) {
      // TMA would gather the 8 k of each column as a 16-byte row of its own
      // (a box's rows, not its bytes, bound it): read a (K, N) copy instead
      if (workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      bf16* t = static_cast<bf16*>(workspace);
      const int ldt = (N + 7) / 8 * 8;   // 16-byte rows, as TMA reads them
      spmm_wg::transpose_bf16<<<dim3((K + 31) / 32, (N + 31) / 32), dim3(32, 8), 0, s>>>(
          Bm, N, K, ldb, t, ldt);
      Bm = t;
      ldb = ldt;
      trans_b = 0;
    }
    return static_cast<int>(spmm_wg::launch_shape(bk, trans_b != 0,
                                                  static_cast<const bf16*>(blocks), rp, ci, Bm, c,
                                                  out_bf16, nrows, N, K, ldb, nnzb, rows_per, s));
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 8 && bk == 8)
    dispatch_spmm<8, 8>(blocks, rp, ci, b, c, in_bf16, out_bf16, nrows, N, K, ldb, trans_b, v, s);
  else if (bm == 16 && bk == 16)
    dispatch_spmm<16, 16>(blocks, rp, ci, b, c, in_bf16, out_bf16, nrows, N, K, ldb, trans_b, v,
                          s);
  else if (bm == 64 && bk == 8)
    dispatch_spmm<64, 8>(blocks, rp, ci, b, c, in_bf16, out_bf16, nrows, N, K, ldb, trans_b, v, s);
  else if (bm == 64 && bk == 16)
    dispatch_spmm<64, 16>(blocks, rp, ci, b, c, in_bf16, out_bf16, nrows, N, K, ldb, trans_b, v,
                          s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K9.  x (tiles·rows, d) and w (E, d, f) contiguous, bf16 if in_bf16 else
// fp32; group_id (tiles) int32 on the device, clamped into [0, E); out
// (tiles·rows, f) contiguous, bf16 if out_bf16 else fp32.  variant 1: wgmma
// (bf16, d and f multiples of 8, x's and w's bases 16-byte aligned); 0:
// wmma (other bf16) or simt (fp32).  Returns cudaGetLastError() after the
// launch.
extern "C" int grouped_matmul(const void* x, const void* group_id, const void* w, void* out,
                              int in_bf16, int out_bf16, int tiles, int rows, int E, int d,
                              int f, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gid = static_cast<const int*>(group_id);
  if (variant == 1) {
    if (!in_bf16 || d % 8 || f % 8)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    return static_cast<int>(grouped_wg::launch(static_cast<const bf16*>(x), gid,
                                               static_cast<const bf16*>(w), out, out_bf16, tiles,
                                               rows, E, d, f, s));
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (rows + 63) / 64;
  if (in_bf16) {
    dim3 grid((f + 127) / 128, tiles, chunks);
    const bf16* X = static_cast<const bf16*>(x);
    const bf16* W = static_cast<const bf16*>(w);
    if (out_bf16)
      grouped_matmul_bf16_wmma<<<grid, 256, 0, s>>>(X, gid, W, static_cast<bf16*>(out), rows, E,
                                                    d, f);
    else
      grouped_matmul_bf16_wmma<<<grid, 256, 0, s>>>(X, gid, W, static_cast<float*>(out), rows, E,
                                                    d, f);
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

// K9's wgmma tile (columns of out a CTA, ring stages), for the wrapper's
// check of its plan.
extern "C" int grouped_tile(int* out) {
  out[0] = grouped_wg::Cfg::BN;
  out[1] = grouped_wg::Cfg::STAGES;
  return 0;
}

// K9's dX: dy (tiles·rows, f) and w (E, d, f) contiguous, bf16 if in_bf16
// else fp32; group_id (tiles) int32 on the device, clamped into [0, E); dx
// (tiles·rows, d) contiguous, bf16 if out_bf16 else fp32.  variant 1:
// wgmma (bf16, d and f multiples of 8, dy's and w's bases 16-byte
// aligned); 0: wmma (other bf16) or simt (fp32).  Returns
// cudaGetLastError() after the launch.
extern "C" int grouped_matmul_dx(const void* dy, const void* group_id, const void* w, void* dx,
                                 int in_bf16, int out_bf16, int tiles, int rows, int E, int d,
                                 int f, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gid = static_cast<const int*>(group_id);
  if (variant == 1) {
    if (!in_bf16 || d % 8 || f % 8) return static_cast<int>(cudaErrorInvalidConfiguration);
    return static_cast<int>(grouped_bwd::launch_dx(static_cast<const bf16*>(dy), gid,
                                                   static_cast<const bf16*>(w), dx, out_bf16,
                                                   tiles, rows, E, d, f, s));
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (rows + 63) / 64;
  if (in_bf16) {
    const dim3 grid((d + 127) / 128, tiles, chunks);
    const bf16* Y = static_cast<const bf16*>(dy);
    const bf16* W = static_cast<const bf16*>(w);
    if (out_bf16)
      grouped_matmul_dx_bf16_wmma<<<grid, 256, 0, s>>>(Y, gid, W, static_cast<bf16*>(dx), rows, E,
                                                       d, f);
    else
      grouped_matmul_dx_bf16_wmma<<<grid, 256, 0, s>>>(Y, gid, W, static_cast<float*>(dx), rows,
                                                       E, d, f);
  } else {
    const dim3 grid((d + 63) / 64, tiles, chunks);
    const float* Y = static_cast<const float*>(dy);
    const float* W = static_cast<const float*>(w);
    if (out_bf16)
      grouped_matmul_dx_f32_simt<<<grid, 256, 0, s>>>(Y, gid, W, static_cast<bf16*>(dx), rows, E,
                                                      d, f);
    else
      grouped_matmul_dx_f32_simt<<<grid, 256, 0, s>>>(Y, gid, W, static_cast<float*>(dx), rows, E,
                                                      d, f);
  }
  return static_cast<int>(cudaGetLastError());
}

// K9's dW: x (tiles·rows, d) and dy (tiles·rows, f) contiguous, bf16 if
// in_bf16 else fp32; group_id (tiles) int32 on the device, clamped into
// [0, E); dw (E, d, f) fp32 contiguous, every element written (zeros for an
// expert that owns no tile).  variant 1: wgmma (bf16, d and f multiples of
// 8, x's, dy's and dw's bases 16-byte aligned) on a persistent grid of
// `ctas` CTAs; 0: wmma (other bf16) or simt (fp32), `ctas` unread.
// Returns cudaGetLastError() after the launch.
extern "C" int grouped_matmul_dw(const void* x, const void* group_id, const void* dy, void* dw,
                                 int in_bf16, int tiles, int rows, int E, int d, int f,
                                 int variant, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gid = static_cast<const int*>(group_id);
  float* out = static_cast<float*>(dw);
  if (variant == 1) {
    if (!in_bf16 || d % 8 || f % 8) return static_cast<int>(cudaErrorInvalidConfiguration);
    return static_cast<int>(grouped_bwd::launch_dw(static_cast<const bf16*>(x), gid,
                                                   static_cast<const bf16*>(dy), out, tiles, rows,
                                                   E, d, f, ctas, s));
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (in_bf16) {
    const dim3 grid((f + 127) / 128, (d + 63) / 64, E);
    grouped_matmul_dw_bf16_wmma<<<grid, 256, 0, s>>>(static_cast<const bf16*>(x), gid,
                                                     static_cast<const bf16*>(dy), out, tiles,
                                                     rows, E, d, f);
  } else {
    const dim3 grid((f + 63) / 64, (d + 63) / 64, E);
    grouped_matmul_dw_f32_simt<<<grid, 256, 0, s>>>(static_cast<const float*>(x), gid,
                                                    static_cast<const float*>(dy), out, tiles,
                                                    rows, E, d, f);
  }
  return static_cast<int>(cudaGetLastError());
}

// K9's backward wgmma tiles, for the wrappers' check of their plans: dX's
// (rows of d, rows of a row tile, ring stages), then dW's (rows of d,
// columns of f, ring stages).
extern "C" int grouped_bwd_tile(int* out) {
  out[0] = grouped_bwd::DxCfg::BM;
  out[1] = grouped_bwd::DxCfg::BN;
  out[2] = grouped_bwd::DxCfg::STAGES;
  out[3] = grouped_bwd::DwCfg::BM;
  out[4] = grouped_bwd::DwCfg::BN;
  out[5] = grouped_bwd::DwCfg::STAGES;
  return 0;
}
