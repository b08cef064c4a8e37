// Device building blocks of K1's GEMM, shared by csrc/gemm.cu (K1) and
// csrc/block_spmm.cu (K9, which runs K1's mainloop on each row tile's
// expert): the epilogue TPPs, the vector tile loader, and the two tile
// mainloops (bf16 on the tensor cores through WMMA, fp32 in SIMT FMA).
// Each mainloop computes the output tile at (m0, n0) that its caller
// names, so a kernel may map blocks to tiles as it likes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace gemm_tile {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3, ACT_SIGMOID = 4 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// The epilogue TPPs of repro/core/tpp.py, on the fp32 accumulator.
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(x, 0.0f);
    case ACT_GELU: {  // tanh approximation
      const float t = tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x));
      return 0.5f * x * (1.0f + t);
    }
    case ACT_SILU: return x * (1.0f / (1.0f + expf(-x)));
    case ACT_SIGMOID: return 1.0f / (1.0f + expf(-x));
    default: return x;
  }
}

template <typename TIn, typename TOut>
__device__ __forceinline__ void store_out(TOut* C, const TIn* bias, float x, int gm, int gn,
                                          int ldc, int act) {
  if (bias != nullptr) x += to_float(bias[gn]);
  C[(size_t)gm * ldc + gn] = from_float<TOut>(activate(x, act));
}

// Copy the 8 bf16 at (r, c..c+7) of a rows x cols matrix with leading
// dimension ld into shared memory, zero-filling what lies outside it.
__device__ __forceinline__ void load8(bf16* dst, const bf16* src, int r, int c, int rows,
                                      int cols, int ld, bool vec) {
  if (vec && r < rows && c + 8 <= cols) {
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      dst[t] = (r < rows && c + t < cols) ? src[(size_t)r * ld + c + t] : __float2bfloat16(0.0f);
  }
}

// bf16 x bf16 -> fp32 on the tensor cores.  A block computes a BM x BN tile
// of C with WARPS_M x WARPS_N warps, each a (BM/WARPS_M) x (BN/WARPS_N) tile
// of 16x16 fragments; K advances 32 at a time through shared memory.  TA: A
// is stored (K,M), its tile kept k-major and read by column-major fragments;
// TB: B is stored (N,K), likewise.  Every row of C is summed in the same
// order whatever M is, so a row does not depend on the rows beside it.
template <int BM, int BN, int WARPS_M, int WARPS_N, bool TA, bool TB, typename TOut>
__device__ __forceinline__ void bf16_wmma_tile(const bf16* __restrict__ A,
                                               const bf16* __restrict__ B,
                                               const bf16* __restrict__ bias,
                                               TOut* __restrict__ C, int M, int N, int K,
                                               int lda, int ldb, int act, bool vec, int m0,
                                               int n0) {
  constexpr int BK = 32;
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  // Rows padded by 8 elements: still 16-byte aligned for vector stores and
  // 32-byte aligned fragment pointers, with fewer bank conflicts.
  constexpr int AP = TA ? BM + 8 : BK + 8;   // A tile: BM x AP, or BK x AP if TA
  constexpr int BP = TB ? BK + 8 : BN + 8;   // B tile: BK x BP, or BN x BP if TB
  using LayoutA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile must be whole fragments");
  __shared__ __align__(128) bf16 As[(TA ? BK : BM) * AP];
  __shared__ __align__(128) bf16 Bs[(TB ? BN : BK) * BP];
  __shared__ __align__(128) float Cs[WARPS_M * WARPS_N][16 * 16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (TA) {  // stored (K, M): vectors along M
      for (int i = threadIdx.x; i < BK * BM / 8; i += NT) {
        const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
        load8(&As[r * AP + c], A, k0 + r, m0 + c, K, M, lda, vec);
      }
    } else {   // stored (M, K): vectors along K
      for (int i = threadIdx.x; i < BM * BK / 8; i += NT) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        load8(&As[r * AP + c], A, m0 + r, k0 + c, M, K, lda, vec);
      }
    }
    if (TB) {  // stored (N, K): vectors along K
      for (int i = threadIdx.x; i < BN * BK / 8; i += NT) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        load8(&Bs[r * BP + c], B, n0 + r, k0 + c, N, K, ldb, vec);
      }
    } else {   // stored (K, N): vectors along N
      for (int i = threadIdx.x; i < BK * BN / 8; i += NT) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        load8(&Bs[r * BP + c], B, k0 + r, n0 + c, K, N, ldb, vec);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int mm = wm * WM + i * 16;
        wmma::load_matrix_sync(af[i], TA ? &As[kk * AP + mm] : &As[mm * AP + kk], AP);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int nn = wn * WN + j * 16;
        wmma::load_matrix_sync(bfr[j], TB ? &Bs[nn * BP + kk] : &Bs[kk * BP + nn], BP);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: each fragment goes through this warp's 16x16 staging tile,
  // then bias, activation, cast and a masked store.
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * WM + i * 16 + e / 16;
        const int gn = n0 + wn * WN + j * 16 + e % 16;
        if (gm < M && gn < N) store_out(C, bias, cs[e], gm, gn, N, act);
      }
      __syncwarp();
    }
}

// fp32 x fp32 -> fp32 in FMA (no TF32).  A block computes a 64x64 tile with
// 256 threads, each a 4x4 micro-tile strided by 16 so shared reads do not
// conflict.  TA / TB as in the bf16 kernel; the fill walks the stored
// layout's contiguous axis fastest, so neighbouring threads read neighbouring
// addresses either way.
template <bool TA, bool TB, typename TOut>
__device__ __forceinline__ void f32_simt_tile(const float* __restrict__ A,
                                              const float* __restrict__ B,
                                              const float* __restrict__ bias,
                                              TOut* __restrict__ C, int M, int N, int K,
                                              int lda, int ldb, int act, int m0, int n0) {
  constexpr int BM = 64, BN = 64, BK = 16, NT = 256;
  __shared__ float As[BK][BM + 4];  // A tile stored k-major
  __shared__ float Bs[BK][BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int r = TA ? i % BM : i / BK, c = TA ? i / BM : i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[TA ? (size_t)gk * lda + gm : (size_t)gm * lda + gk]
                                    : 0.0f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += NT) {
      const int r = TB ? i % BK : i / BN, c = TB ? i / BK : i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? B[TB ? (size_t)gn * ldb + gk : (size_t)gk * ldb + gn]
                                    : 0.0f;
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
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) store_out(C, bias, acc[i][j], gm, gn, N, act);
    }
}

}  // namespace gemm_tile
