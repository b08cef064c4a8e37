// K1: GEMM with a fused bias + activation epilogue,
//     C[M,N] = act(A[M,K] @ B[K,N] + bias), fp32 accumulator, cast at the end.
//
// Replaces the TPU kernel repro/kernels/brgemm.py::matmul_pallas (launched
// through repro/core/pallas_lowering.py::make_pallas_fn) under its default
// schedule DEFAULT_SPEC = "bca": output-stationary, K innermost, the
// accumulator zeroed before the first K step, bias then activation applied
// once after the last one.
//
// What bounds it on an H100: at prefill (M = B*S = 2048 rows against
// 5120x5120, 5120x13824 or 13824x5120 weights) the work is far above the
// card's ~295 flop/byte ridge in bf16, so tensor-core operations bound it; at
// decode (M = 4) it is one pass over the weight matrix, bound by HBM bytes.
//
// What the design does about it: bf16 inputs run on the tensor cores through
// WMMA 16x16x16 fragments (mma.sync) with fp32 accumulators, 128x128 output
// tiles per block for large M; for M <= 16 a block holds a 16-row by 64-column
// tile, so the grid spreads over N and every weight tile is read once with
// 16-byte loads.  fp32 inputs (the reduced test configs) run a SIMT kernel in
// full fp32 FMA, never TF32.  Ragged M, N and K edges are zero-filled on load
// and masked on store.  Loads are not pipelined (no cp.async, TMA or wgmma)
// and K is not split: that is left for the PR that makes this kernel fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

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
// of 16x16 fragments; K advances 32 at a time through shared memory.
template <int BM, int BN, int WARPS_M, int WARPS_N, typename TOut>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
gemm_bf16_wmma(const bf16* __restrict__ A, const bf16* __restrict__ B,
               const bf16* __restrict__ bias, TOut* __restrict__ C, int M, int N, int K,
               int lda, int ldb, int act, bool vec) {
  constexpr int BK = 32;
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  // Rows padded by 8 elements: still 16-byte aligned for vector stores and
  // 32-byte aligned fragment pointers, with fewer bank conflicts.
  constexpr int AP = BK + 8, BP = BN + 8;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile must be whole fragments");
  __shared__ __align__(128) bf16 As[BM * AP];
  __shared__ __align__(128) bf16 Bs[BK * BP];
  __shared__ __align__(128) float Cs[WARPS_M * WARPS_N][16 * 16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK / 8; i += NT) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      load8(&As[r * AP + c], A, m0 + r, k0 + c, M, K, lda, vec);
    }
    for (int i = threadIdx.x; i < BK * BN / 8; i += NT) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      load8(&Bs[r * BP + c], B, k0 + r, n0 + c, K, N, ldb, vec);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], &As[(wm * WM + i * 16) * AP + kk], AP);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfr[j], &Bs[kk * BP + wn * WN + j * 16], BP);
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
// conflict.
template <typename TOut>
__global__ void __launch_bounds__(256)
gemm_f32_simt(const float* __restrict__ A, const float* __restrict__ B,
              const float* __restrict__ bias, TOut* __restrict__ C, int M, int N, int K,
              int lda, int ldb, int act) {
  constexpr int BM = 64, BN = 64, BK = 16, NT = 256;
  __shared__ float As[BK][BM + 4];  // A tile stored k-major
  __shared__ float Bs[BK][BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * lda + gk] : 0.0f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? B[(size_t)gk * ldb + gn] : 0.0f;
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

template <typename TOut>
void launch_bf16(const bf16* A, const bf16* B, const bf16* bias, TOut* C, int M, int N, int K,
                 int lda, int ldb, int act, bool vec, cudaStream_t s) {
  if (M <= 16) {
    dim3 grid((N + 63) / 64, (M + 15) / 16);
    gemm_bf16_wmma<16, 64, 1, 4, TOut><<<grid, 128, 0, s>>>(A, B, bias, C, M, N, K, lda, ldb,
                                                            act, vec);
  } else {
    dim3 grid((N + 127) / 128, (M + 127) / 128);
    gemm_bf16_wmma<128, 128, 2, 4, TOut><<<grid, 256, 0, s>>>(A, B, bias, C, M, N, K, lda,
                                                              ldb, act, vec);
  }
}

template <typename TOut>
void launch_f32(const float* A, const float* B, const float* bias, TOut* C, int M, int N,
                int K, int lda, int ldb, int act, cudaStream_t s) {
  dim3 grid((N + 63) / 64, (M + 63) / 64);
  gemm_f32_simt<TOut><<<grid, 256, 0, s>>>(A, B, bias, C, M, N, K, lda, ldb, act);
}

}  // namespace

// A (M,K) with row stride lda, B (K,N) with row stride ldb, both unit column
// stride and of one dtype (bf16 if in_bf16, else fp32); bias (N,) of that
// dtype or null; C (M,N) contiguous, bf16 if out_bf16 else fp32.  vec: rows of
// A and B start 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int gemm(const void* a, const void* b, const void* bias, void* c, int in_bf16,
                    int out_bf16, int M, int N, int K, int lda, int ldb, int act, int vec,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    const bf16* A = static_cast<const bf16*>(a);
    const bf16* B = static_cast<const bf16*>(b);
    const bf16* bs = static_cast<const bf16*>(bias);
    if (out_bf16)
      launch_bf16(A, B, bs, static_cast<bf16*>(c), M, N, K, lda, ldb, act, vec != 0, s);
    else
      launch_bf16(A, B, bs, static_cast<float*>(c), M, N, K, lda, ldb, act, vec != 0, s);
  } else {
    const float* A = static_cast<const float*>(a);
    const float* B = static_cast<const float*>(b);
    const float* bs = static_cast<const float*>(bias);
    if (out_bf16)
      launch_f32(A, B, bs, static_cast<bf16*>(c), M, N, K, lda, ldb, act, s);
    else
      launch_f32(A, B, bs, static_cast<float*>(c), M, N, K, lda, ldb, act, s);
  }
  return static_cast<int>(cudaGetLastError());
}
