// K5: the fused-TppGraph kernel template.  kernels/fused_gemm.py generates
// one source per simplified graph, which includes this file, defines a
// struct `Epi` (the graph's roots and its epilogue DAG as straight-line fp32
// C++) and the C entry point `fused_gemm` as `fg::entry<Epi>`, which
// instantiates the kernels below on it.
//
// Replaces the TPU kernel repro/fusion/lowering.py:330 `_compile_pallas`
// (launched through repro/core/pallas_lowering.py `make_pallas_fn`) for
// graphs whose contraction roots are base roots (no chained root, no
// transposed operand) and whose epilogue nodes are pointwise: R <= 3 GEMMs
// C_r[M, N_r] = A_l(r)[M, K] @ B_r[K, N_r] sharing one (M, K) problem, each
// with an fp32 accumulator, and the epilogue DAG applied to the
// accumulators before anything is written.  Several outputs stack on a
// leading axis, (NOUT, M, N); a root narrower than N (GQA's k/v in
// fused_qkv) computes only its own columns and its stack slice is zero past
// its width.
//
// What bounds it on an H100: at prefill (M = 2048 against llama2-13b's
// 5120 x 13824 gate and up weights) tensor-core operations; at decode
// (M <= 16) one pass over the R weight matrices, HBM bytes.  Fusing saves
// bytes only: the lhs is read once per K step for all roots (not once per
// root), the roots' accumulators never go to device memory, and the output
// is written once in the out dtype.
//
// What the design does about it: K1's mainloop (csrc/gemm.cu) with R
// accumulators.  bf16 inputs run WMMA 16x16x16 fragments on the tensor
// cores: BM x BN = 128 x 128 tiles for one root, 128 x 64 for two or three
// (so the R accumulators stay in registers), and 16 x 64 for M <= 16 (the
// grid spreads over N; a row's sums do not depend on M there, so a decoded
// row is the same at any batch of up to 16 rows).  Each K step copies the
// distinct lhs tiles to shared memory once and the R rhs tiles beside them,
// with 16-byte loads where aligned; ragged M, N and K are zero-filled.  At
// the end of K each warp stages its fragments through shared memory (the
// operand tiles' space, reused) and each lane evaluates the generated
// epilogue per element: rowvec operands read at the column, tile and mask
// operands at (row, column), all in fp32, each output cast once.  fp32
// inputs run K1's SIMT mainloop (64 x 64 tiles, full fp32 FMA, no TF32).
// Loads are not pipelined (no cp.async, TMA or wgmma): left for the PR that
// makes K1 and K5 fast.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#define FG_MAX_ROOTS 3
#define FG_MAX_EP 8

typedef __nv_bfloat16 fg_bf16;

// Operand pointers and leading dimensions (elements).  lhs[l] for the
// graph's distinct lhs operands, rhs[r] per root; ep[i] the epilogue
// operands in canonical order with their dtype (0 fp32, 1 bf16, 2 bool).
struct FusedArgs {
  const void* lhs[FG_MAX_ROOTS];
  const void* rhs[FG_MAX_ROOTS];
  const void* ep[FG_MAX_EP];
  void* out;
  long long lda[FG_MAX_ROOTS];
  long long ldb[FG_MAX_ROOTS];
  long long ld_ep[FG_MAX_EP];
  int ep_dtype[FG_MAX_EP];
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

// An epilogue operand element as fp32 (dtype 0 fp32, 1 bf16), or a mask
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(fg_bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ fg_bf16 from_float<fg_bf16>(float x) {
  return __float2bfloat16(x);
}

// Run the generated epilogue at (gm, gn) on the R accumulator values and
// store every output.
template <class E, typename TOut>
__device__ __forceinline__ void finish(const float* acc, int gm, int gn, int M, int N,
                                       const FusedArgs& a) {
  float out[E::NOUT];
  E::apply(acc, gm, gn, a, out);
  TOut* o = static_cast<TOut*>(a.out);
#pragma unroll
  for (int q = 0; q < E::NOUT; ++q)
    o[((long long)q * M + gm) * N + gn] = from_float<TOut>(out[q]);
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

template <int BM, int BN, int WARPS_M, int WARPS_N>
struct Bf16Tiles {
  static constexpr int BK = 32;
  static constexpr int NT = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int FM = WM / 16, FN = WN / 16;
  // Rows padded by 8 elements: 16-byte aligned, fewer bank conflicts.
  static constexpr int AP = BK + 8, BP = BN + 8;
  static constexpr int A_ELEMS = BM * AP, B_ELEMS = BK * BP;
};

// bf16 x bf16 -> fp32 on the tensor cores, R roots on one (M, K, N) tile.
template <class E, int BM, int BN, int WARPS_M, int WARPS_N, typename TOut>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
fused_gemm_bf16_wmma(FusedArgs a, int M, int N, int K, int w0, int w1, int w2, bool vec) {
  using T = Bf16Tiles<BM, BN, WARPS_M, WARPS_N>;
  constexpr int R = E::R, NL = E::NLHS, BK = T::BK, NT = T::NT;
  static_assert(T::WM % 16 == 0 && T::WN % 16 == 0, "warp tile must be whole fragments");
  constexpr int STAGE_BYTES = (NL * T::A_ELEMS + R * T::B_ELEMS) * 2;
  constexpr int EPI_BYTES = WARPS_M * WARPS_N * R * 256 * 4;
  __shared__ __align__(128) unsigned char smem[STAGE_BYTES > EPI_BYTES ? STAGE_BYTES : EPI_BYTES];
  fg_bf16* As = reinterpret_cast<fg_bf16*>(smem);
  fg_bf16* Bs = As + NL * T::A_ELEMS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int width[3] = {w0, w1, w2};
  bool live[R];   // a narrow root's tiles past its width stay zero
#pragma unroll
  for (int r = 0; r < R; ++r) live[r] = n0 < width[r];

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
      const fg_bf16* A = static_cast<const fg_bf16*>(a.lhs[l]);
      for (int i = threadIdx.x; i < BM * BK / 8; i += NT) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        load8(&As[l * T::A_ELEMS + r * T::AP + c], A, m0 + r, k0 + c, M, K, a.lda[l], vec);
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!live[q]) continue;
      const fg_bf16* B = static_cast<const fg_bf16*>(a.rhs[q]);
      for (int i = threadIdx.x; i < BK * BN / 8; i += NT) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        load8(&Bs[q * T::B_ELEMS + r * T::BP + c], B, k0 + r, n0 + c, K, width[q], a.ldb[q],
              vec);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, fg_bf16, wmma::row_major> af[NL][T::FM];
#pragma unroll
      for (int l = 0; l < NL; ++l)
#pragma unroll
        for (int i = 0; i < T::FM; ++i)
          wmma::load_matrix_sync(af[l][i],
                                 &As[l * T::A_ELEMS + (wm * T::WM + i * 16) * T::AP + kk], T::AP);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (!live[q]) continue;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, fg_bf16, wmma::row_major> bfr[T::FN];
#pragma unroll
        for (int j = 0; j < T::FN; ++j)
          wmma::load_matrix_sync(bfr[j], &Bs[q * T::B_ELEMS + kk * T::BP + wn * T::WN + j * 16],
                                 T::BP);
#pragma unroll
        for (int i = 0; i < T::FM; ++i)
#pragma unroll
          for (int j = 0; j < T::FN; ++j)
            wmma::mma_sync(acc[q][i][j], af[E::lhs_of(q)][i], bfr[j], acc[q][i][j]);
      }
    }
    __syncthreads();
  }

  // Epilogue: each warp stages one fragment position of every root in its
  // R x 16 x 16 slice of shared memory, then each lane runs the generated
  // epilogue on its elements and stores every output.
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
          finish<E, TOut>(v, gm, gn, M, N, a);
        }
      }
      __syncwarp();
    }
}

// fp32 x fp32 -> fp32 in FMA (no TF32): a 64 x 64 tile with 256 threads,
// each a 4 x 4 micro-tile per root strided by 16.
template <class E, typename TOut>
__global__ void __launch_bounds__(256)
fused_gemm_f32_simt(FusedArgs a, int M, int N, int K, int w0, int w1, int w2) {
  constexpr int R = E::R, NL = E::NLHS, BM = 64, BN = 64, BK = 16, NT = 256;
  __shared__ float As[NL][BK][BM + 4];  // A tiles stored k-major
  __shared__ float Bs[R][BK][BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int width[3] = {w0, w1, w2};
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) live[r] = n0 < width[r];
  float acc[R][4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const float* A = static_cast<const float*>(a.lhs[l]);
      for (int i = threadIdx.x; i < BM * BK; i += NT) {
        const int r = i / BK, c = i % BK, gm = m0 + r, gk = k0 + c;
        As[l][c][r] = (gm < M && gk < K) ? A[gm * a.lda[l] + gk] : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!live[q]) continue;
      const float* B = static_cast<const float*>(a.rhs[q]);
      for (int i = threadIdx.x; i < BK * BN; i += NT) {
        const int r = i / BN, c = i % BN, gk = k0 + r, gn = n0 + c;
        Bs[q][r][c] = (gk < K && gn < width[q]) ? B[gk * a.ldb[q] + gn] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (!live[q]) continue;
        float x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = As[E::lhs_of(q)][kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = Bs[q][kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[q][i][j] = fmaf(x[i], y[j], acc[q][i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        float v[R];
#pragma unroll
        for (int q = 0; q < R; ++q) v[q] = acc[q][i][j];
        finish<E, TOut>(v, gm, gn, M, N, a);
      }
    }
}

template <class E, int BM, int BN, int WARPS_M, int WARPS_N, typename TOut>
void launch_bf16(const FusedArgs& a, int M, int N, int K, const int* w, bool vec,
                 cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_gemm_bf16_wmma<E, BM, BN, WARPS_M, WARPS_N, TOut>
      <<<grid, WARPS_M * WARPS_N * 32, 0, s>>>(a, M, N, K, w[0], w[1], w[2], vec);
}

template <class E, typename TOut>
void dispatch_bf16(const FusedArgs& a, int M, int N, int K, const int* w, bool vec,
                   cudaStream_t s) {
  if (M <= 16)
    launch_bf16<E, 16, 64, 1, 4, TOut>(a, M, N, K, w, vec, s);
  else if (E::R == 1)
    launch_bf16<E, 128, 128, 2, 4, TOut>(a, M, N, K, w, vec, s);
  else
    launch_bf16<E, 128, 64, 4, 2, TOut>(a, M, N, K, w, vec, s);
}

template <class E, typename TOut>
void dispatch_f32(const FusedArgs& a, int M, int N, int K, const int* w, cudaStream_t s) {
  dim3 grid((N + 63) / 64, (M + 63) / 64);
  fused_gemm_f32_simt<E, TOut><<<grid, 256, 0, s>>>(a, M, N, K, w[0], w[1], w[2]);
}

// The body of the C entry point every generated source defines:
//   extern "C" int fused_gemm(const FusedArgs* args, int M, int N, int K,
//       int R, int w0, int w1, int w2, int in_bf16, int out_bf16, int vec,
//       void* stream)
// M, N (the widest root), K; R must be the graph's root count; widths per
// root (<= N, unused ones 0); the lhs and rhs bf16 if in_bf16 else fp32;
// the (NOUT, M, N) contiguous output bf16 if out_bf16 else fp32; vec: every
// lhs and rhs row starts 16-byte aligned.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for an R that is not the graph's.
template <class E>
int entry(const FusedArgs* args, int M, int N, int K, int R, int w0, int w1, int w2,
          int in_bf16, int out_bf16, int vec, void* stream) {
  if (R != E::R) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w[3] = {w0, w1, w2};
  if (in_bf16) {
    if (out_bf16)
      dispatch_bf16<E, fg_bf16>(*args, M, N, K, w, vec != 0, s);
    else
      dispatch_bf16<E, float>(*args, M, N, K, w, vec != 0, s);
  } else {
    if (out_bf16)
      dispatch_f32<E, fg_bf16>(*args, M, N, K, w, s);
    else
      dispatch_f32<E, float>(*args, M, N, K, w, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fg
