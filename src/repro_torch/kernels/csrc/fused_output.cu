// K7: the fused Bert-Output / Bert-SelfOutput layer (paper Listing 6),
//   y = layernorm(dropout(x @ w + bias) + residual) * gamma + beta,
// x (M, K), w (K, N), residual (M, N) of one dtype (bf16 or fp32); bias,
// gamma, beta (N,) fp32; dropout by the caller's keep mask (M, N) at a scale
// of 1 / (1 - rate), or none; layernorm over N with its eps; y (M, N).
//
// Replaces repro/kernels/fused_output.py::fused_output_pallas.  The TPU kernel
// runs the grid (M/bm, N/bn, K/bk) in order and keeps a (bm, N) fp32 row
// panel and a (bm, 2) strip of sums in VMEM, normalising the panel at the
// last N tile.
//
// What bounds it on an H100: at bert-large's layers (M 4096 tokens, N 1024)
// the product does 2·M·N·K operations against the bytes of x, w,
// residual, mask and y read or written once: at K 4096 (Bert-Output) the
// bf16 tensor-core rate bounds it, at K 1024 (Bert-SelfOutput) the bytes,
// within 10 % of the operations.  The epilogue is what fusion saves: the
// (M, N) fp32 sum never goes to device memory between the product,
// dropout, the residual and the two passes of the layernorm.
//
// What the design does about it: nothing carries between blocks, so one
// block of 256 threads owns 32 rows and all N.  It computes the row block's
// 128-column tiles one after another (bf16: WMMA 16x16x16 fragments, 8
// warps as 2 x 4 of 16 x 32; fp32: SIMT FMA, 4 x 4 outputs a thread, never
// TF32), K stepping 32 (bf16) or 16 (fp32) deep through shared memory,
// and stores each finished tile into the row panel, where bias, dropout and
// residual are applied in place.  When every tile is in, each warp takes 4
// rows: the mean, then the variance about it (two passes over the panel,
// as the plain version computes it), then normalises and writes each
// output element once.  The panel lives in shared memory when 32 rows of
// N fp32 fit beside the tiles (N <= 1664: bert-large's 1024 takes 129 KB);
// for wider N it is an fp32 scratch in device memory that the wrapper
// allocates, read back from L2 (as K5's row panel, csrc/fused_gemm.cuh).
// Loads are not pipelined, and 128 row blocks at M 4096 fill 128 of the
// 132 SMs once: that is left for the PR that makes this kernel fast.
#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

constexpr int kBM = 32, kBN = 128, kThreads = 256;
constexpr int kBKh = 32, kBKf = 16;                       // K steps: bf16, fp32
constexpr int kAPh = kBKh + 8, kBPh = kBN + 8;            // bf16 tiles' padded rows
constexpr int kAPf = kBM + 4, kBPf = kBN + 4;             // fp32 tiles' padded rows
constexpr int kTileBytes = 11264;                         // the larger of the two pairs
static_assert((kBM * kAPh + kBKh * kBPh) * 2 <= kTileBytes, "bf16 tiles");
static_assert((kBKf * kAPf + kBKf * kBPf) * 4 <= kTileBytes, "fp32 tiles");

// One 32 x 128 tile of x @ w at (m0, n0) into panel columns n0.. (ldp).
__device__ __forceinline__ void tile_product(const bf16* __restrict__ x,
                                             const bf16* __restrict__ w, float* panel, int ldp,
                                             unsigned char* tiles, int M, int N, int K, int m0,
                                             int n0, bool vec) {
  bf16* As = reinterpret_cast<bf16*>(tiles);
  bf16* Bs = As + kBM * kAPh;
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int k0 = 0; k0 < K; k0 += kBKh) {
    for (int i = threadIdx.x; i < kBM * kBKh / 8; i += kThreads) {
      const int r = i / (kBKh / 8), c = (i % (kBKh / 8)) * 8;
      load8(&As[r * kAPh + c], x, m0 + r, k0 + c, M, K, K, vec);
    }
    for (int i = threadIdx.x; i < kBKh * kBN / 8; i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      load8(&Bs[r * kBPh + c], w, k0 + r, n0 + c, K, N, N, vec);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBKh; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, &As[wm * 16 * kAPh + kk], kAPh);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, &Bs[kk * kBPh + wn * 32 + f * 16], kBPh);
        wmma::mma_sync(acc[f], af, bfr, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(&panel[(size_t)wm * 16 * ldp + n0 + wn * 32 + f * 16], acc[f], ldp,
                            wmma::mem_row_major);
}

__device__ __forceinline__ void tile_product(const float* __restrict__ x,
                                             const float* __restrict__ w, float* panel, int ldp,
                                             unsigned char* tiles, int M, int N, int K, int m0,
                                             int n0, bool) {
  float* As = reinterpret_cast<float*>(tiles);     // k-major: As[k][row]
  float* Bs = As + kBKf * kAPf;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBKf) {
    for (int i = threadIdx.x; i < kBM * kBKf; i += kThreads) {
      const int r = i / kBKf, c = i % kBKf;
      As[c * kAPf + r] = (m0 + r < M && k0 + c < K) ? x[(size_t)(m0 + r) * K + k0 + c] : 0.0f;
    }
    for (int i = threadIdx.x; i < kBKf * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      Bs[r * kBPf + c] = (k0 + r < K && n0 + c < N) ? w[(size_t)(k0 + r) * N + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBKf; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * kAPf + ty + 8 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * kBPf + tx + 32 * j];
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
    for (int j = 0; j < 4; ++j) panel[(size_t)(ty + 8 * i) * ldp + n0 + tx + 32 * j] = acc[i][j];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// scratch: null for a shared-memory panel, else the (ceil(M/32)·32, ldp)
// fp32 panels of every row block in device memory.
template <typename T, typename TOut>
__global__ void __launch_bounds__(kThreads)
fused_output_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, const T* __restrict__ residual,
                    const uint8_t* __restrict__ keep, const float* __restrict__ gamma,
                    const float* __restrict__ beta, TOut* __restrict__ out,
                    float* __restrict__ scratch, int M, int N, int K, int ldp, float scale,
                    float eps, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * kBM;
  float* panel = scratch != nullptr ? scratch + (size_t)m0 * ldp
                                    : reinterpret_cast<float*>(smem + kTileBytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kRows = kBM / (kThreads / 32);             // rows a warp finishes

  for (int n0 = 0; n0 < N; n0 += kBN) {
    tile_product(x, w, panel, ldp, smem, M, N, K, m0, n0, vec);
    __syncthreads();
    // bias, dropout, residual on the tile, in place
    for (int rr = 0; rr < kRows; ++rr) {
      const int row = warp * kRows + rr, gm = m0 + row;
      if (gm >= M) break;
      for (int c = lane; c < kBN && n0 + c < N; c += 32) {
        const int gn = n0 + c;
        const size_t e = (size_t)gm * N + gn;
        float v = panel[(size_t)row * ldp + gn] + bias[gn];
        if (keep != nullptr) v = keep[e] ? v * scale : 0.0f;
        panel[(size_t)row * ldp + gn] = v + to_float(residual[e]);
      }
    }
    __syncthreads();
  }

  for (int rr = 0; rr < kRows; ++rr) {
    const int row = warp * kRows + rr, gm = m0 + row;
    if (gm >= M) break;
    const float* p = panel + (size_t)row * ldp;
    float s = 0.0f;
    for (int c = lane; c < N; c += 32) s += p[c];
    const float mu = warp_sum(s) / N;
    float q = 0.0f;
    for (int c = lane; c < N; c += 32) {
      const float dv = p[c] - mu;
      q += dv * dv;
    }
    const float rstd = rsqrtf(warp_sum(q) / N + eps);
    for (int c = lane; c < N; c += 32)
      out[(size_t)gm * N + c] = from_float<TOut>((p[c] - mu) * rstd * gamma[c] + beta[c]);
  }
}

template <typename T, typename TOut>
int launch(const void* x, const void* w, const float* bias, const void* residual,
           const uint8_t* keep, const float* gamma, const float* beta, void* out, float* scratch,
           int M, int N, int K, float scale, float eps, bool vec, cudaStream_t s) {
  const int np = (N + kBN - 1) / kBN * kBN;
  const int ldp = scratch != nullptr ? np : np + 4;
  const size_t smem = kTileBytes + (scratch != nullptr ? 0 : (size_t)kBM * ldp * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(fused_output_kernel<T, TOut>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + kBM - 1) / kBM);
  fused_output_kernel<T, TOut><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<const T*>(residual),
      keep, gamma, beta, static_cast<TOut*>(out), scratch, M, N, K, ldp, scale, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest N whose 32-row fp32 panel the kernel keeps in shared memory;
// a wider N needs the scratch.
extern "C" int fused_output_smem_max_n() {
  return ((232448 - kTileBytes) / (kBM * 4) - 4) / kBN * kBN;
}

// x (M, K), w (K, N), residual (M, N) contiguous, bf16 if in_bf16 else
// fp32; bias, gamma, beta (N,) fp32; keep (M, N) bytes (nonzero = kept) or
// null for no dropout; out (M, N) contiguous, bf16 if out_bf16 else fp32;
// scratch null when N <= fused_output_smem_max_n(), else (ceil(M/32)·32,
// ceil(N/128)·128) fp32.  vec: x's and w's rows start 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_output(const void* x, const void* w, const void* bias, const void* residual,
                            const void* keep, const void* gamma, const void* beta, void* out,
                            void* scratch, int in_bf16, int out_bf16, int M, int N, int K,
                            float scale, float eps, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const uint8_t* k = static_cast<const uint8_t*>(keep);
  float* sc = static_cast<float*>(scratch);
  const bool v = vec != 0;
  if (in_bf16)
    return out_bf16 ? launch<bf16, bf16>(x, w, b, residual, k, g, be, out, sc, M, N, K, scale, eps, v, s)
                    : launch<bf16, float>(x, w, b, residual, k, g, be, out, sc, M, N, K, scale, eps, v, s);
  return out_bf16 ? launch<float, bf16>(x, w, b, residual, k, g, be, out, sc, M, N, K, scale, eps, v, s)
                  : launch<float, float>(x, w, b, residual, k, g, be, out, sc, M, N, K, scale, eps, v, s);
}
