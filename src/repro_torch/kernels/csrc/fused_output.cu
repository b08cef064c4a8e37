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
// What the design does about it: three variants, which the wrapper's plan
// (kernels/fused_output.py fused_output_plan) names and the C entry launches
// or refuses (no fallback).
//   wgmma (bf16 operands TMA can read, N a multiple of 128 that a cluster
//     holds): the product on csrc/gemm_mainloop.cuh (a producer warp filling
//     a TMA ring, WG consumer warpgroups of 64 rows on wgmma; x read K-major,
//     w (K, N) MN-major with wgmma's transpose bit, nothing copied), and the
//     layernorm closed across a thread-block cluster instead of a row panel.
//     A cluster of CL <= 8 CTAs along N owns a band of 64 WG rows; CTA rank r
//     owns NT 128-column tiles from column 128 NT r.  Each tile's residual
//     (bf16) and keep-mask (bytes) boxes come by TMA through the ring
//     itself, as the ring steps after the tile's k-steps, so they load
//     while its last k-steps run (128-byte swizzle: the accumulator layout
//     reads them without bank conflicts); the consumers add bias, apply the
//     keep mask at the scale and add the residual in their accumulator
//     registers.  The layernorm: each thread sums its rows' values in a
//     fixed order, four lanes a row close the CTA's partial in a fixed tree,
//     the partial goes to shared memory, and after a cluster barrier every
//     CTA reads the CL partials of its rows in rank order from its peers'
//     shared memory (mapa / ld.shared::cluster) and takes the mean; a second
//     exchange does the same for the sum of (v - mean)^2 (two passes, as the
//     plain version), which gives rstd; each CTA then normalises its values
//     and stores y once.  With one tile a CTA (N <= 1024: two warpgroups,
//     two CTAs an SM, 3 stages) the values never leave the registers; with
//     several (one warpgroup, 4 stages) each finished tile but the last
//     waits in shared memory as fp32 (at N 5120 four of five 64 x 128 tiles:
//     128 KB beside a ring of 4 x 24 KB stages).  A CTA leaves only after a
//     last cluster barrier, so no peer reads the shared memory of a CTA that
//     exited.  Every row is reduced in the same order whatever M is or where
//     the row lies, so the same inputs give the same bits.  8-CTA clusters
//     schedule whole: 15 at once on an H100 at one CTA an SM, 30 at two, so
//     M 4096's 256 CTAs run as 30 clusters and then 2.  A TMA multicast of
//     x across the cluster measured slower and is not used (PERF.md).
//   wmma (bf16 operands TMA cannot read, or a width no cluster holds): one
//     block of 256 threads owns 32 rows and all N.  It computes the row
//     block's 128-column tiles one after another (WMMA 16x16x16 fragments, 8
//     warps as 2 x 4 of 16 x 32, K stepping 32 deep through shared memory,
//     unpipelined) and stores each finished tile into the row panel, where
//     bias, dropout and residual are applied in place.  When every tile is
//     in, each warp takes 4 rows: the mean, then the variance about it, then
//     normalises and writes each output element once.  The panel lives in
//     shared memory when 32 rows of N fp32 fit beside the tiles (N <= 1664);
//     for wider N it is an fp32 scratch in device memory that the wrapper
//     allocates, read back from L2.
//   simt (fp32): the same kernel on SIMT FMA, 4 x 4 outputs a thread, K
//     stepping 16 deep, never TF32.
#include <cuda.h>

#include "gemm_mainloop.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

enum Variant { V_WMMA = 0, V_WGMMA = 1, V_SIMT = 2 };

// ---------------------------------------------------------------------------
// wmma and simt: a block owns 32 rows and all N
// ---------------------------------------------------------------------------

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

constexpr int panel_smem_max_n() { return ((232448 - kTileBytes) / (kBM * 4) - 4) / kBN * kBN; }

// ---------------------------------------------------------------------------
// wgmma: the product on csrc/gemm_mainloop.cuh, the layernorm across a cluster
// ---------------------------------------------------------------------------

namespace wg7 {

constexpr int BN = 128;          // columns a tile
constexpr int MAX_CLUSTER = 8;   // CTAs a cluster (the portable limit)

template <int WG, int STAGES>
using Cfg = gemm_ml::Config<WG, BN, STAGES, false, true>;  // x K-major, w (K, N) MN-major

// A CTA's shared memory past the 1024-aligned ring and its barriers: with
// several tiles a CTA (MULTI) one fp32 slot of BM x BN values for each tile
// but the last (which stays in the accumulator registers), then the (sum,
// sum of squares) partials of the CTA's rows.  A tile's residual
// and keep-mask boxes (BM rows by 64 bf16 or 128 bytes: BOX bytes each)
// travel through the ring itself, BPS boxes a stage, as the ring steps
// after the tile's k-steps.  Mirrored by kernels/fused_output.py _wgmma_smem.
template <int WG, int STAGES>
struct Layout {
  static constexpr int BM = 64 * WG;
  static constexpr int BOX = BM * 128;
  static constexpr int BPS = Cfg<WG, STAGES>::STAGE_BYTES / BOX;
  static constexpr int RES_BOXES = BN / 64, KEEP_BOXES = BN / 128;
  static constexpr int SLOTS = (STAGES * Cfg<WG, STAGES>::STAGE_BYTES + 16 * STAGES + 16 + 1023) /
                               1024 * 1024;
  static_assert(Cfg<WG, STAGES>::STAGE_BYTES % BOX == 0, "whole boxes a stage");
  static_assert((RES_BOXES + KEEP_BOXES + BPS - 1) / BPS <= STAGES, "a tile's boxes fit the ring");
  // the ring steps that carry a tile's boxes
  __host__ __device__ static constexpr int vsteps(bool dropping) {
    return (RES_BOXES + (dropping ? KEEP_BOXES : 0) + BPS - 1) / BPS;
  }
  __host__ __device__ static constexpr int stats(int nt) {
    return SLOTS + (nt > 1 ? (nt - 1) * BM * BN * 4 : 0);
  }
  __host__ __device__ static constexpr int smem(int nt) { return 1024 + stats(nt) + 2 * BM * 4; }
};

struct Params {
  const float* bias;
  const float* gamma;
  const float* beta;
  void* out;
  int M, N, K, nt, cluster, dropping;
  float scale, eps;
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every CTA of the cluster: writes to shared memory before it
// are visible to the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
// The float at shared address `addr` of the cluster's CTA `rank`.
__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// The four lanes that hold a row's columns: their sum, in one fixed tree.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The sum over the cluster's CTAs, in rank order, of the partial at `addr`.
__device__ __forceinline__ float cluster_total(uint32_t addr, int cluster) {
  float t = 0.0f;
  for (int q = 0; q < cluster; ++q) t += ld_cluster(addr, q);
  return t;
}

template <typename TOut>
__device__ __forceinline__ void store2(void* out, size_t at, float y0, float y1) {
  if constexpr (std::is_same<TOut, float>::value)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(y0, y1);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + at) = __floats2bfloat162_rn(y0, y1);
}

// Byte b of row r of a 128-byte-swizzled box (TMA's CU_TENSOR_MAP_SWIZZLE_128B).
__device__ __forceinline__ int swz(int r, int b) { return r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15); }

// The producer's loads of a tile's boxes into ring step `it` (the v-th step
// after the tile's k-steps): residual boxes 0 .. RES_BOXES - 1, then keep
// boxes, BPS a stage.
template <class L>
__device__ __forceinline__ void load_boxes(uint32_t stage, uint32_t bar, int v, int nbox,
                                           const CUtensorMap* tres, const CUtensorMap* tkeep,
                                           int m0, int n0) {
  const int first = v * L::BPS, last = min(nbox, first + L::BPS);
  hopper::mbar_expect_tx(bar, (last - first) * L::BOX);
  for (int b = first; b < last; ++b) {
    const uint32_t dst = stage + (b - first) * L::BOX;
    if (b < L::RES_BOXES) hopper::tma_load_4d(dst, tres, bar, n0 + 64 * b, m0, 0, 0);
    else hopper::tma_load_4d(dst, tkeep, bar, n0 + 128 * (b - L::RES_BOXES), m0, 0, 0);
  }
}

template <int WG, int STAGES, int CTAS, bool MULTI, typename TOut>
__global__ void __launch_bounds__(Cfg<WG, STAGES>::THREADS, CTAS)
fused_output_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap tres,
                   const __grid_constant__ CUtensorMap tkeep, const Params p) {
  using C = Cfg<WG, STAGES>;
  using L = Layout<WG, STAGES>;
  constexpr int BM = C::BM, NV = BN / 2;
  extern __shared__ unsigned char smem_raw[];
  const gemm_ml::Smem<C> sm(smem_raw);
  unsigned char* ring = smem_raw + (sm.ring - hopper::smem_u32(smem_raw));
  const int nt = MULTI ? p.nt : 1;
  const uint32_t sums = sm.ring + L::stats(nt), sqs = sums + 4 * BM;
  float* sum_p = reinterpret_cast<float*>(ring + L::stats(nt));
  float* sq_p = sum_p + BM;
  const int rank = static_cast<int>(cluster_rank());
  const int m0 = blockIdx.y * BM, col0 = rank * nt * BN;
  const int steps = (p.K + gemm_ml::BK - 1) / gemm_ml::BK;
  const int nbox = L::RES_BOXES + (p.dropping ? L::KEEP_BOXES : 0);
  const int vsteps = L::vsteps(p.dropping != 0), per_tile = steps + vsteps;
  gemm_ml::init<C>(sm);
  const int wg = gemm_ml::warpgroup();
  if (wg == WG) {
    // the producer: each tile's k-steps through the ring, then its residual
    // and keep boxes as the next ring steps, loading while the tile's last
    // k-steps run
    if (threadIdx.x == 128 * WG) {
      for (int t = 0; t < nt; ++t) {
        const int n0 = col0 + t * BN;
        for (int i = 0; i < per_tile; ++i) {
          const int it = t * per_tile + i, s = it % STAGES;
          if (it >= STAGES) gemm_ml::wait(sm.empty + 8 * s, ((it / STAGES) - 1) & 1);
          const uint32_t bar = sm.full + 8 * s;
          if (i < steps) {
            hopper::mbar_expect_tx(bar, C::STAGE_BYTES);
            C::A::load(sm.a(s), &tx, bar, m0, i * gemm_ml::BK, 0, 0);
            C::B::load(sm.b(s), &tw, bar, n0, i * gemm_ml::BK, 0, 0);
          } else {
            load_boxes<L>(sm.a(s), bar, i - steps, nbox, &tres, &tkeep, m0, n0);
          }
        }
      }
    }
    __syncwarp();
    cluster_sync();   // the sums are in
    cluster_sync();   // the sums of squares are in
    cluster_sync();   // no peer reads this CTA's shared memory any more
    return;
  }

  // A consumer warpgroup: rows r_lo = 64 wg + acc_row(0) and r_lo + 8 of
  // the band (acc[i] with (i / 2) % 2 = 0 and 1), columns acc_col(i).
  const int r_lo = 64 * wg + gemm_ml::acc_row(0), tid = threadIdx.x;
  float acc[NV];
  for (int t = 0; t < nt; ++t) {
    const int n0 = col0 + t * BN, it0 = t * per_tile;
    gemm_ml::consume<C>(acc, sm, steps, wg, it0, true);
    const unsigned char* box[L::RES_BOXES + L::KEEP_BOXES];
#pragma unroll
    for (int b = 0; b < L::RES_BOXES + L::KEEP_BOXES; ++b) {
      const int it = it0 + steps + b / L::BPS;
      box[b] = ring + (it % STAGES) * C::STAGE_BYTES + (b % L::BPS) * L::BOX;
    }
    for (int v = 0; v < vsteps; ++v) {
      const int it = it0 + steps + v;
      gemm_ml::wait(sm.full + 8 * (it % STAGES), (it / STAGES) & 1);
    }
#pragma unroll
    for (int i = 0; i < NV; i += 2) {
      const int r = r_lo + 8 * ((i >> 1) & 1), c = gemm_ml::acc_col(i);
      const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + n0 + c));
      float v0 = acc[i] + b.x, v1 = acc[i + 1] + b.y;
      if (p.dropping) {
        const uint16_t k = *reinterpret_cast<const uint16_t*>(
            box[L::RES_BOXES + (8 * (i / 4)) / 128] + swz(r, c & 127));
        v0 = (k & 0xFFu) ? v0 * p.scale : 0.0f;
        v1 = (k >> 8) ? v1 * p.scale : 0.0f;
      }
      const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(
          box[(8 * (i / 4)) / 64] + swz(r, (c & 63) * 2));
      acc[i] = v0 + __bfloat162float(res.x);
      acc[i + 1] = v1 + __bfloat162float(res.y);
    }
    // every consumer has read the tile's boxes: free their stages
    hopper::named_sync<1, 128 * WG>();
    for (int v = 0; v < vsteps; ++v)
      gemm_ml::arrive_if(sm.empty + 8 * ((it0 + steps + v) % STAGES), threadIdx.x % 128 == 0);
    if constexpr (MULTI) {
      if (t < nt - 1) {   // the tile's values wait in its slot, each thread's own
        float* vals = reinterpret_cast<float*>(ring + L::SLOTS + t * (BM * BN * 4));
#pragma unroll
        for (int i = 0; i < NV; ++i) vals[i * 128 * WG + tid] = acc[i];
      }
    }
  }
  // f(values, n0) for each tile in column order: the slots' into `cur`,
  // then the last, still in acc
  float cur[MULTI ? NV : 1];
  auto each_tile = [&](auto f) {
    if constexpr (MULTI) {
      for (int t = 0; t < nt - 1; ++t) {
        const float* vals = reinterpret_cast<const float*>(ring + L::SLOTS + t * (BM * BN * 4));
#pragma unroll
        for (int i = 0; i < NV; ++i) cur[i] = vals[i * 128 * WG + tid];
        f(cur, col0 + t * BN);
      }
    }
    f(acc, col0 + (nt - 1) * BN);
  };
  const bool quad_lead = threadIdx.x % 4 == 0;
  const float n = static_cast<float>(p.N);
  // the mean: this CTA's partial of each row, then the cluster's
  float s_lo = 0.0f, s_hi = 0.0f;
  each_tile([&](const float* v, int) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((i >> 1) & 1) s_hi += v[i];
      else s_lo += v[i];
    }
  });
  s_lo = quad_sum(s_lo);
  s_hi = quad_sum(s_hi);
  if (quad_lead) {
    sum_p[r_lo] = s_lo;
    sum_p[r_lo + 8] = s_hi;
  }
  cluster_sync();
  const float mu_lo = cluster_total(sums + 4 * r_lo, p.cluster) / n;
  const float mu_hi = cluster_total(sums + 4 * (r_lo + 8), p.cluster) / n;
  // the variance about it, the same way
  float q_lo = 0.0f, q_hi = 0.0f;
  each_tile([&](const float* v, int) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((i >> 1) & 1) {
        const float d = v[i] - mu_hi;
        q_hi += d * d;
      } else {
        const float d = v[i] - mu_lo;
        q_lo += d * d;
      }
    }
  });
  q_lo = quad_sum(q_lo);
  q_hi = quad_sum(q_hi);
  if (quad_lead) {
    sq_p[r_lo] = q_lo;
    sq_p[r_lo + 8] = q_hi;
  }
  cluster_sync();
  const float rstd_lo = rsqrtf(cluster_total(sqs + 4 * r_lo, p.cluster) / n + p.eps);
  const float rstd_hi = rsqrtf(cluster_total(sqs + 4 * (r_lo + 8), p.cluster) / n + p.eps);
  // normalise and store y once
  each_tile([&](const float* v, int n0) {
#pragma unroll
    for (int i = 0; i < NV; i += 2) {
      const bool hi = (i >> 1) & 1;
      const int gm = m0 + r_lo + (hi ? 8 : 0), gn = n0 + gemm_ml::acc_col(i);
      const float mu = hi ? mu_hi : mu_lo, rstd = hi ? rstd_hi : rstd_lo;
      const float2 g = __ldg(reinterpret_cast<const float2*>(p.gamma + gn));
      const float2 be = __ldg(reinterpret_cast<const float2*>(p.beta + gn));
      if (gm < p.M)
        store2<TOut>(p.out, (size_t)gm * p.N + gn, (v[i] - mu) * rstd * g.x + be.x,
                     (v[i + 1] - mu) * rstd * g.y + be.y);
    }
  });
  cluster_sync();
}

// A 2-D matrix of `rows` x `cols` bf16 (row stride ld elements) read in
// boxes of `box_rows` rows by `panel` columns, as hopper::tile_map builds it.
inline cudaError_t matrix_map(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
                              int panel, int box_rows) {
  return hopper::tile_map(map, ptr, cols, rows, 1, 1, ld, 0, 0, panel, box_rows);
}

// The keep mask (rows x cols bytes, contiguous) as a 4-D map (hopper's TMA
// loads are 4-D; the outer two dimensions have extent 1) in boxes of 128
// bytes by `box_rows` rows, 128-byte swizzled.
inline cudaError_t byte_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows), 1, 1};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(cols), 16, 16};
  const cuuint32_t box[4] = {128, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The launch configuration of a grid of (cluster, bands) CTAs in clusters of
// `cluster` along x; `attr` must outlive it.
inline cudaLaunchConfig_t launch_config(cudaLaunchAttribute* attr, int cluster, int bands,
                                        int threads, int smem, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, bands, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The shapes the source builds, as kernels/fused_output.py WGMMA_SHAPES lists
// them: (consumer warpgroups, ring stages, CTAs an SM, several tiles a CTA).
// The plan takes the first whose shared memory holds a CTA's tiles.
#define K7_SHAPES(X) X(2, 3, 2, false) X(1, 4, 1, true)

template <int WG, int STAGES, int CTAS, bool MULTI>
struct Shape {
  using C = Cfg<WG, STAGES>;
  using L = Layout<WG, STAGES>;
  template <typename TOut>
  static constexpr auto kernel() { return &fused_output_wgmma<WG, STAGES, CTAS, MULTI, TOut>; }
  static bool takes(int nt) { return MULTI || nt == 1; }
};

template <class Kern>
cudaError_t allow_smem(Kern kern) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
}

template <class S, typename TOut>
cudaError_t launch(const bf16* x, const bf16* w, const bf16* res, const uint8_t* keep,
                   const Params& p, int smem, cudaStream_t s) {
  using C = typename S::C;
  if (!S::takes(p.nt) || smem != S::L::smem(p.nt)) return cudaErrorInvalidValue;
  CUtensorMap tx, tw, tres, tkeep = {};
  cudaError_t e = matrix_map(&tx, x, p.M, p.K, p.K, gemm_ml::BK, C::BM);
  if (e == cudaSuccess) e = matrix_map(&tw, w, p.K, p.N, p.N, C::B::SW, gemm_ml::BK);
  if (e == cudaSuccess) e = matrix_map(&tres, res, p.M, p.N, p.N, 64, C::BM);
  if (e == cudaSuccess && p.dropping) e = byte_map(&tkeep, keep, p.M, p.N, C::BM);
  if (e != cudaSuccess) return e;
  const auto kern = S::template kernel<TOut>();
  static const cudaError_t attr = allow_smem(kern);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute la[1];
  const cudaLaunchConfig_t cfg =
      launch_config(la, p.cluster, (p.M + C::BM - 1) / C::BM, C::THREADS, smem, s);
  e = cudaLaunchKernelEx(&cfg, kern, tx, tw, tres, tkeep, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <class S, typename TOut>
cudaError_t max_clusters(int cluster, int nt, int bands, int* out) {
  const auto kern = S::template kernel<TOut>();
  static const cudaError_t attr = allow_smem(kern);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute la[1];
  const cudaLaunchConfig_t cfg =
      launch_config(la, cluster, bands, S::C::THREADS, S::L::smem(nt), nullptr);
  return cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

template <class F>
cudaError_t by_shape(int wg, int stages, int ctas, F f) {
#define K7_CASE(W, S, N, MU) \
  if (wg == W && stages == S && ctas == N) return f(Shape<W, S, N, MU>{});
  K7_SHAPES(K7_CASE)
#undef K7_CASE
  return cudaErrorInvalidValue;
}

}  // namespace wg7

}  // namespace

// The largest N whose 32-row fp32 panel the wmma and simt variants keep in
// shared memory; a wider N needs the scratch.
extern "C" int fused_output_smem_max_n() { return panel_smem_max_n(); }

// The shared memory a wgmma CTA of shape (wg, stages, ctas) and `nt` tiles
// takes, or -1 for a shape the source does not build or tiles it does not take.
extern "C" int fused_output_wgmma_smem(int wg, int stages, int ctas, int nt) {
  int bytes = -1;
  wg7::by_shape(wg, stages, ctas, [&](auto shape) {
    using S = decltype(shape);
    if (S::takes(nt)) bytes = S::L::smem(nt);
    return cudaSuccess;
  });
  return bytes;
}

// cudaOccupancyMaxActiveClusters of the wgmma variant's launch for `bands`
// row bands into out[0].  Returns its error.
extern "C" int fused_output_max_clusters(int wg, int stages, int ctas, int nt, int cluster,
                                         int bands, int out_bf16, int* out) {
  auto f = [&](auto shape) {
    using S = decltype(shape);
    return out_bf16 ? wg7::max_clusters<S, bf16>(cluster, nt, bands, out)
                    : wg7::max_clusters<S, float>(cluster, nt, bands, out);
  };
  return static_cast<int>(wg7::by_shape(wg, stages, ctas, f));
}

// x (M, K), w (K, N), residual (M, N) contiguous, bf16 if in_bf16 else
// fp32; bias, gamma, beta (N,) fp32; keep (M, N) bytes (nonzero = kept) or
// null for no dropout; out (M, N) contiguous, bf16 if out_bf16 else fp32.
// variant (enum Variant) and, for wgmma, the plan's cluster (CTAs along N),
// nt (128-column tiles a CTA; cluster x nt x 128 = N), wg, stages and ctas
// (a shape of K7_SHAPES) and smem (its bytes): x, w, residual and keep must
// have 16-byte aligned bases and rows, and bias, gamma and beta (read two
// floats at a time) 8-byte aligned bases.  wmma (bf16) and simt (fp32): scratch
// null when N <= fused_output_smem_max_n(), else (ceil(M/32)·32,
// ceil(N/128)·128) fp32; vec: x's and w's rows start 16-byte aligned.
// Returns cudaErrorInvalidValue without launching for a call the variant
// does not take, else cudaGetLastError() after the launch.
extern "C" int fused_output(const void* x, const void* w, const void* bias, const void* residual,
                            const void* keep, const void* gamma, const void* beta, void* out,
                            void* scratch, int in_bf16, int out_bf16, int M, int N, int K,
                            float scale, float eps, int vec, int variant, int cluster, int nt,
                            int wg, int stages, int ctas, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const uint8_t* k = static_cast<const uint8_t*>(keep);
  if (variant == V_WGMMA) {
    if (!in_bf16 || cluster < 1 || cluster > wg7::MAX_CLUSTER || nt < 1 ||
        cluster * nt * wg7::BN != N || K < 1 ||
        (reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(g) |
         reinterpret_cast<uintptr_t>(be)) % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const wg7::Params p{b, g, be, out, M, N, K, nt, cluster, k != nullptr ? 1 : 0, scale, eps};
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    const bf16* rb = static_cast<const bf16*>(residual);
    auto f = [&](auto shape) {
      using S = decltype(shape);
      return out_bf16 ? wg7::launch<S, bf16>(xb, wb, rb, k, p, smem, s)
                      : wg7::launch<S, float>(xb, wb, rb, k, p, smem, s);
    };
    return static_cast<int>(wg7::by_shape(wg, stages, ctas, f));
  }
  if ((variant == V_WMMA) != (in_bf16 != 0) || (variant != V_WMMA && variant != V_SIMT) ||
      (scratch == nullptr) != (N <= panel_smem_max_n()))
    return static_cast<int>(cudaErrorInvalidValue);
  float* sc = static_cast<float*>(scratch);
  const bool v = vec != 0;
  if (in_bf16)
    return out_bf16 ? launch<bf16, bf16>(x, w, b, residual, k, g, be, out, sc, M, N, K, scale, eps, v, s)
                    : launch<bf16, float>(x, w, b, residual, k, g, be, out, sc, M, N, K, scale, eps, v, s);
  return out_bf16 ? launch<float, bf16>(x, w, b, residual, k, g, be, out, sc, M, N, K, scale, eps, v, s)
                  : launch<float, float>(x, w, b, residual, k, g, be, out, sc, M, N, K, scale, eps, v, s);
}
