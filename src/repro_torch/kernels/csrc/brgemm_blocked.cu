// K11: the paper's blocked BRGEMM (Listing 1), in its own layouts:
//     A (Mb, Kb, bm, bk) x B (Nb, Kb, bk, bn) -> C (Nb, Mb, bm, bn),
//     C[n][m] = sum over kb of A[m][kb] @ B[n][kb], fp32 accumulator, cast once.
//
// Replaces the TPU kernel repro/kernels/brgemm.py::brgemm_blocked_pallas
// (launched through repro/core/pallas_lowering.py::make_pallas_fn).  There
// the spec string over a = K (k_step blocks a visit), b = M, c = N sets the
// Pallas grid, and each grid step adds one visit's batch-reduce into the
// VMEM output block.  Here kernels/brgemm.py plans the same nest
// (core/cuda_lowering.py::plan_cuda) and passes its output visit order, the
// (n, m) blocks in the order the reference's grid first reaches them, as an
// int32 table: block i of the 1-D grid owns output block order[i], so the
// spec string sets the order in which blocks are rasterised and which of
// them share the L2 cache.  A block walks the a levels in nest order (every
// legal spec keeps them innermost, so that is kb = 0 .. Kb-1), batch-reduces
// k_step (A, B) block pairs a visit into accumulators that stay live across
// all visits, and writes C once, after the last visit, in the output dtype.
// The reference rounds its output after every visit; its oracle
// (brgemm_blocked_ref) rounds once, and this kernel follows the oracle.
// Every block computes its output the same way under any table, so every
// legal spec gives the same bits.
//
// Layouts, read in place: the m-th block row of A is Kb separate bm x bk
// blocks (its K axis strided by bm*bk), so A is loaded block by block; the
// n-th block column of B is one row-major (Kb*bk) x bn matrix.
//
// What bounds it on an H100: at the paper's GEMM shapes (bench_gemm.py,
// 1024^3 to 4096x4096x11008, bf16) the work is far above the card's ~295
// flop/byte ridge, so tensor-core operations bound it, and only wgmma fed
// ahead of time reaches their rate.  A 64x64 output block does 32 flop per
// byte it loads, so it leans on the L2 cache for A's block rows and B's
// block columns, which its neighbours in the order table read too.
//
// What the design does about it: bf16 blocks with bm 64 or 128, bn a
// multiple of 16 up to 256 and bk a multiple of 16, from 16-byte aligned
// tensors, run the wgmma variant on csrc/gemm_mainloop.cuh (one consumer
// warpgroup per 64 rows of the block plus a producer warp, a 4-stage TMA
// ring): A's block row through a 3-D tensor map (bk, bm, Mb*Kb), each box
// one bm x 64 slice of one block, K-major; B's block column through a 3-D
// map (bn, bk, Nb*Kb), read MN-major with the transpose bit; K runs
// kb = 0 .. Kb-1 in 64-deep steps (zero-filled past bk) under every spec,
// so every spec gives "bca"'s bits.  The CTA's N extent is bn rounded up to
// 64, 128 or 256 (the columns past bn arrive as zeros and are not stored).
// The other bf16 blocks whose bm, bn and bk are multiples of 16 run the WMMA
// variant (4 warps, each holding up to 16 accumulator fragments in
// registers, A and B staged through shared memory 32 (or 16) deep in
// 16-byte vectors, unpipelined).  fp32 runs a SIMT variant in full fp32
// FMA, never TF32, and so does any other block size (up to 8192 outputs a
// block): one thread per output element, 16-deep chunks.
#include "gemm_mainloop.cuh"
#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

constexpr int kWarps = 4;           // WMMA variant: warps a block
constexpr int kSimtThreads = 256;   // SIMT variant: threads a block
constexpr int kSimtKc = 16;         // SIMT variant: K depth a chunk

// The wgmma variant: WG consumer warpgroups (bm = 64 WG) by WN >= bn
// columns.  Block (n, m) of the order table; k-step it is 64-deep step
// it % spb of block kb = it / spb (spb = ceil(bk / 64)).  A pair also loads
// block column n_hi into B's upper panels.
struct BlockedCoords {
  int m, n, n_hi, Kb, spb;
  __device__ __forceinline__ void coords(int it, int& ar, int& ak, int& az, int& br, int& bk,
                                         int& bz, int& bz_hi) const {
    const int kb = it / spb;
    ar = br = 0;
    ak = bk = (it % spb) * gemm_ml::BK;
    az = m * Kb + kb;
    bz = n * Kb + kb;
    bz_hi = n_hi * Kb + kb;
  }
};

template <int WG, int WN>
using BlockedCfg = gemm_ml::Config<WG, WN, 4, false, true>;

// PAIRED (64-row blocks at most 64 wide, C::BN = 128): `order` holds
// (n, m, n_hi) triples, and the CTA computes block (n, m) in its lower 64
// columns and block (n_hi, m) in its upper 64, sharing A's loads; n_hi < 0
// for a block alone.  Every column is summed the same way in either half,
// so a block has the same bits paired or alone.
template <class C, bool PAIRED>
__global__ void __launch_bounds__(C::THREADS)
brgemm_blocked_bf16_wgmma(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb, void* __restrict__ c,
                          int out_f32, const int* __restrict__ order, int Mb, int Kb, int bn,
                          int bk) {
  extern __shared__ unsigned char smem_raw[];
  const gemm_ml::Smem<C> sm(smem_raw);
  const int n = order[(PAIRED ? 3 : 2) * blockIdx.x], m = order[(PAIRED ? 3 : 2) * blockIdx.x + 1];
  const int n_hi = PAIRED ? order[3 * blockIdx.x + 2] : -1;
  const int spb = (bk + gemm_ml::BK - 1) / gemm_ml::BK;
  gemm_ml::init<C>(sm);
  const int wg = gemm_ml::warpgroup();
  if (wg == C::WG) {
    gemm_ml::produce<C>(sm, &ta, &tb, BlockedCoords{m, n, n_hi >= 0 ? n_hi : n, Kb, spb},
                        Kb * spb);
    return;
  }
  float acc[C::BN / 2];
  gemm_ml::consume<C>(acc, sm, Kb * spb, wg);
  // C blocks (n, m) and (n_hi, m), row-major bm x bn; bn is even, so every
  // pair of columns is aligned
#pragma unroll
  for (int i = 0; i < C::BN / 2; i += 2) {
    const int r = 64 * wg + gemm_ml::acc_row(i);
    int col = gemm_ml::acc_col(i), bn_of = n;
    if (PAIRED && col >= 64) {
      if (n_hi < 0) continue;
      bn_of = n_hi;
      col -= 64;
    }
    if (col < bn) {
      const size_t at = ((size_t)bn_of * Mb + m) * C::BM * bn + (size_t)r * bn + col;
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(c) + at) = make_float2(acc[i], acc[i + 1]);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(c) + at) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// The tensor-core variant.  Fragment f of the bm x bn output block (row
// f / (bn/16), column f % (bn/16)) belongs to warp f % kWarps, slot
// f / kWarps; FPW slots a warp.
template <int FPW, typename TOut>
__global__ void __launch_bounds__(kWarps * 32)
brgemm_blocked_bf16_wmma(const bf16* __restrict__ A, const bf16* __restrict__ B,
                         TOut* __restrict__ C, const int* __restrict__ order, int Mb, int Kb,
                         int bm, int bn, int bk, int k_step, int kc, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  // Rows padded by 8 elements: 16-byte aligned vector stores, 32-byte
  // aligned fragment pointers, fewer bank conflicts.
  const int ap = kc + 8, bp = bn + 8;
  bf16* As = reinterpret_cast<bf16*>(smem);            // bm x ap
  bf16* Bs = As + bm * ap;                             // kc x bp
  float* Cs = reinterpret_cast<float*>(Bs + kc * bp);  // kWarps staging tiles of 16x16

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = order[2 * blockIdx.x], m = order[2 * blockIdx.x + 1];
  const int fn = bn / 16, nfrag = (bm / 16) * fn;
  const bf16* Arow = A + (size_t)m * Kb * bm * bk;     // Kb blocks of bm x bk
  const bf16* Bcol = B + (size_t)n * Kb * bk * bn;     // a (Kb*bk) x bn matrix

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FPW];
#pragma unroll
  for (int t = 0; t < FPW; ++t) wmma::fill_fragment(acc[t], 0.0f);

  for (int kv = 0; kv < Kb; kv += k_step)          // the visits (a levels)
    for (int kb = kv; kb < kv + k_step; ++kb)      // one visit's batch-reduce
      for (int k0 = 0; k0 < bk; k0 += kc) {
        const bf16* a = Arow + (size_t)kb * bm * bk;
        for (int i = threadIdx.x; i < bm * kc / 8; i += kWarps * 32) {
          const int r = i / (kc / 8), c = (i % (kc / 8)) * 8;
          load8(&As[r * ap + c], a, r, k0 + c, bm, bk, bk, vec);
        }
        for (int i = threadIdx.x; i < kc * bn / 8; i += kWarps * 32) {
          const int r = i / (bn / 8), c = (i % (bn / 8)) * 8;
          load8(&Bs[r * bp + c], Bcol, kb * bk + k0 + r, c, Kb * bk, bn, bn, vec);
        }
        __syncthreads();
        for (int kk = 0; kk < kc; kk += 16) {
#pragma unroll
          for (int t = 0; t < FPW; ++t) {
            const int f = warp + kWarps * t;
            if (f < nfrag) {  // uniform across the warp
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
              wmma::load_matrix_sync(af, &As[(f / fn) * 16 * ap + kk], ap);
              wmma::load_matrix_sync(bfr, &Bs[kk * bp + (f % fn) * 16], bp);
              wmma::mma_sync(acc[t], af, bfr, acc[t]);
            }
          }
        }
        __syncthreads();
      }

  // C block (n, m), row-major bm x bn: each fragment through this warp's
  // staging tile, cast, stored.
  float* cs = Cs + warp * 256;
  TOut* Cblk = C + ((size_t)n * Mb + m) * bm * bn;
#pragma unroll
  for (int t = 0; t < FPW; ++t) {
    const int f = warp + kWarps * t;
    if (f < nfrag) {
      wmma::store_matrix_sync(cs, acc[t], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        Cblk[(size_t)((f / fn) * 16 + e / 16) * bn + (f % fn) * 16 + e % 16] =
            from_float<TOut>(cs[e]);
      __syncwarp();
    }
  }
}

// The SIMT variant, fp32 FMA: thread t owns output elements t + 256 * s,
// s < EPT, of the row-major bm x bn block.
template <int EPT, typename T, typename TOut>
__global__ void __launch_bounds__(kSimtThreads)
brgemm_blocked_simt(const T* __restrict__ A, const T* __restrict__ B, TOut* __restrict__ C,
                    const int* __restrict__ order, int Mb, int Kb, int bm, int bn, int bk,
                    int k_step) {
  extern __shared__ __align__(16) float fsmem[];
  float* As = fsmem;                   // bm x kSimtKc
  float* Bs = fsmem + bm * kSimtKc;    // kSimtKc x bn
  const int n = order[2 * blockIdx.x], m = order[2 * blockIdx.x + 1];
  const int ne = bm * bn;
  const T* Arow = A + (size_t)m * Kb * bm * bk;
  const T* Bcol = B + (size_t)n * Kb * bk * bn;
  float acc[EPT];
#pragma unroll
  for (int s = 0; s < EPT; ++s) acc[s] = 0.0f;

  for (int kv = 0; kv < Kb; kv += k_step)          // the visits (a levels)
    for (int kb = kv; kb < kv + k_step; ++kb)      // one visit's batch-reduce
      for (int k0 = 0; k0 < bk; k0 += kSimtKc) {
        const int kc = min(kSimtKc, bk - k0);
        const T* a = Arow + (size_t)kb * bm * bk;
        for (int i = threadIdx.x; i < bm * kc; i += kSimtThreads) {
          const int r = i / kc, c = i % kc;
          As[r * kSimtKc + c] = to_float(a[(size_t)r * bk + k0 + c]);
        }
        const T* b = Bcol + ((size_t)kb * bk + k0) * bn;   // kc contiguous rows of bn
        for (int i = threadIdx.x; i < kc * bn; i += kSimtThreads) Bs[i] = to_float(b[i]);
        __syncthreads();
#pragma unroll
        for (int s = 0; s < EPT; ++s) {
          const int e = threadIdx.x + kSimtThreads * s;
          if (e < ne) {
            const int i = e / bn, j = e % bn;
            float v = acc[s];
            for (int kk = 0; kk < kc; ++kk) v = fmaf(As[i * kSimtKc + kk], Bs[kk * bn + j], v);
            acc[s] = v;
          }
        }
        __syncthreads();
      }

  TOut* Cblk = C + ((size_t)n * Mb + m) * ne;
#pragma unroll
  for (int s = 0; s < EPT; ++s) {
    const int e = threadIdx.x + kSimtThreads * s;
    if (e < ne) Cblk[e] = from_float<TOut>(acc[s]);
  }
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename Kernel>
void allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
}

template <int FPW, typename TOut>
void run_wmma(const bf16* A, const bf16* B, TOut* C, const int* order, int n_order, int Mb,
              int Kb, int bm, int bn, int bk, int k_step, bool vec, cudaStream_t s) {
  const int kc = bk % 32 == 0 ? 32 : 16;
  const size_t smem = (size_t)bm * (kc + 8) * 2 + (size_t)kc * (bn + 8) * 2 + kWarps * 256 * 4;
  allow_smem(brgemm_blocked_bf16_wmma<FPW, TOut>, smem);
  brgemm_blocked_bf16_wmma<FPW, TOut><<<n_order, kWarps * 32, smem, s>>>(
      A, B, C, order, Mb, Kb, bm, bn, bk, k_step, kc, vec);
}

template <typename TOut>
void launch_wmma(const bf16* A, const bf16* B, TOut* C, const int* order, int n_order, int Mb,
                 int Kb, int bm, int bn, int bk, int k_step, bool vec, cudaStream_t s) {
  const int per_warp = ((bm / 16) * (bn / 16) + kWarps - 1) / kWarps;
  if (per_warp <= 1)
    run_wmma<1, TOut>(A, B, C, order, n_order, Mb, Kb, bm, bn, bk, k_step, vec, s);
  else if (per_warp <= 2)
    run_wmma<2, TOut>(A, B, C, order, n_order, Mb, Kb, bm, bn, bk, k_step, vec, s);
  else if (per_warp <= 4)
    run_wmma<4, TOut>(A, B, C, order, n_order, Mb, Kb, bm, bn, bk, k_step, vec, s);
  else if (per_warp <= 8)
    run_wmma<8, TOut>(A, B, C, order, n_order, Mb, Kb, bm, bn, bk, k_step, vec, s);
  else
    run_wmma<16, TOut>(A, B, C, order, n_order, Mb, Kb, bm, bn, bk, k_step, vec, s);
}

template <int WG, int WN, bool PAIRED>
cudaError_t run_wgmma(const bf16* A, const bf16* B, void* C, int out_f32, const int* order,
                      int n_order, int Mb, int Nb, int Kb, int bm, int bn, int bk,
                      cudaStream_t s) {
  using Cfg = BlockedCfg<WG, WN>;
  CUtensorMap ta, tb;
  cudaError_t e = hopper::tile_map(&ta, A, bk, bm, Mb * Kb, 1, bk, (long long)bm * bk, 0,
                                           gemm_ml::BK, bm);
  if (e == cudaSuccess)
    e = hopper::tile_map(&tb, B, bn, bk, Nb * Kb, 1, bn, (long long)bk * bn, 0,
                                 Cfg::B::SW, gemm_ml::BK);
  if (e != cudaSuccess) return e;
  auto kern = brgemm_blocked_bf16_wgmma<Cfg, PAIRED>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (attr != cudaSuccess) return attr;
  kern<<<n_order, Cfg::THREADS, Cfg::SMEM, s>>>(ta, tb, C, out_f32, order, Mb, Kb, bn, bk);
  return cudaGetLastError();
}

// The CTA's N extent: bn rounded up to 64, 128 or 256; paired 64-row
// blocks up to 64 wide: 128.
template <int WG>
cudaError_t launch_wgmma(const bf16* A, const bf16* B, void* C, int out_f32, const int* order,
                         int n_order, int paired, int Mb, int Nb, int Kb, int bm, int bn, int bk,
                         cudaStream_t s) {
  if (paired)
    return run_wgmma<1, 128, true>(A, B, C, out_f32, order, n_order, Mb, Nb, Kb, bm, bn, bk, s);
  if (bn <= 64)
    return run_wgmma<WG, 64, false>(A, B, C, out_f32, order, n_order, Mb, Nb, Kb, bm, bn, bk, s);
  if (bn <= 128)
    return run_wgmma<WG, 128, false>(A, B, C, out_f32, order, n_order, Mb, Nb, Kb, bm, bn, bk,
                                     s);
  return run_wgmma<WG, 256, false>(A, B, C, out_f32, order, n_order, Mb, Nb, Kb, bm, bn, bk, s);
}

template <int EPT, typename T, typename TOut>
void run_simt(const T* A, const T* B, TOut* C, const int* order, int n_order, int Mb, int Kb,
              int bm, int bn, int bk, int k_step, cudaStream_t s) {
  const size_t smem = (size_t)(bm + bn) * kSimtKc * 4;
  allow_smem(brgemm_blocked_simt<EPT, T, TOut>, smem);
  brgemm_blocked_simt<EPT, T, TOut><<<n_order, kSimtThreads, smem, s>>>(A, B, C, order, Mb, Kb,
                                                                         bm, bn, bk, k_step);
}

template <typename T, typename TOut>
void launch_simt(const T* A, const T* B, TOut* C, const int* order, int n_order, int Mb, int Kb,
                 int bm, int bn, int bk, int k_step, cudaStream_t s) {
  const int per_thread = (bm * bn + kSimtThreads - 1) / kSimtThreads;
  if (per_thread <= 1)
    run_simt<1, T, TOut>(A, B, C, order, n_order, Mb, Kb, bm, bn, bk, k_step, s);
  else if (per_thread <= 2)
    run_simt<2, T, TOut>(A, B, C, order, n_order, Mb, Kb, bm, bn, bk, k_step, s);
  else if (per_thread <= 4)
    run_simt<4, T, TOut>(A, B, C, order, n_order, Mb, Kb, bm, bn, bk, k_step, s);
  else if (per_thread <= 8)
    run_simt<8, T, TOut>(A, B, C, order, n_order, Mb, Kb, bm, bn, bk, k_step, s);
  else if (per_thread <= 16)
    run_simt<16, T, TOut>(A, B, C, order, n_order, Mb, Kb, bm, bn, bk, k_step, s);
  else
    run_simt<32, T, TOut>(A, B, C, order, n_order, Mb, Kb, bm, bn, bk, k_step, s);
}

template <typename T>
void dispatch_simt(const T* A, const T* B, void* c, int out_bf16, const int* order, int n_order,
                   int Mb, int Kb, int bm, int bn, int bk, int k_step, cudaStream_t s) {
  if (out_bf16)
    launch_simt(A, B, static_cast<bf16*>(c), order, n_order, Mb, Kb, bm, bn, bk, k_step, s);
  else
    launch_simt(A, B, static_cast<float*>(c), order, n_order, Mb, Kb, bm, bn, bk, k_step, s);
}

}  // namespace

// A (Mb, Kb, bm, bk) and B (Nb, Kb, bk, bn) contiguous, both bf16 if in_bf16
// else fp32; C (Nb, Mb, bm, bn) contiguous, bf16 if out_bf16 else fp32.
// order: n_order (n, m) int32 output blocks on the device, each block of C
// once; with `paired` (wgmma, bm 64, bn at most 64) n_order (n, m, n_hi)
// triples instead, two blocks of one block row a CTA (n_hi < 0: a block
// alone).  variant: 2 wgmma (bf16, bm 64 or 128, bn a multiple of 16 up to
// 256, bk a multiple of 16, A and B 16-byte aligned), 1 the WMMA variant
// (bf16, bm, bn, bk multiples of 16, at most 64 fragments a block), 0 the
// SIMT variant (at most 8192 outputs a block).  vec: A and B start 16-byte
// aligned.  Returns cudaErrorInvalidValue without launching for a variant
// that does not take the block, else cudaGetLastError() after the launch.
extern "C" int brgemm_blocked(const void* a, const void* b, void* c, const int* order,
                              int n_order, int paired, int in_bf16, int out_bf16, int variant,
                              int Mb, int Nb, int Kb, int bm, int bn, int bk, int k_step, int vec,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 2) {
    if (!in_bf16 || !vec || (bm != 64 && bm != 128) || bn % 16 || bn > 256 || bk % 16 ||
        (paired && (bm != 64 || bn > 64)))
      return static_cast<int>(cudaErrorInvalidValue);
    const bf16* A = static_cast<const bf16*>(a);
    const bf16* B = static_cast<const bf16*>(b);
    const cudaError_t e =
        bm == 64 ? launch_wgmma<1>(A, B, c, !out_bf16, order, n_order, paired, Mb, Nb, Kb, bm, bn,
                                   bk, s)
                 : launch_wgmma<2>(A, B, c, !out_bf16, order, n_order, 0, Mb, Nb, Kb, bm, bn, bk,
                                   s);
    return static_cast<int>(e);
  }
  if (paired) return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 1) {
    if (!in_bf16 || bm % 16 || bn % 16 || bk % 16 || (bm / 16) * (bn / 16) > 16 * kWarps)
      return static_cast<int>(cudaErrorInvalidValue);
    const bf16* A = static_cast<const bf16*>(a);
    const bf16* B = static_cast<const bf16*>(b);
    if (out_bf16)
      launch_wmma(A, B, static_cast<bf16*>(c), order, n_order, Mb, Kb, bm, bn, bk, k_step,
                  vec != 0, s);
    else
      launch_wmma(A, B, static_cast<float*>(c), order, n_order, Mb, Kb, bm, bn, bk, k_step,
                  vec != 0, s);
  } else {
    if (bm * bn > 32 * kSimtThreads) return static_cast<int>(cudaErrorInvalidValue);
    if (in_bf16)
      dispatch_simt(static_cast<const bf16*>(a), static_cast<const bf16*>(b), c, out_bf16, order,
                    n_order, Mb, Kb, bm, bn, bk, k_step, s);
    else
      dispatch_simt(static_cast<const float*>(a), static_cast<const float*>(b), c, out_bf16,
                    order, n_order, Mb, Kb, bm, bn, bk, k_step, s);
  }
  return static_cast<int>(cudaGetLastError());
}
