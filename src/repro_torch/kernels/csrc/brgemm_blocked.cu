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
// flop/byte ridge, so tensor-core operations bound it.  A 64x64 output block
// fed 32-deep chunks does 32 flop per byte it loads, so it leans on the L2
// cache for A's block rows and B's block columns, which its neighbours in
// the order table read too.
//
// What the design does about it: bf16 blocks whose bm, bn and bk are
// multiples of 16 run on the tensor cores through WMMA 16x16x16 fragments
// (4 warps, each holding up to 16 accumulator fragments in registers), with
// A and B staged through shared memory 32 (or 16) deep in 16-byte vectors.
// fp32 runs a SIMT variant in full fp32 FMA, never TF32, and so does any
// other block size (up to 8192 outputs a block): one thread per output
// element, 16-deep chunks.  Loads are not pipelined (no cp.async, TMA or
// wgmma): that is left for the PR that makes this kernel fast.
#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

constexpr int kWarps = 4;           // WMMA variant: warps a block
constexpr int kSimtThreads = 256;   // SIMT variant: threads a block
constexpr int kSimtKc = 16;         // SIMT variant: K depth a chunk

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
// once.  wmma picks the tensor-core variant (bf16, bm, bn, bk multiples of
// 16, at most 64 fragments a block), else the SIMT variant (at most 8192
// outputs a block).  vec: A and B start 16-byte aligned.  Returns
// cudaErrorInvalidValue without launching for a variant that does not take
// the block, else cudaGetLastError() after the launch.
extern "C" int brgemm_blocked(const void* a, const void* b, void* c, const int* order,
                              int n_order, int in_bf16, int out_bf16, int wmma, int Mb, int Kb,
                              int bm, int bn, int bk, int k_step, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wmma) {
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
