// K5's chained root: flash attention generated from a TppGraph.
// kernels/fused_gemm.py generates one source per chained graph, which
// includes this file, defines a struct `Epi` (the base root's operand
// layouts, the pre-reduce nodes as straight-line fp32 C++ and which score
// tiles the graph's attn_mask node leaves fully masked) and the C entry point
// `fused_gemm` as `fg::chain_entry<Epi>`.
//
// Replaces the chained branch of the TPU kernel repro/fusion/lowering.py:330
// `_compile_pallas` (:345-370 and :558-596): O = softmax_online(z) @ V with
// z = pre(lhs @ rhs) over the base contraction (M, K, N) and the chain
// operand V (N, N2), streamed over N tiles with a running (max, sum) per row
// that rescales the chain accumulator, so the (M, N) panel never exists.
// Scores at or below -1e29 (the mask fill, -1e30) add nothing to the sum; a
// row with no live score outputs 0 (the sum floored at 1e-30), as the
// reference's chained Pallas kernel does.  Under compile_with_vjp the
// kernel also writes each row's log-sum-exp of its live scores, m + log(l)
// (-inf for a row with none), to FusedArgs::lse: the chained backward
// (csrc/attention_bwd.cuh) rebuilds P from it.  Leading batch axes run one
// problem (a (batch, head) pair of attention) per grid.z index.  Under a
// schedule a block takes its 64 rows from the order table (the plan's M
// order), as fused_gemm.cuh's row panels do.
//
// What bounds it on an H100: at the minicpm-2b training shape (144 heads of
// 1024 x 1024 x 64, causal, bf16) both limits sit near 20 us: 75 MB of q, k,
// v and o against the HBM rate, and 19 GFLOP for the live half of the
// scores against the bf16 tensor-core peak.
//
// What the design does about it: simple and exact first.  A block of 256
// threads owns 64 query rows of one problem and walks the 64-column score
// tiles; a tile whose every score the graph's attn_mask node masks (causal:
// all columns past the rows; window: all columns before them) is skipped,
// which leaves the result unchanged.  S = q k^T and O += P V run as fp32 FMA
// on the SIMT cores (4 x 4 scores and 4 x N2/16 outputs a thread), each
// operand converted to fp32 as it is copied to shared memory in its stored
// layout; the row max and sum reduce over the 16 threads of a row with
// warp shuffles, in a fixed order (deterministic).  The tensor cores (WMMA
// or wgmma for both products) are left for the PR that makes K5 fast.
#pragma once
#include "fused_gemm.cuh"

namespace fg {

template <int NJ>
struct ChainSmem {
  float Qs[16][64 + 4];        // BK x BM, k-major
  float Ks[16][64 + 4];        // BK x BN
  float Ps[64][64 + 4];        // BM x BN probabilities
  float Vs[16][NJ * 16 + 4];   // 16 chain rows x N2
};

__device__ __forceinline__ const void* typed(const void* p, int bf16, long long off) {
  return bf16 ? static_cast<const void*>(static_cast<const fg_bf16*>(p) + off)
              : static_cast<const void*>(static_cast<const float*>(p) + off);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <class E, int NJ, typename TOut>
__global__ void __launch_bounds__(256)
fused_chain_f32_simt(FusedArgs a) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ ChainSmem<NJ> sm;
  const FgCtx c = block_ctx(a);
  const int M = a.M, N = a.N, K = a.K, N2 = a.N2;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = tile_origin(a, BM, 0).x;
  const int dq = a.lhs_bf16[0], dk = a.rhs_bf16[0], dv = a.crhs_bf16;
  const void* Q = typed(a.lhs[0], dq, c.off(a.s_lhs[0]));
  const void* Kp = typed(a.rhs[0], dk, c.off(a.s_rhs[0]));
  const void* V = typed(a.crhs, dv, c.off(a.s_crhs));

  float o[4][NJ], mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = FG_NEG_INF;
    lrow[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.0f;
  }

  for (int n0 = 0; n0 < N; n0 += BN) {
    if (E::tile_dead(m0, BM, n0, BN)) continue;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int i = threadIdx.x; i < BK * BM; i += 256) {
        int kk, mm;
        long long at;
        if (E::trans_lhs(0)) {   // stored (K, M)
          kk = i / BM, mm = i % BM;
          at = (long long)(k0 + kk) * a.lda[0] + m0 + mm;
        } else {
          mm = i / BK, kk = i % BK;
          at = (long long)(m0 + mm) * a.lda[0] + k0 + kk;
        }
        sm.Qs[kk][mm] = (m0 + mm < M && k0 + kk < K) ? fg_load(Q, dq, at) : 0.0f;
      }
      for (int i = threadIdx.x; i < BK * BN; i += 256) {
        int kk, nn;
        long long at;
        if (E::trans_rhs(0)) {   // stored (N, K)
          nn = i / BK, kk = i % BK;
          at = (long long)(n0 + nn) * a.ldb[0] + k0 + kk;
        } else {
          kk = i / BN, nn = i % BN;
          at = (long long)(k0 + kk) * a.ldb[0] + n0 + nn;
        }
        sm.Ks[kk][nn] = (n0 + nn < N && k0 + kk < K) ? fg_load(Kp, dk, at) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = sm.Qs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = sm.Ks[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
      }
      __syncthreads();
    }
    // the pre-reduce nodes, then the online softmax of the tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      float z[4], mt = FG_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + tx + 16 * j;
        z[j] = gn < N ? E::chain_pre(s[i][j], gm, gn, a, c) : FG_NEG_INF;
        mt = fmaxf(mt, z[j]);
      }
      const float m_new = fmaxf(mrow[i], row_max16(mt));
      const float alpha = expf(mrow[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = z[j] > FG_MASK_FLOOR ? expf(z[j] - m_new) : 0.0f;
        sm.Ps[ty + 16 * i][tx + 16 * j] = p;
        ps += p;
      }
      lrow[i] = lrow[i] * alpha + row_sum16(ps);
      mrow[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    // O += P @ V over the tile's 64 chain rows, 16 at a time
    for (int r0 = 0; r0 < BN; r0 += 16) {
      for (int i = threadIdx.x; i < 16 * NJ * 16; i += 256) {
        const int r = i / (NJ * 16), cc = i % (NJ * 16), gk = n0 + r0 + r;
        sm.Vs[r][cc] = (gk < N && cc < N2) ? fg_load(V, dv, gk * a.ldc + cc) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        float y[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) y[j] = sm.Vs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = sm.Ps[ty + 16 * i][r0 + kk];
#pragma unroll
          for (int j = 0; j < NJ; ++j) o[i][j] = fmaf(x, y[j], o[i][j]);
        }
      }
      __syncthreads();
    }
  }
  TOut* out = static_cast<TOut*>(a.out) + c.off(a.s_out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
    if (a.lse != nullptr && tx == 0)
      a.lse[(long long)blockIdx.z * M + gm] = lrow[i] > 0.0f ? mrow[i] + logf(lrow[i]) : -INFINITY;
    const float l = fmaxf(lrow[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < N2) out[(long long)gm * N2 + col] = from_float<TOut>(o[i][j] / l);
    }
  }
}

template <class E, int NJ>
void launch_chain(const FusedArgs& a, cudaStream_t s) {
  const dim3 grid = tile_grid(a, 64, a.N);
  if (a.out_bf16)
    fused_chain_f32_simt<E, NJ, fg_bf16><<<grid, 256, 0, s>>>(a);
  else
    fused_chain_f32_simt<E, NJ, float><<<grid, 256, 0, s>>>(a);
}

// The body of the C entry point of a chained graph's source:
//   extern "C" int fused_gemm(const FusedArgs* args, void* stream)
// lhs[0], rhs[0]: the base root's operands; crhs: the chain operand
// (N, N2) with leading dimension ldc; the output (batch, M, N2)
// contiguous; lse (if not null) (batch, M) contiguous.  N2 <= 128.  order
// (if not null): the origins of 64-row blocks in the plan's M order.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a chain wider than 128.
template <class E>
int chain_entry(const FusedArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->N2 <= 64)
    launch_chain<E, 4>(*args, s);
  else if (args->N2 <= 128)
    launch_chain<E, 8>(*args, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fg
