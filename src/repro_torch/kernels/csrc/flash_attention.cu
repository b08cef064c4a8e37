// K2: flash attention forward (prefill).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (the
// kernel derived from the chained-root TppGraph; its hand-written spec is
// _legacy_flash_attention_pallas).  Semantics kept: q (B,H,Sq,D), k/v
// (B,Hk,Skv,D), GQA query head h reads kv head h / (H/Hk); scale given by
// the caller (1/sqrt(D) by default); causal and window masks aligned at the
// ends (row i sits at key position i + Skv - Sq); wholly masked key blocks
// are skipped; online softmax keeps fp32 (m, l, acc); l is floored at
// 1e-30, so a row with every key masked gives 0.  For training, K2 also
// writes each row's log-sum-exp of its scaled, masked scores, m + log(l)
// (-inf for a row with every key masked), to an optional fp32 (B, H, Sq)
// buffer: the K6 backward (flash_attention_bwd.cu) recomputes the
// probabilities from it, so l is summed from the fp32 probabilities, before
// P is rounded.  K3, the one-token decode, is csrc/flash_decode.cu.
//
// What bounds it on an H100: at the main-path shape (B 4, H 40, S 512,
// D 128, causal, bf16) K2 does ~11 GFLOP on ~84 MB of q, k, v and o, about
// 128 flop/byte, under the card's ~295 flop/byte ridge in bf16: bytes bound
// it at this length, operations from about S = 1200 on; the card comes near
// either only with the products on its tensor cores (fp32 FMA peaks at 67
// TFLOP/s, 0.16 ms for the 11 GFLOP).
//
// What the design does about it.  K2 in bf16 is the forward mainloop of
// csrc/attention_fwd.cuh (wgmma for both products, a TMA-fed K/V ring, its
// header says how), instantiated here on K2's epilogue K2Epi: the caller's
// scale, causal and window masks aligned at the ends, the key tiles
// key_tiles (whose spec is kernels/flash_attention.py::key_tile_range)
// leaves live, and a mask test only on the tiles that cross the causal
// diagonal or the window's edge; the grid reverses the query tiles under a
// causal mask so the heaviest start first.  K5's chained forward
// (csrc/fused_chain.cuh) instantiates the same mainloop on a generated
// epilogue.  fp32 keeps the SIMT kernel (flash_attention_kernel: 32-row
// query tiles, 32-key tiles in shared memory), which holds fp32's tolerance
// (1e-4) where TF32 products would not; the wrapper's forward_plan picks
// the kernel by dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// K2 in fp32 (SIMT).  Grid (ceil(Sq/32), H, B), 128 threads.
// ---------------------------------------------------------------------------
constexpr int kBQ = 32, kBKV = 32, kAttnThreads = 128;

template <int D>
constexpr size_t attn_smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBKV * (D + 1) + kBKV * D + kBQ * (kBKV + 1));
}

template <int D>
__global__ void __launch_bounds__(kAttnThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                       int H, int Hk, int Sq,
                       int Skv, long long q_sb, long long q_sh, long long q_ss,
                       long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                       long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                       long long o_ss, int causal, int window, float scale) {
  constexpr int DP = D + 1, PP = kBKV + 1, NA = D / 4;
  extern __shared__ float smem[];
  float* Qs = smem;              // kBQ x DP
  float* Ks = Qs + kBQ * DP;     // kBKV x DP
  float* Vs = Ks + kBKV * DP;    // kBKV x D
  float* Ps = Vs + kBKV * D;     // kBQ x PP

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x, r = tid / 4, cg = tid % 4;
  const int off = Skv - Sq;
  const float* qp = q + b * q_sb + h * q_sh;
  const float* kp = k + b * k_sb + hk * k_sh;
  const float* vp = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < kBQ * D; i += kAttnThreads) {
    const int rr = i / D, d = i % D;
    Qs[rr * DP + d] = (q0 + rr < Sq) ? qp[(q0 + rr) * q_ss + d] : 0.0f;
  }

  // Key tiles that any row of this tile can see; tiles outside are skipped.
  int t_lo, t_hi;
  attn_fwd::key_tiles(q0, kBQ, Sq, Skv, causal, window, kBKV, t_lo, t_hi);

  const int qpos = q0 + r + off;  // this row's key-aligned position
  float m = kNegInf, l = 0.0f;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;

  for (int j0 = t_lo * kBKV; j0 < t_hi * kBKV; j0 += kBKV) {
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    for (int i = tid; i < kBKV * D; i += kAttnThreads) {
      const int c = i / D, d = i % D;
      const bool in = j0 + c < Skv;
      Ks[c * DP + d] = in ? kp[(j0 + c) * k_ss + d] : 0.0f;
      Vs[c * D + d] = in ? vp[(j0 + c) * v_ss + d] : 0.0f;
    }
    __syncthreads();

    float s[kBKV / 4];
    bool live[kBKV / 4];
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kBKV / 4; ++jj) {
      const int c = cg + 4 * jj, col = j0 + c;
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[r * DP + d], Ks[c * DP + d], dot);
      live[jj] = col < Skv && (!causal || col <= qpos) && (window <= 0 || col > qpos - window);
      s[jj] = live[jj] ? dot * scale : kNegInf;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kBKV / 4; ++jj) {
      const float p = live[jj] ? expf(s[jj] - m_new) : 0.0f;
      Ps[r * PP + cg + 4 * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's p values are written and read by the same warp

#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] *= alpha;
    for (int c = 0; c < kBKV; ++c) {
      const float p = Ps[r * PP + c];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = fmaf(p, Vs[c * D + cg + 4 * i], acc[i]);
    }
  }

  if (q0 + r < Sq) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    float* op = o + b * o_sb + h * o_sh + (q0 + r) * o_ss;
#pragma unroll
    for (int i = 0; i < NA; ++i) op[cg + 4 * i] = acc[i] * inv;
    if (lse != nullptr && cg == 0)
      lse[((long long)b * H + h) * Sq + q0 + r] = l > 0.0f ? m + logf(l) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// K2 in bf16 on the tensor cores: csrc/attention_fwd.cuh's mainloop on K2's
// epilogue.  Grid (ceil(Sq/BM), H, B); the tile sizes of each head dim are
// attn_fwd::FwdConfig's, and kernels/flash_attention.py::forward_plan
// repeats them (the entry point refuses a plan that differs).
// ---------------------------------------------------------------------------
struct K2Epi {
  using Params = attn_fwd::Params;
  // the scaled score; masked (-inf) where the causal diagonal or the window
  // (both aligned at the ends) drops the pair, tested on a mixed tile only
  template <bool MIXED>
  static __device__ __forceinline__ float pre(float s, int gm, int gn, const Params& p) {
    if (MIXED) {
      const int pos = gm + p.Skv - p.Sq;
      if ((p.causal && gn > pos) || (p.window > 0 && gn <= pos - p.window)) return -INFINITY;
    }
    return s * p.scale;
  }
  static __device__ __forceinline__ void key_range(int q0, int rows, int bn, int& lo, int& hi,
                                                   const Params& p) {
    attn_fwd::key_tiles(q0, rows, p.Sq, p.Skv, p.causal, p.window, bn, lo, hi);
  }
  // a tile that crosses the causal diagonal or the window's edge
  static __device__ __forceinline__ bool tile_mixed(int m0, int bm, int n0, int bn,
                                                    const Params& p) {
    const int off = p.Skv - p.Sq;
    return (p.causal && n0 + bn - 1 > m0 + off) ||
           (p.window > 0 && n0 <= m0 + bm - 1 + off - p.window);
  }
};

template <int D>
cudaError_t launch_attention(const void* q, const void* k, const void* v, void* o, float* lse,
                             int B, int H,
                             int Hk, int Sq, int Skv, const long long* st, int causal,
                             int window, float scale, cudaStream_t s) {
  constexpr size_t smem = attn_smem_bytes<D>();
  auto kern = flash_attention_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kAttnThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, Hk, Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                         int H, int Hk, int Sq, int Skv, const long long* st, int causal,
                         int window, float scale, cudaStream_t s) {
  using T = attn_fwd::FwdTile<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t e = hopper::tile_map(&tq, q, D, Sq, H, B, st[2], st[1], st[0], T::SW, T::BM);
  if (e == cudaSuccess && Skv > 0) e = hopper::tile_map(&tk, k, D, Skv, Hk, B, st[5], st[4], st[3], T::SW, T::BN);
  if (e == cudaSuccess && Skv > 0) e = hopper::tile_map(&tv, v, D, Skv, Hk, B, st[8], st[7], st[6], T::SW, T::BN);
  if (e != cudaSuccess) return e;
  if (Skv == 0) tk = tv = tq;  // no key tile is loaded
  const attn_fwd::Layout L{o, lse, st[9], st[10], st[11], 0, 1, 1, 1, 1, 1, 1, nullptr, causal};
  const attn_fwd::Params p{H, Hk, Sq, Skv, causal, window, scale};
  return attn_fwd::launch<D, K2Epi>(tq, tk, tv, L, p, (Sq + T::BM - 1) / T::BM, B, s);
}

// bf16 on the tensor cores, fp32 on the SIMT kernel, each only under the
// plan (query rows a CTA, keys a tile, ring stages, dynamic shared memory)
// that forward_plan gave the wrapper.
template <int D>
cudaError_t launch_forward(int bf16_, const int* plan, const void* q, const void* k,
                           const void* v, void* o, float* lse, int B, int H, int Hk, int Sq,
                           int Skv, const long long* st, int causal, int window, float scale,
                           cudaStream_t s) {
  if (bf16_) {
    if (!attn_fwd::plan_is<D>(plan)) return cudaErrorInvalidConfiguration;
    return launch_wgmma<D>(q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
  }
  if (plan[0] != kBQ || plan[1] != kBKV || plan[2] != 1 ||
      plan[3] != static_cast<int>(attn_smem_bytes<D>()))
    return cudaErrorInvalidConfiguration;
  return launch_attention<D>(q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
}

cudaError_t dispatch_attention(int D, int bf16_, const int* plan, const void* q, const void* k,
                             const void* v, void* o, float* lse, int B, int H, int Hk, int Sq,
                             int Skv, const long long* st, int causal, int window, float scale,
                             cudaStream_t s) {
  switch (D) {
    case 16: return launch_forward<16>(bf16_, plan, q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
    case 32: return launch_forward<32>(bf16_, plan, q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
    case 64: return launch_forward<64>(bf16_, plan, q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
    case 128: return launch_forward<128>(bf16_, plan, q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
    case 256: return launch_forward<256>(bf16_, plan, q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Hk,Skv,D), o (B,H,Sq,D), each given by its (batch,
// head, seq) strides with unit stride over D; bf16 (the tensor-core kernel)
// if bf16 else fp32 (the SIMT kernel).  rows, bn, stages and smem are the
// wrapper's forward_plan; a plan this source does not build is refused.
// lse: a contiguous fp32 (B,H,Sq) buffer for each row's log-sum-exp, or
// null.  window <= 0 means none.  Returns the launch's cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                               int bf16_,
                               int B, int H, int Hk, int Sq, int Skv, int D, int rows, int bn,
                               int stages, int smem, long long q_sb,
                               long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                               long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                               long long o_sb, long long o_sh, long long o_ss, int causal,
                               int window, float scale, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const int plan[4] = {rows, bn, stages, smem};
  cudaError_t e = dispatch_attention(D, bf16_, plan, q, k, v, o, static_cast<float*>(lse), B, H, Hk,
                                   Sq, Skv, st, causal, window, scale,
                                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
