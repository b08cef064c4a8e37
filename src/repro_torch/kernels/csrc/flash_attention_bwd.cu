// K6: flash attention backward, (dq, dk, dv) of K2's forward.
//
// Replaces the TPU backward that repro/fusion/autodiff.py derives for the
// chained-root attention graph (ChainedBackwardPlan, run by
// _run_backward_chained and attached by compile_with_vjp, each graph lowered
// to K5's pallas_call).  Semantics kept: q (B,H,Sq,D), k/v (B,Hk,Skv,D) with
// query head h reading kv head h / (H/Hk), so dk and dv sum over the group's
// query heads; causal and window masks aligned at the ends (row i sits at key
// position i + Skv - Sq); scale given by the caller.  The forward's row
// log-sum-exp (K2's lse output) stands in for the (m, l) statistics; a row
// with every key masked (lse = -inf, output 0) gets zero gradients.
//
// The kernels are csrc/attention_bwd.cuh's mainloop (its header says what
// bounds them on an H100 and what the design does about it: bf16 on wgmma,
// fp32 on the SIMT cores), instantiated here on K6's epilogue: the score
// scaled and masked as K2 masks it, its derivative the scale, and the
// tiles the masks leave empty skipped.
#include "attention_bwd.cuh"

namespace {

struct K6Epi {
  using Params = attn_bwd::Params;
  static __device__ __forceinline__ float pre(float s, int gm, int gn, const Params& p) {
    const int pos = gm + p.Skv - p.Sq;
    const bool live = (!p.causal || gn <= pos) && (p.window <= 0 || gn > pos - p.window);
    return live ? s * p.scale : -INFINITY;
  }
  static __device__ __forceinline__ float grad(float dz, float, int, int, const Params& p) {
    return dz * p.scale;
  }
  static __host__ __device__ __forceinline__ bool tile_dead(int m0, int bm, int n0, int bn,
                                                           const Params& p) {
    const int off = p.Skv - p.Sq;
    return (p.causal && n0 > m0 + bm - 1 + off) ||
           (p.window > 0 && n0 + bn - 1 <= m0 + off - p.window);
  }
};

}  // namespace

// The arguments of attn_bwd::entry (csrc/attention_bwd.cuh); window <= 0
// means none.
extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* lse, const void* dout, void* stats, void* dq, void* dk,
                             void* dv, int bf16_, int B, int H, int Hk, int Sq, int Skv, int D,
                             const int* plan, const long long* strides, int causal, int window,
                             float scale, void* stream) {
  return attn_bwd::entry<K6Epi, 16, 32, 64, 128, 256>(q, k, v, o, lse, dout, stats, dq, dk, dv,
                                                      bf16_, B, H, Hk, Sq, Skv, D, plan,
                                                      strides, causal, window, scale, stream);
}
