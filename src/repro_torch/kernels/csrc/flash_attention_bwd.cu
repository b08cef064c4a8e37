// K6: flash attention backward, (dq, dk, dv) of K2's forward.
//
// Replaces the TPU backward that repro/fusion/autodiff.py derives for the
// chained-root attention graph (ChainedBackwardPlan, run by
// _run_backward_chained and attached by compile_with_vjp, each graph lowered
// to K5's pallas_call).  Its six graphs compute P from the saved row
// statistics, dP = dO V^T, the softmax gradient dS = P * (dP - rowsum(dO*O)),
// then dQ = dS K, dK = dS^T Q and dV = P^T dO.  Semantics kept: q (B,H,Sq,D),
// k/v (B,Hk,Skv,D) with query head h reading kv head h / (H/Hk), so dk and dv
// sum over the group's query heads; causal and window masks aligned at the
// ends (row i sits at key position i + Skv - Sq); scale given by the caller.
// The forward's row log-sum-exp (K2's lse output) stands in for the (m, l)
// statistics; a row with every key masked (lse = -inf, output 0) gets zero
// gradients.
//
// What bounds it on an H100: at minicpm-2b's training shape (B 4, H 36,
// S 1024, D 64, causal) it does 2.5x the forward's operations (five
// products of the score tile's size against two) on q, k, v, o, dO, dq, dk
// and dv; like K2 at S >= ~1200 in bf16, tensor-core operations bound it.
//
// What the design does about it, in this first version: it is fp32 SIMT
// like K2, and simple.  Three kernels, none with a float atomic, so a step's
// gradients are the same bits from run to run:
//   1. delta: D_i = rowsum(dO * O) in fp32, one warp per row;
//   2. dk/dv: one block per (batch, kv head, 32-key tile) walks the query
//      tiles of every head in the GQA group that can see its keys, keeping
//      its K and V tiles in shared memory and dK, dV in registers;
//   3. dq: one block per (batch, head, 32-query tile) walks the key tiles its
//      rows can see, keeping Q and dO in shared memory and dQ in registers.
// P and dS live only in shared memory, one 32x32 tile at a time: the score
// matrix never reaches device memory.  Kernels 2 and 3 both recompute S and
// dP; tensor cores (wgmma) and one fused pass are for the PR that makes this
// kernel fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBQ = 32, kBKV = 32, kThreads = 128, kPP = kBKV + 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// (batch, head, seq) strides of q, k, v, o, do, dq, dk, dv, in that order.
struct Strides {
  long long v[24];
};
enum { SQ = 0, SK = 3, SV = 6, SO = 9, SDO = 12, SDQ = 15, SDK = 18, SDV = 21 };

struct Problem {
  int H, Hk, Sq, Skv, causal, window;
  float scale;
};

__device__ __forceinline__ bool live(const Problem& p, int row, int col) {
  const int pos = row + p.Skv - p.Sq;
  return row < p.Sq && col < p.Skv && (!p.causal || col <= pos) &&
         (p.window <= 0 || col > pos - p.window);
}

// Copy rows [r0, r0 + 32) of one head of a (.., seq, D) tensor into an
// fp32 32 x (D + 1) tile, zero past ``rows``.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss, int r0,
                                          int rows) {
  for (int i = threadIdx.x; i < 32 * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = (r0 + r < rows) ? to_float(src[(r0 + r) * ss + d]) : 0.0f;
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float s = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// ---------------------------------------------------------------------------
// 1. delta[b, h, i] = sum_d dO[b, h, i, d] * O[b, h, i, d].  4 rows a block.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int H, int Sq, int D, long long rows, Strides st) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = row % Sq, h = (row / Sq) % H, b = row / ((long long)Sq * H);
  const T* op = o + b * st.v[SO] + h * st.v[SO + 1] + i * st.v[SO + 2];
  const T* dp = dout + b * st.v[SDO] + h * st.v[SDO + 1] + i * st.v[SDO + 2];
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_float(op[d]), to_float(dp[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * 32 * (D + 1) + 2 * kBQ * kPP + 2 * kBQ);
}

// ---------------------------------------------------------------------------
// 2. dk, dv.  Grid (ceil(Skv/32), Hk, B).  Thread t owns key row c = t / 4 of
//    the tile and dims cg + 4i (cg = t % 4) of its dK and dV rows; for the
//    score tile it computes rows cg + 4jj of column c.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
            Problem pb, Strides st) {
  constexpr int DP = D + 1, NA = D / 4;
  extern __shared__ float smem[];
  float* Ks = smem;                // kBKV x DP
  float* Vs = Ks + kBKV * DP;      // kBKV x DP
  float* Qs = Vs + kBKV * DP;      // kBQ x DP
  float* dOs = Qs + kBQ * DP;      // kBQ x DP
  float* Ps = dOs + kBQ * DP;      // kBQ x kPP
  float* dSs = Ps + kBQ * kPP;     // kBQ x kPP
  float* Ls = dSs + kBQ * kPP;     // kBQ
  float* Dl = Ls + kBQ;            // kBQ

  const int b = blockIdx.z, hk = blockIdx.y, j0 = blockIdx.x * kBKV;
  const int G = pb.H / pb.Hk;
  const int tid = threadIdx.x, c = tid / 4, cg = tid % 4;
  const int off = pb.Skv - pb.Sq;
  load_tile<T, D>(Ks, k + b * st.v[SK] + hk * st.v[SK + 1], st.v[SK + 2], j0, pb.Skv);
  load_tile<T, D>(Vs, v + b * st.v[SV] + hk * st.v[SV + 1], st.v[SV + 2], j0, pb.Skv);

  // Query rows that can see any key of this tile.
  const int j_last = min(j0 + kBKV, pb.Skv) - 1;
  const int i_begin = pb.causal ? max(0, j0 - off) : 0;
  const int i_end = pb.window > 0 ? min(pb.Sq, j_last - off + pb.window) : pb.Sq;

  float dk_acc[NA], dv_acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) { dk_acc[i] = 0.0f; dv_acc[i] = 0.0f; }

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qp = q + b * st.v[SQ] + h * st.v[SQ + 1];
    const T* dop = dout + b * st.v[SDO] + h * st.v[SDO + 1];
    const float* lp = lse + ((long long)b * pb.H + h) * pb.Sq;
    const float* dlp = delta + ((long long)b * pb.H + h) * pb.Sq;
    for (int i0 = (i_begin / kBQ) * kBQ; i0 < i_end; i0 += kBQ) {
      __syncthreads();  // the previous tile's reads are done (and K, V loaded)
      load_tile<T, D>(Qs, qp, st.v[SQ + 2], i0, pb.Sq);
      load_tile<T, D>(dOs, dop, st.v[SDO + 2], i0, pb.Sq);
      if (tid < kBQ) {
        const bool in = i0 + tid < pb.Sq;
        Ls[tid] = in ? lp[i0 + tid] : 0.0f;
        Dl[tid] = in ? dlp[i0 + tid] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < kBQ / 4; ++jj) {
        const int r = cg + 4 * jj;
        float p = 0.0f, ds = 0.0f;
        if (live(pb, i0 + r, j0 + c)) {
          const float s = dot_rows<D>(&Qs[r * DP], &Ks[c * DP]) * pb.scale;
          const float dp = dot_rows<D>(&dOs[r * DP], &Vs[c * DP]);
          p = expf(s - Ls[r]);
          ds = p * (dp - Dl[r]);
        }
        Ps[r * kPP + c] = p;
        dSs[r * kPP + c] = ds;
      }
      __syncthreads();
      for (int r = 0; r < kBQ; ++r) {
        const float p = Ps[r * kPP + c], ds = dSs[r * kPP + c];
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          dv_acc[i] = fmaf(p, dOs[r * DP + cg + 4 * i], dv_acc[i]);
          dk_acc[i] = fmaf(ds, Qs[r * DP + cg + 4 * i], dk_acc[i]);
        }
      }
    }
  }

  if (j0 + c < pb.Skv) {
    T* dkp = dk + b * st.v[SDK] + hk * st.v[SDK + 1] + (j0 + c) * st.v[SDK + 2];
    T* dvp = dv + b * st.v[SDV] + hk * st.v[SDV + 1] + (j0 + c) * st.v[SDV + 2];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      dkp[cg + 4 * i] = from_float<T>(dk_acc[i] * pb.scale);
      dvp[cg + 4 * i] = from_float<T>(dv_acc[i]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 32 * (D + 1) + kBQ * kPP + 2 * kBQ);
}

// ---------------------------------------------------------------------------
// 3. dq.  Grid (ceil(Sq/32), H, B).  Thread t owns query row r = t / 4 and
//    dims cg + 4i of its dQ row; for the score tile it computes columns
//    cg + 4jj of row r.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, Problem pb, Strides st) {
  constexpr int DP = D + 1, NA = D / 4;
  extern __shared__ float smem[];
  float* Qs = smem;                // kBQ x DP
  float* dOs = Qs + kBQ * DP;      // kBQ x DP
  float* Ks = dOs + kBQ * DP;      // kBKV x DP
  float* Vs = Ks + kBKV * DP;      // kBKV x DP
  float* dSs = Vs + kBKV * DP;     // kBQ x kPP
  float* Ls = dSs + kBQ * kPP;     // kBQ
  float* Dl = Ls + kBQ;            // kBQ

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (pb.H / pb.Hk);
  const int tid = threadIdx.x, r = tid / 4, cg = tid % 4;
  const int off = pb.Skv - pb.Sq;
  const T* kp = k + b * st.v[SK] + hk * st.v[SK + 1];
  const T* vp = v + b * st.v[SV] + hk * st.v[SV + 1];
  load_tile<T, D>(Qs, q + b * st.v[SQ] + h * st.v[SQ + 1], st.v[SQ + 2], q0, pb.Sq);
  load_tile<T, D>(dOs, dout + b * st.v[SDO] + h * st.v[SDO + 1], st.v[SDO + 2], q0, pb.Sq);
  if (tid < kBQ) {
    const bool in = q0 + tid < pb.Sq;
    const long long base = ((long long)b * pb.H + h) * pb.Sq + q0 + tid;
    Ls[tid] = in ? lse[base] : 0.0f;
    Dl[tid] = in ? delta[base] : 0.0f;
  }

  // Key range that any row of this tile can see (as in K2).
  const int row_first = q0 + off;
  const int row_last = min(q0 + kBQ, pb.Sq) - 1 + off;
  const int kv_end = pb.causal ? min(pb.Skv, row_last + 1) : pb.Skv;
  const int kv_begin = pb.window > 0 ? max(0, row_first - pb.window + 1) : 0;

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;

  for (int j0 = (kv_begin / kBKV) * kBKV; j0 < kv_end; j0 += kBKV) {
    __syncthreads();  // Q, dO loaded; the previous tile's reads are done
    load_tile<T, D>(Ks, kp, st.v[SK + 2], j0, pb.Skv);
    load_tile<T, D>(Vs, vp, st.v[SV + 2], j0, pb.Skv);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kBKV / 4; ++jj) {
      const int c = cg + 4 * jj;
      float ds = 0.0f;
      if (live(pb, q0 + r, j0 + c)) {
        const float s = dot_rows<D>(&Qs[r * DP], &Ks[c * DP]) * pb.scale;
        const float dp = dot_rows<D>(&dOs[r * DP], &Vs[c * DP]);
        ds = expf(s - Ls[r]) * (dp - Dl[r]);
      }
      dSs[r * kPP + c] = ds;
    }
    __syncwarp();  // a row's dS values are written and read by the same warp
    for (int c = 0; c < kBKV; ++c) {
      const float ds = dSs[r * kPP + c];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = fmaf(ds, Ks[c * DP + cg + 4 * i], acc[i]);
    }
  }

  if (q0 + r < pb.Sq) {
    T* dqp = dq + b * st.v[SDQ] + h * st.v[SDQ + 1] + (q0 + r) * st.v[SDQ + 2];
#pragma unroll
    for (int i = 0; i < NA; ++i) dqp[cg + 4 * i] = from_float<T>(acc[i] * pb.scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
                   const void* dout, float* delta, void* dq, void* dk, void* dv, int B,
                   const Problem& pb, const Strides& st, cudaStream_t s) {
  const T* Q = static_cast<const T*>(q);
  const T* Kp = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* dO = static_cast<const T*>(dout);
  const long long rows = (long long)B * pb.H * pb.Sq;
  delta_kernel<T><<<(rows + 3) / 4, kThreads, 0, s>>>(static_cast<const T*>(o), dO, delta,
                                                        pb.H, pb.Sq, D, rows, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  constexpr size_t kv_smem = dkdv_smem_bytes<D>();
  if ((e = allow_smem(dkdv_kernel<T, D>, kv_smem)) != cudaSuccess) return e;
  dim3 kv_grid((pb.Skv + kBKV - 1) / kBKV, pb.Hk, B);
  dkdv_kernel<T, D><<<kv_grid, kThreads, kv_smem, s>>>(
      Q, Kp, V, dO, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), pb, st);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  constexpr size_t q_smem = dq_smem_bytes<D>();
  if ((e = allow_smem(dq_kernel<T, D>, q_smem)) != cudaSuccess) return e;
  dim3 q_grid((pb.Sq + kBQ - 1) / kBQ, pb.H, B);
  dq_kernel<T, D><<<q_grid, kThreads, q_smem, s>>>(Q, Kp, V, dO, lse, delta,
                                                   static_cast<T*>(dq), pb, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, const void* o,
                     const float* lse, const void* dout, float* delta, void* dq, void* dk,
                     void* dv, int B, const Problem& pb, const Strides& st, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, pb, st, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, pb, st, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, pb, st, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, pb, st, s);
    case 256: return launch<T, 256>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, pb, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Hk,Skv,D), o and do (B,H,Sq,D), dq (B,H,Sq,D), dk/dv
// (B,Hk,Skv,D), all of one dtype (bf16 if bf16_, else fp32) with unit
// stride over D; ``strides`` points to 24 host int64s: the (batch, head,
// seq) strides of q, k, v, o, do, dq, dk, dv in that order.  lse: K2's
// contiguous fp32 (B,H,Sq) row log-sum-exp; delta: contiguous fp32 (B,H,Sq)
// scratch.  window <= 0 means none.  Returns the first launch error.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* delta, void* dq,
                                   void* dk, void* dv, int bf16_, int B, int H, int Hk, int Sq,
                                   int Skv, int D, const long long* strides, int causal,
                                   int window, float scale, void* stream) {
  Strides st;
  for (int i = 0; i < 24; ++i) st.v[i] = strides[i];
  const Problem pb{H, Hk, Sq, Skv, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t e = bf16_ ? dispatch<bf16>(D, q, k, v, o, l, dout, dl, dq, dk, dv, B, pb, st, s)
                        : dispatch<float>(D, q, k, v, o, l, dout, dl, dq, dk, dv, B, pb, st, s);
  return static_cast<int>(e);
}
