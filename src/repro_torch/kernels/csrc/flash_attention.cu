// K2: flash attention forward (prefill) and K3: flash decode (one query token
// against a dense KV cache).
//
// K2 replaces repro/kernels/flash_attention.py::flash_attention_pallas (the
// kernel derived from the chained-root TppGraph; its hand-written spec is
// _legacy_flash_attention_pallas).  K3 replaces flash_decode_pallas in the
// same file.  Semantics kept from both: q (B,H,Sq,D), k/v (B,Hk,Skv,D), GQA
// query head h reads kv head h / (H/Hk); scale given by the caller (1/sqrt(D)
// by default); causal and window masks aligned at the ends
// (row i sits at key position i + Skv - Sq); wholly masked key blocks are
// skipped; online softmax keeps fp32 (m, l, acc) with -1e30 fill; l is
// floored at 1e-30, so a row with every key masked gives 0.  For training,
// K2 also writes each row's log-sum-exp of its scaled, masked scores,
// m + log(l) (-inf for a row with every key masked), to an optional fp32
// (B, H, Sq) buffer: the K6 backward (flash_attention_bwd.cu) recomputes
// the probabilities from it.  K3 reads each
// batch row's valid length from device memory (no host sync) and an optional
// window keeps keys with index >= length - window.
//
// What bounds them on an H100: K2 at the main-path shape (B 4, H 40, S 512,
// D 128, causal, bf16) does ~11 GFLOP on ~84 MB of q, k, v and o, about 128
// flop/byte, under the card's ~295 flop/byte ridge in bf16: bytes bound it
// at this length, operations from about S = 1200 on.  K3 reads the cache
// once per token at ~1 flop/byte: bytes bound it.
//
// What the design does about it: K2 keeps a 32-row query tile and streams
// 32-key tiles of K and V through shared memory as fp32, never writing the
// score matrix to device memory; each 4-thread group owns one query row, so
// the row max and sum are two shuffles.  K3 gives one block to each
// (batch, kv head) and puts all H/Hk query heads of the group in it, so every
// key and value row is read from device memory once for the whole group.
// Both compute in fp32 on the SIMT cores: a first, simple version; tensor
// cores (wgmma) and split-KV decode are for the PR that makes them fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// K2: prefill flash attention.  Grid (ceil(Sq/32), H, B), 128 threads.
// ---------------------------------------------------------------------------
constexpr int kBQ = 32, kBKV = 32, kAttnThreads = 128;

template <int D>
constexpr size_t attn_smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBKV * (D + 1) + kBKV * D + kBQ * (kBKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
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
  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + hk * k_sh;
  const T* vp = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < kBQ * D; i += kAttnThreads) {
    const int rr = i / D, d = i % D;
    Qs[rr * DP + d] = (q0 + rr < Sq) ? to_float(qp[(q0 + rr) * q_ss + d]) : 0.0f;
  }

  // Key range that any row of this tile can see; blocks outside it are skipped.
  const int row_first = q0 + off;
  const int row_last = min(q0 + kBQ, Sq) - 1 + off;
  const int kv_end = causal ? min(Skv, row_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, row_first - window + 1) : 0;

  const int qpos = q0 + r + off;  // this row's key-aligned position
  float m = kNegInf, l = 0.0f;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;

  for (int j0 = (kv_begin / kBKV) * kBKV; j0 < kv_end; j0 += kBKV) {
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    for (int i = tid; i < kBKV * D; i += kAttnThreads) {
      const int c = i / D, d = i % D;
      const bool in = j0 + c < Skv;
      Ks[c * DP + d] = in ? to_float(kp[(j0 + c) * k_ss + d]) : 0.0f;
      Vs[c * D + d] = in ? to_float(vp[(j0 + c) * v_ss + d]) : 0.0f;
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
    T* op = o + b * o_sb + h * o_sh + (q0 + r) * o_ss;
#pragma unroll
    for (int i = 0; i < NA; ++i) op[cg + 4 * i] = from_float<T>(acc[i] * inv);
    if (lse != nullptr && cg == 0)
      lse[((long long)b * H + h) * Sq + q0 + r] = l > 0.0f ? m + logf(l) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// K3: flash decode.  Grid (Hk, B), 128 threads; the G = H/Hk query heads of a
// kv head share the block.  Warp w owns heads w, w+4, w+8, w+12 (G <= 16) and
// lane c scores key c of the tile; for p @ V thread t owns the (head, dim)
// pairs t, t+128, ... of the G x D output (G*D <= 2048).
// ---------------------------------------------------------------------------
constexpr int kDecThreads = 128, kDecMaxPairs = 16, kDecMaxG = 16;

template <int D>
size_t decode_smem_bytes(int G) {
  return sizeof(float) * (G * D + kBKV * (D + 1) + kBKV * D + G * kBKV + 2 * G);
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ length, T* __restrict__ o, int G, int S,
                    long long q_sb, long long q_sh, long long k_sb, long long k_sh,
                    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                    long long o_sb, long long o_sh, int window, float scale) {
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // G x D
  float* Ks = Qs + G * D;       // kBKV x DP
  float* Vs = Ks + kBKV * DP;   // kBKV x D
  float* Ps = Vs + kBKV * D;    // G x kBKV
  float* Al = Ps + G * kBKV;    // G: this tile's rescale factor per head
  float* Ls = Al + G;           // G: final softmax denominators

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(length[b], S);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const T* qp = q + b * q_sb + (long long)hk * G * q_sh;
  const T* kp = k + b * k_sb + hk * k_sh;
  const T* vp = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < G * D; i += kDecThreads)
    Qs[i] = to_float(qp[(i / D) * q_sh + i % D]);

  float m_run[kDecMaxG / 4], l_run[kDecMaxG / 4];
#pragma unroll
  for (int t = 0; t < kDecMaxG / 4; ++t) { m_run[t] = kNegInf; l_run[t] = 0.0f; }
  float acc[kDecMaxPairs];
#pragma unroll
  for (int i = 0; i < kDecMaxPairs; ++i) acc[i] = 0.0f;

  for (int j0 = (lo / kBKV) * kBKV; j0 < len; j0 += kBKV) {
    __syncthreads();  // Qs is loaded; the previous tile's reads are done
    for (int i = tid; i < kBKV * D; i += kDecThreads) {
      const int c = i / D, d = i % D;
      const bool in = j0 + c < S;
      Ks[c * DP + d] = in ? to_float(kp[(j0 + c) * k_ss + d]) : 0.0f;
      Vs[c * D + d] = in ? to_float(vp[(j0 + c) * v_ss + d]) : 0.0f;
    }
    __syncthreads();

    const int col = j0 + lane;
    const bool live = col < len && col >= lo;
#pragma unroll
    for (int t = 0; t < kDecMaxG / 4; ++t) {
      const int gi = warp + 4 * t;
      if (gi < G) {
        float dot = 0.0f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(Qs[gi * D + d], Ks[lane * DP + d], dot);
        const float s = live ? dot * scale : kNegInf;
        const float m_new = fmaxf(m_run[t], warp_max(s));
        const float alpha = expf(m_run[t] - m_new);
        const float p = live ? expf(s - m_new) : 0.0f;
        l_run[t] = l_run[t] * alpha + warp_sum(p);
        m_run[t] = m_new;
        Ps[gi * kBKV + lane] = p;
        if (lane == 0) Al[gi] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kDecMaxPairs; ++i) {
      const int idx = tid + i * kDecThreads;
      if (idx < G * D) {
        const int gi = idx / D, d = idx % D;
        float a = acc[i] * Al[gi];
        for (int c = 0; c < kBKV; ++c) a = fmaf(Ps[gi * kBKV + c], Vs[c * D + d], a);
        acc[i] = a;
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kDecMaxG / 4; ++t) {
    const int gi = warp + 4 * t;
    if (gi < G && lane == 0) Ls[gi] = l_run[t];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kDecMaxPairs; ++i) {
    const int idx = tid + i * kDecThreads;
    if (idx < G * D) {
      const int gi = idx / D, d = idx % D;
      o[b * o_sb + ((long long)hk * G + gi) * o_sh + d] =
          from_float<T>(acc[i] / fmaxf(Ls[gi], 1e-30f));
    }
  }
}

template <typename T, int D>
cudaError_t launch_attention(const void* q, const void* k, const void* v, void* o, float* lse,
                             int B, int H,
                             int Hk, int Sq, int Skv, const long long* st, int causal,
                             int window, float scale, cudaStream_t s) {
  constexpr size_t smem = attn_smem_bytes<D>();
  auto kern = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kAttnThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Hk, Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const int* length,
                          void* o, int B, int H, int Hk, int S, const long long* st, int window,
                          float scale, cudaStream_t s) {
  const int G = H / Hk;
  const size_t smem = decode_smem_bytes<D>(G);
  auto kern = flash_decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(Hk, B);
  kern<<<grid, kDecThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), length,
      static_cast<T*>(o), G, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_attention(int D, const void* q, const void* k, const void* v, void* o,
                               float* lse, int B, int H, int Hk, int Sq, int Skv, const long long* st,
                               int causal, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch_attention<T, 16>(q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
    case 32: return launch_attention<T, 32>(q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
    case 64: return launch_attention<T, 64>(q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
    case 128: return launch_attention<T, 128>(q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
    case 256: return launch_attention<T, 256>(q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_decode(int D, const void* q, const void* k, const void* v,
                            const int* length, void* o, int B, int H, int Hk, int S,
                            const long long* st, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch_decode<T, 16>(q, k, v, length, o, B, H, Hk, S, st, window, scale, s);
    case 32: return launch_decode<T, 32>(q, k, v, length, o, B, H, Hk, S, st, window, scale, s);
    case 64: return launch_decode<T, 64>(q, k, v, length, o, B, H, Hk, S, st, window, scale, s);
    case 128: return launch_decode<T, 128>(q, k, v, length, o, B, H, Hk, S, st, window, scale, s);
    case 256: return launch_decode<T, 256>(q, k, v, length, o, B, H, Hk, S, st, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Hk,Skv,D), o (B,H,Sq,D), each given by its (batch,
// head, seq) strides with unit stride over D; bf16 if bf16 else fp32.
// lse: a contiguous fp32 (B,H,Sq) buffer for each row's log-sum-exp, or
// null.  window <= 0 means none.  Returns the launch's cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                               int bf16_,
                               int B, int H, int Hk, int Sq, int Skv, int D, long long q_sb,
                               long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                               long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                               long long o_sb, long long o_sh, long long o_ss, int causal,
                               int window, float scale, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t e = bf16_ ? dispatch_attention<bf16>(D, q, k, v, o, l, B, H, Hk, Sq, Skv, st, causal, window, scale, s)
                        : dispatch_attention<float>(D, q, k, v, o, l, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
  return static_cast<int>(e);
}

// q (B,H,D) by (batch, head) strides; k/v caches (B,Hk,S,D) by (batch, head,
// seq) strides; length (B,) int32 on the device; o (B,H,D) by (batch, head)
// strides.  window <= 0 means none.  Returns the launch's cudaGetLastError().
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* length,
                            void* o, int bf16_, int B, int H, int Hk, int S, int D,
                            long long q_sb, long long q_sh, long long k_sb, long long k_sh,
                            long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                            long long o_sb, long long o_sh, int window, float scale,
                            void* stream) {
  const long long st[10] = {q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  cudaError_t e = bf16_ ? dispatch_decode<bf16>(D, q, k, v, len, o, B, H, Hk, S, st, window, scale, s)
                        : dispatch_decode<float>(D, q, k, v, len, o, B, H, Hk, S, st, window, scale, s);
  return static_cast<int>(e);
}
