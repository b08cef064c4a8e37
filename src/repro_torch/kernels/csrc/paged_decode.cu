// K4: paged decode attention: one query token per (slot, head) against
// token-major K/V page pools, read through the slots' page table.
//
// Replaces repro/kernels/ops.py::paged_decode_attention.  Its Pallas path
// gathers a head-major copy of every slot's pages, (B, maxp, ps, Hk, D) →
// (B, Hk, maxp*ps, D), and hands that copy to flash_decode_pallas
// (repro/kernels/flash_attention.py); this kernel reads the pages where they
// lie and makes no copy.  Semantics are those of
// repro/kernels/ref.py::paged_decode_attention_ref: pools (P+1, ps, Hk, D),
// the last row the trash page; page_table (B, maxp) int32; key position t of
// slot b is row (page_table[b, t / ps] * ps + t % ps) of the pool; keys
// t < length[b] are live (length read from device memory, no host sync), and
// with a window only t >= length[b] - window; GQA query head h reads kv head
// h / (H/Hk); online softmax in fp32 with -1e30 fill; l floored at 1e-30, so
// a slot with no live key gives 0.  A table column at or past
// ceil(length/ps) is never read, and page ids are clamped to [0, P] as the
// reference's gather clamps them.
//
// What bounds it on an H100: each live K and V row is read once and used for
// G = H/Hk query heads at 2 flop per element, about G/2 flop per byte in
// bf16, far under the card's ~295 flop/byte ridge: HBM bytes bound it.
//
// What the design does about it: one block per (slot, kv head) holds the
// whole GQA group, so every live K/V row is read from device memory once for
// all G heads; a key row is D contiguous elements (256 bytes for bf16 at
// D 128) and is read with 16-byte loads, so the table indirection costs one
// int32 read per key and no gather copy.  Scores and p @ V run in fp32 on
// the SIMT cores, like K3's; K3's fixed-chunk split over the KV length, its
// combine in chunk order and its asynchronous copies (csrc/flash_decode.cu)
// are still to come here (ROADMAP.md, Queue 2).  Head dims 16 to 256: at
// gpt-j-6b's D 256 (G = 1) a thread holds 2 of the 256 (head, dim) pairs and
// the block's shared memory is ~67 KB, over the 48 KB default, which
// `launch` raises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBKV = 32;          // keys per tile: one per lane when scoring
constexpr int kThreads = 128;
constexpr int kMaxG = 16;         // query heads per kv head in one block
constexpr int kMaxPairs = 16;     // (head, dim) pairs per thread: G * D <= 2048

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

// One 16-byte load of V = 16 / sizeof(T) elements, widened to fp32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
  }
};
template <> struct Vec<bf16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void load(const bf16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <int D>
size_t smem_bytes(int G) {
  return sizeof(float) * (G * D + kBKV * (D + 1) + kBKV * D + G * kBKV + 2 * G);
}

// Grid (Hk, B), 128 threads.  Warp w scores heads w, w+4, w+8, w+12 of the
// group, lane c key c of the tile; for p @ V thread t owns the (head, dim)
// pairs t, t+128, ... of the G x D output.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ table, const int* __restrict__ length,
                    T* __restrict__ o, int G, int Hk, int ps, int maxp, int last_page,
                    long long q_sb, long long q_sh, long long o_sb, long long o_sh, int window,
                    float scale) {
  constexpr int DP = D + 1, V = Vec<T>::V, VPR = D / V;  // 16-byte loads per key row
  extern __shared__ float smem[];
  __shared__ long long rows[kBKV];  // pool row of each key of the tile, -1 if not live
  float* Qs = smem;                 // G x D
  float* Ks = Qs + G * D;           // kBKV x DP
  float* Vs = Ks + kBKV * DP;       // kBKV x D
  float* Ps = Vs + kBKV * D;        // G x kBKV
  float* Al = Ps + G * kBKV;        // G: this tile's rescale factor per head
  float* Ls = Al + G;               // G: final softmax denominators

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(length[b], maxp * ps);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const T* qp = q + b * q_sb + (long long)hk * G * q_sh;
  const int* trow = table + (long long)b * maxp;

  for (int i = tid; i < G * D; i += kThreads) Qs[i] = to_float(qp[(i / D) * q_sh + i % D]);

  float m_run[kMaxG / 4], l_run[kMaxG / 4];
#pragma unroll
  for (int t = 0; t < kMaxG / 4; ++t) { m_run[t] = kNegInf; l_run[t] = 0.0f; }
  float acc[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) acc[i] = 0.0f;

  for (int j0 = (lo / kBKV) * kBKV; j0 < len; j0 += kBKV) {
    __syncthreads();  // Qs is loaded; the previous tile's reads are done
    if (tid < kBKV) {
      const int t = j0 + tid;
      long long r = -1;
      if (t >= lo && t < len) {
        const int page = min(max(trow[t / ps], 0), last_page);
        r = ((long long)page * ps + t % ps) * Hk + hk;
      }
      rows[tid] = r;
    }
    __syncthreads();
    for (int i = tid; i < kBKV * VPR; i += kThreads) {
      const int c = i / VPR, d0 = (i % VPR) * V;
      const long long r = rows[c];
      float kv[V], vv[V];
      if (r >= 0) {
        Vec<T>::load(k + r * D + d0, kv);
        Vec<T>::load(v + r * D + d0, vv);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) { kv[e] = 0.0f; vv[e] = 0.0f; }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        Ks[c * DP + d0 + e] = kv[e];
        Vs[c * D + d0 + e] = vv[e];
      }
    }
    __syncthreads();

    const bool live = rows[lane] >= 0;
#pragma unroll
    for (int t = 0; t < kMaxG / 4; ++t) {
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
    for (int i = 0; i < kMaxPairs; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G * D) {
        const int gi = idx / D, d = idx % D;
        float a = acc[i] * Al[gi];
        for (int c = 0; c < kBKV; ++c) a = fmaf(Ps[gi * kBKV + c], Vs[c * D + d], a);
        acc[i] = a;
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kMaxG / 4; ++t) {
    const int gi = warp + 4 * t;
    if (gi < G && lane == 0) Ls[gi] = l_run[t];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < G * D) {
      const int gi = idx / D, d = idx % D;
      o[b * o_sb + ((long long)hk * G + gi) * o_sh + d] =
          from_float<T>(acc[i] / fmaxf(Ls[gi], 1e-30f));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* table,
                   const int* length, void* o, int B, int H, int Hk, int ps, int maxp,
                   int last_page, const long long* st, int window, float scale,
                   cudaStream_t s) {
  const int G = H / Hk;
  const size_t smem = smem_bytes<D>(G);
  auto kern = paged_decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(Hk, B);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), table,
      length, static_cast<T*>(o), G, Hk, ps, maxp, last_page, st[0], st[1], st[2], st[3],
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, const int* table,
                     const int* length, void* o, int B, int H, int Hk, int ps, int maxp,
                     int last_page, const long long* st, int window, float scale,
                     cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, table, length, o, B, H, Hk, ps, maxp, last_page, st, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, table, length, o, B, H, Hk, ps, maxp, last_page, st, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, table, length, o, B, H, Hk, ps, maxp, last_page, st, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, table, length, o, B, H, Hk, ps, maxp, last_page, st, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, table, length, o, B, H, Hk, ps, maxp, last_page, st, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,D) by (batch, head) strides, unit stride over D; k/v pools
// contiguous (num_rows, ps, Hk, D) with 16-byte aligned bases; table
// contiguous (B, maxp) int32 and length (B,) int32, both on the device;
// o (B,H,D) by (batch, head) strides.  window <= 0 means none.  Returns the
// launch's cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* table, const void* length, void* o, int bf16_, int B,
                            int H, int Hk, int D, int ps, int maxp, int num_rows,
                            long long q_sb, long long q_sh, long long o_sb, long long o_sh,
                            int window, float scale, void* stream) {
  const long long st[4] = {q_sb, q_sh, o_sb, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(length);
  cudaError_t e =
      bf16_ ? dispatch<bf16>(D, q, k_pool, v_pool, tab, len, o, B, H, Hk, ps, maxp, num_rows - 1,
                             st, window, scale, s)
            : dispatch<float>(D, q, k_pool, v_pool, tab, len, o, B, H, Hk, ps, maxp, num_rows - 1,
                              st, window, scale, s);
  return static_cast<int>(e);
}
