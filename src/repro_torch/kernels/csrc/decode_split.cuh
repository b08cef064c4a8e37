// The split-KV decode stream that K3 (csrc/flash_decode.cu, a dense cache)
// and K4 (csrc/paged_decode.cu, page pools read through a page table) both
// run: one query token a (batch row, query head), the key axis cut into
// fixed chunks of Chunk key positions, grid (chunks, Hk, B).
//
// A block copies its chunk's live K rows, then its live V rows, into shared
// memory with 16-byte cp.async loads, all in flight at once in two commit
// groups (the scores start when K has landed, V still in flight); a block
// whose chunk holds no live key does nothing more.  Where a key row lies is
// the caller's: a KV policy gives the address of row r of the chunk
// (`k_row`, `v_row`) after `prepare` (K4 looks its chunk's rows up in the
// page table there).  The scores spread keys and D over all four warps (up
// to 8 lanes a key row, each lane 16-byte vectors 8 apart, so a quarter
// warp reads 128 contiguous bytes and G = 1 keeps every lane busy); then
// one warp a head takes the chunk's softmax, and the block's (head, dim)
// pairs p @ V, all in fp32 on the SIMT cores: at G <= 16 that is at most 8
// flop per byte, so the tensor cores would buy nothing.  Each block writes
// its fp32 partial (m, l, acc) to the wrapper's workspace; the last of the
// live blocks of a (batch, kv head) to arrive (an int counter in device
// memory, reset by that block) combines the live chunks in chunk order (a
// row with one live chunk is written by its block directly):
//   m* = max m_c,  l = sum l_c e^(m_c - m*),  o = sum acc_c e^(m_c - m*) / max(l, 1e-30).
// No float atomics: the same inputs give the same bits, from run to run and
// at any B.  One launch a call.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

namespace split {

constexpr int kThreads = 128;
constexpr int kMaxG = 16;        // query heads a kv head
constexpr int kMaxPairs = 16;    // (head, dim) pairs a thread: G * D <= 2048
constexpr int kSmemLimit = 232448;
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

// The 16 / sizeof(T) elements of one 16-byte vector, widened to fp32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16-byte copy from device memory into shared memory, past L1.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A device integer that is int32 or int64, by a flag.
__device__ __forceinline__ long long load_index(const void* p, long long i, bool is64) {
  return is64 ? static_cast<const long long*>(p)[i] : static_cast<const int*>(p)[i];
}

// How a block's threads cover a key row of D elements: NV 16-byte vectors,
// L lanes a row (VPT vectors a lane, L apart), KP rows a pass.
template <typename T, int D>
struct Rows {
  static constexpr int EPV = Vec<T>::N;
  static constexpr int NV = D / EPV;
  static constexpr int L = NV < 8 ? NV : 8;
  static constexpr int VPT = NV / L;
  static constexpr int KP = kThreads / L;
};

// q, the chunk's K and V rows (T), the chunk's scores and then its
// probabilities (G x Chunk fp32; in the combine each chunk's weight), the
// combine's l_c times that weight (G x Chunk fp32), and each head's m and l.
template <typename T, int D, int Chunk>
constexpr size_t smem_bytes(int G) {
  return sizeof(T) * (size_t)(G * D + 2 * Chunk * D) +
         sizeof(float) * (size_t)(2 * G * Chunk + 2 * G);
}

// The largest group one block takes at head dim D, and its shared bytes.
template <typename T, int D, int Chunk>
constexpr size_t most_smem() {
  return smem_bytes<T, D, Chunk>(kMaxG * D <= kMaxG * kThreads ? kMaxG : kMaxG * kThreads / D);
}

// What every split decode reads besides its keys and values.
struct Common {
  const void* q;
  void* o;
  float* ws;       // chunks > 1: the chunks' acc (B, Hk, chunks, G, D), then their (m, l)
  int* counters;   // chunks > 1: one zero int a (batch, kv head)
  int G, chunks, window;
  float scale;
  long long q_sb, q_sh, o_sb, o_sh;
};

// The block (chunk, hk, b) of a grid (chunks, Hk, B), kThreads threads, with
// len live key positions in its (batch row, kv head) (the window's taken
// off here).  KV gives the rows: prepare(c0, beg, end) once before the
// copies (then a barrier if KV::kPrepares), k_row(r) and v_row(r) the
// addresses of key position c0 + r.
template <typename T, int D, int Chunk, typename KV>
__device__ __forceinline__ void split_decode(const Common& a, const KV& kv, int len) {
  static_assert(Chunk % 32 == 0, "the softmax takes the chunk in whole warps");
  using R = Rows<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.G;
  T* Qs = reinterpret_cast<T*>(smem);        // G x D
  T* Ks = Qs + G * D;                        // Chunk x D
  T* Vs = Ks + Chunk * D;                    // Chunk x D
  float* Ps = reinterpret_cast<float*>(Vs + Chunk * D);   // G x Chunk
  float* Lw = Ps + G * Chunk;                // G x Chunk
  float* Ms = Lw + G * Chunk;                // G
  float* Ls = Ms + G;                        // G
  __shared__ int last;

  const int chunk = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lo = a.window > 0 ? max(len - a.window, 0) : 0;
  // the chunks holding live keys, [c_lo, c_hi); the others do nothing
  const int c_lo = lo / Chunk, c_hi = (len + Chunk - 1) / Chunk, nlive = c_hi - c_lo;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + (long long)hk * G * a.o_sh;
  if (nlive <= 0) {   // no live key: the row is 0 (the l floor), written by chunk 0
    if (chunk == 0)
      for (int idx = tid; idx < G * D; idx += kThreads)
        op[(idx / D) * a.o_sh + idx % D] = from_float<T>(0.0f);
    return;
  }
  if (chunk < c_lo || chunk >= c_hi) return;
  const int c0 = chunk * Chunk;
  // the chunk's live keys, [beg, end) from c0, not empty
  const int beg = max(lo - c0, 0), end = min(len - c0, Chunk);

  float acc[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) acc[i] = 0.0f;

  {
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + (long long)hk * G * a.q_sh;
    for (int i = tid; i < G * D; i += kThreads) Qs[i] = qp[(i / D) * a.q_sh + i % D];
    kv.prepare(c0, beg, end);
    if (KV::kPrepares) __syncthreads();
    const int n = (end - beg) * R::NV;
    const uint32_t ks = smem_u32(Ks), vs = smem_u32(Vs);
    for (int i = tid; i < n; i += kThreads) {
      const int r = beg + i / R::NV, c = i % R::NV;
      cp_async16(ks + (r * R::NV + c) * 16, kv.k_row(r) + 16 * c);
    }
    cp_async_commit();
    for (int i = tid; i < n; i += kThreads) {
      const int r = beg + i / R::NV, c = i % R::NV;
      cp_async16(vs + (r * R::NV + c) * 16, kv.v_row(r) + 16 * c);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this thread's K copies have landed
    __syncthreads();      // and everyone's, and q

    // Scores: lane j of a row's L reads vectors j, j + L, ... of the key row
    // and of each head's q row; the L partial dots are summed by shuffles.
    const int j = tid % R::L;
    const uint4* K4 = reinterpret_cast<const uint4*>(Ks);
    const uint4* Q4 = reinterpret_cast<const uint4*>(Qs);
    for (int p0 = 0; p0 < Chunk; p0 += R::KP) {
      const int c = p0 + tid / R::L;
      const bool live = c >= beg && c < end;
      float kf[R::VPT * R::EPV];
#pragma unroll
      for (int i = 0; i < R::VPT; ++i) {
        const uint4 u = live ? K4[c * R::NV + j + R::L * i] : make_uint4(0u, 0u, 0u, 0u);
        Vec<T>::widen(u, kf + i * R::EPV);
      }
      for (int g = 0; g < G; ++g) {
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < R::VPT; ++i) {
          float qf[R::EPV];
          Vec<T>::widen(Q4[g * R::NV + j + R::L * i], qf);
#pragma unroll
          for (int e = 0; e < R::EPV; ++e) dot = fmaf(qf[e], kf[i * R::EPV + e], dot);
        }
#pragma unroll
        for (int o = R::L / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (j == 0 && c < Chunk) Ps[g * Chunk + c] = live ? dot * a.scale : kNegInf;
      }
    }
    __syncthreads();

    // The chunk's softmax, a warp a head: m, p = e^(s - m) on live keys, l.
    for (int g = warp; g < G; g += kThreads / 32) {
      float* s = Ps + g * Chunk;
      float mx = kNegInf;
      for (int c = lane; c < Chunk; c += 32) mx = fmaxf(mx, s[c]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int c = lane; c < Chunk; c += 32) {
        const float p = c >= beg && c < end ? expf(s[c] - mx) : 0.0f;
        s[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        Ms[g] = mx;
        Ls[g] = sum;
      }
    }
    cp_async_wait<0>();   // this thread's V copies have landed
    __syncthreads();

    // p @ V: thread t owns the (head, dim) pairs t, t + 128, ... of G x D.
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        const float* p = Ps + g * Chunk;
        float x = 0.0f;
#pragma unroll 8
        for (int c = beg; c < end; ++c) x = fmaf(p[c], to_float(Vs[c * D + d]), x);
        acc[i] = x;
      }
    }
  }
  __syncthreads();

  if (nlive == 1) {   // the only live chunk writes the row

#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G * D)
        op[(idx / D) * a.o_sh + idx % D] = from_float<T>(acc[i] / fmaxf(Ls[idx / D], 1e-30f));
    }
    return;
  }

  const int bh = b * gridDim.y + hk;
  const size_t pairs = (size_t)G * D;
  float* part = a.ws + (size_t)bh * a.chunks * pairs;   // this (batch, kv head)'s acc partials
  float* ml = a.ws + (size_t)gridDim.z * gridDim.y * a.chunks * pairs +
              (size_t)bh * a.chunks * G * 2;            // and its (m, l) pairs
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < G * D) __stcg(part + chunk * pairs + idx, acc[i]);
  }
  if (tid < G) {
    __stcg(ml + (chunk * G + tid) * 2, Ms[tid]);
    __stcg(ml + (chunk * G + tid) * 2 + 1, Ls[tid]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.counters + bh, 1) == nlive - 1;
  __syncthreads();
  if (!last) return;
  // The last live chunk to arrive combines them all, with its loads in
  // flight together: m* of each head (a warp a head, lanes over the
  // chunks); then, Chunk chunks at a time, each (head, chunk)'s weight w_c =
  // e^(m_c - m*) and l_c w_c into shared memory, l summed in chunk order a
  // thread a head, and each (head, dim) pair's acc_c w_c summed in chunk
  // order into X (the K tile's shared memory, free now), 8 loads in flight.
  __threadfence();
  float* X = reinterpret_cast<float*>(Ks);   // G x D <= Chunk x D x sizeof(T) / 4
  for (int g = warp; g < G; g += kThreads / 32) {
    float mx = kNegInf;
    for (int c = c_lo + lane; c < c_hi; c += 32) mx = fmaxf(mx, __ldcg(ml + (c * G + g) * 2));
    mx = warp_max(mx);
    if (lane == 0) Ms[g] = mx;
  }
  for (int c0 = c_lo; c0 < c_hi; c0 += Chunk) {
    const int nc = min(Chunk, c_hi - c0);
    __syncthreads();   // m* is known; the last slab's weights and l are read
    for (int i = tid; i < G * nc; i += kThreads) {
      const int g = i / nc, j = i % nc, c = c0 + j;
      const float lc = __ldcg(ml + (c * G + g) * 2 + 1);
      const float w = lc > 0.0f ? expf(__ldcg(ml + (c * G + g) * 2) - Ms[g]) : 0.0f;
      Ps[g * Chunk + j] = w;
      Lw[g * Chunk + j] = lc * w;
    }
    __syncthreads();
    if (tid < G) {
      float l = c0 == c_lo ? 0.0f : Ls[tid];
      for (int j = 0; j < nc; ++j) l += Lw[tid * Chunk + j];
      Ls[tid] = l;
    }
#pragma unroll 2
    for (int idx = tid; idx < G * D; idx += kThreads) {   // a thread keeps its pairs
      const float* w = Ps + (idx / D) * Chunk;
      const float* src = part + c0 * pairs + idx;
      float x = c0 == c_lo ? 0.0f : X[idx];
      for (int j0 = 0; j0 < nc; j0 += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = j0 + u < nc && w[j0 + u] > 0.0f ? __ldcg(src + (j0 + u) * pairs) : 0.0f;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (j0 + u < nc) x = fmaf(v[u], w[j0 + u], x);
      }
      X[idx] = x;
    }
  }
  __syncthreads();   // every head's l
  for (int idx = tid; idx < G * D; idx += kThreads)
    op[(idx / D) * a.o_sh + idx % D] = from_float<T>(X[idx] / fmaxf(Ls[idx / D], 1e-30f));
  if (tid == 0) a.counters[bh] = 0;
}

// Whether a call's group of G query heads at head dim D fits one block.
__host__ __forceinline__ bool fits(int G, int D) {
  return G >= 1 && G <= kMaxG && G * D <= kMaxPairs * kThreads;
}

}  // namespace split
}  // namespace
