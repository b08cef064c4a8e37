// K3: flash decode, one query token a (batch row, query head) against a
// dense KV cache, split over the key axis.
//
// Replaces repro/kernels/flash_attention.py:169 flash_decode_pallas
// (pallas_call at :240), which walks the cache in 128-key blocks down one
// (batch, head) grid row, carrying (m, l, acc) from block to block in VMEM.
// Semantics kept: q (B, H, D); caches (B, Hk, S, D) with any (batch, head,
// seq) strides and a unit stride over D; GQA query head h reads kv head
// h / (H/Hk); keys t < length[b] are live (length read from device memory,
// no host sync, clamped to S), and with a window only t >= length[b] -
// window; softmax in fp32 with the -1e30 fill, l floored at 1e-30, so a row
// with no live key gives 0.  Head dims 16 to 256, G = H/Hk <= 16 with
// G * D <= 2048, bf16 and fp32.
//
// What bounds it on an H100: every live K and V row is read once for the G
// query heads of its kv head at 2 flop per element, G/2 flop per byte in
// bf16, far under the card's ~295 flop/byte ridge: HBM bytes bound it
// (llama2-13b's decode at B 4, H 40, length 520, D 128 reads 42.6 MB, 12.7
// us at 3.35 TB/s).  Reaching that rate takes tens of KB of loads in flight
// on every SM; one block a (batch, kv head) gives 160 blocks for 132 SMs,
// each waiting on one tile of scalar loads at a time.
//
// What the design does about it: the key axis is cut into fixed chunks of
// kChunk keys, grid (chunks, Hk, B): 1440 blocks at the main row.  The
// chunk is a constant of this source, never a function of B, of the SM
// count or of the lengths, so a row has the same bits whatever batch it is
// decoded in.  A block copies its chunk's live K rows, then its live V rows,
// into shared memory with 16-byte cp.async loads, all in flight at once in
// two commit groups (the scores start when K has landed, V still in
// flight); a block whose chunk holds no live key issues no load.  The
// scores spread keys and D over all four warps (up to 8 lanes a key row,
// each lane 16-byte vectors 8 apart, so a quarter warp reads 128
// contiguous bytes and G = 1 keeps every lane busy); then one warp a head
// takes the chunk's softmax, and the block's (head, dim) pairs p @ V, all
// in fp32 on the SIMT cores: at G <= 16 that is at most 8 flop per byte,
// so the tensor cores would buy nothing.  Each block writes its fp32
// partial (m, l, acc) to the wrapper's workspace; the last block of a
// (batch, kv head) to arrive (an int counter in device memory, reset by
// that block) combines the chunks in chunk order:
//   m* = max m_c,  l = sum l_c e^(m_c - m*),  o = sum acc_c e^(m_c - m*) / max(l, 1e-30).
// No float atomics: the same inputs give the same bits, from run to run and
// at any B.  One launch a call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

// Keys a block: 64 beat 32 and 128 at llama2-13b's and gpt-j-6b's decode
// rows on an H100 (PERF.md).
// kernels/flash_attention.py's DECODE_CHUNK mirrors it and its wrapper
// checks it against flash_decode_chunk() once.
constexpr int kChunk = 64;
constexpr int kThreads = 128;
constexpr int kMaxG = 16;        // query heads a kv head
constexpr int kMaxPairs = 16;    // (head, dim) pairs a thread: G * D <= 2048
constexpr int kSmemLimit = 232448;
constexpr float kNegInf = -1e30f;
static_assert(kChunk % 32 == 0, "the softmax takes the chunk in whole warps");

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
// probabilities (G x kChunk fp32; in the combine each chunk's weight), the
// combine's l_c times that weight (G x kChunk fp32), and each head's m and l.
template <typename T, int D>
constexpr size_t smem_bytes(int G) {
  return sizeof(T) * (size_t)(G * D + 2 * kChunk * D) +
         sizeof(float) * (size_t)(2 * G * kChunk + 2 * G);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* length;
  void* o;
  float* ws;       // chunks > 1: the chunks' acc (B, Hk, chunks, G, D), then their (m, l)
  int* counters;   // chunks > 1: one zero int a (batch, kv head)
  int G, S, chunks, window;
  float scale;
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh;
};

// Grid (chunks, Hk, B), kThreads threads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const Args a) {
  using R = Rows<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.G;
  T* Qs = reinterpret_cast<T*>(smem);        // G x D
  T* Ks = Qs + G * D;                        // kChunk x D
  T* Vs = Ks + kChunk * D;                   // kChunk x D
  float* Ps = reinterpret_cast<float*>(Vs + kChunk * D);   // G x kChunk
  float* Lw = Ps + G * kChunk;               // G x kChunk
  float* Ms = Lw + G * kChunk;               // G
  float* Ls = Ms + G;                        // G
  __shared__ int last;

  const int chunk = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(max(a.length[b], 0), a.S);
  const int lo = a.window > 0 ? max(len - a.window, 0) : 0;
  const int c0 = chunk * kChunk;
  // the chunk's live keys, [beg, end) from c0
  const int beg = max(lo - c0, 0), end = min(len - c0, kChunk);

  float acc[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) acc[i] = 0.0f;

  if (beg < end) {
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + (long long)hk * G * a.q_sh;
    for (int i = tid; i < G * D; i += kThreads) Qs[i] = qp[(i / D) * a.q_sh + i % D];
    const char* kp = static_cast<const char*>(a.k) +
                     sizeof(T) * (b * a.k_sb + hk * a.k_sh + (long long)c0 * a.k_ss);
    const char* vp = static_cast<const char*>(a.v) +
                     sizeof(T) * (b * a.v_sb + hk * a.v_sh + (long long)c0 * a.v_ss);
    const int n = (end - beg) * R::NV;
    const uint32_t ks = smem_u32(Ks), vs = smem_u32(Vs);
    for (int i = tid; i < n; i += kThreads) {
      const int r = beg + i / R::NV, c = i % R::NV;
      cp_async16(ks + (r * R::NV + c) * 16, kp + sizeof(T) * r * a.k_ss + 16 * c);
    }
    cp_async_commit();
    for (int i = tid; i < n; i += kThreads) {
      const int r = beg + i / R::NV, c = i % R::NV;
      cp_async16(vs + (r * R::NV + c) * 16, vp + sizeof(T) * r * a.v_ss + 16 * c);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this thread's K copies have landed
    __syncthreads();      // and everyone's, and q

    // Scores: lane j of a row's L reads vectors j, j + L, ... of the key row
    // and of each head's q row; the L partial dots are summed by shuffles.
    const int j = tid % R::L;
    const uint4* K4 = reinterpret_cast<const uint4*>(Ks);
    const uint4* Q4 = reinterpret_cast<const uint4*>(Qs);
    for (int p0 = 0; p0 < kChunk; p0 += R::KP) {
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
        if (j == 0 && c < kChunk) Ps[g * kChunk + c] = live ? dot * a.scale : kNegInf;
      }
    }
    __syncthreads();

    // The chunk's softmax, a warp a head: m, p = e^(s - m) on live keys, l.
    for (int g = warp; g < G; g += kThreads / 32) {
      float* s = Ps + g * kChunk;
      float mx = kNegInf;
      for (int c = lane; c < kChunk; c += 32) mx = fmaxf(mx, s[c]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int c = lane; c < kChunk; c += 32) {
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
        const float* p = Ps + g * kChunk;
        float x = 0.0f;
#pragma unroll 8
        for (int c = beg; c < end; ++c) x = fmaf(p[c], to_float(Vs[c * D + d]), x);
        acc[i] = x;
      }
    }
  } else if (tid < G) {   // no live key: the empty partial
    Ms[tid] = kNegInf;
    Ls[tid] = 0.0f;
  }
  __syncthreads();

  T* op = static_cast<T*>(a.o) + b * a.o_sb + (long long)hk * G * a.o_sh;
  if (a.chunks == 1) {
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
  if (tid == 0) last = atomicAdd(a.counters + bh, 1) == a.chunks - 1;
  __syncthreads();
  if (!last) return;
  // The last chunk to arrive combines them all, with its loads in flight
  // together: m* of each head (a warp a head, lanes over the chunks); then,
  // kChunk chunks at a time, each (head, chunk)'s weight w_c = e^(m_c - m*)
  // (0 for an empty chunk, whose acc was never written) and l_c w_c into
  // shared memory, l summed in chunk order a thread a head, and each
  // (head, dim) pair's acc_c w_c summed in chunk order into X (the K tile's
  // shared memory, free now), 8 loads in flight.
  __threadfence();
  float* X = reinterpret_cast<float*>(Ks);   // G x D <= kChunk x D x sizeof(T) / 4
  for (int g = warp; g < G; g += kThreads / 32) {
    float mx = kNegInf;
    for (int c = lane; c < a.chunks; c += 32) mx = fmaxf(mx, __ldcg(ml + (c * G + g) * 2));
    mx = warp_max(mx);
    if (lane == 0) Ms[g] = mx;
  }
  for (int c0 = 0; c0 < a.chunks; c0 += kChunk) {
    const int nc = min(kChunk, a.chunks - c0);
    __syncthreads();   // m* is known; the last slab's weights and l are read
    for (int i = tid; i < G * nc; i += kThreads) {
      const int g = i / nc, j = i % nc, c = c0 + j;
      const float lc = __ldcg(ml + (c * G + g) * 2 + 1);
      const float w = lc > 0.0f ? expf(__ldcg(ml + (c * G + g) * 2) - Ms[g]) : 0.0f;
      Ps[g * kChunk + j] = w;
      Lw[g * kChunk + j] = lc * w;
    }
    __syncthreads();
    if (tid < G) {
      float l = c0 == 0 ? 0.0f : Ls[tid];
      for (int j = 0; j < nc; ++j) l += Lw[tid * kChunk + j];
      Ls[tid] = l;
    }
#pragma unroll 2
    for (int idx = tid; idx < G * D; idx += kThreads) {   // a thread keeps its pairs
      const float* w = Ps + (idx / D) * kChunk;
      const float* src = part + c0 * pairs + idx;
      float x = c0 == 0 ? 0.0f : X[idx];
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

template <typename T, int D>
cudaError_t launch(const Args& a, int B, int Hk, cudaStream_t s) {
  constexpr int max_g = kMaxG * D <= kMaxG * kThreads ? kMaxG : kMaxG * kThreads / D;
  constexpr size_t most = smem_bytes<T, D>(max_g);
  const size_t smem = smem_bytes<T, D>(a.G);
  if (smem > kSmemLimit) return cudaErrorInvalidConfiguration;
  const auto kern = flash_decode_split_kernel<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(most < kSmemLimit ? most : kSmemLimit));
  if (attr != cudaSuccess) return attr;
  kern<<<dim3(a.chunks, Hk, B), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const Args& a, int B, int Hk, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, Hk, s);
    case 32: return launch<T, 32>(a, B, Hk, s);
    case 64: return launch<T, 64>(a, B, Hk, s);
    case 128: return launch<T, 128>(a, B, Hk, s);
    case 256: return launch<T, 256>(a, B, Hk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,D) by (batch, head) strides; k/v caches (B,Hk,S,D) by (batch, head,
// seq) strides, unit stride over D, base and strides multiples of 16 bytes;
// length (B,) int32 on the device; o (B,H,D) by (batch, head) strides; bf16
// if bf16_ else fp32.  The key axis is cut into chunks = ceil(S / kChunk)
// blocks (1 for S = 0); with chunks > 1, ws holds B·H·chunks·(D + 2) floats
// and counters B·Hk zero ints, which the kernel leaves at zero.  window <= 0
// means none.  Returns the launch's cudaGetLastError().
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* length,
                            void* o, void* ws, void* counters, int bf16_, int B, int H, int Hk,
                            int S, int D, long long q_sb, long long q_sh, long long k_sb,
                            long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                            long long v_ss, long long o_sb, long long o_sh, int window,
                            float scale, void* stream) {
  const int G = Hk > 0 ? H / Hk : 0;
  const int chunks = S > 0 ? (S + kChunk - 1) / kChunk : 1;
  if (G < 1 || G > kMaxG || G * D > kMaxPairs * kThreads ||
      (chunks > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Args a{q, k, v, static_cast<const int*>(length), o, static_cast<float*>(ws),
               static_cast<int*>(counters), G, S, chunks, window, scale,
               q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16_ ? dispatch<bf16>(D, a, B, Hk, s) : dispatch<float>(D, a, B, Hk, s);
  return static_cast<int>(e);
}

// Keys a block (kChunk), for the wrapper's check of its plan.
extern "C" int flash_decode_chunk() { return kChunk; }
