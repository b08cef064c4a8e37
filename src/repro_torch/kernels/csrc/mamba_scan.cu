// K8: the selective scan of a Mamba-1 layer, prefill (L tokens) and decode
// (L = 1 from the cached state), as two kernels that
// kernels/mamba_scan.py's scan_plan names.
//
// Replaces repro/kernels/mamba_scan.py::mamba_scan_pallas.  Semantics are
// those of repro/kernels/ref.py::mamba_scan_ref: x, dt (B, L, D); A (D, N)
// fp32, the negative decay rates; B, C (B, L, N); D (D,) fp32; h0 (B, D, N)
// fp32 or none (zeros).  Per channel d and step t, in fp32:
//   h[n] <- h[n] * exp(dt A[d, n]) + (dt x) B[n],   y = sum_n h[n] C[n] + D[d] x,
// y stored in x's type, the final state h (B, D, N) in fp32.  x and dt are
// read in place through (batch, step) strides with a unit stride along D;
// B and C through (batch, step, n) strides: they are column slices of the
// x projection's output.
//
// What bounds it on an H100: each step of a channel does about 6 N flops
// and N exponentials against 6 bytes of x, dt and y in bf16, and the state
// stays on chip: HBM bytes give the least time, one read of x, dt, B, C and
// h0 and one write of y and h (0.031 ms for falcon-mamba-7b's B 4 x 512
// prefill).  The exponentials give a larger floor: B·L·D·N of them on 132
// SMs x 16 special-function results a clock (0.064 ms for that prefill at
// 1.98 GHz); and the L dependent steps of every channel bound a small
// batch's latency.
//
// What the design does about it:
// - The decay is one FMUL and one MUFU a state: e^(dt A) = 2^(dt A log2 e)
//   by ex2.approx.ftz.f32 on A·log2 e held in registers (2^0 is exactly 1,
//   so a padded step, dt = 0 and x = 0, leaves a state bitwise unchanged).
// - y's sum over the N states is one fixed tree (groups of 4 states summed
//   in order, the groups summed pairwise), whichever lanes hold the states,
//   and every product and sum is rounded as written (__fmul_rn, __fmaf_rn,
//   __fadd_rn): a row has the same bits at any B and under either variant.
// - prefill: a block owns 128 / LANES channels of one row for the whole
//   sequence, LANES threads a channel with N / LANES states each in
//   registers, and walks time in chunks of kSteps steps.  The chunk after
//   the one being stepped is in flight meanwhile: its x and dt rows by
//   16-byte cp.async into the other of two shared buffers, in their own
//   type, and its B and C in registers, widened to fp32 into shared memory
//   after the steps; each step reads its B and C as 16-byte shared loads
//   and writes y straight to device memory.  A block holds 20 KB (bf16,
//   LANES 2) to 36 KB (LANES 1) of shared memory, so falcon-mamba-7b's B 4
//   prefill is resident in one wave (scan_plan).  LANES is the plan's: 1
//   where the grid covers the card anyway (more states a thread, no
//   shuffles), 2 where a small batch needs the parallelism.
// - decode: no staging and no barrier; a thread loads its 4 states and
//   their 4 decay rates by 16-byte loads, x, dt, B and C directly, reduces
//   y over the channel's N / 4 lanes by shuffles and writes its states back
//   in place (h_out may be h0: the layer updates its cache).
// Each thread reads its own states of h0 before its first step and writes
// the same states of h_out after its last, so h_out may be h0 in both.
// For training the prefill also stores, when given a pointer, each
// thread's states entering every chunk of kSteps steps in fp32 (B,
// chunks, D, N): the boundary states the backward starts from.  A null
// pointer (serving) leaves the kernel's arithmetic, bits and launches as
// they were.
//
// The backward, mamba_scan_bwd_kernel, has no TPU counterpart: the
// reference differentiates its XLA scan (repro/kernels/ref.py
// mamba_scan_xla_chunked) and the Pallas scan has no VJP.  Per channel d,
// state n and step t, with a_t = exp(dt_t A) and g the carried dL/dh
// (dh_final, or 0), walking t backwards:
//   g += dy_t C_t;  dC_t = sum_d dy_t h_t;  dx_t = dt_t sum_n g B_t + D dy_t;
//   ddt_t = sum_n g (x_t B_t + A a_t h_{t-1});  dB_t = sum_d g dt_t x_t;
//   dA += g dt_t a_t h_{t-1};  dD += dy_t x_t;  then g <- a_t g; dh0 = g.
// (kernels/ref.py mamba_scan_bwd_ref is the same walk in plain PyTorch.)
//
// What bounds the backward on an H100, at falcon-mamba-7b's training layer
// (B 2, L 2048, D 8192, N 16, bf16): bytes, x, dt and dy read, dx and ddt
// written, the boundary states read (64 chunks of 1 MB), B, C, dB, dC,
// A, dA, D, dD, dh_final and dh0: about 0.40 GB, 0.12 ms at 3.35 TB/s;
// and the exponentials, B·L·D·N = 537 M a pass, 0.128 ms a pass on 132 SMs
// x 16 special-function results a clock at 1.98 GHz.  This kernel makes
// two passes (the recompute and the reverse walk), so its floor is 0.257
// ms.
//
// What its design does about it (a simple kernel first; PERF.md):
// - A block owns 128 channels of one row, one thread a channel with its N
//   states in registers (the forward's LANES 1), and walks the chunks from
//   the last to the first.  For each chunk it stages the chunk's B and C
//   in shared memory as fp32, recomputes the chunk's states from its
//   boundary state with the forward's own arithmetic (the ex2 decay on
//   A·log2 e, __fmul_rn / __fmaf_rn as the forward rounds them, so the
//   states are bitwise the forward's), storing each step's states in a
//   per-block workspace in device memory (kSteps x N x 128 fp32, 256 KB a
//   block at N 16: 32 MB for the whole grid at B 2, which L2 mostly
//   holds), and then walks the chunk backwards reading h_{t-1} from there
//   (the boundary state for the chunk's first step).  Cost: two
//   exponentials a state-step instead of one, and the workspace written and
//   read once (2 B·L·D·N·4 bytes, 4.3 GB at that layer, L2 traffic) where
//   keeping (B, L, D, N) would take 2.1 GB of device memory a layer.
// - No floating-point atomics.  dB_t and dC_t sum over D: each warp
//   reduces its 32 channels' 2N values by a butterfly that leaves one value
//   a lane (fixed lanes, fixed order), the four warps' sums are added in a
//   fixed tree after the chunk, and each block writes its partial for the
//   chunk's steps; the last block of a (row, chunk) to finish (an integer
//   counter) adds the partials of the row's channel blocks in block order
//   and writes dB and dC.  dA and dD sum over B and L: each thread sums its
//   channel's steps in registers, and the last block of a channel block
//   adds the rows' partials in row order.  A row has the same bits at any
//   B, and two runs the same bits.
// - x, dt and dy are read in place through (batch, step) strides with a
//   unit stride along D, B and C through (batch, step, n) strides (column
//   slices of the x projection); dx, ddt, dB and dC are written contiguous
//   in the operands' type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;     // a block, both variants
// Steps a prefill chunk stages.
// kernels/mamba_scan.py's SCAN_STEPS mirrors it and its wrapper checks it
// against mamba_scan_steps() once.
constexpr int kSteps = 32;
constexpr int kSmemLimit = 232448;
constexpr float kLog2e = 1.4426950408889634f;

// Blocks an SM the prefill on LANES asks ptxas to keep resident (its
// register budget): 264 blocks of 128 threads on 132 SMs at LANES 1, one
// wave of falcon-mamba-7b's B 4 prefill, and 528 at LANES 2.
// kernels/mamba_scan.py's _MIN_BLOCKS mirrors it and its wrapper checks it
// against mamba_scan_min_blocks() once.
template <int LANES> struct MinBlocks;
template <> struct MinBlocks<1> { static constexpr int value = 2; };
template <> struct MinBlocks<2> { static constexpr int value = 4; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const void* x;
  const void* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* dskip;
  const float* h0;
  void* y;
  float* hout;
  float* hb;      // (B, chunks, D, N): the states entering each chunk, or null
  int L, D;
  long long xb, xl, db, dl, bb, bl, bn, cb, cl, cn;   // element strides
};

// The decays of S consecutive states of a channel at one step: 2^(dt a2).
template <int S>
__device__ __forceinline__ void decays(float (&dec)[S], const float (&a2)[S], float dv) {
#pragma unroll
  for (int s = 0; s < S; ++s) dec[s] = ex2(__fmul_rn(dv, a2[s]));
}

// One step of those states from their decays: h <- h decay + (dt x) B, and
// this thread's part of y: each group of 4 states' h C summed in order, the
// groups summed pairwise.
template <int S>
__device__ __forceinline__ float step(float (&h)[S], const float (&dec)[S], float dx,
                                      const float* bv, const float* cv) {
  static_assert(S % 4 == 0, "states go in groups of 4");
  float p[S / 4];
#pragma unroll
  for (int s = 0; s < S; ++s) h[s] = __fmaf_rn(h[s], dec[s], __fmul_rn(dx, bv[s]));
#pragma unroll
  for (int g = 0; g < S / 4; ++g) {
    float q = __fmul_rn(h[4 * g], cv[4 * g]);
#pragma unroll
    for (int s = 1; s < 4; ++s) q = __fmaf_rn(h[4 * g + s], cv[4 * g + s], q);
    p[g] = q;
  }
#pragma unroll
  for (int w = 1; w < S / 4; w *= 2)
#pragma unroll
    for (int g = 0; g + w < S / 4; g += 2 * w) p[g] = __fadd_rn(p[g], p[g + w]);
  return p[0];
}

// The rest of the tree: the channel's LANES neighbouring lanes add their
// parts pairwise (a + b and b + a round alike).
template <int LANES>
__device__ __forceinline__ float lanes_sum(float p) {
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1) p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, o));
  return p;
}

template <int S>
__device__ __forceinline__ void load_states(float (&v)[S], const float* p) {
#pragma unroll
  for (int q = 0; q < S / 4; ++q) {
    const float4 u = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = u.x;
    v[4 * q + 1] = u.y;
    v[4 * q + 2] = u.z;
    v[4 * q + 3] = u.w;
  }
}

template <int S>
__device__ __forceinline__ void store_states(float* p, const float (&v)[S]) {
#pragma unroll
  for (int q = 0; q < S / 4; ++q)
    reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <typename T, int LANES>
constexpr size_t prefill_smem(int N) {
  return 2 * 2 * kSteps * (kThreads / LANES) * sizeof(T) + kSteps * 2 * N * sizeof(float);
}

// Grid (ceil(D / (128 / LANES)), B), 128 threads.  Shared memory: x and dt
// rows of two chunks in T ([2][kSteps][channels] each), then one chunk's B
// and C widened to fp32 ([kSteps][2N]: B then C of each step).
template <typename T, int N, int LANES>
__global__ void __launch_bounds__(kThreads, MinBlocks<LANES>::value)
mamba_scan_prefill_kernel(const Args a) {
  constexpr int S = N / LANES, CH = kThreads / LANES, VX = 16 / sizeof(T);
  constexpr int BCR = kSteps * 2 * N / kThreads;   // B and C elements a thread stages
  // steps unrolled: 2 at 16 states a thread, 4 below (measured, PERF.md)
  constexpr int UNROLL = LANES == 1 ? 2 : 4;
  static_assert(BCR * kThreads == kSteps * 2 * N, "B and C stage in whole passes");
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* ds = xs + 2 * kSteps * CH;
  float* bc = reinterpret_cast<float*>(ds + 2 * kSteps * CH);

  const int tid = threadIdx.x, ch = tid / LANES, j = tid % LANES;
  const int b = blockIdx.y, d0 = blockIdx.x * CH, d = d0 + ch;
  const int nc = min(CH, a.D - d0);   // live channels of this block
  const bool live = ch < nc;
  const int L = a.L;

  // Every thread runs every step (the shuffles need whole warps); a thread
  // past the last channel steps on zeros and stores nothing.
  float h[S], a2[S];
  const long long hoff = ((long long)b * a.D + d) * N + j * S;
  if (live && a.h0 != nullptr) {
    load_states(h, a.h0 + hoff);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) h[s] = 0.0f;
  }
  if (live) {
    load_states(a2, a.a + (long long)d * N + j * S);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) a2[s] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < S; ++s) a2[s] = __fmul_rn(a2[s], kLog2e);
  const float dsk = live ? a.dskip[d] : 0.0f;

  const T* xr = static_cast<const T*>(a.x) + b * a.xb + d0;
  const T* dr = static_cast<const T*>(a.dt) + b * a.db + d0;
  const T* br = static_cast<const T*>(a.b) + b * a.bb;
  const T* cr = static_cast<const T*>(a.c) + b * a.cb;
  T* yr = static_cast<T*>(a.y) + (long long)b * L * a.D + d;
  const int nv = nc / VX;   // 16-byte vectors of a staged row (D * sizeof(T) % 16 == 0)

  // chunk i's x and dt rows into buffer i % 2, one commit group
  auto stage = [&](int i) {
    const int t0 = i * kSteps, n = min(kSteps, L - t0);
    const uint32_t xo = smem_u32(xs + (i & 1) * kSteps * CH);
    const uint32_t dso = smem_u32(ds + (i & 1) * kSteps * CH);
    for (int e = tid; e < n * nv; e += kThreads) {
      const int t = e / nv, v = e % nv;
      cp_async16(xo + (t * CH + v * VX) * sizeof(T), xr + (t0 + t) * a.xl + v * VX);
      cp_async16(dso + (t * CH + v * VX) * sizeof(T), dr + (t0 + t) * a.dl + v * VX);
    }
    cp_async_commit();
  };
  // chunk i's B and C: element e = t * 2N + k of the chunk, thread tid
  // holding e = tid, tid + 128, ...
  T bcr[BCR];
  auto fetch = [&](int i) {
    const int t0 = i * kSteps, n = min(kSteps, L - t0);
#pragma unroll
    for (int r = 0; r < BCR; ++r) {
      const int e = tid + r * kThreads, t = e / (2 * N), k = e % (2 * N);
      bcr[r] = t >= n ? from_float<T>(0.0f)
               : k < N ? br[(t0 + t) * a.bl + k * a.bn] : cr[(t0 + t) * a.cl + (k - N) * a.cn];
    }
  };
  auto widen = [&]() {
#pragma unroll
    for (int r = 0; r < BCR; ++r) bc[tid + r * kThreads] = to_float(bcr[r]);
  };

  const int chunks = (L + kSteps - 1) / kSteps;
  stage(0);
  fetch(0);
  widen();
  for (int i = 0; i < chunks; ++i) {
    const int t0 = i * kSteps, n = min(kSteps, L - t0);
    const bool more = i + 1 < chunks;
    if (a.hb != nullptr && live)
      store_states(a.hb + (((long long)b * chunks + i) * a.D + d) * N + j * S, h);
    if (more) {
      stage(i + 1);   // its buffer was last read before the previous barrier
      fetch(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk i's x, dt, B and C are in shared memory
    const T* xc = xs + (i & 1) * kSteps * CH + ch;
    const T* dc = ds + (i & 1) * kSteps * CH + ch;
    T* yp = yr + (long long)t0 * a.D;
#pragma unroll UNROLL
    for (int t = 0; t < n; ++t) {
      const float xv = live ? to_float(xc[t * CH]) : 0.0f;
      const float dv = live ? to_float(dc[t * CH]) : 0.0f;
      float bv[S], cv[S], dec[S];
      load_states(bv, bc + t * 2 * N + j * S);
      load_states(cv, bc + t * 2 * N + N + j * S);
      decays(dec, a2, dv);
      const float p = lanes_sum<LANES>(step<S>(h, dec, __fmul_rn(dv, xv), bv, cv));
      if (live && j == 0) *yp = from_float<T>(__fmaf_rn(dsk, xv, p));
      yp += a.D;
    }
    __syncthreads();   // chunk i's buffers are read
    if (more) widen();
  }
  if (live) store_states(a.hout + hoff, h);
}

// Grid (ceil(D / (128 / LANES)), B), 128 threads, LANES = N / 4: a thread
// owns 4 states of one channel.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_decode_kernel(const Args a) {
  constexpr int LANES = N / 4, CH = kThreads / LANES;
  const int tid = threadIdx.x, ch = tid / LANES, j = tid % LANES;
  const int b = blockIdx.y, d = blockIdx.x * CH + ch;
  const bool live = d < a.D;
  float h[4] = {0.0f, 0.0f, 0.0f, 0.0f}, a2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float bv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float xv = 0.0f, dv = 0.0f, dsk = 0.0f;
  const long long hoff = ((long long)b * a.D + d) * N + j * 4;
  if (live) {
    if (a.h0 != nullptr) load_states(h, a.h0 + hoff);
    load_states(a2, a.a + (long long)d * N + j * 4);
    xv = to_float(static_cast<const T*>(a.x)[b * a.xb + d]);
    dv = to_float(static_cast<const T*>(a.dt)[b * a.db + d]);
    dsk = a.dskip[d];
    const T* br = static_cast<const T*>(a.b) + b * a.bb + j * 4 * a.bn;
    const T* cr = static_cast<const T*>(a.c) + b * a.cb + j * 4 * a.cn;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      bv[s] = to_float(br[s * a.bn]);
      cv[s] = to_float(cr[s * a.cn]);
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) a2[s] = __fmul_rn(a2[s], kLog2e);
  float dec[4];
  decays(dec, a2, dv);
  const float p = lanes_sum<LANES>(step<4>(h, dec, __fmul_rn(dv, xv), bv, cv));
  if (live) {
    store_states(a.hout + hoff, h);
    if (j == 0)
      static_cast<T*>(a.y)[(long long)b * a.D + d] = from_float<T>(__fmaf_rn(dsk, xv, p));
  }
}

template <typename T, int N, int LANES>
cudaError_t launch_prefill(const Args& a, int B, cudaStream_t s) {
  constexpr size_t smem = prefill_smem<T, LANES>(N);
  static_assert(smem <= kSmemLimit, "a prefill block fits the SM");
  const auto kern = mamba_scan_prefill_kernel<T, N, LANES>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  constexpr int CH = kThreads / LANES;
  kern<<<dim3((a.D + CH - 1) / CH, B), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch(const Args& a, int B, int lanes, cudaStream_t s) {
  if (a.L == 1) {
    if (lanes != N / 4) return cudaErrorInvalidValue;
    constexpr int CH = kThreads / (N / 4);
    mamba_scan_decode_kernel<T, N><<<dim3((a.D + CH - 1) / CH, B), kThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  switch (lanes) {
    case 1: return launch_prefill<T, N, 1>(a, B, s);
    case 2: return launch_prefill<T, N, 2>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int N, const Args& a, int B, int lanes, cudaStream_t s) {
  switch (N) {
    case 8: return launch<T, 8>(a, B, lanes, s);
    case 16: return launch<T, 16>(a, B, lanes, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The backward (see the header).
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void* x;
  const void* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* dskip;
  const float* hb;     // (B, chunks, D, N): the states entering each chunk
  const void* dy;
  const float* dhf;    // (B, D, N) or null
  void* dx;            // (B, L, D) in T, contiguous
  void* ddt;           // (B, L, D) in T, contiguous
  void* db;            // (B, L, N) in T, contiguous
  void* dc;            // (B, L, N) in T, contiguous
  float* da;           // (D, N)
  float* dd;           // (D,)
  float* dh0;          // (B, D, N) or null
  float4* ws;          // (B, gx, kSteps, N / 4, 128): each step's states
  float* pbc;          // (B, chunks, gx, kSteps, 2N): dB, dC partials
  float* pa;           // (B, D, N + 1): dA and dD partials
  int* cnt;            // B·chunks + gx counters, zero at the launch
  int L, D;
  long long xb, xl, db_, dl, bb, bl, bn, cb, cl, cn, yb, yl;   // element strides
};

// The butterfly that sums V values over a warp's 32 lanes and leaves one
// sum a lane: at offset O the lanes with bit O set keep the upper half of
// their W values and add their partner's upper half, the others the lower
// half; once one value is left the remaining offsets add it to the
// partner's (a + b and b + a round alike).  Lane l ends with the sum of
// value l >> (5 - log2 V), in one fixed order.
template <int W, int O, int V>
__device__ __forceinline__ void scatter(float (&v)[V], int lane) {
  if constexpr (O >= 1) {
    if constexpr (W > 1) {
      constexpr int H = W / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float send = up ? v[k] : v[k + H];
        const float keep = up ? v[k + H] : v[k];
        v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
      }
      scatter<H, O / 2, V>(v, lane);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], O));
      scatter<1, O / 2, V>(v, lane);
    }
  }
}

template <int N>
struct BwdSmem {
  float bc[kSteps][2 * N];                     // the chunk's B then C, fp32
  float red[kSteps][kThreads / 32][2 * N];     // each warp's dB, dC sums a step
  int last[4];                                 // [0]: this block finished last (16 bytes)
};

// Grid (ceil(D / 128), B), 128 threads, one a channel.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel(const BwdArgs a) {
  constexpr int V = 2 * N, W = kThreads / 32, Q = N / 4;
  constexpr int SHIFT = V == 32 ? 0 : 1;        // lane l holds value l >> SHIFT
  static_assert(V == 16 || V == 32, "N is 8 or 16");
  static_assert(W == 4, "four warps a block: their sums are added (w0 + w1) + (w2 + w3)");
  __shared__ __align__(16) BwdSmem<N> sm;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, bx = blockIdx.x, gx = gridDim.x, B = gridDim.y;
  const int d = bx * kThreads + tid;
  const bool live = d < a.D;
  const int L = a.L, chunks = (L + kSteps - 1) / kSteps;

  float av[N], a2[N], g[N], dA[N];
  if (live) {
    load_states(av, a.a + (long long)d * N);
  } else {
#pragma unroll
    for (int s = 0; s < N; ++s) av[s] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < N; ++s) {
    a2[s] = __fmul_rn(av[s], kLog2e);
    g[s] = 0.0f;
    dA[s] = 0.0f;
  }
  if (live && a.dhf != nullptr) load_states(g, a.dhf + ((long long)b * a.D + d) * N);
  float dD = 0.0f;
  const float dsk = live ? a.dskip[d] : 0.0f;

  const T* xr = static_cast<const T*>(a.x) + b * a.xb + d;
  const T* dr = static_cast<const T*>(a.dt) + b * a.db_ + d;
  const T* yr = static_cast<const T*>(a.dy) + b * a.yb + d;
  const T* br = static_cast<const T*>(a.b) + b * a.bb;
  const T* cr = static_cast<const T*>(a.c) + b * a.cb;
  T* dxr = static_cast<T*>(a.dx) + (long long)b * L * a.D + d;
  T* dtr = static_cast<T*>(a.ddt) + (long long)b * L * a.D + d;
  float4* ws = a.ws + ((long long)b * gx + bx) * kSteps * Q * kThreads + tid;

  for (int i = chunks - 1; i >= 0; --i) {
    const int t0 = i * kSteps, n = min(kSteps, L - t0);
    __syncthreads();   // the previous chunk's B, C and warp sums are read
    for (int e = tid; e < kSteps * V; e += kThreads) {
      const int t = e / V, k = e % V;
      sm.bc[t][k] = t >= n ? 0.0f
                    : k < N ? to_float(br[(t0 + t) * a.bl + k * a.bn])
                            : to_float(cr[(t0 + t) * a.cl + (k - N) * a.cn]);
    }
    __syncthreads();

    // Recompute the chunk's states from its boundary state, the forward's
    // arithmetic step for step, each step's states into the workspace.
    const float* hbp = a.hb + (((long long)b * chunks + i) * a.D + d) * N;
    float h[N];
    if (live) {
      load_states(h, hbp);
    } else {
#pragma unroll
      for (int s = 0; s < N; ++s) h[s] = 0.0f;
    }
    for (int t = 0; t < n; ++t) {
      const float xv = live ? to_float(xr[(t0 + t) * a.xl]) : 0.0f;
      const float dv = live ? to_float(dr[(t0 + t) * a.dl]) : 0.0f;
      float dec[N];
      decays(dec, a2, dv);
      const float dxv = __fmul_rn(dv, xv);
#pragma unroll
      for (int s = 0; s < N; ++s) h[s] = __fmaf_rn(h[s], dec[s], __fmul_rn(dxv, sm.bc[t][s]));
#pragma unroll
      for (int q = 0; q < Q; ++q)
        ws[(t * Q + q) * kThreads] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    }

    // Walk the chunk backwards: h holds h_t, hp becomes h_{t-1}.
    for (int t = n - 1; t >= 0; --t) {
      float hp[N];
      if (t > 0) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float4 u = ws[((t - 1) * Q + q) * kThreads];
          hp[4 * q] = u.x;
          hp[4 * q + 1] = u.y;
          hp[4 * q + 2] = u.z;
          hp[4 * q + 3] = u.w;
        }
      } else if (live) {
        load_states(hp, hbp);
      } else {
#pragma unroll
        for (int s = 0; s < N; ++s) hp[s] = 0.0f;
      }
      const float xv = live ? to_float(xr[(t0 + t) * a.xl]) : 0.0f;
      const float dv = live ? to_float(dr[(t0 + t) * a.dl]) : 0.0f;
      const float dyv = live ? to_float(yr[(t0 + t) * a.yl]) : 0.0f;
      float dec[N];
      decays(dec, a2, dv);
      const float dxv = __fmul_rn(dv, xv);
      float v[V];            // this channel's dB (first N) and dC terms
      float gb = 0.0f, gd = 0.0f;
#pragma unroll
      for (int s = 0; s < N; ++s) {
        const float bv = sm.bc[t][s], cv = sm.bc[t][N + s];
        g[s] = __fmaf_rn(dyv, cv, g[s]);
        v[N + s] = __fmul_rn(dyv, h[s]);
        v[s] = __fmul_rn(g[s], dxv);
        const float p = __fmul_rn(dec[s], hp[s]);                    // a_t h_{t-1}
        gb = __fmaf_rn(g[s], bv, gb);
        gd = __fmaf_rn(g[s], __fmaf_rn(xv, bv, __fmul_rn(av[s], p)), gd);
        dA[s] = __fmaf_rn(__fmul_rn(g[s], p), dv, dA[s]);
        g[s] = __fmul_rn(g[s], dec[s]);
        h[s] = hp[s];
      }
      dD = __fmaf_rn(dyv, xv, dD);
      if (live) {
        dxr[(long long)(t0 + t) * a.D] = from_float<T>(__fmaf_rn(dv, gb, __fmul_rn(dsk, dyv)));
        dtr[(long long)(t0 + t) * a.D] = from_float<T>(gd);
      }
      scatter<V, 16, V>(v, lane);
      if ((lane & ((1 << SHIFT) - 1)) == 0) sm.red[t][warp][lane >> SHIFT] = v[0];
    }
    __syncthreads();   // every warp's sums of the chunk are in shared memory

    // This block's partial of dB_t and dC_t, then the row's last block to
    // finish the chunk adds the channel blocks' partials in block order.
    float* part = a.pbc + ((long long)b * chunks + i) * gx * kSteps * V;
    for (int e = tid; e < n * V; e += kThreads) {
      const int t = e / V, k = e % V;
      part[(long long)bx * kSteps * V + e] =
          __fadd_rn(__fadd_rn(sm.red[t][0][k], sm.red[t][1][k]),
                    __fadd_rn(sm.red[t][2][k], sm.red[t][3][k]));
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) sm.last[0] = atomicAdd(a.cnt + (long long)b * chunks + i, 1) == gx - 1;
    __syncthreads();
    if (sm.last[0]) {
      __threadfence();
      for (int e = tid; e < n * V; e += kThreads) {
        const int t = e / V, k = e % V;
        float sum = __ldcg(part + e);
        for (int j = 1; j < gx; ++j) sum = __fadd_rn(sum, __ldcg(part + (long long)j * kSteps * V + e));
        const long long o = ((long long)b * L + t0 + t) * N;
        if (k < N) static_cast<T*>(a.db)[o + k] = from_float<T>(sum);
        else static_cast<T*>(a.dc)[o + k - N] = from_float<T>(sum);
      }
    }
  }

  if (live && a.dh0 != nullptr) store_states(a.dh0 + ((long long)b * a.D + d) * N, g);
  // dA and dD: this row's partial, then the channel block's last row to
  // finish adds the rows' partials in row order.
  if (live) {
    float* pa = a.pa + ((long long)b * a.D + d) * (N + 1);
#pragma unroll
    for (int s = 0; s < N; ++s) pa[s] = dA[s];
    pa[N] = dD;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sm.last[0] = atomicAdd(a.cnt + (long long)B * chunks + bx, 1) == B - 1;
  __syncthreads();
  if (sm.last[0] && live) {
    __threadfence();
#pragma unroll
    for (int s = 0; s <= N; ++s) {
      float sum = __ldcg(a.pa + (long long)d * (N + 1) + s);
      for (int r = 1; r < B; ++r)
        sum = __fadd_rn(sum, __ldcg(a.pa + ((long long)r * a.D + d) * (N + 1) + s));
      if (s < N) a.da[(long long)d * N + s] = sum;
      else a.dd[d] = sum;
    }
  }
}

template <typename T>
cudaError_t dispatch_bwd(int N, const BwdArgs& a, int B, cudaStream_t s) {
  const dim3 grid((a.D + kThreads - 1) / kThreads, B);
  switch (N) {
    case 8: mamba_scan_bwd_kernel<T, 8><<<grid, kThreads, 0, s>>>(a); break;
    case 16: mamba_scan_bwd_kernel<T, 16><<<grid, kThreads, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x, dt (B, L, D) and b, c (B, L, N) of one type (bf16 when bf16_ != 0,
// else fp32): x and dt by (batch, step) element strides with a unit stride
// along D (for L > 1 a 16-byte aligned base, strides and D·size, which the
// cp.async copies read), b and c by (batch, step, n) element strides; a
// (D, N), dskip (D,), h0 (B, D, N) or null, contiguous fp32 with 16-byte
// aligned bases; y (B, L, D) contiguous in x's type and hout (B, D, N)
// contiguous fp32 (may be h0); hb (B, ceil(L / kSteps), D, N) contiguous
// fp32 with a 16-byte aligned base, or null: the prefill stores there the
// states entering each chunk (the decode kernel ignores it).  N is 8 (the
// reduced configs) or 16.  L = 1 runs the decode kernel (lanes must be N /
// 4), L > 1 the prefill kernel on `lanes` threads a channel (1 or 2).
// Returns the launch's cudaGetLastError().
extern "C" int mamba_scan(const void* x, const void* dt, const void* a, const void* b,
                          const void* c, const void* dskip, const void* h0, void* y, void* hout,
                          void* hb, int bf16_, int B, int L, int D, int N, int lanes, long long x_sb,
                          long long x_sl, long long dt_sb, long long dt_sl, long long b_sb,
                          long long b_sl, long long b_sn, long long c_sb, long long c_sl,
                          long long c_sn, void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x, dt, static_cast<const float*>(a), b, c, static_cast<const float*>(dskip),
                  static_cast<const float*>(h0), y, static_cast<float*>(hout),
                  static_cast<float*>(hb), L, D,
                  x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl, b_sn, c_sb, c_sl, c_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16_ ? dispatch<bf16>(N, args, B, lanes, s)
                              : dispatch<float>(N, args, B, lanes, s);
  return static_cast<int>(e);
}

// Steps a prefill chunk stages (kSteps), for the wrapper's check of its plan.
extern "C" int mamba_scan_steps() { return kSteps; }

// Blocks an SM the prefill on `lanes` threads a channel keeps resident
// (MinBlocks), for the same check; 0 for a lane count it does not run.
extern "C" int mamba_scan_min_blocks(int lanes) {
  switch (lanes) {
    case 1: return MinBlocks<1>::value;
    case 2: return MinBlocks<2>::value;
    default: return 0;
  }
}

// The backward.  x, dt, b, c, a, dskip as mamba_scan's; hb (B, ceil(L /
// kSteps), D, N) fp32 contiguous, the states the forward stored; dy (B, L,
// D) in x's type by (batch, step) strides with a unit stride along D;
// dh_final (B, D, N) fp32 contiguous or null (zeros).  Writes dx, ddt (B,
// L, D) and db, dc (B, L, N) contiguous in x's type, da (D, N), dd (D,)
// and, when not null, dh0 (B, D, N) in fp32.  ws (B · ceil(D / 128) ·
// kSteps · N · 128 floats), pbc (B · chunks · ceil(D / 128) · kSteps · 2N
// floats) and pa (B · D · (N + 1) floats) are workspaces, cnt (B · chunks +
// ceil(D / 128) int32s) counters that must be zero.  The base of every
// fp32 tensor is 16-byte aligned.  Returns the launch's
// cudaGetLastError().
extern "C" int mamba_scan_bwd(const void* x, const void* dt, const void* a, const void* b,
                              const void* c, const void* dskip, const void* hb, const void* dy,
                              const void* dhf, void* dx, void* ddt, void* db, void* dc, void* da,
                              void* dd, void* dh0, void* ws, void* pbc, void* pa, void* cnt,
                              int bf16_, int B, int L, int D, int N, long long x_sb,
                              long long x_sl, long long dt_sb, long long dt_sl, long long b_sb,
                              long long b_sl, long long b_sn, long long c_sb, long long c_sl,
                              long long c_sn, long long dy_sb, long long dy_sl, void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs args{x, dt, static_cast<const float*>(a), b, c, static_cast<const float*>(dskip),
                     static_cast<const float*>(hb), dy, static_cast<const float*>(dhf), dx, ddt,
                     db, dc, static_cast<float*>(da), static_cast<float*>(dd),
                     static_cast<float*>(dh0), static_cast<float4*>(ws), static_cast<float*>(pbc),
                     static_cast<float*>(pa), static_cast<int*>(cnt), L, D,
                     x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl, b_sn, c_sb, c_sl, c_sn, dy_sb, dy_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16_ ? dispatch_bwd<bf16>(N, args, B, s) : dispatch_bwd<float>(N, args, B, s);
  return static_cast<int>(e);
}

// The backward's static shared memory at state size N (bf16 and fp32
// alike), for the wrapper's check of its plan; -1 for another N.
extern "C" int mamba_scan_bwd_smem(int N) {
  cudaFuncAttributes attr;
  cudaError_t e;
  switch (N) {
    case 8: e = cudaFuncGetAttributes(&attr, mamba_scan_bwd_kernel<bf16, 8>); break;
    case 16: e = cudaFuncGetAttributes(&attr, mamba_scan_bwd_kernel<bf16, 16>); break;
    default: return -1;
  }
  return e == cudaSuccess ? static_cast<int>(attr.sharedSizeBytes) : -1;
}
