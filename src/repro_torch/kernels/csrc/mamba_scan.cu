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
// the operations, about 25 N + 8 a channel-step at the fp32 rate (0.20
// ms); and the exponentials, B·L·D·N = 537 M a pass, 0.128 ms a pass on
// 132 SMs x 16 special-function results a clock at 1.98 GHz.  The states
// h_{t-1} the reverse walk needs are recomputed (keeping (B, L, D, N)
// would take 2.1 GB a layer), so the exponentials are paid more than once:
// two passes give a floor of 0.257 ms.  Each channel is a chain of L
// dependent steps forward and L back, so what the card is given to issue
// while a step waits on shared memory, a shuffle or an exponential sets
// the time: warps an SM, and no device-memory latency inside a step.
//
// What its design does about it:
// - Four states a thread: a channel's N states on N / 4 neighbouring lanes
//   (4 at N 16, 2 at N 8), a block of 128 threads owning 128 / LANES
//   channels of one row (32 at N 16), so falcon-mamba-7b's B 2 layer is
//   512 blocks and 4 of them (16 warps) fit an SM by shared memory and the
//   128 registers __launch_bounds__ grants: one wave.  The sums over a
//   channel's states (dx's and ddt's) are one fixed tree whichever lanes
//   hold them: groups of 4 states in order, the groups pairwise (the
//   forward's y), the last levels by shuffles.
// - The block walks the chunks of kSteps steps from the last to the first.
//   While it walks one, the next one's x, dt and dy rows are in flight by
//   16-byte cp.async into the other of two shared buffers, its B and C in
//   registers (widened to fp32 into shared memory after the walk: they are
//   column slices of the x projection, which 16-byte copies cannot read in
//   general) and its boundary state in registers: no step loop reads
//   device memory.
// - The chunk's states stay on chip.  The block walks the chunk forward
//   once from its boundary state to the states entering each sub-chunk of
//   kSub steps (into shared memory, each thread its own); then, for each
//   sub-chunk in reverse, it recomputes the sub-chunk's states and decays
//   in registers and walks back through them, its kSub steps unrolled and
//   unconditional so that they interleave (the last chunk's last sub-chunk
//   is padded with steps of x = dt = dy = 0, which change nothing).
//   Holding 8 steps' states in shared memory instead was no faster, and 8
//   steps in registers need 3 blocks an SM, which was slower.  The
//   recompute is the forward's arithmetic (the ex2 decay on A·log2 e,
//   __fmul_rn / __fmaf_rn as the forward rounds them), so its states are
//   bitwise the forward's.  A 32-step chunk costs 60 exponentials a state:
//   28 to the last sub-chunk's entry and 32 recomputed.
// - dB_t and dC_t (sums over D) without a reduction a step: each step
//   leaves its terms g dt x and dy h in shared memory; once a sub-chunk,
//   the block sums its channels' terms in one fixed order (four
//   interleaved runs over the channels, then (r0 + r1) + (r2 + r3)) into
//   its partial in device memory.  A second launch
//   (mamba_scan_bwd_combine_kernel) adds the channel blocks' partials in
//   block order: a last-block-to-finish combine inside the kernel
//   serialised the card on the few blocks that finished last (5.0 ms
//   against 1.38; PERF.md).  dA and dD (sums over B and L): each thread
//   sums its steps in registers and the second launch adds the rows in
//   row order.  No floating-point atomics: a row has the same bits at any
//   B, and two runs the same bits.
// - ddt is x Σ g B + Σ A g a h_{t-1}: Σ g B is dx's sum already, so a
//   state costs two operations fewer than Σ g (x B + A a h_{t-1}).
// - dx and ddt of a chunk collect in shared memory (every lane of a
//   channel stores the same value: no branch) and leave it in 16-byte
//   stores.
// - x, dt and dy are read in place through (batch, step) strides with a
//   unit stride along D, B and C through (batch, step, n) strides; dx,
//   ddt, dB and dC are written contiguous in the operands' type.  Rows the
//   16-byte copies cannot cover (a base, stride or D·size not a multiple
//   of 16 bytes) are staged and stored an element at a time.
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

// Steps of a chunk whose states and decays a thread holds in registers at
// once.  kernels/mamba_scan.py's SCAN_BWD_SUB mirrors it.
constexpr int kSub = 4;
// Blocks an SM the backward asks ptxas to keep resident (its register
// budget, 128 a thread): four, which its shared memory allows at N 16 in
// bf16.  kernels/mamba_scan.py's _BWD_MIN_BLOCKS mirrors it.
constexpr int kBwdMinBlocks = 4;

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
  float* pbc;          // (B, chunks, gx, kSteps, 2N): each block's dB, dC sums
  float* pa;           // (B, D, N + 1): each row's dA and dD
  int L, D;
  int vec;             // x, dt and dy rows take 16-byte copies
  long long xb, xl, db_, dl, bb, bl, bn, cb, cl, cn, yb, yl;   // element strides
};

// Shared memory of a backward block: 128 / (N / 4) channels, 4 states a
// thread.
template <typename T, int N>
struct BwdSmem {
  static constexpr int CH = kThreads / (N / 4);
  T xs[2][kSteps][CH];                 // x of two chunks
  T ds[2][kSteps][CH];                 // dt
  T ys[2][kSteps][CH];                 // dy
  T dxs[kSteps][CH];                   // the chunk's dx
  T dts[kSteps][CH];                   // its ddt
  float bc[kSteps][2 * N];             // the chunk's B then C, fp32
  float4 ent[kSteps / kSub - 1][kThreads];   // each thread's states entering sub-chunks 1, 2, ...
  float4 tb[kSub][kThreads];           // each thread's dB terms of the sub-chunk's steps
  float4 gap[4];                       // puts tc 16 banks from tb: the block sum reads both
  float4 tc[kSub][kThreads];           // its dC terms
};

__device__ __forceinline__ float4 pack4(const float (&v)[4]) { return make_float4(v[0], v[1], v[2], v[3]); }
__device__ __forceinline__ void unpack4(float (&v)[4], const float4 u) {
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ float4 add4(const float4 p, const float4 q) {
  return make_float4(__fadd_rn(p.x, q.x), __fadd_rn(p.y, q.y), __fadd_rn(p.z, q.z), __fadd_rn(p.w, q.w));
}
__device__ __forceinline__ float4 shfl_xor4(const float4 p, int o) {
  return make_float4(__shfl_xor_sync(0xffffffffu, p.x, o), __shfl_xor_sync(0xffffffffu, p.y, o),
                     __shfl_xor_sync(0xffffffffu, p.z, o), __shfl_xor_sync(0xffffffffu, p.w, o));
}

// Grid (ceil(D / CH), B), 128 threads, CH = 128 / (N / 4) channels a
// block.  Leaves dB and dC as each block's sums over its channels, dA and
// dD as each row's, for mamba_scan_bwd_combine_kernel.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
mamba_scan_bwd_kernel(const BwdArgs a) {
  using Smem = BwdSmem<T, N>;
  constexpr int LANES = N / 4, CH = Smem::CH, V = 2 * N, VX = 16 / sizeof(T);
  constexpr int BCR = kSteps * V / kThreads;   // B and C elements a thread stages
  static_assert(N % 4 == 0 && LANES <= 32 && CH % 4 == 0, "4 states a thread, whole warps");
  static_assert(BCR * kThreads == kSteps * V, "B and C stage in whole passes");
  static_assert(CH * sizeof(T) % 16 == 0, "a block's rows are whole 16-byte vectors");
  static_assert(kSub * V / 4 * 4 <= kThreads, "a sub-chunk's block sums take one pass");
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);

  const int tid = threadIdx.x, ch = tid / LANES, j = tid % LANES;
  const int b = blockIdx.y, bx = blockIdx.x, gx = gridDim.x;
  const int d0 = bx * CH, d = d0 + ch;
  const int nc = min(CH, a.D - d0);   // live channels of this block
  const bool live = ch < nc;
  const int L = a.L, chunks = (L + kSteps - 1) / kSteps;

  // Slots no copy writes read zero: a channel past the last one steps on
  // zeros from zero states (decay 1, terms 0) and stores nothing, and so
  // do the steps past L that pad the last chunk's last sub-chunk.
  for (int e = tid; e < 2 * kSteps * CH; e += kThreads) {
    (&sm.xs[0][0][0])[e] = from_float<T>(0.0f);
    (&sm.ds[0][0][0])[e] = from_float<T>(0.0f);
    (&sm.ys[0][0][0])[e] = from_float<T>(0.0f);
  }
  __syncthreads();   // before the copies into the same buffers
  float av[4], a2[4], g[4], dA[4];
  if (live) {
    load_states(av, a.a + (long long)d * N + j * 4);
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) av[s] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a2[s] = __fmul_rn(av[s], kLog2e);
    g[s] = 0.0f;
    dA[s] = 0.0f;
  }
  if (live && a.dhf != nullptr) load_states(g, a.dhf + ((long long)b * a.D + d) * N + j * 4);
  float dD = 0.0f;
  const float dsk = live ? a.dskip[d] : 0.0f;

  const T* xr = static_cast<const T*>(a.x) + b * a.xb + d0;
  const T* dr = static_cast<const T*>(a.dt) + b * a.db_ + d0;
  const T* yr = static_cast<const T*>(a.dy) + b * a.yb + d0;
  const T* br = static_cast<const T*>(a.b) + b * a.bb;
  const T* cr = static_cast<const T*>(a.c) + b * a.cb;
  const float* hbr = a.hb + ((long long)b * chunks * a.D + d) * N + j * 4;
  const bool vec_out = a.D * sizeof(T) % 16 == 0;

  // chunk i's x, dt and dy rows into buffer i % 2, one commit group
  auto stage = [&](int i) {
    const int t0 = i * kSteps, n = min(kSteps, L - t0), q = i & 1;
    T* xd = &sm.xs[q][0][0];
    T* dd = &sm.ds[q][0][0];
    T* yd = &sm.ys[q][0][0];
    if (a.vec) {
      const int nv = nc / VX;
      for (int e = tid; e < n * nv; e += kThreads) {
        const int t = e / nv, v = e % nv, o = t * CH + v * VX;
        cp_async16(smem_u32(xd + o), xr + (t0 + t) * a.xl + v * VX);
        cp_async16(smem_u32(dd + o), dr + (t0 + t) * a.dl + v * VX);
        cp_async16(smem_u32(yd + o), yr + (t0 + t) * a.yl + v * VX);
      }
    } else {
      for (int e = tid; e < n * nc; e += kThreads) {
        const int t = e / nc, k = e % nc, o = t * CH + k;
        xd[o] = xr[(t0 + t) * a.xl + k];
        dd[o] = dr[(t0 + t) * a.dl + k];
        yd[o] = yr[(t0 + t) * a.yl + k];
      }
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
      const int e = tid + r * kThreads, t = e / V, k = e % V;
      bcr[r] = t >= n ? from_float<T>(0.0f)
               : k < N ? br[(t0 + t) * a.bl + k * a.bn] : cr[(t0 + t) * a.cl + (k - N) * a.cn];
    }
  };
  auto widen = [&]() {
#pragma unroll
    for (int r = 0; r < BCR; ++r) (&sm.bc[0][0])[tid + r * kThreads] = to_float(bcr[r]);
  };
  // this thread's states entering chunk i
  auto bound = [&](float (&h)[4], int i) {
    if (live) {
      load_states(h, hbr + (long long)i * a.D * N);
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s) h[s] = 0.0f;
    }
  };

  float hcur[4], hnext[4];
  stage(chunks - 1);
  fetch(chunks - 1);
  widen();
  bound(hcur, chunks - 1);
  for (int i = chunks - 1; i >= 0; --i) {
    const int t0 = i * kSteps, n = min(kSteps, L - t0), q = i & 1;
    const bool more = i > 0;
    if (more) {
      stage(i - 1);   // its buffer was last read before the previous chunk's last barrier
      fetch(i - 1);
      bound(hnext, i - 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk i's x, dt, dy, B and C are in shared memory
    const T* xc = &sm.xs[q][0][ch];
    const T* dc = &sm.ds[q][0][ch];
    const T* yc = &sm.ys[q][0][ch];

    // One step of this thread's states, the forward's arithmetic:
    // h <- h a_t + (dt x) B_t with a_t = 2^(dt A log2 e).
    auto walk = [&](float (&h)[4], float (&dec)[4], int t) {
      const float xv = to_float(xc[t * CH]), dv = to_float(dc[t * CH]);
      float bv[4];
      load_states(bv, &sm.bc[t][j * 4]);
      decays(dec, a2, dv);
      const float dxv = __fmul_rn(dv, xv);
#pragma unroll
      for (int s = 0; s < 4; ++s) h[s] = __fmaf_rn(h[s], dec[s], __fmul_rn(dxv, bv[s]));
    };

    // The states entering each sub-chunk: one walk from the boundary state
    // to the last sub-chunk's first step, each thread into its own slots.
    const int subs = (n + kSub - 1) / kSub;
    {
      float h[4], dec[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) h[s] = hcur[s];
      for (int k = 1; k < subs; ++k) {
#pragma unroll
        for (int u = 0; u < kSub; ++u) walk(h, dec, (k - 1) * kSub + u);
        sm.ent[k - 1][tid] = pack4(h);
      }
    }

    float* part = a.pbc + (((long long)b * chunks + i) * gx + bx) * kSteps * V;
    for (int k = subs - 1; k >= 0; --k) {
      const int u0 = k * kSub, nk = min(kSub, n - u0);
      // Recompute the sub-chunk in registers: hs[u] enters step u0 + u,
      // hs[u + 1] leaves it, dec[u] is its decay.
      float hs[kSub + 1][4], dec[kSub][4];
      if (k == 0) {
#pragma unroll
        for (int s = 0; s < 4; ++s) hs[0][s] = hcur[s];
      } else {
        unpack4(hs[0], sm.ent[k - 1][tid]);
      }
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
#pragma unroll
        for (int s = 0; s < 4; ++s) hs[u + 1][s] = hs[u][s];
        walk(hs[u + 1], dec[u], u0 + u);
      }
      // Walk it back.  Every step runs, so the unrolled steps interleave: a
      // step past the chunk's end reads x = dt = dy = 0 and B = C = 0,
      // which leave g unchanged, add nothing to dA and dD, and leave terms
      // and rows that are never read.
#pragma unroll
      for (int u = kSub - 1; u >= 0; --u) {
        const int t = u0 + u;
        float bv[4], cv[4];
        load_states(bv, &sm.bc[t][j * 4]);
        load_states(cv, &sm.bc[t][N + j * 4]);
        const float xv = to_float(xc[t * CH]), dv = to_float(dc[t * CH]);
        const float dyv = to_float(yc[t * CH]);
        const float dxv = __fmul_rn(dv, xv);
        float vb[4], vc[4], pb = 0.0f, pd = 0.0f;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          g[s] = __fmaf_rn(dyv, cv[s], g[s]);
          vc[s] = __fmul_rn(dyv, hs[u + 1][s]);
          vb[s] = __fmul_rn(g[s], dxv);
          const float r = __fmul_rn(g[s], __fmul_rn(dec[u][s], hs[u][s]));   // g a_t h_{t-1}
          pb = s == 0 ? __fmul_rn(g[s], bv[s]) : __fmaf_rn(g[s], bv[s], pb);
          pd = s == 0 ? __fmul_rn(av[s], r) : __fmaf_rn(av[s], r, pd);
          dA[s] = __fmaf_rn(r, dv, dA[s]);
          g[s] = __fmul_rn(g[s], dec[u][s]);
        }
        const float gb = lanes_sum<LANES>(pb), gd = lanes_sum<LANES>(pd);
        dD = __fmaf_rn(dyv, xv, dD);
        // the channel's lanes hold the same sums and store the same values
        sm.dxs[t][ch] = from_float<T>(__fmaf_rn(dv, gb, __fmul_rn(dsk, dyv)));
        sm.dts[t][ch] = from_float<T>(__fmaf_rn(xv, gb, gd));
        sm.tb[u][tid] = pack4(vb);
        sm.tc[u][tid] = pack4(vc);
      }
      __syncthreads();   // every thread's dB and dC terms of the sub-chunk are in shared memory
      // The block's sums over its channels, 4 states at a time: thread
      // c * LANES + j's float4 holds channel c's states 4j..4j+3.  Each of
      // four neighbouring lanes runs over the channels c = r, r + 4, ...
      // in order, then they add (r0 + r1) + (r2 + r3).
      {
        const int task = tid / 4, r = tid % 4, u = task / (V / 4), grp = task % (V / 4);
        float4 run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (u < nk) {
          const float4* src = grp < LANES ? &sm.tb[u][grp] : &sm.tc[u][grp - LANES];
          run = src[r * LANES];
#pragma unroll
          for (int it = 1; it < CH / 4; ++it) run = add4(run, src[(r + 4 * it) * LANES]);
        }
        run = add4(run, shfl_xor4(run, 1));   // every lane: the shuffles need whole warps
        run = add4(run, shfl_xor4(run, 2));
        if (u < nk && r == 0) *reinterpret_cast<float4*>(part + (u0 + u) * V + grp * 4) = run;
      }
      __syncthreads();   // the sub-chunk's terms are read
    }

    // chunk i's dx and ddt rows
    {
      T* dxr = static_cast<T*>(a.dx) + ((long long)b * L + t0) * a.D + d0;
      T* dtr = static_cast<T*>(a.ddt) + ((long long)b * L + t0) * a.D + d0;
      const T* xo = &sm.dxs[0][0];
      const T* dO = &sm.dts[0][0];
      if (vec_out) {
        const int nv = nc / VX;
        for (int e = tid; e < n * nv; e += kThreads) {
          const int t = e / nv, v = e % nv, o = t * CH + v * VX;
          *reinterpret_cast<uint4*>(dxr + (long long)t * a.D + v * VX) = *reinterpret_cast<const uint4*>(xo + o);
          *reinterpret_cast<uint4*>(dtr + (long long)t * a.D + v * VX) = *reinterpret_cast<const uint4*>(dO + o);
        }
      } else {
        for (int e = tid; e < n * nc; e += kThreads) {
          const int t = e / nc, k = e % nc;
          dxr[(long long)t * a.D + k] = xo[t * CH + k];
          dtr[(long long)t * a.D + k] = dO[t * CH + k];
        }
      }
    }
    __syncthreads();   // chunk i's buffers are read
    if (more) {
      widen();
#pragma unroll
      for (int s = 0; s < 4; ++s) hcur[s] = hnext[s];
    }
  }

  if (live && a.dh0 != nullptr) store_states(a.dh0 + ((long long)b * a.D + d) * N + j * 4, g);
  if (live) {   // this row's dA and dD
    float* pa = a.pa + ((long long)b * a.D + d) * (N + 1);
#pragma unroll
    for (int s = 0; s < 4; ++s) pa[j * 4 + s] = dA[s];
    if (j == 0) pa[N] = dD;
  }
}

// The backward's second launch: grid (ceil(max(L·2N, D·(N + 1)) / 128), B
// + 1).  Item (t, k) of row b < B adds the channel blocks' dB/dC sums of
// its step in block order; item (d, k) of y = B adds the rows' dA/dD in
// row order.  No atomics: the same bits at any B and on every run.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_combine_kernel(const BwdArgs a, int gx) {
  constexpr int V = 2 * N;
  const int B = gridDim.y - 1, b = blockIdx.y, e = blockIdx.x * kThreads + threadIdx.x;
  if (b == B) {
    if (e >= a.D * (N + 1)) return;
    const int d = e / (N + 1), k = e % (N + 1);
    float sum = a.pa[e];
    for (int r = 1; r < B; ++r) sum = __fadd_rn(sum, a.pa[(long long)r * a.D * (N + 1) + e]);
    if (k < N) a.da[(long long)d * N + k] = sum;
    else a.dd[d] = sum;
    return;
  }
  if (e >= a.L * V) return;
  const int t = e / V, k = e % V, i = t / kSteps, chunks = (a.L + kSteps - 1) / kSteps;
  const float* p = a.pbc + ((long long)b * chunks + i) * gx * kSteps * V + (t % kSteps) * V + k;
  float sum = p[0];
#pragma unroll 8
  for (int jb = 1; jb < gx; ++jb) sum = __fadd_rn(sum, p[(long long)jb * kSteps * V]);
  const long long o = ((long long)b * a.L + t) * N;
  if (k < N) static_cast<T*>(a.db)[o + k] = from_float<T>(sum);
  else static_cast<T*>(a.dc)[o + k - N] = from_float<T>(sum);
}

template <typename T, int N>
cudaError_t launch_bwd(const BwdArgs& a, int B, cudaStream_t s) {
  constexpr size_t smem = sizeof(BwdSmem<T, N>);
  static_assert(smem <= kSmemLimit, "a backward block fits the SM");
  const auto kern = mamba_scan_bwd_kernel<T, N>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  constexpr int CH = BwdSmem<T, N>::CH;
  const int gx = (a.D + CH - 1) / CH;
  kern<<<dim3(gx, B), kThreads, smem, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int items = max(a.L * 2 * N, a.D * (N + 1));
  mamba_scan_bwd_combine_kernel<T, N><<<dim3((items + kThreads - 1) / kThreads, B + 1), kThreads, 0, s>>>(a, gx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(int N, const BwdArgs& a, int B, cudaStream_t s) {
  switch (N) {
    case 8: return launch_bwd<T, 8>(a, B, s);
    case 16: return launch_bwd<T, 16>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward's dynamic shared memory (what 0), registers a thread (1) or
// blocks resident an SM (2) at state size N in T, for the wrapper's check
// of its plan; -1 where it cannot say.
template <typename T, int N>
int bwd_info(int what) {
  const auto kern = mamba_scan_bwd_kernel<T, N>;
  constexpr int smem = static_cast<int>(sizeof(BwdSmem<T, N>));
  if (what == 0) return smem;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kern) != cudaSuccess) return -1;
  if (what == 1) return attr.numRegs;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
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

// The backward: two launches, the walk and the combine.  x, dt, b, c, a,
// dskip as mamba_scan's; hb (B, ceil(L / kSteps), D, N) fp32 contiguous,
// the states the forward stored; dy (B, L, D) in x's type by (batch, step)
// strides with a unit stride along D; dh_final (B, D, N) fp32 contiguous
// or null (zeros).  Writes dx, ddt (B, L, D) and db, dc (B, L, N)
// contiguous in x's type, da (D, N), dd (D,) and, when not null, dh0 (B,
// D, N) in fp32.  pbc (B · chunks · gx · kSteps · 2N floats, gx = ceil(D /
// (128 / (N / 4)))) and pa (B · D · (N + 1) floats) are workspaces.  vec:
// x, dt and dy have 16-byte aligned bases, (batch, step) strides and
// D·size (the cp.async copies read them), else 0.  The base of every fp32
// tensor is 16-byte aligned.  Returns the launches' cudaGetLastError().
extern "C" int mamba_scan_bwd(const void* x, const void* dt, const void* a, const void* b,
                              const void* c, const void* dskip, const void* hb, const void* dy,
                              const void* dhf, void* dx, void* ddt, void* db, void* dc, void* da,
                              void* dd, void* dh0, void* pbc, void* pa, int bf16_, int vec, int B,
                              int L, int D, int N, long long x_sb, long long x_sl, long long dt_sb,
                              long long dt_sl, long long b_sb, long long b_sl, long long b_sn,
                              long long c_sb, long long c_sl, long long c_sn, long long dy_sb,
                              long long dy_sl, void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs args{x, dt, static_cast<const float*>(a), b, c, static_cast<const float*>(dskip),
                     static_cast<const float*>(hb), dy, static_cast<const float*>(dhf), dx, ddt,
                     db, dc, static_cast<float*>(da), static_cast<float*>(dd),
                     static_cast<float*>(dh0), static_cast<float*>(pbc), static_cast<float*>(pa),
                     L, D, vec, x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl, b_sn, c_sb, c_sl, c_sn,
                     dy_sb, dy_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16_ ? dispatch_bwd<bf16>(N, args, B, s) : dispatch_bwd<float>(N, args, B, s);
  return static_cast<int>(e);
}

// Steps of a backward sub-chunk (kSub) and its register budget in blocks
// an SM (kBwdMinBlocks), for the wrapper's check of its plan.
extern "C" int mamba_scan_bwd_sub() { return kSub; }
extern "C" int mamba_scan_bwd_min_blocks() { return kBwdMinBlocks; }

// bwd_info at state size N (8 or 16) in bf16 (bf16_ != 0) or fp32; -1 for
// another N.
extern "C" int mamba_scan_bwd_info(int bf16_, int N, int what) {
  switch (N) {
    case 8: return bf16_ ? bwd_info<bf16, 8>(what) : bwd_info<float, 8>(what);
    case 16: return bf16_ ? bwd_info<bf16, 16>(what) : bwd_info<float, 16>(what);
    default: return -1;
  }
}
