// K8: the selective scan of a Mamba-1 layer, prefill (L tokens) and decode
// (L = 1 from the cached state) alike.
//
// Replaces repro/kernels/mamba_scan.py::mamba_scan_pallas.  Semantics are
// those of repro/kernels/ref.py::mamba_scan_ref: x, dt (B, L, D); A (D, N)
// fp32, the negative decay rates; B, C (B, L, N); D (D,) fp32; h0 (B, D, N)
// fp32 or none (zeros).  Per channel d and step t, in fp32:
//   h[n] <- h[n] * exp(dt A[d, n]) + (dt x) B[n],   y = sum_n h[n] C[n] + D[d] x,
// y stored in x's type, the final state h (B, D, N) in fp32.  x, dt, B and C
// are read in place through (batch, step) strides with a unit stride along
// their last axis: B and C are column slices of the x projection's output.
//
// What bounds it on an H100: each step of a channel does about 6 N flops
// (and N exponentials) against 6 bytes of x, dt and y in bf16, 16 flop/byte
// at N = 16, far under the card's ~295 flop/byte ridge, and the state stays
// on chip: HBM bytes bound it, one read of x, dt, B, C and h0 and one write
// of y and h.  Two floors sit near that bound: the N exponentials per
// channel-step on the special-function units, and the L dependent steps of
// every channel.
//
// What the design does about it: the TPU kernel keeps the (D, N) state in
// VMEM across a sequential grid axis of time chunks; no state survives
// between blocks here, so one block owns 32 channels of one row for the
// whole sequence and walks time in a loop.  Four threads share a channel,
// N / 4 states each in registers, and add their parts of y with two warp
// shuffles, so a batch-1 prefill of 8192 channels still runs 256 blocks of
// 128 threads.  A chunk of 64 steps of x and dt (32 channels) and of B and
// C is staged in shared memory with the block's threads reading along the
// unit-stride axes, then consumed step by step; y goes back through shared
// memory the same way.  Each lane's states are contiguous in h0 and h, so
// the state moves as 16-byte runs, which is all decode (L = 1) reads.  A
// thread reads its own states of h0 before its first step and writes the
// same states of hout after its last, so hout may be h0: decode updates the
// cache's state in place.
// Decay factors use expf (not __expf) on fp32 states.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kLanes = 4;                    // threads sharing one channel's states
constexpr int kChannels = 32;                // channels per block
constexpr int kThreads = kLanes * kChannels;
constexpr int kChunk = 64;                   // steps staged in shared memory at once

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// Element strides (batch, step) of x, dt, B and C.
struct Strides {
  long long xb, xl, db, dl, bb, bl, cb, cl;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ a,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  const float* __restrict__ dskip, const float* h0,
                  T* __restrict__ y, float* hout, int L, int D, Strides st) {
  constexpr int S = N / kLanes;              // states per thread
  __shared__ float xs[kChunk][kChannels];
  __shared__ float ds[kChunk][kChannels];
  __shared__ float ys[kChunk][kChannels];
  __shared__ float bs[kChunk][N];
  __shared__ float cs[kChunk][N];

  const int tid = threadIdx.x;
  const int ch = tid / kLanes, lane = tid % kLanes;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + ch;
  const int nc = min(kChannels, D - d0);     // live channels of this block
  const bool live = ch < nc;

  // Every thread runs every step (the shuffles need whole warps); a thread
  // past the last channel computes on zeros and stores nothing.
  float h[S], av[S];
  const long long hoff = ((long long)b * D + d) * N + lane * S;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    av[s] = live ? a[(long long)d * N + lane * S + s] : 0.f;
    h[s] = (live && h0 != nullptr) ? h0[hoff + s] : 0.f;
  }
  const float dsk = live ? dskip[d] : 0.f;

  const T* xr = x + b * st.xb + d0;
  const T* dr = dt + b * st.db + d0;
  const T* br = bm + b * st.bb;
  const T* cr = cm + b * st.cb;
  T* yr = y + (long long)b * L * D + d0;

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int n = min(kChunk, L - t0);
    for (int i = tid; i < n * kChannels; i += kThreads) {
      const int t = i / kChannels, c = i % kChannels;
      float xv = 0.f, dv = 0.f;
      if (c < nc) {
        xv = to_float(xr[(t0 + t) * st.xl + c]);
        dv = to_float(dr[(t0 + t) * st.dl + c]);
      }
      xs[t][c] = xv;
      ds[t][c] = dv;
    }
    for (int i = tid; i < n * N; i += kThreads) {
      const int t = i / N, k = i % N;
      bs[t][k] = to_float(br[(t0 + t) * st.bl + k]);
      cs[t][k] = to_float(cr[(t0 + t) * st.cl + k]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float xv = xs[t][ch], dv = ds[t][ch];
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int k = lane * S + s;
        h[s] = h[s] * expf(dv * av[s]) + dx * bs[t][k];
        acc += h[s] * cs[t][k];
      }
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) ys[t][ch] = acc + dsk * xv;
    }
    __syncthreads();
    // The next chunk's loads write xs, ds, bs and cs only; its steps write
    // ys after the barrier that follows those loads.
    for (int i = tid; i < n * kChannels; i += kThreads) {
      const int t = i / kChannels, c = i % kChannels;
      if (c < nc) yr[(long long)(t0 + t) * D + c] = from_float<T>(ys[t][c]);
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < S; ++s) hout[hoff + s] = h[s];
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
                   const void* dskip, const void* h0, void* y, void* hout, int B, int L, int D,
                   const Strides& st, cudaStream_t s) {
  dim3 grid((D + kChannels - 1) / kChannels, B);
  mamba_scan_kernel<T, N><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<const float*>(dskip),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(hout), L, D, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int N, const void* x, const void* dt, const void* a, const void* b,
                     const void* c, const void* dskip, const void* h0, void* y, void* hout, int B,
                     int L, int D, const Strides& st, cudaStream_t s) {
  switch (N) {
    case 8: return launch<T, 8>(x, dt, a, b, c, dskip, h0, y, hout, B, L, D, st, s);
    case 16: return launch<T, 16>(x, dt, a, b, c, dskip, h0, y, hout, B, L, D, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dt (B, L, D) and b, c (B, L, N) of one type (bf16 when bf16_ != 0,
// else fp32), each by (batch, step) element strides with a unit stride along
// the last axis; a (D, N), dskip (D,), h0 (B, D, N) or null, contiguous fp32;
// y (B, L, D) contiguous in x's type and hout (B, D, N) contiguous fp32
// (may be h0).  N is 8 (the reduced configs) or 16.  Returns the launch's
// cudaGetLastError().
extern "C" int mamba_scan(const void* x, const void* dt, const void* a, const void* b,
                          const void* c, const void* dskip, const void* h0, void* y, void* hout,
                          int bf16_, int B, int L, int D, int N, long long x_sb, long long x_sl,
                          long long dt_sb, long long dt_sl, long long b_sb, long long b_sl,
                          long long c_sb, long long c_sl, void* stream) {
  const Strides st{x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl, c_sb, c_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = bf16_ ? dispatch<bf16>(N, x, dt, a, b, c, dskip, h0, y, hout, B, L, D, st, s)
                        : dispatch<float>(N, x, dt, a, b, c, dskip, h0, y, hout, B, L, D, st, s);
  return static_cast<int>(e);
}
