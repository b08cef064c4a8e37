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
// skipped; online softmax keeps fp32 (m, l, acc); l is floored at 1e-30, so
// a row with every key masked gives 0.  For training, K2 also writes each
// row's log-sum-exp of its scaled, masked scores, m + log(l) (-inf for a
// row with every key masked), to an optional fp32 (B, H, Sq) buffer: the K6
// backward (flash_attention_bwd.cu) recomputes the probabilities from it, so
// l is summed from the fp32 probabilities, before P is rounded.  K3 reads
// each batch row's valid length from device memory (no host sync) and an
// optional window keeps keys with index >= length - window.
//
// What bounds them on an H100: K2 at the main-path shape (B 4, H 40, S 512,
// D 128, causal, bf16) does ~11 GFLOP on ~84 MB of q, k, v and o, about 128
// flop/byte, under the card's ~295 flop/byte ridge in bf16: bytes bound it
// at this length, operations from about S = 1200 on; the card comes near
// either only with the products on its tensor cores (fp32 FMA peaks at 67
// TFLOP/s, 0.16 ms for the 11 GFLOP).  K3 reads the cache once per token
// at ~1 flop/byte: bytes bound it.
//
// What the design does about it.  K2 in bf16 (flash_attention_wgmma_kernel)
// issues both products on the tensor cores with wgmma and keeps K/V loads in
// flight behind them: a CTA owns 64 query rows per consumer warpgroup (two
// warpgroups at D 16 to 64, one at D 128 and 256) and loads its Q tile once by
// TMA into the swizzled layout wgmma reads (csrc/wgmma.cuh).  K and V stream
// through a ring of STAGES tiles of BN keys (FwdConfig), each filled by TMA
// (one tensor map per operand, built per call from the wrapper's strides) and
// completed on an mbarrier, so the next tiles are in flight while one is
// computed.  Warpgroups never wait for each other: each counts itself done
// with a stage, and the last one to finish it loads the tile STAGES ahead into
// it, so one warpgroup's softmax runs beside another's products (of its own
// CTA or, where two CTAs share an SM, of the other).  S = Q K^T is m64 x BN x
// k16 wgmma from shared memory (both K-major); the online softmax runs on the
// fp32 accumulator in registers (exp2 with log2(e) folded into the scale; row
// max and sum over the quad of lanes that share a row), masks only the tiles
// that cross the causal diagonal, the window edge or the end of Skv, and skips
// the wholly masked ones (key_tiles, whose spec is
// kernels/flash_attention.py::key_tile_range, per CTA for the loads and per
// warpgroup for the products).  P is rounded to bf16 in registers, where the
// accumulator's layout is wgmma's A fragment, and O += P V reads V as an
// MN-major B operand (the transpose bit).  The grid reverses the query tiles
// under a causal mask so the heaviest start first.  The score matrix never
// reaches device memory.  What is left: each K/V tile crosses from L2 once per
// CTA, and a warpgroup's softmax waits for its own S product
// (FlashAttention-3's overlap of the two inside a warpgroup, issuing P V one
// tile late, was slower on an H100: it holds the stage a tile longer and
// costs the registers of a second P).
// fp32 keeps the SIMT kernel (flash_attention_kernel: 32-row query tiles,
// 32-key tiles in shared memory), which holds fp32's tolerance (1e-4) where
// TF32 products would not; the wrapper's forward_plan picks the kernel by
// dtype.  K3 gives one block to each (batch, kv head) and puts all H/Hk query
// heads of the group in it, so every key and value row is read from device
// memory once for the whole group, in fp32 on the SIMT cores; split-KV decode
// is for the PR that makes it fast.
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

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

// The key tiles [lo, hi) of `bn` keys that the query rows [q0, q0 + rows)
// (those below Sq) can see; every tile outside holds only masked pairs.
// kernels/flash_attention.py::key_tile_range is its spec, and the CPU tests
// hold that against brute-force masks; both K2 kernels follow it.
__device__ __forceinline__ void key_tiles(int q0, int rows, int Sq, int Skv, int causal,
                                          int window, int bn, int& lo, int& hi) {
  const int last = min(q0 + rows, Sq) - 1, off = Skv - Sq;
  const int end = causal ? min(Skv, last + off + 1) : Skv;
  const int begin = window > 0 ? max(0, q0 + off - window + 1) : 0;
  if (last < q0 || end <= begin) {
    lo = hi = 0;
    return;
  }
  lo = begin / bn;
  hi = (end + bn - 1) / bn;
}

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
  key_tiles(q0, kBQ, Sq, Skv, causal, window, kBKV, t_lo, t_hi);

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
// K2 in bf16 on the tensor cores.  Grid (ceil(Sq/BM), H, B), 128 threads a
// consumer warpgroup; the tile sizes of each head dim are FwdTile's, and
// kernels/flash_attention.py::forward_plan repeats them (the entry point
// refuses a plan that differs).
// ---------------------------------------------------------------------------
// Tiles by head dim: consumer warpgroups (64 query rows each), keys a K/V
// tile, stages of the ring, and the CTAs an SM should hold at once (which
// sets the registers __launch_bounds__ leaves a thread).  D 64 and 128 are
// the paths' (the fastest of the shapes timed on an H100); at both, two
// CTAs share an SM (about 83 KB of shared memory each), so one CTA's loads
// and epilogue run beside the other's products.
template <int D>
struct FwdConfig {
  static constexpr int WG = 2, BN = 128, STAGES = 2, CTAS = 1;
};
template <>
struct FwdConfig<64> {
  static constexpr int WG = 2, BN = 64, STAGES = 4, CTAS = 1;
};
template <>
struct FwdConfig<128> {
  static constexpr int WG = 1, BN = 64, STAGES = 2, CTAS = 2;
};
template <>
struct FwdConfig<256> {
  static constexpr int WG = 1, BN = 64, STAGES = 2, CTAS = 1;
};

template <int D>
struct FwdTile {
  static constexpr int WG = FwdConfig<D>::WG, BN = FwdConfig<D>::BN;
  static constexpr int STAGES = FwdConfig<D>::STAGES, CTAS = FwdConfig<D>::CTAS;
  static constexpr int BM = 64 * WG;               // query rows a CTA
  static constexpr int SW = D < 64 ? D : 64;       // columns of one swizzled panel
  static constexpr int PITCH = 2 * SW;             // bytes of a panel row: the swizzle span
  static constexpr int PANELS = D / SW;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;      // K or V of one stage
  // 1024 bytes of slack to align the panels, Q, the ring, one mbarrier for
  // Q and for each stage, and each stage's count of warpgroups done with it
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (STAGES + 1) + 4 * STAGES;
  static constexpr int THREADS = 128 * WG;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Issue the TMA loads of key tile `tile` (K, then V, each in PANELS
// panels) into ring stage `stage`; they complete on the stage's mbarrier.
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t ring, uint32_t bars, int stage, int tile, int hk,
                                        int b) {
  using T = FwdTile<D>;
  const uint32_t bar = bars + 8 * (1 + stage), k_s = ring + stage * 2 * T::KV_BYTES;
  hopper::mbar_expect_tx(bar, 2 * T::KV_BYTES);
#pragma unroll
  for (int p = 0; p < T::PANELS; ++p) {
    const uint32_t at = p * T::BN * T::PITCH;
    hopper::tma_load_4d(k_s + at, tk, bar, p * T::SW, tile * T::BN, hk, b);
    hopper::tma_load_4d(k_s + T::KV_BYTES + at, tv, bar, p * T::SW, tile * T::BN, hk, b);
  }
}

// tq, tk, tv: 4-D tensor maps (D, S, heads, B) of q, k, v with boxes of
// (SW, BM) and (SW, BN); o by (batch, head, seq) strides; scale_log2 the
// caller's scale times log2(e).
template <int D>
__global__ void __launch_bounds__(FwdTile<D>::THREADS, FwdTile<D>::CTAS)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                             float* __restrict__ lse, int H, int Hk, int Sq, int Skv,
                             long long o_sb, long long o_sh, long long o_ss, int causal,
                             int window, float scale_log2) {
  using T = FwdTile<D>;
  constexpr int BN = T::BN, BM = T::BM, SW = T::SW, PITCH = T::PITCH, STAGES = T::STAGES;
  constexpr int NS = BN / 2, NO = D / 2;  // fp32 accumulator registers a thread: S, O
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = q_s + T::Q_BYTES;                      // stage s: K, then V
  const uint32_t bars = ring + STAGES * 2 * T::KV_BYTES;       // Q's mbarrier, then each stage's
  // per stage, the warpgroups done with its tile (the last one refills it)
  int* released = reinterpret_cast<int*>(smem_raw + (bars + 8 * (STAGES + 1) -
                                                     hopper::smem_u32(smem_raw)));

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (H / Hk);
  const int q0 = qt * BM, off = Skv - Sq;
  const int row_w = q0 + 64 * wg;                  // this warpgroup's first query row
  const int row0 = row_w + 16 * warp + lane / 4;   // this thread's rows: row0 and row0 + 8
  int lo, hi, w_lo, w_hi;
  key_tiles(q0, BM, Sq, Skv, causal, window, BN, lo, hi);         // the CTA loads these
  key_tiles(row_w, 64, Sq, Skv, causal, window, BN, w_lo, w_hi);  // this warpgroup uses these
  const int n = hi - lo;

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(bars + 8 * i, 1);
    for (int i = 0; i < STAGES; ++i) released[i] = 0;
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    // rows past Sq and keys past Skv arrive as zeros (the maps' bounds)
    hopper::mbar_expect_tx(bars, T::Q_BYTES);
#pragma unroll
    for (int p = 0; p < T::PANELS; ++p)
      hopper::tma_load_4d(q_s + p * BM * PITCH, &tq, bars, p * SW, q0, h, b);
    for (int st = 0; st < STAGES && st < n; ++st)
      load_kv<D>(&tk, &tv, ring, bars, st, lo + st, hk, b);
  }

  float s[NS], acc[NO];
  uint32_t pf[BN / 16][4];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  // running max (in log2 units) and this thread's share of the row sums
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  if (n > 0) hopper::mbar_wait(bars, 0);

  for (int it = 0; it < n; ++it) {
    const int tile = lo + it, stage = it % STAGES;
    const uint32_t k_s = ring + stage * 2 * T::KV_BYTES, v_s = k_s + T::KV_BYTES;
    hopper::mbar_wait(bars + 8 * (1 + stage), (it / STAGES) & 1);
    if (tile >= w_lo && tile < w_hi) {
      // S = Q K^T over D in k16 steps; Q and K both K-major
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int panel = (ks * 16) / SW;
        const uint32_t col = ((ks * 16) % SW) * 2;  // bytes into the panel's rows
        const uint64_t da = hopper::desc(q_s + panel * BM * PITCH + wg * 64 * PITCH + col, 16,
                                         8 * PITCH, PITCH);
        const uint64_t db = hopper::desc(k_s + panel * BN * PITCH + col, 16, 8 * PITCH, PITCH);
        hopper::Wgmma<BN>::template ss<0, 0>(s, da, db, ks > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // Scale into log2 units; mask only a tile that crosses the causal
      // diagonal, the window's edge or the end of the keys.
      const int j0 = tile * BN;
      const bool masked = j0 + BN > Skv || (causal && j0 + BN - 1 > row_w + off) ||
                          (window > 0 && j0 <= row_w + 63 + off - window);
      float mx[2] = {-INFINITY, -INFINITY};
      // accumulator i holds row row0 + 8 r, r = (i / 2) % 2, and column
      // 8 (i / 4) + 2 (lane % 4) + i % 2 of the tile
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1;
        float x = s[i] * scale_log2;
        if (masked) {
          const int c = j0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1), pos = row0 + 8 * r + off;
          const bool live = c < Skv && (!causal || c <= pos) && (window <= 0 || c > pos - window);
          x = live ? x : -INFINITY;
        }
        s[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float alpha[2], base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        base[r] = m_new == -INFINITY ? 0.0f : m_new;  // a row with no live key so far
        alpha[r] = fast_exp2(m[r] - base[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float p = fast_exp2(s[i] - base[(i >> 1) & 1]);
        l[(i >> 1) & 1] += p;  // summed in fp32, before P is rounded
        s[i] = p;
      }
      // P in bf16: the accumulator's layout is wgmma's A fragment
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pf[kk][j] = hopper::pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V over the tile's keys in k16 steps; V MN-major (transposed)
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = hopper::desc(v_s + kk * 16 * PITCH, BN * PITCH, 8 * PITCH, PITCH);
        hopper::Wgmma<D>::template rs<1>(acc, pf[kk], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(pf);
    }
    // Release the stage: the last warpgroup done with it loads the tile
    // STAGES ahead into it, so neither warpgroup waits for the other.
    if (it + STAGES < n) {
      // this warpgroup's four warps are past their products
      if (wg == 0) hopper::named_sync<1, 128>();
      else hopper::named_sync<2, 128>();
      if (tid % 128 == 0 && hopper::last_to_arrive(released + stage, T::WG))
        load_kv<D>(&tk, &tv, ring, bars, stage, tile + STAGES, hk, b);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const int row = row0 + 8 * r;
    if (row < Sq) {
      const float inv = 1.0f / fmaxf(sum, 1e-30f);
      bf16* op = o + b * o_sb + h * o_sh + row * o_ss + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
      if (lse != nullptr && lane % 4 == 0)
        lse[((long long)b * H + h) * Sq + row] =
            sum > 0.0f ? m[r] * 0.6931471805599453f + logf(sum) : -INFINITY;
    }
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

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no link to
// libcuda), or null.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                                  &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D tensor map (D, S, heads, B) of a bf16 operand with (seq, head,
// batch) strides in elements, read in boxes of `rows` x `panel` columns
// into `panel`-column swizzled panels; reads past S or D give zeros.  The
// wrapper has checked that the base and every stride of a dimension longer
// than 1 are multiples of 16 bytes; a dimension of length 1 is never
// stepped, so its stride is set to 16 bytes.
cudaError_t tile_map(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B,
                     long long ss, long long sh, long long sb, int panel, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  auto bytes = [](long long stride, int n) -> cuuint64_t {
    return n > 1 ? static_cast<cuuint64_t>(stride) * 2 : 16;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(ss, S), bytes(sh, heads), bytes(sb, B)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(panel), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = panel == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : panel == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                         int H, int Hk, int Sq, int Skv, const long long* st, int causal,
                         int window, float scale, cudaStream_t s) {
  using T = FwdTile<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t e = tile_map(&tq, q, D, Sq, H, B, st[2], st[1], st[0], T::SW, T::BM);
  if (e == cudaSuccess && Skv > 0) e = tile_map(&tk, k, D, Skv, Hk, B, st[5], st[4], st[3], T::SW, T::BN);
  if (e == cudaSuccess && Skv > 0) e = tile_map(&tv, v, D, Skv, Hk, B, st[8], st[7], st[6], T::SW, T::BN);
  if (e != cudaSuccess) return e;
  if (Skv == 0) tk = tv = tq;  // no key tile is loaded
  auto kern = flash_attention_wgmma_kernel<D>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + T::BM - 1) / T::BM, H, B);
  kern<<<grid, T::THREADS, T::SMEM, s>>>(tq, tk, tv, static_cast<bf16*>(o), lse, H, Hk, Sq, Skv,
                                         st[9], st[10], st[11], causal, window,
                                         scale * 1.4426950408889634f);
  return cudaGetLastError();
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
    using T = FwdTile<D>;
    if (plan[0] != T::BM || plan[1] != T::BN || plan[2] != T::STAGES || plan[3] != T::SMEM)
      return cudaErrorInvalidConfiguration;
    return launch_wgmma<D>(q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
  }
  if (plan[0] != kBQ || plan[1] != kBKV || plan[2] != 1 ||
      plan[3] != static_cast<int>(attn_smem_bytes<D>()))
    return cudaErrorInvalidConfiguration;
  return launch_attention<D>(q, k, v, o, lse, B, H, Hk, Sq, Skv, st, causal, window, scale, s);
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
