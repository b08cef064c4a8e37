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
// decoded in.  Each block runs csrc/decode_split.cuh's split stream on its
// chunk (K and V by cp.async, scores, softmax, p @ V in fp32, partials
// combined in chunk order by the last block of a (batch, kv head)); a key
// row here is row c0 + r of the (batch, kv head)'s cache.
#include "decode_split.cuh"

namespace {

// Keys a block: 64 beat 32 and 128 at llama2-13b's and gpt-j-6b's decode
// rows on an H100 (PERF.md).
// kernels/flash_attention.py's DECODE_CHUNK mirrors it and its wrapper
// checks it against flash_decode_chunk() once.
constexpr int kChunk = 64;

struct Args {
  split::Common c;
  const void* k;
  const void* v;
  const int* length;
  int S;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
};

// Key position c0 + r of a (batch, kv head)'s dense cache.
template <typename T>
struct DenseKV {
  static constexpr bool kPrepares = false;
  const char* k;   // the chunk's first key row
  const char* v;
  long long k_ss, v_ss;   // bytes a key
  __device__ __forceinline__ void prepare(int, int, int) const {}
  __device__ __forceinline__ const char* k_row(int r) const { return k + r * k_ss; }
  __device__ __forceinline__ const char* v_row(int r) const { return v + r * v_ss; }
};

// Grid (chunks, Hk, B), split::kThreads threads.
template <typename T, int D>
__global__ void __launch_bounds__(split::kThreads)
flash_decode_split_kernel(const Args a) {
  const int hk = blockIdx.y, b = blockIdx.z;
  const long long c0 = (long long)blockIdx.x * kChunk;
  const DenseKV<T> kv{
      static_cast<const char*>(a.k) + sizeof(T) * (b * a.k_sb + hk * a.k_sh + c0 * a.k_ss),
      static_cast<const char*>(a.v) + sizeof(T) * (b * a.v_sb + hk * a.v_sh + c0 * a.v_ss),
      (long long)sizeof(T) * a.k_ss, (long long)sizeof(T) * a.v_ss};
  split::split_decode<T, D, kChunk>(a.c, kv, min(max(a.length[b], 0), a.S));
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, int Hk, cudaStream_t s) {
  constexpr size_t most = split::most_smem<T, D, kChunk>();
  const size_t smem = split::smem_bytes<T, D, kChunk>(a.c.G);
  if (smem > split::kSmemLimit) return cudaErrorInvalidConfiguration;
  const auto kern = flash_decode_split_kernel<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(most < split::kSmemLimit ? most : split::kSmemLimit));
  if (attr != cudaSuccess) return attr;
  kern<<<dim3(a.c.chunks, Hk, B), split::kThreads, smem, s>>>(a);
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
  if (!split::fits(G, D) || (chunks > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Args a{{q, o, static_cast<float*>(ws), static_cast<int*>(counters), G, chunks, window,
                scale, q_sb, q_sh, o_sb, o_sh},
               k, v, static_cast<const int*>(length), S, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16_ ? dispatch<bf16>(D, a, B, Hk, s) : dispatch<float>(D, a, B, Hk, s);
  return static_cast<int>(e);
}

// Keys a block (kChunk), for the wrapper's check of its plan.
extern "C" int flash_decode_chunk() { return kChunk; }
