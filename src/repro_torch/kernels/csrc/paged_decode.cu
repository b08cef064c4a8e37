// K4: paged decode attention: one query token a (slot, query head) against
// token-major K/V page pools, read through the slots' page table, split
// over the key positions.
//
// Replaces repro/kernels/ops.py::paged_decode_attention.  Its Pallas path
// gathers a head-major copy of every slot's pages, (B, maxp, ps, Hk, D) →
// (B, Hk, maxp*ps, D), and hands that copy to flash_decode_pallas
// (repro/kernels/flash_attention.py); this kernel reads the pages where they
// lie and makes no copy.  Semantics are those of
// repro/kernels/ref.py::paged_decode_attention_ref: pools (P+1, ps, Hk, D),
// the last row the trash page; page_table (B, maxp); key position t of
// slot b is row (page_table[b, t / ps] * ps + t % ps) of the pool; keys
// t < length[b] are live (length read from device memory, no host sync,
// clamped to maxp * ps), and with a window only t >= length[b] - window;
// GQA query head h reads kv head h / (H/Hk); softmax in fp32 with the -1e30
// fill; l floored at 1e-30, so a slot with no live key gives 0.  A table
// column at or past ceil(length/ps) is never read, and page ids are clamped
// to [0, P] as the reference's gather clamps them.  The table and length
// may be int32 or int64 (flags), read as they lie.  Head dims 16 to 256,
// G = H/Hk <= 16 with G * D <= 2048, bf16 and fp32.
//
// What bounds it on an H100: each live K and V row is read once and used for
// G = H/Hk query heads at 2 flop per element, about G/2 flop per byte in
// bf16, far under the card's ~295 flop/byte ridge: HBM bytes bound it
// (llama2-13b's engine step at B 8, H 40, lengths 37..1000 reads 65.3 MB,
// 19.5 us at 3.35 TB/s).  Reaching that rate takes tens of KB of loads in
// flight on every SM.
//
// What the design does about it: K3's split stream (csrc/decode_split.cuh)
// over the page table.  The key positions are cut into fixed chunks of
// kChunk positions, grid (chunks, Hk, B) with chunks = ceil(maxp * ps /
// kChunk): 5120 blocks at the engine's shape (maxp 64, ps 16, Hk 40, B 8).
// The chunk is a constant of this source, never a function of B, of the
// page size, of the SM count or of the lengths, so a slot's row has the
// same bits whatever batch it is decoded in.  A block first looks up the
// pool row of each of its live key positions in the table (one index read
// a key, kept in shared memory), then runs the split stream: K and V rows
// by 16-byte cp.async (a key row is D contiguous elements of one pool row,
// so any page size works), scores, softmax, p @ V in fp32, partials
// combined in chunk order by the last block of a (slot, kv head).
#include "decode_split.cuh"

namespace {

// Key positions a block, as K3's chunk (PERF.md).
// kernels/flash_attention.py's DECODE_CHUNK mirrors it and its wrapper
// checks it against paged_decode_chunk() once.
constexpr int kChunk = 64;

struct Args {
  split::Common c;
  const void* k;
  const void* v;
  const void* table;     // (B, maxp), row stride table_sb
  const void* length;    // (B,)
  int ps, maxp, last_page, Hk;
  long long table_sb;
  bool table64, length64;
};

// Key position c0 + r of a slot, through the page table: its pool row is
// looked up once by the block (prepare) into shared memory.
template <typename T, int D>
struct PagedKV {
  static constexpr bool kPrepares = true;
  const char* k;
  const char* v;
  const void* table;   // this slot's row of the table
  long long* rows;     // shared: the element offset of each live key's row
  int ps, last_page, Hk, hk;
  bool table64;
  __device__ __forceinline__ void prepare(int c0, int beg, int end) const {
    const int r = threadIdx.x;
    if (r >= beg && r < end) {
      const int t = c0 + r;
      const long long id = split::load_index(table, t / ps, table64);
      const long long page = min(max(id, 0LL), (long long)last_page);
      rows[r] = ((page * ps + t % ps) * Hk + hk) * D;
    }
  }
  __device__ __forceinline__ const char* k_row(int r) const { return k + sizeof(T) * rows[r]; }
  __device__ __forceinline__ const char* v_row(int r) const { return v + sizeof(T) * rows[r]; }
};
static_assert(kChunk <= split::kThreads, "prepare looks a key up a thread");

// Grid (chunks, Hk, B), split::kThreads threads.
template <typename T, int D>
__global__ void __launch_bounds__(split::kThreads)
paged_decode_split_kernel(const Args a) {
  __shared__ long long rows[kChunk];
  const int b = blockIdx.z;
  const long long n = split::load_index(a.length, b, a.length64);
  const int len = static_cast<int>(min(max(n, 0LL), (long long)a.maxp * a.ps));
  const char* table = static_cast<const char*>(a.table) +
                      (a.table64 ? 8 : 4) * (b * a.table_sb);
  const PagedKV<T, D> kv{static_cast<const char*>(a.k), static_cast<const char*>(a.v), table, rows,
                         a.ps, a.last_page, a.Hk, static_cast<int>(blockIdx.y), a.table64};
  split::split_decode<T, D, kChunk>(a.c, kv, len);
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  constexpr size_t most = split::most_smem<T, D, kChunk>();
  const size_t smem = split::smem_bytes<T, D, kChunk>(a.c.G);
  if (smem > split::kSmemLimit) return cudaErrorInvalidConfiguration;
  const auto kern = paged_decode_split_kernel<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(most < split::kSmemLimit ? most : split::kSmemLimit));
  if (attr != cudaSuccess) return attr;
  kern<<<dim3(a.c.chunks, a.Hk, B), split::kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const Args& a, int B, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, s);
    case 32: return launch<T, 32>(a, B, s);
    case 64: return launch<T, 64>(a, B, s);
    case 128: return launch<T, 128>(a, B, s);
    case 256: return launch<T, 256>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,D) by (batch, head) strides; k/v pools contiguous (num_rows, ps,
// Hk, D) with 16-byte aligned bases; table (B, maxp) by row stride table_sb
// and length (B,), both on the device, int64 where table64 / length64 else
// int32; o (B,H,D) by (batch, head) strides; bf16 if bf16_ else fp32.  The
// key positions are cut into chunks = ceil(maxp * ps / kChunk) blocks (1
// for none); with chunks > 1, ws holds B·H·chunks·(D + 2) floats and
// counters B·Hk zero ints, which the kernel leaves at zero.  window <= 0
// means none.  Returns the launch's cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* table, const void* length, void* o, void* ws,
                            void* counters, int bf16_, int table64, int length64, int B, int H,
                            int Hk, int D, int ps, int maxp, int num_rows, long long table_sb,
                            long long q_sb, long long q_sh, long long o_sb, long long o_sh,
                            int window, float scale, void* stream) {
  const int G = Hk > 0 ? H / Hk : 0;
  const long long keys = (long long)maxp * ps;
  const int chunks = keys > 0 ? static_cast<int>((keys + kChunk - 1) / kChunk) : 1;
  if (!split::fits(G, D) || ps < 1 || num_rows < 1 ||
      (chunks > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Args a{{q, o, static_cast<float*>(ws), static_cast<int*>(counters), G, chunks, window,
                scale, q_sb, q_sh, o_sb, o_sh},
               k_pool, v_pool, table, length, ps, maxp, num_rows - 1, Hk, table_sb,
               table64 != 0, length64 != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16_ ? dispatch<bf16>(D, a, B, s) : dispatch<float>(D, a, B, s);
  return static_cast<int>(e);
}

// Key positions a block (kChunk), for the wrapper's check of its plan.
extern "C" int paged_decode_chunk() { return kChunk; }
