// The re-check's rows of a pack, sorted: an LSD radix sort of int32 keys with
// no values, over only the bits that the vertex ids need.
//
// Replaces no pl.pallas_call. It is the port's counterpart of the JAX
// package's `jnp.sort` of the masked rows (repro/kernels/ops.py:58), which
// the port ran as `torch.sort(torch.where(mask > 0, edges, PAD_ID)...)`: a
// where buffer, then cub's radix sort of (key, int64 index) pairs over all 32
// bits, whose indices no one read.
//
// Input: the pack's edges (k, E, 2) int32 and mask (k, E) f32. Row r's keys
// are the 2E ids edges[r, :, :] in slot order, slot s valid where
// mask[r, s / 2] > 0. Output: (k, 2E) int32, row r holding its valid ids in
// ascending order and then PAD_ID (int32 max) up to 2E, element for element
// `torch.sort(torch.where(mask[..., None] > 0, edges, PAD_ID).reshape(k, 2E),
// dim=1).values`. Valid ids must lie in [0, 2^bits): the caller's bound
// num_vertices gives bits = max(1, bit_length(num_vertices - 1)), and 31
// covers every id that is not negative. 2E < 2^30.
//
// Bound: bytes. With digits of 8 bits, passes = ceil(bits / 8): 3 for
// graph500-22 and -24, 4 for 31 bits. A key costs 6 bytes read in the
// histogram launch (its 4 bytes of edge and half of its edge's 4 bytes of
// mask), 6 read and 4 written in the first pass, 4 read and 4 written in each
// later one: 32 bytes a key at 3 passes, so (8 + 8 * passes) * keys / 3.35e12
// s on an H100 (4.97 ms at graph500-24's 520,768,828 keys). A padding slot
// costs its 6 bytes of reads twice and its 4 bytes of PAD_ID written.
//
// Design (onesweep, Adinets and Merrill 2022, here row by row):
// - One histogram launch over every row: a CTA reads 8,192 edges of one row
//   (8-byte edge and 4-byte mask loads, consecutive edges on consecutive
//   lanes), counts each valid id's digits of every pass in shared memory and
//   adds its counts once to the global (k, passes, 256) table. A run of equal
//   ids on neighbouring lanes is counted once, by its first lane, so a hub's
//   run does not serialise on one shared-memory counter. Each pass's
//   histogram of a row sums to the row's valid count, where its PAD_ID tail
//   starts.
// - Then one launch a digit pass, every row at once. A CTA takes the next
//   tile of 8,192 positions from an atomic counter (tiles in row-major order,
//   so every earlier tile of its row has started), ranks the tile's keys in
//   shared memory, publishes its per-digit counts, finds the counts of the
//   row's earlier tiles by decoupled look-back over their published words
//   (flag and count in one 32-bit word), and writes each key to the row's
//   start of its digit plus those counts plus its rank in the tile, out of
//   shared memory so that neighbouring threads write neighbouring addresses
//   of a digit.
// - Ranking. LSD needs every pass but the first to be stable. The first pass
//   ranks by shared-memory atomics on the tile's 256 counters, in no order
//   within a digit. A later pass ranks warp by warp, rounds and lanes in
//   position order: __match_any_sync finds the lanes of equal digit, their
//   first lane adds their count to the warp's private histogram. On an H100
//   at graph500-24, k = 16, the sort took 13.47 ms as built, 14.99 with the first
//   pass stable too and 16.67 with 8 ballots in place of the match; 256
//   threads a CTA, or a persistent CTA that copies the next tile in with
//   cp.async, were no faster.
// - The first pass reads the edges and the mask and drops the masked slots:
//   no where buffer is written. Later passes read only the row's valid keys.
//   Passes ping-pong between the output and one scratch buffer so that the
//   last writes the output, whose tiles also fill [valid, 2E) with PAD_ID.
// - The workspace (tile counters, histograms, look-back words) is one
//   zero-filled buffer from the caller; nothing here allocates, synchronises
//   or reads back.
// Only the order of the ids is relied on, not the order of the slots.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;      // 256 bins a digit
constexpr int kMaxPasses = 4;               // 31 bits at most
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;       // 512
constexpr int kKeys = 16;                   // keys a thread ranks
constexpr int kTile = kThreads * kKeys;     // 8,192 positions a tile
constexpr int kHistThreads = 256;
constexpr int kHistSteps = 32;
constexpr int kHistEdges = kHistThreads * kHistSteps;  // 8,192 edges a histogram CTA
constexpr int kCounterWords = 4;            // one tile counter a pass
constexpr int32_t kPad = 0x7fffffff;
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kAggregate = 1u << 30;   // the tile's own counts
constexpr unsigned kInclusive = 2u << 30;   // the counts of the row's tiles up to and with this one
constexpr unsigned kCount = kAggregate - 1;

__device__ __forceinline__ unsigned digit_of(int32_t key, int shift) {
  return (static_cast<unsigned>(key) >> shift) & (kBins - 1);
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Counts `key` (where `live`) into every pass's shared histogram. A run of
// equal live keys on consecutive lanes adds once, from its first lane. Every
// lane of the warp calls it.
__device__ __forceinline__ void count_key(unsigned* s_hist, int32_t key, bool live, int lane, int passes) {
  const int32_t prev = __shfl_up_sync(kAll, key, 1);
  const unsigned live_lanes = __ballot_sync(kAll, live);
  const bool follows = live && lane > 0 && ((live_lanes >> (lane - 1)) & 1u) && prev == key;
  const unsigned followers = __ballot_sync(kAll, follows);
  if (live && !follows) {
    const unsigned after = lane == 31 ? 0u : followers >> (lane + 1);
    const unsigned run = __ffs(~after);  // this lane and the followers right after it
    for (int p = 0; p < passes; ++p) atomicAdd(s_hist + p * kBins + digit_of(key, kDigitBits * p), run);
  }
}

// hist[row][p][b] += the count of row's valid ids whose digit p is b.
__global__ void __launch_bounds__(kHistThreads)
packed_sort_histogram_kernel(const int2* __restrict__ edges, const float* __restrict__ mask,
                             unsigned* __restrict__ hist, long long e_max, int chunks, int passes) {
  __shared__ unsigned s_hist[kMaxPasses * kBins];
  for (int i = threadIdx.x; i < passes * kBins; i += kHistThreads) s_hist[i] = 0;
  __syncthreads();
  const long long row = blockIdx.x / chunks;
  const long long first = static_cast<long long>(blockIdx.x % chunks) * kHistEdges;
  const long long end = first + kHistEdges < e_max ? first + kHistEdges : e_max;
  const int2* e_row = edges + row * e_max;
  const float* m_row = mask + row * e_max;
  const int lane = threadIdx.x & 31;
  const int warp_first = threadIdx.x & ~31;
#pragma unroll 4
  for (int step = 0; step < kHistSteps; ++step) {
    const long long base = first + static_cast<long long>(step) * kHistThreads;
    if (base + warp_first >= end) break;  // the same for every lane of the warp
    const long long j = base + threadIdx.x;
    int2 e = make_int2(0, 0);
    float m = 0.0f;
    if (j < end) {
      e = __ldcs(e_row + j);
      m = __ldcs(m_row + j);
    }
    const bool live = m > 0.0f;
    count_key(s_hist, e.x, live, lane, passes);
    count_key(s_hist, e.y, live, lane, passes);
  }
  __syncthreads();
  unsigned* h_row = hist + row * passes * kBins;
  for (int i = threadIdx.x; i < passes * kBins; i += kHistThreads) {
    const unsigned v = s_hist[i];
    if (v) atomicAdd(h_row + i, v);
  }
}

// Exclusive prefix over the 256 bins of `v`, held by threads 0..255 (the
// rest pass 0); `*total` gets the sum. Every thread of the CTA calls it.
__device__ __forceinline__ unsigned scan_bins(unsigned v, unsigned* s_part, unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31 && warp < kBins / 32) s_part[warp] = x;
  __syncthreads();
  unsigned before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kBins / 32; ++w) {
    const unsigned p = s_part[w];
    before += w < warp ? p : 0u;
    sum += p;
  }
  __syncthreads();  // s_part is free again
  *total = sum;
  return before + x - v;
}

// One digit pass over every row, tile by tile: stable but for pass 0, which
// reads the edges (as int32, slot order) and the mask; a later pass reads
// `src`'s valid keys. The last pass also writes the PAD_ID tail.
__global__ void __launch_bounds__(kThreads, 2)
packed_sort_pass_kernel(const int32_t* __restrict__ ids, const float* __restrict__ mask,
                        const int32_t* __restrict__ src, int32_t* __restrict__ dst,
                        const unsigned* __restrict__ hist, unsigned* __restrict__ status,
                        unsigned* __restrict__ counter, long long e_max, int tiles_per_row, int pass, int passes) {
  __shared__ int32_t s_keys[kTile];
  __shared__ unsigned short s_warp[kWarps][kBins];  // a warp's count of a digit, then its start in the bin;
                                                    // in pass 0 the tile's 256 counters (32-bit)
  __shared__ unsigned s_local[kBins];               // the tile's start of each bin
  __shared__ int s_dst[kBins];                      // row position of a bin's tile-local index 0
  __shared__ unsigned s_part[kBins / 32];
  __shared__ unsigned s_tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(counter, 1u);
  for (int i = tid; i < kWarps * kBins / 2; i += kThreads) reinterpret_cast<unsigned*>(s_warp)[i] = 0u;
  __syncthreads();
  const unsigned tile = s_tile;
  const long long row = tile / tiles_per_row;
  const int t = static_cast<int>(tile % tiles_per_row);
  const long long width = 2 * e_max;
  const long long row_base = row * width;
  const long long tile_first = static_cast<long long>(t) * kTile;
  const int shift = kDigitBits * pass;

  // The tile's keys, loaded before the row's histogram is read: a later
  // pass loads up to the row's end and drops what lies past its valid keys.
  int32_t key[kKeys];
  unsigned live = 0;  // bit i: key i is a valid id
  const long long first = tile_first + warp * (32 * kKeys) + lane;
#pragma unroll
  for (int i = 0; i < kKeys; ++i) {
    const long long pos = first + 32 * i;
    key[i] = 0;
    if (pos < width) {
      if (pass == 0) {
        key[i] = __ldcs(ids + row_base + pos);
        if (__ldcs(mask + row * e_max + (pos >> 1)) > 0.0f) live |= 1u << i;
      } else {
        key[i] = __ldcs(src + row_base + pos);
      }
    }
  }

  // The row's start of every bin of this digit, and its valid count.
  unsigned valid = 0;
  const unsigned row_start =
      scan_bins(tid < kBins ? hist[(row * passes + pass) * kBins + tid] : 0u, s_part, &valid);
  const bool has_keys = pass == 0 || tile_first < valid;  // the same for the whole CTA

  if (has_keys) {
    if (pass > 0) {
#pragma unroll
      for (int i = 0; i < kKeys; ++i)
        if (first + 32 * i < valid) live |= 1u << i;
    }
    // Rank: the first pass by the tile's shared counters (LSD needs no order
    // within a digit there), a later pass stably within the warp (rounds in
    // order, lanes in order).
    unsigned short rank[kKeys];
    if (pass == 0) {
      unsigned* s_cnt = reinterpret_cast<unsigned*>(s_warp);
#pragma unroll
      for (int i = 0; i < kKeys; ++i)
        if ((live >> i) & 1u) rank[i] = static_cast<unsigned short>(atomicAdd(s_cnt + digit_of(key[i], shift), 1u));
    } else {
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const bool is_live = (live >> i) & 1u;
        const unsigned d = digit_of(key[i], shift);
        const unsigned peers = __ballot_sync(kAll, is_live) & __match_any_sync(kAll, d);
        const int leader = is_live ? __ffs(peers) - 1 : lane;
        unsigned base = 0;
        if (is_live && leader == lane) {
          base = s_warp[warp][d];
          s_warp[warp][d] = static_cast<unsigned short>(base + __popc(peers));
        }
        base = __shfl_sync(kAll, base, leader);
        rank[i] = static_cast<unsigned short>(base + __popc(peers & below));
        __syncwarp();
      }
    }
    __syncthreads();

    // Per bin: each warp's start within the bin, the tile's count, published.
    unsigned count = 0;
    if (tid < kBins) {
      if (pass == 0) {
        count = reinterpret_cast<unsigned*>(s_warp)[tid];
      } else {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const unsigned c = s_warp[w][tid];
          s_warp[w][tid] = static_cast<unsigned short>(count);
          count += c;
        }
      }
      store_relaxed(status + static_cast<size_t>(tile) * kBins + tid, (t == 0 ? kInclusive : kAggregate) | count);
    }
    unsigned tile_keys = 0;
    const unsigned local = scan_bins(count, s_part, &tile_keys);
    if (tid < kBins) s_local[tid] = local;
    __syncthreads();

    // The tile's keys in digit order, in shared memory.
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      if ((live >> i) & 1u) {
        const unsigned d = digit_of(key[i], shift);
        s_keys[s_local[d] + (pass == 0 ? 0u : s_warp[warp][d]) + rank[i]] = key[i];
      }
    }

    // Look back over the row's earlier tiles for each bin's keys before this tile.
    if (tid < kBins) {
      unsigned before = 0;
      if (t > 0) {
        for (long long j = static_cast<long long>(tile) - 1;; --j) {
          unsigned word;
          do {
            word = load_relaxed(status + static_cast<size_t>(j) * kBins + tid);
          } while ((word & ~kCount) == 0u);
          before += word & kCount;
          if (word & kInclusive) break;
        }
        store_relaxed(status + static_cast<size_t>(tile) * kBins + tid, kInclusive | (before + count));
      }
      s_dst[tid] = static_cast<int>(row_start + before) - static_cast<int>(local);
    }
    __syncthreads();

    for (unsigned j = tid; j < tile_keys; j += kThreads) {
      const int32_t k = s_keys[j];
      dst[row_base + s_dst[digit_of(k, shift)] + static_cast<int>(j)] = k;
    }
  }

  if (pass == passes - 1) {  // the row's PAD_ID tail within this tile
    const long long lo = tile_first > valid ? tile_first : static_cast<long long>(valid);
    const long long hi = tile_first + kTile < width ? tile_first + kTile : width;
    for (long long p = lo + tid; p < hi; p += kThreads) dst[row_base + p] = kPad;
  }
}

long long tiles_per_row(long long e_max) { return (2 * e_max + kTile - 1) / kTile; }

}  // namespace

// Words (int32) of the zero-filled workspace that packed_sort takes for
// `rows` rows of `e_max` edges sorted over `bits` bits.
extern "C" long long packed_sort_workspace_words(long long rows, long long e_max, int bits) {
  const long long passes = (bits + kDigitBits - 1) / kDigitBits;
  return kCounterWords + rows * passes * kBins + passes * rows * tiles_per_row(e_max) * kBins;
}

// Sorts the pack's rows into `out` ((rows, 2 * e_max) int32), through
// `scratch` (the same shape; unused at one pass) and the zero-filled
// `workspace` of packed_sort_workspace_words, all on `stream`; returns a
// cudaError_t as an int (0 = cudaSuccess). edges must be 8-byte aligned.
// Does not synchronise and allocates nothing.
extern "C" int packed_sort(const void* edges, const void* mask, void* out, void* scratch, void* workspace,
                           long long rows, long long e_max, int bits, void* stream) {
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  const long long chunks = (e_max + kHistEdges - 1) / kHistEdges;
  const long long tiles = rows * tiles_per_row(e_max);
  if (rows <= 0 || e_max <= 0 || 2 * e_max >= (1LL << 30) || bits < 1 || bits > 31 ||
      rows * chunks > 0x7fffffffLL || tiles > 0x7fffffffLL || (passes > 1 && scratch == nullptr) ||
      reinterpret_cast<uintptr_t>(edges) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* counters = static_cast<unsigned*>(workspace);
  unsigned* hist = counters + kCounterWords;
  unsigned* status = hist + rows * passes * kBins;
  packed_sort_histogram_kernel<<<static_cast<unsigned>(rows * chunks), kHistThreads, 0, s>>>(
      static_cast<const int2*>(edges), static_cast<const float*>(mask), hist, e_max, static_cast<int>(chunks),
      passes);
  cudaError_t err = cudaGetLastError();
  const int32_t* src = nullptr;
  for (int p = 0; err == cudaSuccess && p < passes; ++p) {
    int32_t* dst = static_cast<int32_t*>((passes - 1 - p) % 2 == 0 ? out : scratch);
    packed_sort_pass_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
        static_cast<const int32_t*>(edges), static_cast<const float*>(mask), src, dst, hist,
        status + static_cast<size_t>(p) * tiles * kBins, counters + p, e_max, static_cast<int>(tiles_per_row(e_max)),
        p, passes);
    err = cudaGetLastError();
    src = dst;
  }
  return static_cast<int>(err);
}

extern "C" const char* packed_sort_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
