// Distinct-id count per sorted row: the replication-factor measure of CEP chunks.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_rf.py
// (segment_distinct_counts, body _segment_rf_kernel, one BLOCK_ROWS row block
// a grid step). For each row of a (rows, width) int32 array, sorted ascending
// and padded at the tail with PAD_ID = INT32_MAX, it counts the positions i
// where ids[i] != ids[i-1] and ids[i] != PAD_ID, with ids[-1] taken as -1.
//
// Bound: memory. The function reads rows*width*4 bytes once and writes
// rows*4, so on an H100 (3.35 TB/s) the least time is
// (rows*width*4 + rows*4) / 3.35e12 s: 37.5 us at the k = 16 pack's rows
// (16, 1,962,714), but only 0.4-3 us at the narrow rows of the full rung's
// selection ((2, 161,792), (3, 798,720)). There the bound lies below a
// launch's own latency, so the goal is one launch and no host work beyond it.
//
// Design:
// - One launch a call, and no zero-fill of the output: a row is split among
//   `bpr` CTAs (the caller's choice: about four CTAs an SM over the launch,
//   no more than the row has chunks). Each CTA reduces its count in registers
//   and shared memory. With bpr = 1 it stores out[row]. Otherwise it stores
//   its partial, fences, and takes a ticket on the row's counter; the CTA
//   that takes the last ticket sums the row's partials, stores out[row] with
//   a plain store and sets the counter back to 0. The counters are zeroed
//   once, where the caller allocates them (one array for each stream), and
//   every launch leaves them zero. Integer sums are exact, so the result is
//   the same whichever CTA finishes last.
// - Why not one thread-block cluster a row, summed through distributed
//   shared memory (no counters at all): a cluster holds at most 16 CTAs, so
//   the few wide rows of the paths ((3, 2,944,512), (4, 1,962,714)) ran on
//   48-64 SMs, and every shape was slower on the card than the kernel it
//   replaces (a zero-fill and one atomicAdd a block), by 1.1x at the k = 16
//   rows and up to 2.1x at (3, 2,944,512) (tools/segment_rf_variants.py,
//   PERF.md, PR 21).
// - 16-byte loads: each thread reads an int4 (kUnroll of them in flight),
//   compares within the vector, and takes its predecessor across vectors
//   from the lane before by __shfl_up_sync; lane 0 reads its predecessor
//   from global memory, one extra 4-byte read a warp, issued beside the
//   vector loads so that no load waits on another. Nothing is staged in
//   shared memory. A row whose start is not 16-byte aligned (width % 4 != 0,
//   or an offset view) is split into a scalar head up to the first boundary,
//   the vectors, and a scalar tail of at most 3 ids, which the row's first
//   CTA counts one id a thread.
// The grid is rows * bpr CTAs on gridDim.x (at most 2^31 - 1).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                        // int4 loads in flight a thread
constexpr long long kChunk = kThreads * kUnroll;  // vectors a CTA reads an iteration (4,096 ids)
constexpr int32_t kPadId = 0x7fffffff;

__device__ __forceinline__ int is_new(int32_t x, int32_t prev) { return (x != prev) & (x != kPadId); }

__global__ void __launch_bounds__(kThreads)
segment_rf_kernel(const int32_t* __restrict__ ids, int32_t* __restrict__ out, long long width, int bpr,
                  int* __restrict__ partials, unsigned* __restrict__ tickets) {
  __shared__ int warp_sums[kWarps];
  __shared__ bool last;

  const long long row_idx = blockIdx.x / bpr;
  const int part = static_cast<int>(blockIdx.x % bpr);
  const int32_t* row = ids + row_idx * width;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Head: the ids before the first 16-byte boundary of the row.
  long long head = (4 - static_cast<long long>((reinterpret_cast<uintptr_t>(row) >> 2) & 3)) & 3;
  if (head > width) head = width;
  const long long nvec = (width - head) >> 2;
  const int4* vec = reinterpret_cast<const int4*>(row + head);

  int count = 0;
  for (long long c0 = part * kChunk; c0 < nvec; c0 += bpr * kChunk) {
    int4 x[kUnroll];
    int32_t before[kUnroll];  // lane 0: the id before its vector, loaded beside the vectors
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = c0 + u * kThreads + threadIdx.x;
      x[u] = j < nvec ? __ldg(vec + j) : make_int4(0, 0, 0, 0);
      const long long e = head + 4 * j;
      before[u] = lane == 0 && j < nvec && e > 0 ? __ldg(row + e - 1) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = c0 + u * kThreads + threadIdx.x;
      // Lane l holds vector j and lane l - 1 vector j - 1, whose last id is
      // this vector's predecessor; lane 0 has read it from memory.
      const int32_t up = __shfl_up_sync(0xffffffffu, x[u].w, 1);
      const int32_t prev = lane == 0 ? before[u] : up;
      if (j < nvec)
        count += is_new(x[u].x, prev) + is_new(x[u].y, x[u].x) + is_new(x[u].z, x[u].y) +
                 is_new(x[u].w, x[u].z);
    }
  }
  if (part == 0 && threadIdx.x < 8) {  // the scalar head (threads 0-3) and tail (4-7)
    const long long e = threadIdx.x < 4 ? threadIdx.x : head + 4 * nvec + (threadIdx.x - 4);
    if (threadIdx.x < 4 ? e < head : e < width) count += is_new(row[e], e > 0 ? row[e - 1] : -1);
  }

  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (warp == 0) {
    const int s = __reduce_add_sync(0xffffffffu, lane < kWarps ? warp_sums[lane] : 0);
    if (lane == 0) {
      if (bpr == 1) {
        out[row_idx] = s;
      } else {
        partials[row_idx * bpr + part] = s;
        __threadfence();  // the partial is visible before the ticket is taken
        last = atomicAdd(tickets + row_idx, 1u) == static_cast<unsigned>(bpr - 1);
      }
    }
  }
  if (bpr == 1) return;
  __syncthreads();
  if (last && warp == 0) {  // every other partial of the row is written and fenced
    __threadfence();
    int s = 0;
    for (int p = lane; p < bpr; p += 32) s += __ldcg(partials + row_idx * bpr + p);
    s = __reduce_add_sync(0xffffffffu, s);
    if (lane == 0) {
      out[row_idx] = s;
      tickets[row_idx] = 0;  // left zero for the next launch on this stream
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns the launch's cudaError_t as an
// int (0 = cudaSuccess). Every entry of `out` (`rows` int32 counts) is
// written. With `bpr` > 1 CTAs a row, `partials` holds rows * bpr int32 of
// scratch and `tickets` rows zeroed uint32 counters that no other launch
// uses at the same time (the launch leaves them zero). Does not synchronise
// and allocates nothing.
extern "C" int segment_rf_counts(const void* ids, void* out, long long rows, long long width, int bpr,
                                 void* partials, void* tickets, void* stream) {
  if (rows <= 0 || width <= 0 || bpr <= 0 || rows * bpr > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_rf_kernel<<<static_cast<unsigned>(rows * bpr), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<int32_t*>(out), width, bpr, static_cast<int*>(partials),
      static_cast<unsigned*>(tickets));
  return static_cast<int>(cudaGetLastError());
}

// Ids a CTA reads in one iteration: the caller gives a row no more CTAs
// than it has such chunks.
extern "C" long long segment_rf_chunk_ids() { return 4 * kChunk; }

extern "C" const char* segment_rf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
