// Distinct-id count per sorted row: the replication-factor measure of CEP chunks.
//
// Replaces the Pallas TPU kernel repro/kernels/segment_rf.py
// (segment_distinct_counts, body _segment_rf_kernel). For each row of a
// (rows, width) int32 array, sorted ascending and padded at the tail with
// PAD_ID = INT32_MAX, it counts the positions i where ids[i] != ids[i-1] and
// ids[i] != PAD_ID, with ids[-1] taken as -1.
//
// Bound: memory. The kernel reads rows*width*4 bytes once and does two
// compares and an add per element, so on an H100 (3.35 TB/s) the least time is
// rows*width*4 / 3.35e12 s. Design: a 2-D grid, rows on gridDim.x (not capped
// at 65535) and tiles of the row on gridDim.y, with a grid-stride loop over
// tiles for rows wider than 65535 tiles. Each block stages a tile in shared
// memory with coalesced loads, so every element is read from device memory
// once; only a tile's first element reads its predecessor from global memory.
// Per-thread counts are reduced with warp shuffles and a block reduction,
// and one atomicAdd per block adds the block's count into the row's output,
// which the caller zeroes.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 16;
constexpr int kTile = kThreads * kItemsPerThread;  // 4096 ids = 16 KiB of shared memory
constexpr int kMaxTilesPerRow = 65535;             // gridDim.y limit
constexpr int32_t kPadId = 0x7fffffff;

__global__ void __launch_bounds__(kThreads)
segment_rf_kernel(const int32_t* __restrict__ ids, int32_t* __restrict__ out, long long width) {
  __shared__ int32_t tile[kTile];
  __shared__ int warp_sums[kThreads / 32];

  const int32_t* row = ids + static_cast<long long>(blockIdx.x) * width;
  int count = 0;
  for (long long t0 = static_cast<long long>(blockIdx.y) * kTile; t0 < width;
       t0 += static_cast<long long>(gridDim.y) * kTile) {
    const int n = static_cast<int>(width - t0 < kTile ? width - t0 : kTile);
    for (int i = threadIdx.x; i < n; i += kThreads) tile[i] = row[t0 + i];
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int32_t v = tile[i];
      const int32_t prev = i > 0 ? tile[i - 1] : (t0 > 0 ? row[t0 - 1] : -1);
      count += (v != prev) & (v != kPadId);
    }
    __syncthreads();  // the next tile overwrites shared memory
  }

  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (warp == 0) {
    count = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
    if (lane == 0 && count != 0) atomicAdd(out + blockIdx.x, count);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = cudaSuccess). `out` must hold `rows` zeroed int32 counts. Does not
// synchronise and allocates nothing.
extern "C" int segment_rf_counts(const void* ids, void* out, long long rows, long long width,
                                 void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (width + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>(tiles < kMaxTilesPerRow ? tiles : kMaxTilesPerRow));
  segment_rf_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<int32_t*>(out), width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_rf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
