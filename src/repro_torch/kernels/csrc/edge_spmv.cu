// Blocked edge-centric gather-reduce (vertex-cut SpMV) over windowed chunks.
//
// Replaces the Pallas TPU kernel repro/kernels/edge_spmv.py (spmv_blocked,
// body _spmv_kernel). For each chunk c and each edge slot e of it:
//
//     out[c, dst_l[c, e]] += w[c, e] * x_win[c, src_l[c, e]]
//
// where an edge whose local ids are not both in [0, W_V) adds nothing (the
// caller pads empty slots with W_V). The TPU kernel builds two one-hot
// (W_E, W_V) matrices for its matrix unit; at W_V = 2^20 those would hold
// 10^12 entries, so this kernel gathers and scatters directly instead.
//
// Bound: memory. Each edge slot is read once (12 bytes: two ids and a
// weight), each window element of x is read and each output element written
// (8 bytes), so on an H100 (3.35 TB/s) the least time is
// (12 * C * W_E + 8 * C * W_V) / 3.35e12 s. Design: a 2-D grid, chunks on
// gridDim.x and tiles of a chunk's edges on gridDim.y with a grid-stride loop
// over tiles. One thread per edge slot: coalesced loads of the ids and the
// weight, a gather of x from the chunk's window, and an atomicAdd into the
// chunk's output row, which the caller zeroes. The order of the f32 sums
// therefore changes from run to run. Offsets are 64-bit.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTilesPerChunk = 65535;  // gridDim.y limit

__global__ void __launch_bounds__(kThreads)
edge_spmv_kernel(const int32_t* __restrict__ src_l, const int32_t* __restrict__ dst_l,
                 const float* __restrict__ w, const float* __restrict__ x_win,
                 float* __restrict__ out, long long w_e, long long w_v) {
  const long long row_e = static_cast<long long>(blockIdx.x) * w_e;
  const long long row_v = static_cast<long long>(blockIdx.x) * w_v;
  for (long long e = static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x; e < w_e;
       e += static_cast<long long>(gridDim.y) * kThreads) {
    const int32_t s = src_l[row_e + e];
    const int32_t d = dst_l[row_e + e];
    if (s < 0 || s >= w_v || d < 0 || d >= w_v) continue;  // padding or out of the window
    atomicAdd(out + row_v + d, w[row_e + e] * x_win[row_v + s]);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 = cudaSuccess). `out` must hold `chunks * w_v` zeroed floats. Does not
// synchronise and allocates nothing.
extern "C" int edge_spmv_blocked(const void* src_l, const void* dst_l, const void* w, const void* x_win,
                                 void* out, long long chunks, long long w_e, long long w_v, void* stream) {
  if (chunks <= 0 || chunks > 0x7fffffffLL || w_e <= 0 || w_v <= 0 || w_v > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (w_e + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(chunks),
                  static_cast<unsigned>(tiles < kMaxTilesPerChunk ? tiles : kMaxTilesPerChunk));
  edge_spmv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src_l), static_cast<const int32_t*>(dst_l), static_cast<const float*>(w),
      static_cast<const float*>(x_win), static_cast<float*>(out), w_e, w_v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* edge_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
