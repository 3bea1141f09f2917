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
// Bound: memory. The two ids of each edge slot are read once (8 bytes), the
// weight only for a valid slot (4 bytes; a padding slot's weight adds
// nothing), each output element is written once and each x entry that the
// gather needs is read once, so on an H100 (3.35 TB/s) the least time is
// about (8 * C * W_E + 4 * valid slots + 4 * C * W_V + 4 * distinct x reads)
// / 3.35e12 s.
// What stands between the kernel and that bound is the scatter: one
// read-modify-write in L2 per add, and a miss to device memory whenever the
// line it hits has left L2. The design attacks both:
//
// * Chunk-major order. Tile t of a 1-D grid is tile t % tiles_per_chunk of
//   chunk t / tiles_per_chunk, and the card starts blocks in the order of
//   their index, so the blocks in flight hold the output rows and x windows
//   of a few consecutive chunks, which stay in the 50 MB L2, instead of every
//   chunk's at once. One block a tile lets the card hand a tile to whichever
//   SM is free; past kMaxGrid tiles the blocks stride over the rest.
// * Warp-aggregated atomics. Each warp walks a strip of consecutive edge
//   slots, 32 at a time (lane i on slot i, coalesced streaming loads). GEO
//   puts runs of edges with one dst next to each other, so a segmented
//   reduction over lanes with equal dst (head flags from a ballot, five
//   __shfl_down_sync steps) leaves one atomicAdd per run, issued by the
//   run's head. The run that reaches the last lane is carried into the
//   warp's next 32 slots, so a long run (a hub vertex) costs one atomic per
//   strip. Invalid slots (padding, ids outside [0, W_V)) start no run and
//   add exactly 0; a step with no valid slot skips the reduction.
//
// The caller zeroes `out`. The f32 sums run in an order that depends on the
// schedule, so they change from run to run. Offsets are 64-bit.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 4;                   // 32-slot steps in one warp's strip
constexpr int kStrip = 32 * kSteps;         // edge slots of one warp's strip
constexpr int kTile = kWarps * kStrip;      // edge slots of one block tile
constexpr long long kMaxGrid = 1 << 16;    // blocks launched; more tiles are strided over
constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
edge_spmv_kernel(const int32_t* __restrict__ src_l, const int32_t* __restrict__ dst_l,
                 const float* __restrict__ w, const float* __restrict__ x_win,
                 float* __restrict__ out, long long w_e, long long w_v, long long tiles_per_chunk,
                 long long tiles) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long chunk = t / tiles_per_chunk;
    const long long first = (t - chunk * tiles_per_chunk) * kTile + warp * kStrip + lane;
    const int32_t* src_row = src_l + chunk * w_e;
    const int32_t* dst_row = dst_l + chunk * w_e;
    const float* w_row = w + chunk * w_e;
    const float* x_row = x_win + chunk * w_v;
    float* out_row = out + chunk * w_v;

    // The whole strip's loads first, so that they are all in flight at once:
    // the ids (read once: streaming loads), then for the valid slots only the
    // weight and the gather of x.
    int32_t s[kSteps], d[kSteps];
    float val[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const long long e = first + 32 * i;
      s[i] = e < w_e ? __ldcs(src_row + e) : -1;
      d[i] = e < w_e ? __ldcs(dst_row + e) : -1;
      if (s[i] < 0 || s[i] >= w_v || d[i] < 0 || d[i] >= w_v) d[i] = -1;  // padding or outside the window
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i)
      val[i] = d[i] < 0 ? 0.0f : __ldcs(w_row + first + 32 * i) * __ldg(x_row + s[i]);

    // Segmented reduction of each 32-slot step; `carry_d`/`carry_v` (the same
    // in every lane) hold the run that reached lane 31 of the last step.
    int carry_d = -1;
    float carry_v = 0.0f;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int di = d[i];
      float vi = val[i];
      if (__ballot_sync(kAll, di >= 0) == 0) {  // padding only: the carried run ends here
        if (carry_d >= 0 && lane == 0) atomicAdd(out_row + carry_d, carry_v);
        carry_d = -1;
        continue;
      }
      const int d0 = __shfl_sync(kAll, di, 0);
      if (carry_d >= 0 && lane == 0) {
        if (d0 == carry_d) vi += carry_v;                 // lane 0 continues the carried run
        else atomicAdd(out_row + carry_d, carry_v);       // the carried run ended with the last step
      }
      const int prev = __shfl_up_sync(kAll, di, 1);
      const bool head = di >= 0 && (lane == 0 || di != prev);
      const unsigned heads = __ballot_sync(kAll, head);
      // This lane's run ends before the next head above it (or at lane 32).
      const unsigned above = heads & ~((2u << lane) - 1u);
      const int end = above ? __ffs(above) - 1 : 32;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float other = __shfl_down_sync(kAll, vi, off);
        if (lane + off < end) vi += other;
      }
      // Each head now holds its run's sum. The last run is carried on, unless
      // this is the strip's last step.
      const int last = heads ? 31 - __clz(heads) : -1;
      if (head && (lane != last || i == kSteps - 1)) atomicAdd(out_row + di, vi);
      carry_d = heads && i < kSteps - 1 ? __shfl_sync(kAll, di, last < 0 ? 0 : last) : -1;
      carry_v = __shfl_sync(kAll, vi, last < 0 ? 0 : last);
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns a cudaError_t as an int
// (0 = cudaSuccess). `out` must hold `chunks * w_v` zeroed floats. Does not
// synchronise and allocates nothing.
extern "C" int edge_spmv_blocked(const void* src_l, const void* dst_l, const void* w, const void* x_win,
                                 void* out, long long chunks, long long w_e, long long w_v, void* stream) {
  if (chunks <= 0 || chunks > 0x7fffffffLL || w_e <= 0 || w_v <= 0 || w_v > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_per_chunk = (w_e + kTile - 1) / kTile;
  const long long tiles = chunks * tiles_per_chunk;
  const unsigned grid = static_cast<unsigned>(tiles < kMaxGrid ? tiles : kMaxGrid);
  edge_spmv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src_l), static_cast<const int32_t*>(dst_l), static_cast<const float*>(w),
      static_cast<const float*>(x_win), static_cast<float*>(out), w_e, w_v, tiles_per_chunk, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* edge_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
