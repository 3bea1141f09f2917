// One Jacobi min-sweep of SSSP or WCC over the int32 edge pack, in one pass.
//
// Replaces no pl.pallas_call. It is the port's counterpart of the JAX
// package's per-sweep scatters `cand.at[e[:, 1]].min(...)` and
// `cand.at[e[:, 0]].min(...)` (repro/graphs/engine.py:434-435 for SSSP,
// 466-467 for WCC), which the port ran as two gathers, two `where`s and two
// float `scatter_reduce_` amin over an int64 copy of the pack.
//
// With nx a copy of x on entry, for every slot s with mask[s] > 0 and
// endpoints (u, v):
//
//     nx[v] = min(nx[v], x[u] + step)   where x[u] + step < x[v]
//     nx[u] = min(nx[u], x[v] + step)   where x[v] + step < x[u]
//
// so on exit nx = min(x, min over the neighbours of x[nbr] + step), the
// sweep of the reference, exactly: a minimum takes no rounding, and the sum
// x[nbr] + step is the same float32 addition. Only x is read, so the sweep
// is Jacobi and its result does not depend on the schedule. Bit 0 of
// `flags` is set where some candidate was below its target's x (the stop
// test `any(nx < x)`), bit 1 where a slot with mask > 0 held an id outside
// [0, V); such a slot is skipped. x must hold no NaN; +0 and -0 count as one
// value.
//
// Bound: bytes. Each slot is read once, 8 bytes of endpoints and 4 of mask;
// x is read once and nx written once, so on an H100 (3.35 TB/s) the least
// time is (12 * S + 8 * V) / 3.35e12 s for S slots and V vertices: 0.24 ms
// at graph500-22 (S = 64.2M, V = 2^22).
//
// Design:
// - The pack is read in place, as int32, with streaming loads (16 bytes of
//   endpoints and 8 of mask a thread, two slots; the wrapper requires views
//   so aligned), kSteps pairs a thread all in flight before any is used. No int64 copy and no temporaries: the endpoints' reads
//   evict first, so x and nx (2 * 16.8 MB at 2^22 vertices) keep the 50 MB L2.
// - The gathers of x[u] and x[v] are issued for the valid slots only, all of
//   a thread's at once, and serve both directions.
// - The atomic min is native: a float's bit pattern, read as an int32, is in
//   float order where the float is not negative, so atomicMin on it lowers
//   nx[t]; a negative candidate takes atomicMax on the unsigned pattern.
//   No compare-and-swap loop.
// - Hubs. A candidate is dropped before any atomic unless it is below
//   x[target] (most slots of a late sweep improve nothing), and the
//   survivor reads nx[target] from L2 first and skips the atomic where nx is
//   already as low, so a hub that one candidate has lowered turns the rest
//   away with a load. A warp's candidates for one target are not merged
//   first: on an H100 at graph500-22, merging them (__match_any_sync, then
//   __reduce_min_sync) made WCC's first sweeps 1.5-2.7x slower (1.85-2.58
//   against 0.96-1.23 ms) and saved nothing in the late ones: in the
//   first sweeps nearly every slot
//   lowers its higher endpoint, and those targets seldom repeat in a warp.
// - The flag is written by one lane a warp, once, at the end.
// The host copies x to nx and zeroes the flags on the launch's stream first.
// Offsets are int64; V fits an int32.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 2;                    // slots a lane loads at once: 16 bytes of endpoints, 8 of mask
constexpr int kSteps = 4;                  // slot pairs a thread loads before it uses one
constexpr long long kMaxGrid = 1 << 20;    // blocks launched; more tiles are strided over
constexpr unsigned kAll = 0xffffffffu;
constexpr int kChanged = 1, kBadId = 2;    // bits of the flags word

__device__ __forceinline__ void atomic_min_float(float* a, float f) {
  if (__float_as_int(f) >= 0) atomicMin(reinterpret_cast<int*>(a), __float_as_int(f));
  else atomicMax(reinterpret_cast<unsigned*>(a), __float_as_uint(f));
}

// Lowers nx[target] to c where `improves` and nx[target], read from L2, is
// not already as low.
__device__ __forceinline__ void lower(float* __restrict__ nx, int target, float c, bool improves) {
  if (improves && c < __ldcg(nx + target)) atomic_min_float(nx + target, c);
}

// 16-byte endpoint and 8-byte mask loads, two slots a lane a step; the last
// slot of an odd count alone takes 4-byte loads.
__global__ void __launch_bounds__(kThreads)
min_sweep_kernel(const int32_t* __restrict__ edges, const float* __restrict__ mask, const float* __restrict__ x,
                 float* __restrict__ nx, int* __restrict__ flags, long long slots, int v, float step,
                 long long tiles) {
  constexpr int kStrip = 32 * kVec * kSteps;  // slots of one warp's strip
  constexpr int kTile = kWarps * kStrip;      // slots of one block tile
  constexpr int kN = kVec * kSteps;           // slots a lane holds
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int bits = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long first = t * kTile + warp * kStrip + lane * kVec;
    int u[kN], w[kN];
    bool ok[kN];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const long long s = first + 32LL * kVec * i;
      float m[kVec];
      if (s + 1 < slots) {
        const int4 e = __ldcs(reinterpret_cast<const int4*>(edges + 2 * s));
        const float2 mm = __ldcs(reinterpret_cast<const float2*>(mask + s));
        u[kVec * i] = e.x, w[kVec * i] = e.y, m[0] = mm.x;
        u[kVec * i + 1] = e.z, w[kVec * i + 1] = e.w, m[1] = mm.y;
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const bool in = s + j < slots;
          u[kVec * i + j] = in ? __ldcs(edges + 2 * (s + j)) : 0;
          w[kVec * i + j] = in ? __ldcs(edges + 2 * (s + j) + 1) : 0;
          m[j] = in ? __ldcs(mask + s + j) : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int q = kVec * i + j;
        const bool live = m[j] > 0.0f;
        const bool inside = static_cast<unsigned>(u[q]) < static_cast<unsigned>(v) &&
                            static_cast<unsigned>(w[q]) < static_cast<unsigned>(v);
        if (live && !inside) bits |= kBadId;
        ok[q] = live && inside;
      }
    }
    float xu[kN], xw[kN];
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      xu[q] = ok[q] ? __ldg(x + u[q]) : 0.0f;
      xw[q] = ok[q] ? __ldg(x + w[q]) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      const float to_w = xu[q] + step, to_u = xw[q] + step;
      const bool lower_w = ok[q] && to_w < xw[q];
      const bool lower_u = ok[q] && to_u < xu[q];
      if (lower_w || lower_u) bits |= kChanged;
      lower(nx, w[q], to_w, lower_w);
      lower(nx, u[q], to_u, lower_u);
    }
  }
  const int any = static_cast<int>(__reduce_or_sync(kAll, static_cast<unsigned>(bits)));
  if (lane == 0 && any) atomicOr(flags, any);
}

}  // namespace

// Copies x to nx, zeroes the flags word and launches one sweep, all on
// `stream`; returns a cudaError_t as an int (0 = cudaSuccess). edges must be
// 16-byte and mask 8-byte aligned. Does not synchronise and allocates
// nothing.
extern "C" int min_sweep(const void* edges, const void* mask, const void* x, void* nx, void* flags,
                         long long slots, long long v, float step, void* stream) {
  if (slots <= 0 || v <= 0 || v > 0x7fffffffLL || reinterpret_cast<uintptr_t>(edges) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(mask) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(nx, x, static_cast<size_t>(v) * sizeof(float), cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(flags, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tile = static_cast<long long>(kThreads) * kSteps * kVec;
  const long long tiles = (slots + tile - 1) / tile;
  const unsigned grid = static_cast<unsigned>(tiles < kMaxGrid ? tiles : kMaxGrid);
  min_sweep_kernel<<<grid, kThreads, 0, s>>>(static_cast<const int32_t*>(edges), static_cast<const float*>(mask),
                                             static_cast<const float*>(x), static_cast<float*>(nx),
                                             static_cast<int*>(flags), slots, static_cast<int>(v), step, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* min_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
