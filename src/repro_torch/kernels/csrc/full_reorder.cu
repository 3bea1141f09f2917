// The full rung's step-parallel GEO greedy as one kernel: the whole loop of
// steps runs on the card in one launch.
//
// Replaces the device program of repro/kernels/full_reorder.py
// (full_order_device, the lax.while_loop at :231-300), which XLA compiles
// into one program with a device-side condition (t < nv) & (i < e_live).
// Each step picks v_min = argmin over touched, unselected vertices with
// D > 0 of alpha*D - beta*M (first index on ties; the least fallback rank
// permpos among unselected vertices with D > 0 when there is no candidate),
// orders v_min's remaining edges keyed by the neighbour (one-hop), then the
// edges e_{f,w} with f in that fresh frontier and w touched, unselected and
// recent: 0 < M[w], i1 - M[w] <= delta (two-hop). Every ordered slot gets the
// keys (step, phase, key_a, key_b); the caller sorts them. The arithmetic is
// int32, as in the JAX twin (greedy_params rejects graphs whose priorities
// could wrap).
//
// Design: one CTA of 1024 threads, __syncthreads() the step barrier, so it
// cannot deadlock beside other kernels (the ingest stream's scatters run
// beside it when the rebuild is in flight on its side stream).
// - Per-vertex state (D, M int32; touched, selected one byte each; the
//   frontier as a bitset: 10 B and one bit a vertex) lives in shared memory
//   where it fits (about 22,000 vertices), else in a global scratch buffer
//   that stays in L2. The kernel initialises it: D from the incidence list.
// - Argmin: a block reduction over the packed 64-bit key
//   ((uint32)(pri ^ 0x80000000) << 32) | v, whose minimum is argmin's first
//   index on ties exactly; the fallback uses (permpos << 32) | v.
// - One-hop: the block walks inc[ptr[vmin]:ptr[vmin+1]], skips done slots,
//   writes their keys, decrements D[other] with integer atomics (order-free)
//   and appends each new frontier vertex (atomicOr on its bit) to a list.
// - Two-hop: the frontier's incidence lists are walked flat, 1024 entries a
//   round, a frontier vertex found by binary search over the prefix sums of
//   its batch's list lengths (no warp waits on a hub's long list). A slot
//   with both ends in the frontier is taken only from its u side (the twin's
//   wother = where(u_in, v, u) makes tu = u there). The test reads M[w] as
//   the one-hop left it, so the qualifying slots are first collected into a
//   list and counted (n2), a barrier passes, and only then are keys, D and M
//   written with i2 = i1 + n2.
// - Counts and list positions come from warp-aggregated shared atomics.
//
// Bound. Bytes: each step's argmin reads the state, 10 B a vertex, so the
// steps T read T * 10 * nv bytes, plus the incidence entries the walks read
// (inc 4 B, u and v 8 B, done 1 B each) and 16 B of keys written once a live
// slot: about 0.4 ms at 3.35 TB/s for path 4's 16,384 vertices and 8,465
// steps. The dependency chain: T steps in sequence, each with at least two
// block-wide reductions and four barriers, and dependent loads in each walk;
// at microseconds a step that chain, not the bytes, bounds the kernel. The
// kernel reports T and the entries walked, so a caller computes the bytes of
// its own run.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kPad = 0x7fffffff;
constexpr unsigned long long kNone = ~0ull;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

struct State {
  int* d;                   // D[v]: live edges of v not yet ordered (0 once v is selected)
  int* m;                   // M[v]: edges ordered when v was last touched (|X^phi| then)
  unsigned* fr;             // the current step's frontier, one bit a vertex
  unsigned char* touched;   // touched[v]
  unsigned char* selected;  // selected[v]
};

__host__ __device__ inline long long padded_vertices(long long nv) { return (nv + 31) / 32 * 32; }
__host__ __device__ inline long long state_bytes(long long nv) {
  const long long nvp = padded_vertices(nv);
  return nvp * 10 + nvp / 8;
}

struct DeviceInfo {
  bool ready;
  long long smem_state_max;  // largest state that fits in shared memory beside the static arrays
};
DeviceInfo g_info[kMaxDevices];

// Index of this lane's item among the warp's items with pred set, offset by
// the warp's claim on *counter (one shared atomic a warp). Every lane calls.
__device__ __forceinline__ int warp_append(bool pred, int* counter) {
  const unsigned mask = __ballot_sync(kFull, pred);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && mask) base = atomicAdd(counter, __popc(mask));
  base = __shfl_sync(kFull, base, 0);
  return base + __popc(mask & ((1u << lane) - 1u));
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a, unsigned long long b) {
  return b < a ? b : a;
}

// Block-wide minimum, returned to every thread. red holds kWarps + 1 values.
__device__ unsigned long long block_min(unsigned long long x, unsigned long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x = umin64(x, __shfl_xor_sync(kFull, x, o));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? red[lane] : kNone;
    for (int o = 16; o > 0; o >>= 1) x = umin64(x, __shfl_xor_sync(kFull, x, o));
    if (lane == 0) red[kWarps] = x;
  }
  __syncthreads();
  return red[kWarps];
}

// Block-wide exclusive prefix sum of x; *total gets the sum. s holds
// kWarps + 1 ints.
__device__ int block_exclusive_scan(int x, int* total, int* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s[lane] : 0;
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kWarps) s[lane] = wi - w;
    if (lane == 31) s[kWarps] = wi;
  }
  __syncthreads();
  *total = s[kWarps];
  return s[warp] + incl - x;
}

__global__ void __launch_bounds__(kThreads, 1)
greedy_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v, unsigned char* __restrict__ done,
              const int32_t* __restrict__ ptr, const int32_t* __restrict__ inc,
              const int32_t* __restrict__ permpos, int32_t* __restrict__ keys, long long cap,
              int32_t* __restrict__ frontier, int4* __restrict__ th, unsigned char* __restrict__ global_state,
              int32_t* __restrict__ steps_out, long long* __restrict__ work_out, int nv, int alpha, int beta,
              int delta, int state_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_red[kWarps + 1];
  __shared__ int s_scan[kWarps + 1];
  __shared__ int s_foff[kThreads + 1];  // prefix sums of a frontier batch's list lengths
  __shared__ int s_fstart[kThreads];    // ptr[f] of the batch's vertices
  __shared__ int s_fv[kThreads];        // the batch's vertices
  __shared__ int s_n1, s_nf, s_n2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvp = static_cast<int>(padded_vertices(nv));
  int32_t* step_key = keys;
  int32_t* phase_key = keys + cap;
  int32_t* ka = keys + 2 * cap;
  int32_t* kb = keys + 3 * cap;

  unsigned char* base = state_in_smem ? smem : global_state;
  State S;
  S.d = reinterpret_cast<int*>(base);
  S.m = S.d + nvp;
  S.fr = reinterpret_cast<unsigned*>(S.m + nvp);
  S.touched = reinterpret_cast<unsigned char*>(S.fr + nvp / 32);
  S.selected = S.touched + nvp;
  for (int x = tid; x < nvp; x += kThreads) {
    S.d[x] = x < nv ? ptr[x + 1] - ptr[x] : 0;  // the live degree
    S.m[x] = 0;
    S.touched[x] = 0;
    S.selected[x] = 0;
  }
  for (int x = tid; x < nvp / 32; x += kThreads) S.fr[x] = 0;
  if (tid == 0) s_n1 = s_nf = s_n2 = 0;
  const int e_live = ptr[nv] / 2;
  __syncthreads();

  int t = 0, i = 0;
  long long walked = 0, fallbacks = 0;  // kept by thread 0
  while (t < nv && i < e_live) {
    // --- v_min: the least packed (priority, vertex) key over the candidates
    unsigned long long best = kNone;
#pragma unroll 4
    for (int x = tid; x < nv; x += kThreads) {
      const int dx = S.d[x];
      const long long pri = static_cast<long long>(alpha) * dx - static_cast<long long>(beta) * S.m[x];
      const unsigned long long key =
          (static_cast<unsigned long long>(static_cast<unsigned>(static_cast<int>(pri)) ^ 0x80000000u) << 32) |
          static_cast<unsigned>(x);
      const bool cand = dx > 0 && S.touched[x] && !S.selected[x];
      best = cand ? umin64(best, key) : best;
    }
    best = block_min(best, s_red);
    if (best == kNone) {  // no candidate: the fallback vertex
      for (int x = tid; x < nv; x += kThreads) {
        if (S.d[x] > 0 && !S.selected[x])
          best = umin64(best, (static_cast<unsigned long long>(static_cast<unsigned>(permpos[x])) << 32) |
                                  static_cast<unsigned>(x));
      }
      best = block_min(best, s_red);
      fallbacks += tid == 0;
    }
    const int vmin = best == kNone ? 0 : static_cast<int>(best & 0xffffffffu);  // argmin of all-MAX is 0

    // --- one-hop: every remaining edge of v_min, keyed by the neighbour
    const int lo = ptr[vmin], hi = ptr[vmin + 1];
    for (int b = lo + warp * 32; b < hi; b += kThreads) {
      const int j = b + lane;
      bool take = false, first = false;
      int other = 0;
      if (j < hi) {
        const int s = inc[j];
        if (!done[s]) {
          take = true;
          const int us = u[s];
          other = us == vmin ? v[s] : us;
          step_key[s] = t;
          phase_key[s] = 0;
          ka[s] = other;
          kb[s] = 0;
          atomicSub(&S.d[other], 1);
          done[s] = 1;
          const unsigned bit = 1u << (other & 31);
          first = !(atomicOr(&S.fr[other >> 5], bit) & bit);
        }
      }
      warp_append(take, &s_n1);
      const int at = warp_append(first, &s_nf);
      if (first) frontier[at] = other;
    }
    __syncthreads();
    const int n1 = s_n1, nf = s_nf;
    const int i1 = i + n1;
    for (int x = tid; x < nf; x += kThreads) {
      const int f = frontier[x];
      S.m[f] = i1;
      S.touched[f] = 1;
    }
    if (tid == 0) {
      S.touched[vmin] = 1;
      S.selected[vmin] = 1;
      S.d[vmin] = 0;
      walked += hi - lo;
    }
    __syncthreads();

    // --- two-hop: collect e_{f,w} (f in the frontier, w recent) before any
    // write of M, since the test reads M[w] as the one-hop left it
    if (n1 > 0) {
      for (int f0 = 0; f0 < nf; f0 += kThreads) {
        const int nb = min(kThreads, nf - f0);
        int len = 0;
        if (tid < nb) {
          const int f = frontier[f0 + tid];
          const int a = ptr[f];
          len = ptr[f + 1] - a;
          s_fstart[tid] = a;
          s_fv[tid] = f;
        }
        int total = 0;
        const int off = block_exclusive_scan(len, &total, s_scan);
        if (tid < nb) s_foff[tid] = off;
        if (tid == 0) {
          s_foff[nb] = total;
          walked += total;
        }
        __syncthreads();
        for (int b = warp * 32; b < total; b += kThreads) {
          const int w = b + lane;
          bool take = false;
          int4 rec = make_int4(0, 0, 0, 0);
          if (w < total) {
            int a = 0, z = nb;  // s_foff[a] <= w < s_foff[z]
            while (z - a > 1) {
              const int mid = (a + z) >> 1;
              if (s_foff[mid] <= w) a = mid;
              else z = mid;
            }
            const int s = inc[s_fstart[a] + (w - s_foff[a])];
            if (!done[s]) {
              const int us = u[s], vs = v[s];
              const bool u_in = (S.fr[us >> 5] >> (us & 31)) & 1u;
              const int tu = u_in ? us : vs;  // the frontier end; u where both ends are in it
              if (tu == s_fv[a]) {
                const int wo = u_in ? vs : us;
                const int mw = S.m[wo];
                take = S.touched[wo] && !S.selected[wo] && mw > 0 && i1 - mw <= delta && wo != vmin;
                rec = make_int4(s, tu, wo, 0);
              }
            }
          }
          const int at = warp_append(take, &s_n2);
          if (take) th[at] = rec;
        }
        __syncthreads();  // the next batch rewrites s_foff, s_fstart and s_fv
      }
    }
    const int n2 = s_n2;
    const int i2 = i1 + n2;
    for (int x = tid; x < n2; x += kThreads) {
      const int4 r = th[x];
      step_key[r.x] = t;
      phase_key[r.x] = 1;
      ka[r.x] = r.y;
      kb[r.x] = r.z;
      atomicSub(&S.d[r.y], 1);
      atomicSub(&S.d[r.z], 1);
      S.m[r.y] = i2;
      S.m[r.z] = i2;
      done[r.x] = 1;
    }
    for (int x = tid; x < nf; x += kThreads) S.fr[frontier[x] >> 5] = 0;  // only frontier bits are set
    __syncthreads();
    if (tid == 0) s_n1 = s_nf = s_n2 = 0;  // every thread has read them; the next writes follow a barrier
    i = i2;
    ++t;
  }
  if (tid == 0) {
    *steps_out = t;
    work_out[0] = walked;
    work_out[1] = fallbacks;
  }
}

cudaError_t device_info(DeviceInfo** info) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_info[dev];
  if (!d.ready) {
    int optin = 0;
    if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess)
      return err;
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, greedy_kernel)) != cudaSuccess) return err;
    const long long room = static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
    if (room > 0 && (err = cudaFuncSetAttribute(greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(room))) != cudaSuccess)
      return err;
    d.smem_state_max = room > 0 ? room : 0;
    d.ready = true;
  }
  *info = &d;
  return cudaSuccess;
}

}  // namespace

// Bytes of global scratch the state needs on the current device for nv
// vertices: 0 where it fits in shared memory. Negative: a cudaError_t.
extern "C" long long full_reorder_state_bytes(int nv) {
  DeviceInfo* info = nullptr;
  const cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const long long need = state_bytes(nv);
  return need <= info->smem_state_max ? 0 : need;
}

// Launches the greedy on `stream` and returns the launch's cudaError_t as an
// int (0 = cudaSuccess). u, v: (cap,) int32; done: (cap,) uint8, 1 for a dead
// slot, written; ptr: (nv + 1,) int32 and inc: (ptr[nv],) int32, the live
// incidence list; permpos: (nv,) int32; keys: (4, cap) int32 filled with
// INT32_MAX, the ordered slots' keys written; frontier: (nv,) int32 and th:
// (cap, 4) int32 scratch; state: full_reorder_state_bytes(nv) bytes of
// scratch (ignored when that is 0); steps_out: (1,) int32; work_out: (2,)
// int64, the incidence entries walked and the fallback steps. Does not
// synchronise and allocates nothing.
extern "C" int full_reorder_greedy(const void* u, const void* v, void* done, const void* ptr, const void* inc,
                                   const void* permpos, void* keys, void* frontier, void* th, void* state,
                                   void* steps_out, void* work_out, long long cap, int nv, int alpha, int beta,
                                   int delta, void* stream) {
  if (cap <= 0 || nv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo* info = nullptr;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = state_bytes(nv);
  const bool in_smem = need <= info->smem_state_max;
  greedy_kernel<<<1, kThreads, in_smem ? static_cast<size_t>(need) : 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(u), static_cast<const int32_t*>(v), static_cast<unsigned char*>(done),
      static_cast<const int32_t*>(ptr), static_cast<const int32_t*>(inc), static_cast<const int32_t*>(permpos),
      static_cast<int32_t*>(keys), cap, static_cast<int32_t*>(frontier), static_cast<int4*>(th),
      static_cast<unsigned char*>(state), static_cast<int32_t*>(steps_out), static_cast<long long*>(work_out), nv,
      alpha, beta, delta, in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* full_reorder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
