// The full rung's step-parallel GEO greedy as one kernel: the whole loop of
// steps runs on the card in one launch.
//
// Replaces the device program of repro/kernels/full_reorder.py
// (full_order_device, the lax.while_loop at :231-314), which XLA compiles
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
// Design. The per-vertex state (D, M int32; touched, selected one byte each;
// the frontier as a bitset: 10 B and one bit a vertex) lives in shared
// memory, split over the CTAs of a thread-block cluster where one CTA's
// does not hold it:
// - one CTA of 1024 threads wherever its shared memory holds the state
//   (about 21,600 vertices). That is a size rule: there the scan is a
//   fraction of a step and a cluster barrier costs 18x a __syncthreads, so a
//   cluster of 2 took 7.70 us a step at 16,384 vertices against one CTA's
//   4.97 (H100, tools/greedy_variants.py);
// - above it, the smallest cluster of C <= 16 CTAs whose shared memory holds
//   the state: vertex x belongs to CTA rank x / per, and every other CTA
//   reaches it through distributed shared memory (DSMEM);
// - past 16 CTAs' shared memory, a cluster of 16 with the state in a global
//   scratch, cut into the same per-rank ranges.
// A step runs in four phases. The first three end at a barrier of the
// cluster (cluster.sync(), release/acquire at cluster scope: 0.70-0.76 us on
// the H100, tools/greedy_variants.py) or, for one CTA, of the CTA; the apply
// writes only each CTA's own range and ends at __syncthreads:
// - Argmin: each CTA reduces its own range (four vertices a thread a round,
//   16-byte loads) to the packed 64-bit key
//   ((uint32)(pri ^ 0x80000000) << 32) | v, whose minimum is argmin's first
//   index on ties exactly (the fallback: (permpos << 32) | v), and writes it
//   to its shared memory; after the barrier every warp takes the minimum of
//   the C partials through DSMEM.
// - One-hop: the cluster's threads walk inc[ptr[vmin]:ptr[vmin+1]], skip
//   done slots, write their keys, decrement D[other] and set its frontier bit
//   with integer atomics at the owner (order-free) and append each new
//   frontier vertex to a list in global memory.
// - Two-hop collect: each CTA scans the same frontier batch's list lengths
//   and takes every C-th stretch of 32 of the flat index range (no warp
//   waits on a hub's long list); a slot with both ends in the frontier is
//   taken only from its u side (the twin's wother = where(u_in, v, u) makes
//   tu = u there). The test reads M[w] and touched[w] as the one-hop left
//   them: the one-hop's own writes (M = i1, touched for the frontier) are
//   deferred to the apply phase, so the test takes them from the frontier
//   bit. Qualifying slots are appended to a list and counted (n2).
// - Apply: keys, D and M with i2 = i1 + n2; M only grows (i1 <= i2, both
//   past every earlier value), so the frontier's M = i1 and the two-hop's
//   M = i2 are atomicMax and need no order; the frontier bits are cleared.
//   Every CTA reads the two lists whole and writes its own vertices only (a
//   slot's keys: the owner of its frontier end), so the next argmin, over
//   the same range, follows a __syncthreads and not a cluster barrier.
// Counts (n1, nf, n2) are warp-aggregated atomics on counters in CTA rank 0's
// shared memory, read by every CTA after the barrier that closes their phase
// and reset by rank 0 after the next cluster barrier, so every CTA runs the
// same t and i.
//
// Deadlock. The launch has no grid-wide barrier: one CTA, or one cluster,
// whose CTAs the hardware schedules together on one GPC. Its barriers wait
// only for threads that are resident, so it cannot deadlock beside other
// kernels (the ingest stream's scatters run beside it when the rebuild is in
// flight on its side stream). No CTA leaves while another may still touch
// its shared memory: a final cluster.sync() closes the kernel.
//
// Bound. Bytes: each step's argmin reads the state, 10 B a vertex, so the
// steps T read T * 10 * nv bytes, plus the incidence entries the walks read
// (inc 4 B, u and v 8 B, done 1 B each) and 16 B of keys written once a live
// slot: about 0.4 ms at 3.35 TB/s for path 4's 16,384 vertices and 8,465
// steps. The dependency chain: T steps in sequence, each at least its
// barriers (three of the cluster's) and the dependent loads of its two
// walks; at microseconds a step that chain, not the bytes, bounds the
// kernel. The kernel reports T and the entries walked, so a caller computes
// the bytes of its own run.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr unsigned long long kNone = ~0ull;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

enum Mode { kOneCta = 0, kClusterShared = 1, kClusterGlobal = 2 };

struct State {
  int* d;                   // D[v]: live edges of v not yet ordered (0 once v is selected)
  int* m;                   // M[v]: edges ordered when v was last touched (|X^phi| then)
  unsigned* fr;             // the current step's frontier, one bit a vertex
  unsigned char* touched;   // touched[v]
  unsigned char* selected;  // selected[v]
};

// The state of n vertices (n a multiple of 32) laid out from base.
__host__ __device__ inline long long padded_vertices(long long nv) { return (nv + 31) / 32 * 32; }
__host__ __device__ inline long long state_bytes(long long n) { return n * 10 + n / 8; }
__host__ __device__ inline long long slice_bytes(long long n) { return (state_bytes(n) + 15) / 16 * 16; }
__device__ inline State carve(unsigned char* base, int n) {
  State s;
  s.d = reinterpret_cast<int*>(base);
  s.m = s.d + n;
  s.fr = reinterpret_cast<unsigned*>(s.m + n);
  s.touched = reinterpret_cast<unsigned char*>(s.fr + n / 32);
  s.selected = s.touched + n;
  return s;
}

struct Shared {
  unsigned long long red[kWarps + 1];
  unsigned long long part[2];  // this CTA's argmin and fallback partials
  int scan[kWarps + 1];
  int foff[kThreads + 1];      // prefix sums of a frontier batch's list lengths
  int fstart[kThreads];        // ptr[f] of the batch's vertices
  int fv[kThreads];            // the batch's vertices
  int n1, nf, n2;              // rank 0's are the cluster's counts
  State views[kMaxCluster];    // each rank's state: DSMEM windows or global slices
};

struct Plan {
  int mode, cluster, per;  // per: vertices a rank, a multiple of 32
  long long smem;          // dynamic shared memory a CTA
  long long global;        // scratch bytes of a global state
};

struct DeviceInfo {
  bool ready;
  long long room_one, room_cluster;  // dynamic shared memory a CTA can take beside the static arrays
  int fits[3][kMaxCluster + 1];      // cudaOccupancyMaxActiveClusters by mode and C (-1: not asked yet)
};
DeviceInfo g_info[kMaxDevices];

// Index of this lane's item among the warp's items with pred set, offset by
// the warp's claim on *counter (one atomic a warp, shared memory of this CTA
// or of rank 0 through DSMEM). Every lane calls.
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

// best, or the packed (priority, vertex) key of x where x is a candidate:
// live (touched, not selected) and D > 0. The priority is the twin's int32
// arithmetic, computed in unsigned 32-bit words (the same bits, no
// overflow).
__device__ __forceinline__ unsigned long long candidate(unsigned long long best, int d, int m, unsigned live, int x,
                                                        int alpha, int beta) {
  const unsigned pri = static_cast<unsigned>(alpha) * static_cast<unsigned>(d) -
                       static_cast<unsigned>(beta) * static_cast<unsigned>(m);
  const unsigned long long key = (static_cast<unsigned long long>(pri ^ 0x80000000u) << 32) | static_cast<unsigned>(x);
  return live && d > 0 ? umin64(best, key) : best;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long x) {
  for (int o = 16; o > 0; o >>= 1) x = umin64(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Block-wide minimum, returned to every thread. red holds kWarps + 1 values.
__device__ unsigned long long block_min(unsigned long long x, unsigned long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_min(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = warp_min(lane < kWarps ? red[lane] : kNone);
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

// Vertex x's state: this CTA's shared memory for one CTA, its owner's
// range (a DSMEM window or a global slice) for a cluster.
struct Vertex {
  int* d;
  int* m;
  unsigned* frw;  // the frontier word holding x's bit
  unsigned char* touched;
  unsigned char* selected;
  unsigned bit;
};

template <int kMode>
__device__ __forceinline__ Vertex vertex(const Shared& sh, const State& own, int x, int per) {
  const unsigned bit = 1u << (x & 31);
  if constexpr (kMode == kOneCta) {
    return {own.d + x, own.m + x, own.fr + (x >> 5), own.touched + x, own.selected + x, bit};
  } else {
    const int r = x / per, lx = x - r * per;
    const State& s = sh.views[r];
    return {s.d + lx, s.m + lx, s.fr + (lx >> 5), s.touched + lx, s.selected + lx, bit};
  }
}

template <int kMode>
__device__ __forceinline__ void barrier() {
  if constexpr (kMode == kOneCta) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// Every thread gets the minimum of the cluster's partials slot `which`
// (written by each rank before the barrier that precedes this call).
__device__ __forceinline__ unsigned long long cluster_min(Shared& sh, int which, int ranks) {
  const int lane = threadIdx.x & 31;
  unsigned long long x = kNone;
  if (lane < ranks) x = *cg::this_cluster().map_shared_rank(&sh.part[which], lane);
  return warp_min(x);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
greedy_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v, unsigned char* __restrict__ done,
              const int32_t* __restrict__ ptr, const int32_t* __restrict__ inc,
              const int32_t* __restrict__ permpos, int32_t* __restrict__ keys, long long cap,
              int32_t* __restrict__ frontier, int4* __restrict__ th, unsigned char* __restrict__ global_state,
              int32_t* __restrict__ steps_out, long long* __restrict__ work_out, int nv, int alpha, int beta,
              int delta, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;

  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = blockIdx.x, ranks = gridDim.x;  // the grid is one cluster: its block rank is blockIdx.x
  const int gt = rank * kThreads + tid, gwarp = gt >> 5, stride = ranks * kThreads;
  const bool lead = gt == 0;  // keeps the work counts and writes the results
  int32_t* step_key = keys;
  int32_t* phase_key = keys + cap;
  int32_t* ka = keys + 2 * cap;
  int32_t* kb = keys + 3 * cap;
  const long long slice = slice_bytes(per);  // a rank's part of a global state

  // This CTA's range [lo_v, hi_v) and its state.
  const int lo_v = rank * per, hi_v = min(nv, lo_v + per);
  const State own = carve(kMode == kClusterGlobal ? global_state + rank * slice : smem, per);
  for (int x = tid; x < per; x += kThreads) {
    const int g = lo_v + x;
    own.d[x] = g < nv ? ptr[g + 1] - ptr[g] : 0;  // the live degree
    own.m[x] = 0;
    own.touched[x] = 0;
    own.selected[x] = 0;
  }
  for (int x = tid; x < per / 32; x += kThreads) own.fr[x] = 0;
  if constexpr (kMode != kOneCta) {
    if (tid < ranks)
      sh.views[tid] = carve(kMode == kClusterGlobal ? global_state + tid * slice
                                                    : cg::this_cluster().map_shared_rank(smem, tid),
                            per);
  }
  if (tid == 0) sh.n1 = sh.nf = sh.n2 = 0;
  int* n1p = &sh.n1;
  int* nfp = &sh.nf;
  int* n2p = &sh.n2;
  if constexpr (kMode != kOneCta) {
    n1p = cg::this_cluster().map_shared_rank(n1p, 0);
    nfp = cg::this_cluster().map_shared_rank(nfp, 0);
    n2p = cg::this_cluster().map_shared_rank(n2p, 0);
  }
  const int e_live = ptr[nv] / 2;
  barrier<kMode>();  // every rank's state, views and counters are set before any is read

  int t = 0, i = 0;
  long long walked = 0, fallbacks = 0;  // kept by the lead thread
  while (t < nv && i < e_live) {
    // --- v_min: the least packed (priority, vertex) key over the candidates
    // (four vertices a thread a round: a 16-byte load of D and of M, a word
    // of touched and of selected; past nv, D is 0)
    unsigned long long best = kNone;
#pragma unroll 2
    for (int q = tid; q < per / 4; q += kThreads) {
      const int4 dq = reinterpret_cast<const int4*>(own.d)[q];
      const int4 mq = reinterpret_cast<const int4*>(own.m)[q];
      const unsigned live = reinterpret_cast<const unsigned*>(own.touched)[q] &
                            ~reinterpret_cast<const unsigned*>(own.selected)[q];  // bytes of 0 or 1
      const int x = lo_v + 4 * q;
      best = candidate(best, dq.x, mq.x, live & 1u, x, alpha, beta);
      best = candidate(best, dq.y, mq.y, live & 0x100u, x + 1, alpha, beta);
      best = candidate(best, dq.z, mq.z, live & 0x10000u, x + 2, alpha, beta);
      best = candidate(best, dq.w, mq.w, live & 0x1000000u, x + 3, alpha, beta);
    }
    best = block_min(best, sh.red);
    if constexpr (kMode != kOneCta) {
      if (tid == 0) sh.part[0] = best;
      barrier<kMode>();
      best = cluster_min(sh, 0, ranks);
      if (gt == 0) sh.n2 = 0;  // read by every rank before this barrier; written after the next
    }
    if (best == kNone) {  // no candidate anywhere: the fallback vertex
      for (int x = lo_v + tid; x < hi_v; x += kThreads) {
        const int lx = x - lo_v;
        if (own.d[lx] > 0 && !own.selected[lx])
          best = umin64(best, (static_cast<unsigned long long>(static_cast<unsigned>(permpos[x])) << 32) |
                                  static_cast<unsigned>(x));
      }
      best = block_min(best, sh.red);
      if constexpr (kMode != kOneCta) {
        if (tid == 0) sh.part[1] = best;
        barrier<kMode>();
        best = cluster_min(sh, 1, ranks);
      }
      fallbacks += lead;
    }
    const int vmin = best == kNone ? 0 : static_cast<int>(best & 0xffffffffu);  // argmin of all-MAX is 0

    // --- one-hop: every remaining edge of v_min, keyed by the neighbour
    const int lo = ptr[vmin], hi = ptr[vmin + 1];
    for (int b = lo + gwarp * 32; b < hi; b += stride) {
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
          const Vertex o = vertex<kMode>(sh, own, other, per);
          atomicSub(o.d, 1);
          done[s] = 1;
          first = !(atomicOr(o.frw, o.bit) & o.bit);
        }
      }
      warp_append(take, n1p);
      const int at = warp_append(first, nfp);
      if (first) frontier[at] = other;
    }
    barrier<kMode>();
    const int n1 = *n1p, nf = *nfp;
    const int i1 = i + n1;
    if (lead) walked += hi - lo;

    // --- two-hop collect: e_{f,w} with f in the frontier and w recent, as
    // the one-hop left M and touched (a frontier end: touched, M = i1)
    if (n1 > 0) {
      for (int f0 = 0; f0 < nf; f0 += kThreads) {
        const int nb = min(kThreads, nf - f0);
        int len = 0;
        if (tid < nb) {
          const int f = frontier[f0 + tid];
          const int a = ptr[f];
          len = ptr[f + 1] - a;
          sh.fstart[tid] = a;
          sh.fv[tid] = f;
        }
        int total = 0;
        const int off = block_exclusive_scan(len, &total, sh.scan);
        if (tid < nb) sh.foff[tid] = off;
        if (tid == 0) sh.foff[nb] = total;
        if (lead) walked += total;
        __syncthreads();
        for (int b = gwarp * 32; b < total; b += stride) {
          const int w = b + lane;
          bool take = false;
          int4 rec = make_int4(0, 0, 0, 0);
          if (w < total) {
            int a = 0, z = nb;  // foff[a] <= w < foff[z]
            while (z - a > 1) {
              const int mid = (a + z) >> 1;
              if (sh.foff[mid] <= w) a = mid;
              else z = mid;
            }
            const int s = inc[sh.fstart[a] + (w - sh.foff[a])];
            if (!done[s]) {
              const int us = u[s], vs = v[s];
              const Vertex vu = vertex<kMode>(sh, own, us, per);
              const bool u_in = *vu.frw & vu.bit;
              const int tu = u_in ? us : vs;  // the frontier end; u where both ends are in it
              if (tu == sh.fv[a]) {
                const int wo = u_in ? vs : us;
                const Vertex o = vertex<kMode>(sh, own, wo, per);
                const bool w_in = u_in && (*o.frw & o.bit);
                const int mw = w_in ? i1 : *o.m;
                take = (w_in || *o.touched) && !*o.selected && mw > 0 && i1 - mw <= delta && wo != vmin;
                rec = make_int4(s, tu, wo, 0);
              }
            }
          }
          const int at = warp_append(take, n2p);
          if (take) th[at] = rec;
        }
        __syncthreads();  // the next batch rewrites foff, fstart and fv
      }
    }
    if constexpr (kMode != kOneCta) {
      barrier<kMode>();
      if (gt == 0) sh.n1 = sh.nf = 0;  // every rank read them before this barrier
    }  // one CTA: the last batch's __syncthreads

    // --- apply: the two-hop's keys, D and M = i2; the frontier's M = i1
    // and touched; v_min selected. Each CTA reads both lists whole and
    // writes only its own range, so the next argmin, over that range, needs
    // no cluster barrier; a slot's keys come from the owner of its frontier
    // end.
    const int n2 = *n2p;
    const int i2 = i1 + n2;
    for (int x = tid; x < n2; x += kThreads) {
      const int4 r = th[x];
      const unsigned la = r.y - lo_v, lb = r.z - lo_v;
      if (la < static_cast<unsigned>(per)) {
        step_key[r.x] = t;
        phase_key[r.x] = 1;
        ka[r.x] = r.y;
        kb[r.x] = r.z;
        done[r.x] = 1;
        atomicSub(own.d + la, 1);
        atomicMax(own.m + la, i2);
      }
      if (lb < static_cast<unsigned>(per)) {
        atomicSub(own.d + lb, 1);
        atomicMax(own.m + lb, i2);
      }
    }
    for (int x = tid; x < nf; x += kThreads) {
      const unsigned lf = frontier[x] - lo_v;
      if (lf < static_cast<unsigned>(per)) {
        atomicMax(own.m + lf, i1);
        own.touched[lf] = 1;
        own.fr[lf >> 5] = 0;  // only frontier bits are set
      }
    }
    const unsigned ls = vmin - lo_v;
    if (tid == 0 && ls < static_cast<unsigned>(per)) {
      own.touched[ls] = 1;
      own.selected[ls] = 1;
      own.d[ls] = 0;
    }
    __syncthreads();
    if constexpr (kMode == kOneCta) {
      if (tid == 0) sh.n1 = sh.nf = sh.n2 = 0;  // every thread has read them; the next writes follow a barrier
    }
    i = i2;
    ++t;
  }
  if (lead) {
    *steps_out = t;
    work_out[0] = walked;
    work_out[1] = fallbacks;
  }
  if constexpr (kMode != kOneCta) cg::this_cluster().sync();
}

template <int kMode>
cudaError_t set_attributes(long long room) {
  cudaError_t err = cudaSuccess;
  if (room > 0)
    err = cudaFuncSetAttribute(greedy_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(room));
  if (err == cudaSuccess && kMode != kOneCta)
    err = cudaFuncSetAttribute(greedy_kernel<kMode>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
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
    cudaFuncAttributes one, cl;
    if ((err = cudaFuncGetAttributes(&one, greedy_kernel<kOneCta>)) != cudaSuccess) return err;
    if ((err = cudaFuncGetAttributes(&cl, greedy_kernel<kClusterShared>)) != cudaSuccess) return err;
    d.room_one = static_cast<long long>(optin) - static_cast<long long>(one.sharedSizeBytes);
    d.room_cluster = static_cast<long long>(optin) - static_cast<long long>(cl.sharedSizeBytes);
    if ((err = set_attributes<kOneCta>(d.room_one)) != cudaSuccess) return err;
    if ((err = set_attributes<kClusterShared>(d.room_cluster)) != cudaSuccess) return err;
    if ((err = set_attributes<kClusterGlobal>(0)) != cudaSuccess) return err;
    for (auto& row : d.fits)
      for (int& f : row) f = -1;
    d.ready = true;
  }
  *info = &d;
  return cudaSuccess;
}

// The branch for nv vertices: one CTA where its shared memory holds the
// state, else the smallest cluster whose shared memory does, else 16 CTAs
// over a global state.
Plan plan_for(const DeviceInfo& info, int nv) {
  const long long nvp = padded_vertices(nv);
  if (state_bytes(nvp) <= info.room_one)
    return {kOneCta, 1, static_cast<int>(nvp), state_bytes(nvp), 0};
  for (int c = 2; c <= kMaxCluster; ++c) {
    const long long per = padded_vertices((nvp + c - 1) / c);
    if (state_bytes(per) <= info.room_cluster) return {kClusterShared, c, static_cast<int>(per), state_bytes(per), 0};
  }
  const long long per = padded_vertices((nvp + kMaxCluster - 1) / kMaxCluster);
  return {kClusterGlobal, kMaxCluster, static_cast<int>(per), 0, kMaxCluster * slice_bytes(per)};
}

template <int kMode>
cudaLaunchConfig_t launch_config(const Plan& p, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kMode == kOneCta ? 0 : 1;
  return cfg;
}

// Whether a cluster of the plan's shape fits the card: cudaErrorInvalidClusterSize
// where cudaOccupancyMaxActiveClusters finds room for none.
template <int kMode>
cudaError_t check_fits(DeviceInfo& info, const Plan& p) {
  int& fits = info.fits[kMode][p.cluster];
  if (fits < 0) {
    Plan widest = p;  // asked once a size, at the most shared memory the branch takes
    widest.smem = kMode == kClusterShared ? info.room_cluster : 0;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config<kMode>(widest, nullptr, &attr);
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&fits, greedy_kernel<kMode>, &cfg);
    if (err != cudaSuccess) {
      fits = -1;
      return err;
    }
  }
  return fits > 0 ? cudaSuccess : cudaErrorInvalidClusterSize;
}

template <int kMode>
cudaError_t launch(DeviceInfo& info, const Plan& p, cudaStream_t stream, const int32_t* u, const int32_t* v,
                   unsigned char* done, const int32_t* ptr, const int32_t* inc, const int32_t* permpos, int32_t* keys,
                   long long cap, int32_t* frontier, int4* th, unsigned char* state, int32_t* steps_out,
                   long long* work_out, int nv, int alpha, int beta, int delta) {
  if constexpr (kMode != kOneCta) {
    const cudaError_t err = check_fits<kMode>(info, p);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<kMode>(p, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, greedy_kernel<kMode>, u, v, done, ptr, inc, permpos, keys, cap,
                                             frontier, th, state, steps_out, work_out, nv, alpha, beta, delta, p.per);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The launch plan for nv vertices on the current device: *cluster, the CTAs
// the kernel runs on (1: the one-CTA kernel), and *global_bytes, the scratch
// the state needs in global memory (0: it lies in shared memory). Returns a
// cudaError_t as an int.
extern "C" int full_reorder_plan(int nv, int* cluster, long long* global_bytes) {
  if (nv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo* info = nullptr;
  const cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = plan_for(*info, nv);
  *cluster = p.cluster;
  *global_bytes = p.global;
  return 0;
}

// Launches the greedy on `stream` and returns the launch's cudaError_t as an
// int (0 = cudaSuccess; a cluster the card cannot hold is
// cudaErrorInvalidClusterSize). u, v: (cap,) int32; done: (cap,) uint8, 1 for
// a dead slot, written; ptr: (nv + 1,) int32 and inc: (ptr[nv],) int32, the
// live incidence list; permpos: (nv,) int32; keys: (4, cap) int32 filled with
// INT32_MAX, the ordered slots' keys written; frontier: (nv,) int32 and th:
// (cap, 4) int32 scratch; state: the plan's global_bytes of scratch (ignored
// when that is 0); steps_out: (1,) int32; work_out: (2,) int64, the incidence
// entries walked and the fallback steps. Does not synchronise and allocates
// nothing.
extern "C" int full_reorder_greedy(const void* u, const void* v, void* done, const void* ptr, const void* inc,
                                   const void* permpos, void* keys, void* frontier, void* th, void* state,
                                   void* steps_out, void* work_out, long long cap, int nv, int alpha, int beta,
                                   int delta, void* stream) {
  if (cap <= 0 || nv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo* info = nullptr;
  const cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = plan_for(*info, nv);
  auto go = [&](auto mode) {
    return launch<decltype(mode)::value>(
        *info, p, static_cast<cudaStream_t>(stream), static_cast<const int32_t*>(u), static_cast<const int32_t*>(v),
        static_cast<unsigned char*>(done), static_cast<const int32_t*>(ptr), static_cast<const int32_t*>(inc),
        static_cast<const int32_t*>(permpos), static_cast<int32_t*>(keys), cap, static_cast<int32_t*>(frontier),
        static_cast<int4*>(th), static_cast<unsigned char*>(state), static_cast<int32_t*>(steps_out),
        static_cast<long long*>(work_out), nv, alpha, beta, delta);
  };
  switch (p.mode) {
    case kOneCta: return static_cast<int>(go(std::integral_constant<int, kOneCta>{}));
    case kClusterShared: return static_cast<int>(go(std::integral_constant<int, kClusterShared>{}));
    default: return static_cast<int>(go(std::integral_constant<int, kClusterGlobal>{}));
  }
}

extern "C" const char* full_reorder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
