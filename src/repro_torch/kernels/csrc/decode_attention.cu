// Single-token GQA decode attention over a long KV cache, as flash-decoding:
// a split-K kernel over the cache and a combine kernel.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention_partials, body _decode_kernel) and, on the merged path,
// its jnp merge_partials. For cache row b (one batch entry and kv head),
// query head g and the keys j of one split [j0, j1):
//
//     s_j = scale * q_g.k_j;  s_j = softcap * tanh(s_j / softcap)  (if softcap)
//     m = max_j s_j,  p_j = exp(s_j - m),  l = sum_j p_j
//     o = sum_j p_j v_j / max(l, 1e-30)
//
// all in f32, with m, l and o carried across the split's key tiles as an
// online softmax. Keys at or past cache_len[b] score -1e30 in the
// reference, so their p is exp(-1e30 - m) = 0 exactly wherever the split
// holds a key below cache_len: such keys are not read. A split wholly past
// cache_len ("masked") has m = -1e30, l = its length and o the mean of its
// v, as the reference's tile there; it reads v and never k.
//
// Two modes of decode_split_kernel. Partials (every_split = 1, split =
// block_s): every split is written, the masked ones too, which is the
// contract of decode_attention_partials. Merged (every_split = 0): a split
// that starts at or past cache_len exits at once and is never written; its
// weight l * exp(-1e30 - m_max) in the merge would be 0 exactly. A row with
// cache_len <= 0 is the exception: all its splits are masked and it decodes
// to the mean of all of v, as the reference does. decode_merge_kernel then
// LSE-combines each (row, head) over the row's written splits, as
// merge_partials does, and writes the (rows, gq, d_out) f32 output.
//
// Bound: memory. A query reads its row's cache once and does 4 * Gq flops
// per element pair of K and V, far below the ~295 flops per byte at which
// the H100's arithmetic would limit; the tensor cores have no role. The
// least time is the bytes of K and V below each row's cache_len over
// 3.35 TB/s, so the design reads no byte past cache_len on the merged path
// and keeps the copies of the bytes it does read in flight without pause.
// One block of 128 threads per (split, row, group of up to kG query heads),
// on a 3-D grid; a block whose split starts past cache_len exits. K and V
// tiles of kTile keys (16 KB each) come in by 1-D bulk copies (TMA) into a
// ring of kStages stages, each with an mbarrier that counts the copied
// bytes; thread 0 refills a stage as soon as the block is done with it, so
// kStages - 1 tiles stay in flight while one is consumed, and two blocks
// fit an SM (shared memory). Per tile: scores with a group of lanes per key
// (each lane 16-byte shared-memory reads of a slice of the key, the query
// heads' matching slices in registers, a shuffle reduction over the
// group), the online softmax with one warp per head, then P.V with each
// thread owning 16 (or 8) bytes of v's columns for a share of the tile's
// keys (summed through shared memory once per split). q is read in its own
// type and converted in the kernel. More than kG = 8 query heads a row run
// as several head groups, each reading the row's cache.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attention.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;          // K/V tiles of a block's ring
constexpr int kTileBytes = 16384;   // bytes of one K (or V) tile
constexpr int kMaxTileKeys = 64;
constexpr int kMaxRowsY = 65535;    // gridDim.y limit
constexpr int kMaxD = 256;
constexpr int kMergeWarps = 2;      // (row, head) pairs per combine block
constexpr float kNegInf = -1e30f;   // the TPU kernel's masking value

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

// Eight bf16 values: each is the high half of the f32 with the same value.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Four bf16 values from 8 bytes.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(x.x << 16);
  out[1] = __uint_as_float(x.x & 0xffff0000u);
  out[2] = __uint_as_float(x.y << 16);
  out[3] = __uint_as_float(x.y & 0xffff0000u);
}

// N values of type T from N * sizeof(T) bytes (16, or 8 for four bf16).
template <int N, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (N * sizeof(T) == 16) {
    load16(p, out);
  } else {
    load8(p, out);
  }
}

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <typename T, int D, int kG>
struct Cfg {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte read
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kTile = cmin(kMaxTileKeys, kTileBytes / kRowBytes);  // keys of a tile
  // Scores: kLanesPerKey lanes share one key, each holding kPerLane of its
  // elements (kChunks 16-byte pieces, kLanesPerKey pieces apart) for kG heads.
  static constexpr int kPerLane = 64 / kG;
  static constexpr int kChunks = kPerLane / kVec;
  static constexpr int kLanesPerKey = D / kPerLane;
  static constexpr int kKeysPerWarp = 32 / kLanesPerKey;
  // P.V: thread t owns piece t % kPieces (kPvVec columns of v: 16 bytes, or
  // 8 at bf16 and kG = 8, so that its kG x kPvVec sums stay 32 registers)
  // for keys t / kPieces + i * kKeyParts.
  static constexpr int kPvVec = cmin(kVec, 32 / kG);
  static constexpr int kPieces = D / kPvVec;
  static constexpr int kKeyParts = kThreads / kPieces;
  // Shared memory, in bytes: the ring (reused for the per-split sum of the
  // kKeyParts partial P.V), then q, the scores, m / l / alpha and the barriers.
  static constexpr int kStageBytes = 2 * kTile * kRowBytes;  // a K tile, then a V tile
  static constexpr int kRedBytes = kKeyParts * kG * D * 4;
  static constexpr int kQOff = cmax(kStages * kStageBytes, kRedBytes);
  static constexpr int kScOff = kQOff + kG * D * 4;
  static constexpr int kStatOff = kScOff + kG * kTile * 4;
  static constexpr int kBarOff = (kStatOff + 3 * kG * 4 + 7) / 8 * 8;
  static constexpr int kSmemBytes = kBarOff + kStages * 8;
  static_assert(kChunks >= 1 && kPerLane % kVec == 0, "a lane reads whole 16-byte pieces");
  static_assert(kLanesPerKey >= 1 && kLanesPerKey <= 32 && 32 % kLanesPerKey == 0, "lanes per key");
  static_assert(kThreads % kPieces == 0, "a block must cover whole rows of v");
  static_assert(kRowBytes % 16 == 0 && kTile >= 1, "bulk copies move 16-byte multiples");
  static_assert(kSmemBytes <= 232448, "more shared memory than a block can have");
};

// Thread 0's copy of tile t of a split (keys [t * kTile, ...) from kr / vr)
// into ring slot it % kStages: K unless masked, then V, exactly the tile's
// keys; the slot's barrier completes when their bytes have landed.
template <typename T, int D, int kG>
__device__ __forceinline__ void issue_tile(unsigned char* smem, uint64_t* full, uint32_t it, const T* kr,
                                           const T* vr, int t, int n_keys, bool masked) {
  using C = Cfg<T, D, kG>;
  const int s = it % kStages;
  const int nk = n_keys - t * C::kTile < C::kTile ? n_keys - t * C::kTile : C::kTile;
  const uint32_t bytes = static_cast<uint32_t>(nk) * C::kRowBytes;
  unsigned char* stage = smem + s * C::kStageBytes;
  const long long off = static_cast<long long>(t) * C::kTile * D;
  mbar_arrive_expect_tx(full + s, masked ? bytes : 2 * bytes);
  if (!masked) bulk_load(stage, kr + off, bytes, full + s);
  bulk_load(stage + C::kTile * C::kRowBytes, vr + off, bytes, full + s);
}

// One block: the keys [key0, key0 + split) of one row (clipped to the row's
// valid keys or to S) for query heads [g_base, g_base + kG). Grid: x = split
// index, y = row (striding past 65535 rows), z = head group.
template <typename T, int D, int kG>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const void* __restrict__ q, int q_bf16, int dq, const T* __restrict__ k, const T* __restrict__ v,
                    const int32_t* __restrict__ cache_len, float* __restrict__ o, float* __restrict__ m_out,
                    float* __restrict__ l_out, long long rows, int gq, long long s_len, int split, int every_split,
                    float scale, float softcap) {
  using C = Cfg<T, D, kG>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [kKeyParts][kG][D], over the ring after a split's last tile
  float* qs = reinterpret_cast<float*>(smem + C::kQOff);  // [kG][D]
  float* sc = reinterpret_cast<float*>(smem + C::kScOff);  // [kG][kTile] scores, then p
  float* m_run = reinterpret_cast<float*>(smem + C::kStatOff);  // [kG] running max
  float* l_run = m_run + kG;                                    // [kG] running sum of p
  float* alpha = l_run + kG;                                    // [kG] exp(m_old - m_new) of the tile
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long nsplit = gridDim.x, key0 = static_cast<long long>(blockIdx.x) * split;
  const int g_base = blockIdx.z * kG, gh = gq - g_base < kG ? gq - g_base : kG;
  const uint16_t* qb = static_cast<const uint16_t*>(q);
  const float* qf = static_cast<const float*>(q);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  uint32_t tiles_done = 0;  // tiles this block consumed over its rows: each stage's phase

  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long len = cache_len[row];
    long long end;
    bool masked;
    if (key0 < len) {
      end = key0 + split < len ? key0 + split : len;
      masked = false;
    } else if (every_split || len <= 0) {
      end = key0 + split;
      masked = true;
    } else {
      continue;  // merged mode: a split past cache_len adds exactly 0
    }
    if (end > s_len) end = s_len;
    const int n_keys = static_cast<int>(end - key0);
    const int n_tiles = (n_keys + C::kTile - 1) / C::kTile;
    const T* kr = k + (row * s_len + key0) * D;
    const T* vr = v + (row * s_len + key0) * D;

    __syncthreads();  // the previous row's reads and writes of shared memory are done
    if (tid == 0) {
      fence_proxy_async();  // ...before the copies overwrite the ring
      for (int t = 0; t < n_tiles && t < kStages; ++t)
        issue_tile<T, D, kG>(smem, full, tiles_done + t, kr, vr, t, n_keys, masked);
    }
    for (int i = tid; i < kG * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float x = 0.f;  // heads past gq and columns past dq are zero
      if (g < gh && d < dq) {
        const long long at = (row * gq + g_base + g) * dq + d;
        x = q_bf16 ? __uint_as_float(static_cast<unsigned>(qb[at]) << 16) : qf[at];
      }
      qs[i] = x;
    }
    if (tid < kG) {
      m_run[tid] = -INFINITY;
      l_run[tid] = 0.f;
    }
    __syncthreads();

    const int slot = lane / C::kLanesPerKey, part = lane % C::kLanesPerKey;
    float qr[kG][C::kPerLane];
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
        for (int e = 0; e < C::kVec; ++e)
          qr[g][c * C::kVec + e] = qs[g * D + (c * C::kLanesPerKey + part) * C::kVec + e];
    const int piece = tid % C::kPieces, kpart = tid / C::kPieces;
    float acc[kG][C::kPvVec];
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < C::kPvVec; ++e) acc[g][e] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      const uint32_t it = tiles_done + t;
      const int s = it % kStages;
      const int nk = n_keys - t * C::kTile < C::kTile ? n_keys - t * C::kTile : C::kTile;
      const T* ks = reinterpret_cast<const T*>(smem + s * C::kStageBytes);
      const T* vs = ks + C::kTile * D;
      mbar_wait(full + s, (it / kStages) & 1);

      // Scores of the tile's keys for the block's heads.
      if (masked) {
        for (int i = tid; i < kG * C::kTile; i += kThreads) sc[i] = kNegInf;
      } else {
        for (int j0 = warp * C::kKeysPerWarp; j0 < nk; j0 += kWarps * C::kKeysPerWarp) {
          const int j = j0 + slot;
          float dot[kG];
#pragma unroll
          for (int g = 0; g < kG; ++g) dot[g] = 0.f;
          if (j < nk) {
#pragma unroll
            for (int c = 0; c < C::kChunks; ++c) {
              float kv[C::kVec];
              load16(ks + j * D + (c * C::kLanesPerKey + part) * C::kVec, kv);
#pragma unroll
              for (int g = 0; g < kG; ++g)
#pragma unroll
                for (int e = 0; e < C::kVec; ++e) dot[g] = fmaf(qr[g][c * C::kVec + e], kv[e], dot[g]);
            }
          }
#pragma unroll
          for (int off = C::kLanesPerKey / 2; off > 0; off >>= 1)
#pragma unroll
            for (int g = 0; g < kG; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
          if (part == 0 && j < nk) {
#pragma unroll
            for (int g = 0; g < kG; ++g) {
              float x = dot[g] * scale;
              if (softcap > 0.f) x = softcap * tanhf(x / softcap);
              sc[g * C::kTile + j] = x;
            }
          }
        }
      }
      __syncthreads();

      // Online softmax: one warp per head.
      for (int g = warp; g < gh; g += kWarps) {
        float* srow = sc + g * C::kTile;
        const float m_old = m_run[g];
        float mx = -INFINITY;
        for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, srow[j]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int j = lane; j < nk; j += 32) {
          const float p = expf(srow[j] - m_new);
          srow[j] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float a = expf(m_old - m_new);  // 0 on the first tile (m_old = -inf)
          alpha[g] = a;
          l_run[g] = l_run[g] * a + sum;
          m_run[g] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + p.v over this thread's keys of the tile.
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float a = g < gh ? alpha[g] : 0.f;
#pragma unroll
        for (int e = 0; e < C::kPvVec; ++e) acc[g][e] *= a;
      }
      for (int j = kpart; j < nk; j += C::kKeyParts) {
        float vv[C::kPvVec];
        load_vec<C::kPvVec>(vs + j * D + piece * C::kPvVec, vv);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float p = g < gh ? sc[g * C::kTile + j] : 0.f;
#pragma unroll
          for (int e = 0; e < C::kPvVec; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
        }
      }
      __syncthreads();  // the stage and the scores are free again
      if (tid == 0 && t + kStages < n_tiles)
        issue_tile<T, D, kG>(smem, full, it + kStages, kr, vr, t + kStages, n_keys, masked);
    }
    tiles_done += n_tiles;

    // o = (sum of the kKeyParts partial sums) / max(l, 1e-30). No copy is in
    // flight: every issued tile was waited for, so red may overwrite the ring.
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < C::kPvVec; ++e) red[(kpart * kG + g) * D + piece * C::kPvVec + e] = acc[g][e];
    __syncthreads();
    const long long out_row = (row * nsplit + blockIdx.x) * gq + g_base;  // (row, split, first head)
    for (int i = tid; i < gh * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float sum = 0.f;
      for (int kp = 0; kp < C::kKeyParts; ++kp) sum += red[(kp * kG + g) * D + d];
      o[(out_row + g) * D + d] = sum / fmaxf(l_run[g], 1e-30f);
    }
    if (tid < gh) {
      m_out[out_row + tid] = m_run[tid];
      l_out[out_row + tid] = l_run[tid];
    }
  }
}

// One warp per (row, head): the LSE merge of the row's written splits,
// out = sum_i o_i * (w_i / max(sum_i w_i, 1e-30)) with w_i = l_i * exp(m_i - m_max),
// as merge_partials. Lane j holds the weight of split base + j of each
// 32-split chunk and broadcasts it; each lane owns kPer columns of o (dp =
// 32 * kPer) and loads them for kBatch splits before it adds any, so that
// the loads of a batch are in flight together. Columns at or past d_out (the
// wrapper's zero padding) are dropped.
template <int kPer>
__global__ void __launch_bounds__(kMergeWarps * 32)
decode_merge_kernel(const float* __restrict__ o, const float* __restrict__ m, const float* __restrict__ l,
                    const int32_t* __restrict__ cache_len, float* __restrict__ out, long long rows, int gq,
                    long long s_len, int split, long long nsplit, int d_out) {
  constexpr int kBatch = 8;
  constexpr int dp = 32 * kPer;
  const long long item = static_cast<long long>(blockIdx.x) * kMergeWarps + (threadIdx.x >> 5);
  if (item >= rows * gq) return;
  const int lane = threadIdx.x & 31;
  const long long row = item / gq;
  const long long len = cache_len[row];
  const long long valid = len < s_len ? len : s_len;
  const long long n = len >= 1 ? (valid + split - 1) / split : nsplit;  // the splits the split kernel wrote
  const long long first = row * nsplit * gq + (item - row * gq);  // (row, split 0, head); splits are gq apart

  float mx = -INFINITY;
  for (long long i = lane; i < n; i += 32) mx = fmaxf(mx, m[first + i * gq]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float den = 0.f;
  for (long long i = lane; i < n; i += 32) den += l[first + i * gq] * expf(m[first + i * gq] - mx);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
  den = fmaxf(den, 1e-30f);

  float acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) acc[c] = 0.f;
  for (long long base = 0; base < n; base += 32) {
    const long long mine = first + (base + lane) * gq;
    const float w = base + lane < n ? l[mine] * expf(m[mine] - mx) / den : 0.f;  // 0 past the last split
    const int count = n - base < 32 ? static_cast<int>(n - base) : 32;
    for (int j0 = 0; j0 < count; j0 += kBatch) {
      float ov[kBatch][kPer];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float* orow = o + (first + (base + j0 + u) * gq) * dp + lane;
#pragma unroll
        for (int c = 0; c < kPer; ++c) ov[u][c] = j0 + u < count ? orow[32 * c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float wj = __shfl_sync(0xffffffffu, w, (j0 + u) & 31);
#pragma unroll
        for (int c = 0; c < kPer; ++c) acc[c] = fmaf(ov[u][c], wj, acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c)
    if (lane + 32 * c < d_out) out[item * d_out + lane + 32 * c] = acc[c];
}

template <int kPer>
int launch_merge(const void* o, const void* m, const void* l, const void* cache_len, void* out, long long rows,
                 long long gq, long long s_len, long long split, long long d_out, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows * gq + kMergeWarps - 1) / kMergeWarps);
  decode_merge_kernel<kPer><<<blocks, kMergeWarps * 32, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const int32_t*>(cache_len), static_cast<float*>(out), rows, static_cast<int>(gq), s_len,
      static_cast<int>(split), (s_len + split - 1) / split, static_cast<int>(d_out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int kG>
int launch_split(const void* q, int q_bf16, int dq, const void* k, const void* v, const void* cache_len, void* o,
                 void* m, void* l, long long rows, int gq, long long s_len, int split, int every_split, float scale,
                 float softcap, cudaStream_t stream) {
  constexpr int smem = Cfg<T, D, kG>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<T, D, kG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nsplit = (s_len + split - 1) / split;
  const dim3 grid(static_cast<unsigned>(nsplit), static_cast<unsigned>(rows < kMaxRowsY ? rows : kMaxRowsY),
                  static_cast<unsigned>((gq + kG - 1) / kG));
  decode_split_kernel<T, D, kG><<<grid, kThreads, smem, stream>>>(
      q, q_bf16, dq, static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const int32_t*>(cache_len),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l), rows, gq, s_len, split, every_split,
      scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int kG>
int blocks_per_sm() {
  constexpr int smem = Cfg<T, D, kG>::kSmemBytes;
  int n = -1;
  if (cudaFuncSetAttribute(decode_split_kernel<T, D, kG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_split_kernel<T, D, kG>, kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}

template <typename T, int D>
int dispatch_heads(const void* q, int q_bf16, int dq, const void* k, const void* v, const void* cache_len, void* o,
                   void* m, void* l, long long rows, int gq, long long s_len, int split, int every_split, float scale,
                   float softcap, cudaStream_t stream) {
  if (gq <= 4)
    return launch_split<T, D, 4>(q, q_bf16, dq, k, v, cache_len, o, m, l, rows, gq, s_len, split, every_split, scale,
                                 softcap, stream);
  return launch_split<T, D, 8>(q, q_bf16, dq, k, v, cache_len, o, m, l, rows, gq, s_len, split, every_split, scale,
                               softcap, stream);
}

template <typename T>
int dispatch(int d, const void* q, int q_bf16, int dq, const void* k, const void* v, const void* cache_len, void* o,
             void* m, void* l, long long rows, int gq, long long s_len, int split, int every_split, float scale,
             float softcap, cudaStream_t stream) {
  switch (d) {
    case 32: return dispatch_heads<T, 32>(q, q_bf16, dq, k, v, cache_len, o, m, l, rows, gq, s_len, split,
                                          every_split, scale, softcap, stream);
    case 64: return dispatch_heads<T, 64>(q, q_bf16, dq, k, v, cache_len, o, m, l, rows, gq, s_len, split,
                                          every_split, scale, softcap, stream);
    case 128: return dispatch_heads<T, 128>(q, q_bf16, dq, k, v, cache_len, o, m, l, rows, gq, s_len, split,
                                            every_split, scale, softcap, stream);
    case 256: return dispatch_heads<T, 256>(q, q_bf16, dq, k, v, cache_len, o, m, l, rows, gq, s_len, split,
                                            every_split, scale, softcap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The split-K kernel. q: contiguous (rows, gq, dq) of q_dtype (0 = f32,
// 1 = bf16), dq <= d; k, v: contiguous (rows, s_len, d) of kv_dtype,
// 16-byte aligned; cache_len: (rows,) int32; o: (rows, nsplit, gq, d) f32
// with nsplit = ceil(s_len / split); m, l: (rows, nsplit, gq) f32.
// every_split = 1 writes every split (the per-tile partials, split =
// block_s); 0 writes only those the merge reads. softcap <= 0 means none.
// Launches on `stream` and returns cudaGetLastError() as an int
// (0 = cudaSuccess). Does not synchronise and allocates nothing.
extern "C" int decode_attention_split_fwd(const void* q, int q_dtype, long long dq, const void* k, const void* v,
                                          const void* cache_len, void* o, void* m, void* l, long long rows,
                                          long long gq, long long s_len, long long d, int kv_dtype, long long split,
                                          int every_split, float scale, float softcap, void* stream) {
  if (rows <= 0 || gq <= 0 || gq > 0xffff || s_len <= 0 || split <= 0 || split > 0x7fffffffLL ||
      (s_len + split - 1) / split > 0x7fffffffLL || dq <= 0 || dq > d || (q_dtype != 0 && q_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(gq), sp = static_cast<int>(split), dd = static_cast<int>(d);
  const int qd = static_cast<int>(dq);
  if (kv_dtype == 0)
    return dispatch<float>(dd, q, q_dtype, qd, k, v, cache_len, o, m, l, rows, g, s_len, sp, every_split, scale,
                           softcap, st);
  if (kv_dtype == 1)
    return dispatch<__nv_bfloat16>(dd, q, q_dtype, qd, k, v, cache_len, o, m, l, rows, g, s_len, sp, every_split,
                                   scale, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The combine kernel, after decode_attention_split_fwd with every_split = 0
// and the same split: o, m, l as written there (d = 32, 64, 128 or 256
// columns), out: (rows, gq, d_out) f32 with d_out <= d.
extern "C" int decode_attention_merge_fwd(const void* o, const void* m, const void* l, const void* cache_len, void* out,
                                          long long rows, long long gq, long long s_len, long long d, long long split,
                                          long long d_out, void* stream) {
  if (rows <= 0 || gq <= 0 || gq > 0xffff || s_len <= 0 || split <= 0 || split > 0x7fffffffLL || d <= 0 ||
      d > kMaxD || d_out <= 0 || d_out > d || (rows * gq + kMergeWarps - 1) / kMergeWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_merge<1>(o, m, l, cache_len, out, rows, gq, s_len, split, d_out, st);
    case 64: return launch_merge<2>(o, m, l, cache_len, out, rows, gq, s_len, split, d_out, st);
    case 128: return launch_merge<4>(o, m, l, cache_len, out, rows, gq, s_len, split, d_out, st);
    case 256: return launch_merge<8>(o, m, l, cache_len, out, rows, gq, s_len, split, d_out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the split kernel that fit one SM at once for head dimension d
// (32, 64, 128 or 256), kv_dtype and gq query heads; -1 if the runtime
// refuses or the arguments are not an instantiation.
extern "C" int decode_attention_blocks_per_sm(long long d, int kv_dtype, long long gq) {
  if (gq <= 0 || (kv_dtype != 0 && kv_dtype != 1)) return -1;
  const bool g4 = gq <= 4, bf16 = kv_dtype == 1;
  switch (d) {
    case 32: return bf16 ? (g4 ? blocks_per_sm<__nv_bfloat16, 32, 4>() : blocks_per_sm<__nv_bfloat16, 32, 8>())
                         : (g4 ? blocks_per_sm<float, 32, 4>() : blocks_per_sm<float, 32, 8>());
    case 64: return bf16 ? (g4 ? blocks_per_sm<__nv_bfloat16, 64, 4>() : blocks_per_sm<__nv_bfloat16, 64, 8>())
                         : (g4 ? blocks_per_sm<float, 64, 4>() : blocks_per_sm<float, 64, 8>());
    case 128: return bf16 ? (g4 ? blocks_per_sm<__nv_bfloat16, 128, 4>() : blocks_per_sm<__nv_bfloat16, 128, 8>())
                          : (g4 ? blocks_per_sm<float, 128, 4>() : blocks_per_sm<float, 128, 8>());
    case 256: return bf16 ? (g4 ? blocks_per_sm<__nv_bfloat16, 256, 4>() : blocks_per_sm<__nv_bfloat16, 256, 8>())
                          : (g4 ? blocks_per_sm<float, 256, 4>() : blocks_per_sm<float, 256, 8>());
    default: return -1;
  }
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
