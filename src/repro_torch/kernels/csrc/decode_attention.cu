// Single-token GQA decode attention over a long KV cache: one normalised
// partial (o, m, l) per tile of block_s cache positions.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention_partials, body _decode_kernel). For cache row b (one
// batch entry and kv head), tile t and query head g:
//
//     s_j = scale * q_g.k_j;  s_j = softcap * tanh(s_j / softcap)  (if softcap)
//     s_j = -1e30 where t * block_s + j >= cache_len[b]
//     m = max_j s_j,  p_j = exp(s_j - m),  l = sum_j p_j
//     o = sum_j p_j v_j / max(l, 1e-30)
//
// all in f32. As on the TPU, a tile past cache_len gives m = -1e30,
// l = block_s and o = the mean of its v; the caller's merge weights it by
// exp(-1e30 - m_max) = 0.
//
// Bound: memory. A query reads its row's cache once and does 4 * Gq flops per
// element pair of K and V, far below the ~295 flops per byte at which the
// H100's arithmetic would limit. Only the keys below cache_len change the
// merged result, so the least time is the bytes of K and V up to each row's
// cache_len over 3.35 TB/s. Design: one block of 128 threads per (tile,
// cache row). Scores: a group of lanes shares one key, each lane loading 16
// bytes of it at a time, with the query heads (four at a time) held in
// registers and the dot products reduced across the group with shuffles;
// keys at or past cache_len are not read. Softmax: one warp per query head
// over the tile's scores in shared memory. Output: each thread owns 16 bytes
// of v's columns for a share of the tile's keys, the shares are summed in
// shared memory. V is read only below cache_len, except in a tile wholly past
// it, whose o is the mean of its v by the contract of the partials.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;          // query heads per register pass
constexpr int kMaxRowsY = 65535;   // gridDim.y limit
constexpr float kNegInf = -1e30f;  // the TPU kernel's masking value

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

template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);                            // elements per 16-byte load
  static constexpr int kLanesPerKey = D / kVec < 32 ? D / kVec : 32;     // lanes sharing one key
  static constexpr int kPerLane = D / kLanesPerKey;                      // elements of a key per lane
  static constexpr int kKeysPerWarp = 32 / kLanesPerKey;
  static constexpr int kVecsPerRow = D / kVec;                           // 16-byte pieces of a v row
  static constexpr int kKeyParts = kThreads / kVecsPerRow;               // threads sharing a piece of v
  static_assert(kThreads % kVecsPerRow == 0, "a block must cover whole rows of v");
};

template <typename T, int D>
constexpr long long smem_floats(long long gq, long long block_s) {
  return gq * D + gq * block_s + gq + Layout<T, D>::kKeyParts * kGroup * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int32_t* __restrict__ cache_len, float* __restrict__ o, float* __restrict__ m_out,
              float* __restrict__ l_out, long long rows, int gq, long long s_len, int block_s, float scale,
              float softcap) {
  using L = Layout<T, D>;
  extern __shared__ float smem[];
  float* qs = smem;                // [gq][D]       the query heads of the row
  float* sc = qs + gq * D;         // [gq][block_s] scores, then exp(s - m)
  float* denom = sc + gq * block_s;  // [gq]       max(l, 1e-30)
  float* red = denom + gq;         // [kKeyParts][kGroup][D] partial sums of p.v

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x, nb = gridDim.x;
  const long long t0 = static_cast<long long>(tile) * block_s;

  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long left = static_cast<long long>(cache_len[row]) - t0;
    const int valid = left <= 0 ? 0 : (left >= block_s ? block_s : static_cast<int>(left));
    const T* kt = k + (row * s_len + t0) * D;
    const T* vt = v + (row * s_len + t0) * D;
    const long long out_row = (row * nb + tile) * gq;  // first (row, tile, head) of this block

    __syncthreads();  // the previous row's reads of shared memory are done
    for (int i = threadIdx.x; i < gq * D; i += kThreads) qs[i] = q[row * gq * D + i];
    __syncthreads();

    // Scores. Each group of kLanesPerKey lanes computes one key's dot products.
    const int slot = lane / L::kLanesPerKey, part = lane % L::kLanesPerKey;
    for (int g0 = 0; g0 < gq; g0 += kGroup) {
      float qr[kGroup][L::kPerLane];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
#pragma unroll
        for (int e = 0; e < L::kPerLane; ++e)
          qr[g][e] = g0 + g < gq ? qs[(g0 + g) * D + part * L::kPerLane + e] : 0.f;
      for (int j0 = warp * L::kKeysPerWarp; j0 < block_s; j0 += kWarps * L::kKeysPerWarp) {
        const int j = j0 + slot;
        float dot[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) dot[g] = 0.f;
        if (j < valid) {  // a key at or past cache_len scores -1e30 whatever it holds
          float kv[L::kPerLane];
#pragma unroll
          for (int c = 0; c < L::kPerLane; c += L::kVec)
            load16(kt + static_cast<long long>(j) * D + part * L::kPerLane + c, kv + c);
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
#pragma unroll
            for (int e = 0; e < L::kPerLane; ++e) dot[g] = fmaf(qr[g][e], kv[e], dot[g]);
        }
#pragma unroll
        for (int off = L::kLanesPerKey / 2; off > 0; off >>= 1)
#pragma unroll
          for (int g = 0; g < kGroup; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
        if (part == 0 && j < block_s) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            if (g0 + g >= gq) break;
            float x = dot[g] * scale;
            if (softcap > 0.f) x = softcap * tanhf(x / softcap);
            sc[(g0 + g) * block_s + j] = j < valid ? x : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // Softmax of each head over the tile: one warp per head.
    for (int g = warp; g < gq; g += kWarps) {
      float* s = sc + g * block_s;
      float mx = kNegInf;
      for (int j = lane; j < block_s; j += 32) mx = fmaxf(mx, s[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int j = lane; j < block_s; j += 32) {
        const float p = expf(s[j] - mx);
        s[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        m_out[out_row + g] = mx;
        l_out[out_row + g] = sum;
        denom[g] = fmaxf(sum, 1e-30f);
      }
    }
    __syncthreads();

    // o = p.v / max(l, 1e-30). Below cache_len only, unless the whole tile is
    // past it: there every p is 1 and o is the mean of v. In a partly valid
    // tile the keys past cache_len have p = exp(-1e30 - m) = 0 exactly.
    const int v_end = valid > 0 ? valid : block_s;
    const int piece = threadIdx.x % L::kVecsPerRow, kpart = threadIdx.x / L::kVecsPerRow;
    for (int g0 = 0; g0 < gq; g0 += kGroup) {
      float acc[kGroup][L::kVec];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
#pragma unroll
        for (int e = 0; e < L::kVec; ++e) acc[g][e] = 0.f;
      for (int j = kpart; j < v_end; j += L::kKeyParts) {
        float vv[L::kVec];
        load16(vt + static_cast<long long>(j) * D + piece * L::kVec, vv);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const float p = g0 + g < gq ? sc[(g0 + g) * block_s + j] : 0.f;
#pragma unroll
          for (int e = 0; e < L::kVec; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
#pragma unroll
        for (int e = 0; e < L::kVec; ++e) red[(kpart * kGroup + g) * D + piece * L::kVec + e] = acc[g][e];
      __syncthreads();
      for (int i = threadIdx.x; i < kGroup * D; i += kThreads) {
        const int g = i / D, d = i % D;
        if (g0 + g >= gq) break;
        float sum = 0.f;
        for (int kp = 0; kp < L::kKeyParts; ++kp) sum += red[(kp * kGroup + g) * D + d];
        o[(out_row + g0 + g) * D + d] = sum / denom[g0 + g];
      }
      __syncthreads();  // red is rewritten by the next group of heads
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* cache_len, void* o, void* m, void* l,
           long long rows, int gq, long long s_len, int block_s, float scale, float softcap, cudaStream_t stream) {
  const long long bytes = static_cast<long long>(sizeof(float)) * smem_floats<T, D>(gq, block_s);
  if (bytes > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(bytes);  // cudaFuncSetAttribute refuses more than a block can have
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nb = s_len / block_s;
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(rows < kMaxRowsY ? rows : kMaxRowsY));
  decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(cache_len), static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      rows, gq, s_len, block_s, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, const void* cache_len, void* o, void* m, void* l,
             long long rows, int gq, long long s_len, int block_s, float scale, float softcap, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, cache_len, o, m, l, rows, gq, s_len, block_s, scale, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, cache_len, o, m, l, rows, gq, s_len, block_s, scale, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, cache_len, o, m, l, rows, gq, s_len, block_s, scale, softcap, stream);
    case 256: return launch<T, 256>(q, k, v, cache_len, o, m, l, rows, gq, s_len, block_s, scale, softcap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory the kernel needs for `g` query heads and `b` keys a tile, in
// bytes (kv_dtype 0 = f32, 1 = bf16), or -1 for an unsupported head
// dimension. The wrapper checks it against the card's per-block limit.
extern "C" long long decode_attention_smem_bytes(long long d, int kv_dtype, long long g, long long b) {
  const bool bf16 = kv_dtype == 1;
  switch (d) {
    case 32: return 4LL * (bf16 ? smem_floats<__nv_bfloat16, 32>(g, b) : smem_floats<float, 32>(g, b));
    case 64: return 4LL * (bf16 ? smem_floats<__nv_bfloat16, 64>(g, b) : smem_floats<float, 64>(g, b));
    case 128: return 4LL * (bf16 ? smem_floats<__nv_bfloat16, 128>(g, b) : smem_floats<float, 128>(g, b));
    case 256: return 4LL * (bf16 ? smem_floats<__nv_bfloat16, 256>(g, b) : smem_floats<float, 256>(g, b));
    default: return -1;
  }
}

// q: contiguous (rows, gq, d) f32; k, v: contiguous (rows, s_len, d) of
// kv_dtype (0 = f32, 1 = bf16), 16-byte aligned; cache_len: (rows,) int32;
// o: (rows, s_len / block_s, gq, d) f32; m, l: (rows, s_len / block_s, gq)
// f32. softcap <= 0 means none. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = cudaSuccess). Does not synchronise and
// allocates nothing.
extern "C" int decode_attention_partials_fwd(const void* q, const void* k, const void* v, const void* cache_len,
                                             void* o, void* m, void* l, long long rows, long long gq,
                                             long long s_len, long long d, int kv_dtype, long long block_s,
                                             float scale, float softcap, void* stream) {
  if (rows <= 0 || gq <= 0 || gq > 0xffff || block_s <= 0 || block_s > 0x7fffffffLL || s_len % block_s != 0 ||
      s_len / block_s > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(gq), b = static_cast<int>(block_s), dd = static_cast<int>(d);
  if (kv_dtype == 0) return dispatch<float>(dd, q, k, v, cache_len, o, m, l, rows, g, s_len, b, scale, softcap, st);
  if (kv_dtype == 1)
    return dispatch<__nv_bfloat16>(dd, q, k, v, cache_len, o, m, l, rows, g, s_len, b, scale, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
