// Flash attention forward (online softmax) with causal masking, a sliding
// window and logit soft-capping, for f32 or bf16 inputs.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel). Per (batch*head, query row):
//
//     s_j = scale * q.k_j;  s_j = softcap * tanh(s_j / softcap)  (if softcap)
//     s_j = -1e30 where masked (causal: j > i; window: j <= i - window)
//     o   = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
//
// with m, l and the output sum held in f32 and updated tile by tile as the
// TPU kernel does, so a fully masked tile visited before the row's first
// visible key is washed out by alpha = exp(-1e30 - m) = 0, as there. The
// output is written in the input's type.
//
// Bound: operations. A causal call does 4 * B * H * D * (visible pairs)
// flops on (B, H, S, D) inputs it reads once, far above the H100's
// ~295 flops per byte at which the tensor cores, not memory, would limit.
// This first kernel uses f32 FMAs on the CUDA cores (67 TFLOP/s), not the
// tensor cores (989 TFLOP/s in bf16): a later kernel moves the two products
// to wgmma. Design: one block of 256 threads per (64-row query tile,
// batch*head). The query tile is staged once in shared memory as f32,
// transposed; the block then walks the 32-key tiles that the causal and
// window masks leave visible, staging each tile of K (transposed) and V in
// shared memory as f32. Each thread owns a 4 x 2 block of scores (4 query
// rows, 2 keys) and 4 rows x D/16 columns of the output; row maxima and sums
// are reduced across the 16 threads that share a row with shuffles. Shared
// memory: (64 + 4) * D + (32 + 1) * D + 32 * D + 32 * 68 floats, 145 KB at
// D = 256, so the launch raises the dynamic shared memory limit first.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kBQ = 64;             // query rows per block
constexpr int kBKV = 32;            // keys per tile
constexpr int kRows = kBQ / 16;     // query rows per thread
constexpr int kKeys = kBKV / 16;    // keys per thread
constexpr int kQStride = kBQ + 4;   // row stride of Q^T and P^T: keeps float4 reads aligned
constexpr int kKStride = kBKV + 1;  // row stride of K^T: conflict-free transposed stores
constexpr int kMaxRowsY = 65535;    // gridDim.y limit
constexpr float kNegInf = -1e30f;   // the TPU kernel's masking value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * (D * kQStride + D * kKStride + kBKV * D + kBKV * kQStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
             long long rows, int s_len, float scale, int causal, int window, float softcap) {
  extern __shared__ float smem[];
  float* qt = smem;                // [D][kQStride]    Q^T of the query tile
  float* kt = qt + D * kQStride;   // [D][kKStride]    K^T of the key tile
  float* vs = kt + D * kKStride;   // [kBKV][D]        V of the key tile
  float* pt = vs + kBKV * D;       // [kBKV][kQStride] P^T, probabilities of the tile

  const int tx = threadIdx.x & 15;  // key / output-column group
  const int ty = threadIdx.x >> 4;  // query-row group: rows ty*kRows .. +kRows-1
  const int q0 = blockIdx.x * kBQ;

  // Keys the tile needs: causal stops at its last row; the window starts
  // where its first row's window does.
  const int kv_end = causal ? min(s_len, q0 + kBQ) : s_len;
  const int kv_begin = window > 0 ? (max(0, q0 - window + 1) / kBKV) * kBKV : 0;

  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long base = row * s_len * D;
    __syncthreads();  // the previous row's reads of shared memory are done
    for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
      const int r = i / D, c = i % D;
      qt[c * kQStride + r] = q0 + r < s_len ? to_float(q[base + static_cast<long long>(q0 + r) * D + c]) : 0.f;
    }

    float m[kRows], l[kRows], acc[kRows][D / 16];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
    }

    for (int k0 = kv_begin; k0 < kv_end; k0 += kBKV) {
      __syncthreads();  // the previous tile's reads of kt, vs and pt are done
      for (int i = threadIdx.x; i < kBKV * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const bool in = k0 + r < s_len;
        const long long g = base + static_cast<long long>(k0 + r) * D + c;
        kt[c * kKStride + r] = in ? to_float(k[g]) : 0.f;
        vs[r * D + c] = in ? to_float(v[g]) : 0.f;
      }
      __syncthreads();

      float s[kRows][kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        const float4 qv = *reinterpret_cast<const float4*>(qt + c * kQStride + ty * kRows);
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const float kv = kt[c * kKStride + tx + 16 * j];
          s[0][j] = fmaf(qv.x, kv, s[0][j]);
          s[1][j] = fmaf(qv.y, kv, s[1][j]);
          s[2][j] = fmaf(qv.z, kv, s[2][j]);
          s[3][j] = fmaf(qv.w, kv, s[3][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int qp = q0 + ty * kRows + i;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const int kp = k0 + tx + 16 * j;
          float x = s[i][j] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          bool visible = true;
          if (causal) visible = visible && kp <= qp;
          if (window > 0) visible = visible && kp > qp - window;
          x = visible ? x : kNegInf;
          if (kp >= s_len) x = -INFINITY;  // past the sequence: not a key at all
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          sum += s[i][j];
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) pt[(tx + 16 * j) * kQStride + ty * kRows + i] = s[i][j];
      }
      __syncthreads();

#pragma unroll 4
      for (int j = 0; j < kBKV; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(pt + j * kQStride + ty * kRows);
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const float vv = vs[j * D + tx + 16 * c];
          acc[0][c] = fmaf(p.x, vv, acc[0][c]);
          acc[1][c] = fmaf(p.y, vv, acc[1][c]);
          acc[2][c] = fmaf(p.z, vv, acc[2][c]);
          acc[3][c] = fmaf(p.w, vv, acc[3][c]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty * kRows + i;
      if (qp >= s_len) continue;
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) store(o + base + static_cast<long long>(qp) * D + tx + 16 * c, acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, long long rows, int s_len, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  const int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s_len + kBQ - 1) / kBQ),
                  static_cast<unsigned>(rows < kMaxRowsY ? rows : kMaxRowsY));
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      rows, s_len, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o, long long rows, int s_len, float scale,
             int causal, int window, float softcap, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, rows, s_len, scale, causal, window, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, o, rows, s_len, scale, causal, window, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, o, rows, s_len, scale, causal, window, softcap, stream);
    case 256: return launch<T, 256>(q, k, v, o, rows, s_len, scale, causal, window, softcap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, o: contiguous (rows, s_len, d) arrays of one type, dtype 0 = f32,
// 1 = bf16; rows = batch * heads. window <= 0 means no window, softcap <= 0
// no soft-capping. Launches on `stream` and returns cudaGetLastError() as an
// int (0 = cudaSuccess). Does not synchronise and allocates nothing.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, long long rows,
                                   long long s_len, long long d, int dtype, float scale, int causal,
                                   long long window, float softcap, void* stream) {
  if (rows <= 0 || s_len <= 0 || s_len > 0x7fffffffLL - kBQ || window > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = window > 0 ? static_cast<int>(window) : 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(static_cast<int>(d), q, k, v, o, rows, static_cast<int>(s_len), scale, causal, w, softcap, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(static_cast<int>(d), q, k, v, o, rows, static_cast<int>(s_len), scale, causal, w,
                                   softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
