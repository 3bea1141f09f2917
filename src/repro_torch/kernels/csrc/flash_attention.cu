// Flash attention forward (online softmax) with causal masking, a sliding
// window and logit soft-capping: a tensor-core kernel for bf16 inputs and a
// CUDA-core kernel for f32 inputs.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :117, body _flash_kernel). Per
// (batch*head, query row):
//
//     s_j = scale * q.k_j;  s_j = softcap * tanh(s_j / softcap)  (if softcap)
//     s_j = -1e30 where masked (causal: j > i; window: j <= i - window)
//     o   = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
//
// with m, l and the output sum held in f32 and updated tile by tile as the
// TPU kernel does, so a fully masked tile visited before the row's first
// visible key is washed out by alpha = exp(-1e30 - m) = 0, as there. Keys at
// or past S are -inf: they never count. The output has the input's type.
//
// Bound: operations. A call does 4 * B * H * D * (visible pairs) flops on
// (B, H, S, D) inputs it reads once: 549.8 GFLOP at qwen3-8b width (B 1,
// H 32, S 8192, D 128, causal) and 412.4 GFLOP at gemma2-9b local-layer
// width (H 16, D 256, window 4096), far above the H100's ~295 flops per byte
// at which the tensor cores, not memory, limit. At 989 TFLOP/s (bf16 tensor
// cores) that is 0.556 and 0.417 ms.
//
// bf16: flash_tc_kernel. One block of 384 threads per (128-row query tile,
// batch*head), three warpgroups:
// - warpgroup 0, the producer: one thread issues TMA loads (tensor maps over
//   (D, S, B*H), boxes 64 rows tall and 128 bytes wide, 128-byte swizzle; 64
//   bytes at D = 32), the query tile once, then the 64-key tiles of K and V
//   into a ring of stages, each with a "full" and an "empty" mbarrier. TMA
//   fills zeros past S inside each head and never reads the next head. It
//   gives its registers away (setmaxnreg 24).
// - warpgroups 1 and 2, the consumers (setmaxnreg 240), 64 query rows each:
//   S = Q·K^T on wgmma (m64n64k16, both operands K-major in swizzled shared
//   memory, so K needs no transpose); scale, softcap and, only on tiles that
//   straddle the causal diagonal, a window edge or S, the masks, on the f32
//   accumulator fragment in registers; row max and sum across the four
//   threads that share a row; then O += P_hi·V + P_lo·V on wgmma with P from
//   registers and V (keys x D, MN-major) through the descriptor's transpose
//   bit. A tile that the masks hide from all 64 rows of a consumer is
//   skipped by it (exactly: its p would be 0 and alpha 1, or washed out by
//   alpha = 0 before the row's first key); it still releases the stage.
// - The grid walks the query tiles last first, so under the causal mask the
//   longest tiles start first and the last wave is short.
//
// Why P is split. The smoke holds a bf16 output to one bf16 rounding step of
// the f32 plain version (|got - plain| <= 2^-7 |plain| + 1e-4). Rounding P to
// bf16 once before P·V, as tensor-core flash kernels usually do, misses that
// by 8.6-11.5x in a CPU emulation (causal S 512 / 4096, D 64 / 128, and D 256
// with window 2048 and softcap 50); P = P_hi + P_lo, both bf16, is within
// 0.83-0.92 of the limit, as exact f32 is. So P·V is two bf16 products, and
// the tensor cores do 1.5x the attention's operations; the bound above does
// not count that extra work. l is summed from the f32 P, before the split.
//
// f32: flash_simt_kernel, on the CUDA cores: no tensor-core format keeps an
// f32 input's 2e-5 agreement with the plain version. One block of 256
// threads per (64-row query tile, batch*head); the block walks the 32-key
// tiles that the masks leave visible, staging K (transposed) and V in shared
// memory as f32; each thread owns a 4 x 2 block of scores and 4 rows x D/16
// output columns; row maxima and sums are reduced with shuffles. Shared
// memory: 145 KB at D = 256, so the launch raises the dynamic limit first.
#include <cstdint>
#include <cstdio>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attention.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's masking value

// ============================================================ bf16: tensor cores
namespace tc {

constexpr int kRowsPerWarpgroup = 64;          // wgmma's M
constexpr int kConsumers = 2;                  // consumer warpgroups per block
constexpr int kBlockQ = kConsumers * kRowsPerWarpgroup;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kMaxQTiles = 65535;              // gridDim.y limit
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeFailed = 100000;          // + CUresult: a tensor map could not be encoded

template <int D>
struct Shape {
  static constexpr int kKeys = kRowsPerWarpgroup;          // keys per tile: 64 fit 240 registers at every D
  static constexpr int kSwizzle = D >= 64 ? 128 : 64;      // bytes of one swizzled row
  static constexpr int kBoxCols = kSwizzle / 2;            // bf16 columns of one TMA box
  static constexpr int kBoxes = D / kBoxCols;              // boxes across a row of D
  static constexpr int kBoxBytes = 64 * kSwizzle;          // one box: 64 rows (queries or keys)
  static constexpr int kTileBytes = kBoxes * kBoxBytes;    // 64 rows x D bf16
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr int kKSteps = D / 16;                   // k16 steps of Q·K^T
  static constexpr int kStepsPerBox = kSwizzle / 32;       // 32 bytes a k16 step
  static constexpr int kSAcc = kKeys / 2;                  // score floats a thread
  static constexpr int kPSteps = kKeys / 16;               // k16 steps of P·V
  static constexpr int kOChunks = D >= 64 ? D / 64 : 1;    // P·V products, one per box
  static constexpr int kOChunkN = D >= 64 ? 64 : 32;       // their N
  static constexpr int kOAcc = kOChunkN / 2;               // accumulator floats a thread
  static constexpr int kBarrierOffset = (kConsumers + 2 * kStages) * kTileBytes;
  // 1024 bytes of slack to align the tiles to the swizzle's repeat.
  static constexpr int kSmemBytes = 1024 + kBarrierOffset + 8 * (1 + 2 * kStages);
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int s_len, float scale,
                int causal, int window, float softcap) {
  using namespace hopper;
  using S = Shape<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  uint8_t* sq = smem;                               // [kConsumers] query tiles
  uint8_t* sk = sq + kConsumers * S::kTileBytes;    // [kStages] key tiles
  uint8_t* sv = sk + S::kStages * S::kTileBytes;    // [kStages] value tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::kBarrierOffset);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S::kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // last query tile first
  // Keys the block needs: causal stops at its last row; the window starts
  // where its first row's window does, rounded down to a key tile.
  const int kv_end = causal ? min(s_len, q0 + kBlockQ) : s_len;
  const int kv_begin = window > 0 ? (max(0, q0 - window + 1) / S::kKeys) * S::kKeys : 0;
  const int n_tiles = (kv_end - kv_begin + S::kKeys - 1) / S::kKeys;
  const int live_consumers = q0 + kRowsPerWarpgroup < s_len ? 2 : 1;  // those with a row below S

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, live_consumers * S::kTileBytes);
      for (int w = 0; w < live_consumers; ++w)
#pragma unroll
        for (int b = 0; b < S::kBoxes; ++b)
          tma_load_3d(sq + w * S::kTileBytes + b * S::kBoxBytes, &tq, q_full, b * S::kBoxCols,
                      q0 + w * kRowsPerWarpgroup, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S::kStages;
        mbar_wait(empty + s, ((t / S::kStages) & 1) ^ 1);  // the consumers are done with this stage
        mbar_arrive_expect_tx(full + s, 2 * S::kTileBytes);
        const int k0 = kv_begin + t * S::kKeys;
#pragma unroll
        for (int b = 0; b < S::kBoxes; ++b) {
          tma_load_3d(sk + s * S::kTileBytes + b * S::kBoxBytes, &tk, full + s, b * S::kBoxCols, k0, bh);
          tma_load_3d(sv + s * S::kTileBytes + b * S::kBoxBytes, &tv, full + s, b * S::kBoxCols, k0, bh);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int cw = warpgroup - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = q0 + cw * kRowsPerWarpgroup;
    const int r_last = min(r0 + kRowsPerWarpgroup, s_len) - 1;
    // The accumulator fragment: register i of a thread holds row
    // row_base + 8 * ((i >> 1) & 1) and column 8 * (i >> 2) + col_base + (i & 1).
    const int row_base = r0 + 16 * warp + lane / 4;
    const int col_base = 2 * (lane % 4);

    // The tiles that hold a key some row of this warpgroup sees.
    int t_lo = 0, t_hi = n_tiles - 1;
    if (r0 >= s_len) {
      t_lo = n_tiles;
      t_hi = -1;
    } else {
      if (causal) t_hi = min(t_hi, (r_last - kv_begin) / S::kKeys);
      if (window > 0) t_lo = (max(0, r0 - window + 1) - kv_begin) / S::kKeys;
    }

    const uint64_t q_desc = make_desc(smem_addr(sq + cw * S::kTileBytes), 16, 8 * S::kSwizzle, S::kSwizzle);
    const uint64_t k_desc = make_desc(smem_addr(sk), 16, 8 * S::kSwizzle, S::kSwizzle);
    // MN-major V: one 64-column box per product, so only the stride between
    // 8-key groups (8 swizzled rows) matters; both offsets carry it.
    const uint64_t v_desc = make_desc(smem_addr(sv), 8 * S::kSwizzle, 8 * S::kSwizzle, S::kSwizzle);

    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};  // this thread's columns only; summed over the row's four threads at the end
    float acc[S::kOChunks][S::kOAcc];
#pragma unroll
    for (int c = 0; c < S::kOChunks; ++c)
#pragma unroll
      for (int i = 0; i < S::kOAcc; ++i) acc[c][i] = 0.f;

    if (t_lo <= t_hi) mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % S::kStages;
      mbar_wait(full + s, (t / S::kStages) & 1);
      const bool skip = t < t_lo || t > t_hi;
      if (!skip) {
        const int k0 = kv_begin + t * S::kKeys;
        // ------------------------------------------------- S = Q·K^T
        float sc[S::kSAcc];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < S::kKSteps; ++kk) {
          const uint32_t box = kk / S::kStepsPerBox, in_row = (kk % S::kStepsPerBox) * 32;
          const uint64_t qd = q_desc + ((box * S::kBoxBytes + in_row) >> 4);
          const uint64_t kd = k_desc + ((s * S::kTileBytes + box * S::kBoxBytes + in_row) >> 4);
          wgmma_ss_n64(sc, qd, kd, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(sc);

        // --------------------------------- scale, softcap, masks, row max
        const bool edge = (causal && k0 + S::kKeys - 1 > r0) || (window > 0 && k0 <= r_last - window) ||
                          k0 + S::kKeys > s_len;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < S::kSAcc; ++i) {
          float x = sc[i] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          if (edge) {
            const int row = row_base + 8 * ((i >> 1) & 1);
            const int key = k0 + 8 * (i >> 2) + col_base + (i & 1);
            bool visible = true;
            if (causal) visible = visible && key <= row;
            if (window > 0) visible = visible && key > row - window;
            x = visible ? x : kNegInf;
            if (key >= s_len) x = -INFINITY;  // past the sequence: not a key at all
          }
          sc[i] = x;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m_run[h], mx[h]);
          alpha[h] = exp2f((m_run[h] - m_new) * kLog2e);
          m_run[h] = m_new;
        }

        // ------------------ P in f32, l from it, then P = P_hi + P_lo in bf16
        float psum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < S::kSAcc; ++i) {
          sc[i] = exp2f((sc[i] - m_run[(i >> 1) & 1]) * kLog2e);
          psum[(i >> 1) & 1] += sc[i];
        }
        // The A fragment of k16 step kk is the accumulator's columns
        // 16 kk .. 16 kk + 15: registers 8 kk .. 8 kk + 7, in pairs.
        uint32_t p_hi[S::kPSteps][4], p_lo[S::kPSteps][4];
#pragma unroll
        for (int kk = 0; kk < S::kPSteps; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
            const uint32_t hi = pack_bf16x2(x0, x1);
            p_hi[kk][r] = hi;
            p_lo[kk][r] = pack_bf16x2(x0 - bf16_lo(hi), x1 - bf16_hi(hi));
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + psum[h];
#pragma unroll
        for (int c = 0; c < S::kOChunks; ++c)
#pragma unroll
          for (int i = 0; i < S::kOAcc; ++i) acc[c][i] *= alpha[(i >> 1) & 1];

        // ------------------------------------- O += P_hi·V + P_lo·V
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < S::kOChunks; ++c)
#pragma unroll
          for (int kk = 0; kk < S::kPSteps; ++kk) {
            const uint64_t d = v_desc + ((s * S::kTileBytes + c * S::kBoxBytes + kk * 16 * S::kSwizzle) >> 4);
            if constexpr (S::kOChunkN == 64) {
              wgmma_rs_n64_tb(acc[c], p_hi[kk], d);
              wgmma_rs_n64_tb(acc[c], p_lo[kk], d);
            } else {
              wgmma_rs_n32_tb(acc[c], p_hi[kk], d);
              wgmma_rs_n32_tb(acc[c], p_lo[kk], d);
            }
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < S::kOChunks; ++c) fence_operands(acc[c]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);  // this warp is done with the stage
    }

    // ------------------------------------------- o = acc / max(l, 1e-30)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row_base + 8 * h;
      if (row >= s_len) continue;
      const float denom = fmaxf(l, 1e-30f);
      __nv_bfloat16* out = o + (static_cast<long long>(bh) * s_len + row) * D;
#pragma unroll
      for (int c = 0; c < S::kOChunks; ++c)
#pragma unroll
        for (int j = 0; j < S::kOAcc / 4; ++j)
          *reinterpret_cast<uint32_t*>(out + c * 64 + 8 * j + col_base) =
              pack_bf16x2(acc[c][4 * j + 2 * h] / denom, acc[c][4 * j + 2 * h + 1] / denom);
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime so that the library
// needs no link to libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A (D, S, rows) tensor map of one bf16 array, boxes of 64 rows.
template <int D>
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, long long rows, int s_len) {
  using S = Shape<D>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(s_len),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(s_len) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(S::kBoxCols), 64, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        S::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, long long rows, int s_len, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  const long long q_tiles = (s_len + kBlockQ - 1) / kBlockQ;
  if (q_tiles > kMaxQTiles || rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn = nullptr;
  cudaError_t err = encode_tiled_fn(&fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  int r = encode<D>(fn, &tq, q, rows, s_len);
  if (r == 0) r = encode<D>(fn, &tk, k, rows, s_len);
  if (r == 0) r = encode<D>(fn, &tv, v, rows, s_len);
  if (r != 0) return r;
  const int smem = Shape<D>::kSmemBytes;
  err = cudaFuncSetAttribute(flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(q_tiles));
  flash_tc_kernel<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), s_len, scale,
                                                        causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// =============================================================== f32: CUDA cores
namespace simt {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kBQ = 64;             // query rows per block
constexpr int kBKV = 32;            // keys per tile
constexpr int kRows = kBQ / 16;     // query rows per thread
constexpr int kKeys = kBKV / 16;    // keys per thread
constexpr int kQStride = kBQ + 4;   // row stride of Q^T and P^T: keeps float4 reads aligned
constexpr int kKStride = kBKV + 1;  // row stride of K^T: conflict-free transposed stores
constexpr int kMaxRowsY = 65535;    // gridDim.y limit

template <int D>
constexpr int simt_smem_bytes() {
  return static_cast<int>(sizeof(float)) * (D * kQStride + D * kKStride + kBKV * D + kBKV * kQStride);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ o,
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
      qt[c * kQStride + r] = q0 + r < s_len ? q[base + static_cast<long long>(q0 + r) * D + c] : 0.f;
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
        kt[c * kKStride + r] = in ? k[g] : 0.f;
        vs[r * D + c] = in ? v[g] : 0.f;
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
      for (int c = 0; c < D / 16; ++c) o[base + static_cast<long long>(qp) * D + tx + 16 * c] = acc[i][c] / denom;
    }
  }
}


template <int D>
int launch(const void* q, const void* k, const void* v, void* o, long long rows, int s_len, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  const int smem = simt_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_simt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s_len + kBQ - 1) / kBQ),
                  static_cast<unsigned>(rows < kMaxRowsY ? rows : kMaxRowsY));
  flash_simt_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), rows, s_len, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, long long rows, int s_len, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  if (dtype == 0) return simt::launch<D>(q, k, v, o, rows, s_len, scale, causal, window, softcap, stream);
  if (dtype == 1) return tc::launch<D>(q, k, v, o, rows, s_len, scale, causal, window, softcap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: contiguous (rows, s_len, d) arrays of one type, dtype 0 = f32
// (the CUDA-core kernel), 1 = bf16 (the tensor-core kernel; 16-byte aligned
// pointers); rows = batch * heads. window <= 0 means no window, softcap <= 0
// no soft-capping. Launches on `stream` and returns cudaGetLastError() as an
// int (0 = cudaSuccess), or 100000 + the CUresult of a tensor map that could
// not be encoded. Does not synchronise and allocates nothing.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, long long rows,
                                   long long s_len, long long d, int dtype, float scale, int causal,
                                   long long window, float softcap, void* stream) {
  if (rows <= 0 || s_len <= 0 || s_len > 0x7fffffffLL - simt::kBQ - tc::kBlockQ || window > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = window > 0 ? static_cast<int>(window) : 0;
  const int s = static_cast<int>(s_len);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(dtype, q, k, v, o, rows, s, scale, causal, w, softcap, st);
    case 64: return launch<64>(dtype, q, k, v, o, rows, s, scale, causal, w, softcap, st);
    case 128: return launch<128>(dtype, q, k, v, o, rows, s, scale, causal, w, softcap, st);
    case 256: return launch<256>(dtype, q, k, v, o, rows, s, scale, causal, w, softcap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code >= tc::kEncodeFailed) {
    static thread_local char msg[96];
    std::snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d", code - tc::kEncodeFailed);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
