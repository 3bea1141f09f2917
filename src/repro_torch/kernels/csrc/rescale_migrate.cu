// The rescale's migration: every slot of a rank's new row block written in one launch.
//
// Replaces no pl.pallas_call. It is the port's counterpart of the JAX
// package's one jitted slice-copy program, repro/elastic/rescale_exec.py:470-484
// (`migrate`: zeros, one slice copy a plan segment, the k_new mask), which
// the port ran as a loop of torch ops from the host: a zero-fill of the new
// buffer, one slice assignment a segment and a clone of the cached mask.
//
// For the rows of the new block at k_new it writes
//   new_edges[r, j] = old_edges[r_old, a_old + (j - a_new)]  for j in a local segment of row r,
//   new_edges[r, j] = 0                                      at or past the row's size, and in a
//                                                            row that holds no partition,
//   new_mask[r, j]  = 1 below the row's size, 0 past it,
// and nothing in the edges of a receive range: the exchange between ranks
// fills those, before or after this launch.
//
// Bound: bytes. It reads 8 bytes an edge it copies and writes 8 bytes of
// edges and 4 of mask a slot, so on an H100 (3.35 TB/s) the least time is
// (8 * copied + 12 * slots) / 3.35e12 s: 0.094 ms at the RMAT-20 plans
// 16->17, 8->12 and 12->8 on one rank (125.6 MB read, 188.4 MB written).
// It does no arithmetic to speak of.
//
// Design:
// - The host (kernels/rescale_migrate.py, migrate_table) cuts the block into
//   pieces that cover every slot once, in row and column order: a copy piece
//   (a local plan segment, its slots from one old row), a receive piece (a
//   segment that another rank sends: only its mask is written here), and a
//   zero piece (the tail past a row's size, or the whole width of a padded
//   row). Each piece is cut into tiles of `tile` slots, and a CTA takes one
//   tile. The CTA finds its piece through a table of one int32 a tile,
//   uploaded with the pieces once a cached program: two dependent loads and
//   no search. A binary search in each row's segment list would read the
//   same few lines of L2 log2(segments) times over in every CTA; the tile
//   table costs 4 bytes a tile (16 KB at RMAT-20) and makes the tails and
//   padded rows tiles like any other, so a single-row plan still gives
//   thousands of CTAs for the 132 SMs.
// - Each thread moves two slots at a time: one 16-byte store of the edges
//   and one 8-byte store of the mask, aligned on the destination. An edge is
//   8 bytes and a row starts at row * width * 8 bytes, so with an odd width
//   every other row starts 8 bytes past a 16-byte boundary: a tile's first
//   slot is then stored alone, and so is an odd last slot. The source is read
//   with one 16-byte load where its slot has the destination's phase, else
//   with two 8-byte loads; kUnroll pairs a thread are loaded before any is
//   stored. Nothing is staged in shared memory.
// - Offsets are int64: the out-of-core graphs' blocks pass 2^31 slots.
// The grid is one CTA a tile, at most 2^31 - 1 of them.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;           // slot pairs a thread loads before it stores
constexpr long long kZero = -1;      // piece kind (the source-row column): zeros, mask 0
constexpr long long kRecv = -2;      // a receive range: mask 1, edges left to the exchange
constexpr int kCols = 6;             // row, a_new, b_new, source row or kind, a_old, first tile

__device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__global__ void __launch_bounds__(kThreads)
rescale_migrate_kernel(const uint2* __restrict__ old_edges, long long old_width, uint2* __restrict__ new_edges,
                       float* __restrict__ new_mask, long long new_width, const long long* __restrict__ pieces,
                       const int* __restrict__ tile_piece, long long tile) {
  const long long t = blockIdx.x;
  const long long* pc = pieces + static_cast<long long>(__ldg(tile_piece + t)) * kCols;
  const long long row = __ldg(pc), a_new = __ldg(pc + 1), b_new = __ldg(pc + 2), kind = __ldg(pc + 3);
  const long long a_old = __ldg(pc + 4), first = __ldg(pc + 5);
  const long long j0 = a_new + (t - first) * tile;
  const long long j1 = j0 + tile < b_new ? j0 + tile : b_new;
  uint2* dst = new_edges + row * new_width;
  float* mdst = new_mask + row * new_width;
  // old_edges + (shift + j) is the source of new slot j of a copy piece.
  const long long shift = kind >= 0 ? kind * old_width + a_old - a_new : 0;
  const float m = kind == kZero ? 0.0f : 1.0f;
  const bool write_edges = kind != kRecv;

  // Slot h on is stored in pairs, each pair's edges on a 16-byte boundary.
  const long long h = aligned(dst + j0, 16) ? j0 : j0 + 1;
  const long long pairs = j1 > h ? (j1 - h) >> 1 : 0;
  const bool src16 = kind >= 0 && aligned(old_edges + (shift + h), 16);
  const bool mask8 = aligned(mdst + h, 8);
  for (long long q0 = 0; q0 < pairs; q0 += kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + u * kThreads + threadIdx.x;
      const long long s = shift + h + 2 * q;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (q < pairs && kind >= 0) {
        if (src16) {
          v[u] = __ldg(reinterpret_cast<const uint4*>(old_edges + s));
        } else {
          const uint2 lo = __ldg(old_edges + s), hi = __ldg(old_edges + s + 1);
          v[u] = make_uint4(lo.x, lo.y, hi.x, hi.y);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + u * kThreads + threadIdx.x;
      if (q >= pairs) break;
      const long long j = h + 2 * q;
      if (write_edges) *reinterpret_cast<uint4*>(dst + j) = v[u];
      if (mask8) {
        *reinterpret_cast<float2*>(mdst + j) = make_float2(m, m);
      } else {
        mdst[j] = m;
        mdst[j + 1] = m;
      }
    }
  }
  // The slots stored alone: the first, off the boundary (thread 0), and an
  // odd last one (thread 1).
  if (threadIdx.x < 2) {
    const long long j = threadIdx.x == 0 ? j0 : h + 2 * pairs;
    const bool alone = threadIdx.x == 0 ? (h > j0 && j0 < j1) : j < j1;
    if (alone) {
      if (write_edges) dst[j] = kind >= 0 ? __ldg(old_edges + (shift + j)) : make_uint2(0u, 0u);
      mdst[j] = m;
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns the launch's cudaError_t as an
// int (0 = cudaSuccess). `old_edges` is the rank's old block, rows of
// `old_width` edges of 8 bytes; `new_edges` and `new_mask` the new block,
// rows of `new_width` slots. `pieces` holds (row, a_new, b_new, source row or
// kind, a_old, first tile) int64 a piece and `tile_piece` the piece of each
// of the `tiles` tiles of `tile` slots (kernels/rescale_migrate.py,
// migrate_table). Does not synchronise and allocates nothing.
extern "C" int rescale_migrate(const void* old_edges, long long old_width, void* new_edges, void* new_mask,
                               long long new_width, const void* pieces, const void* tile_piece, long long tiles,
                               long long tile, void* stream) {
  if (tiles <= 0 || tiles > 0x7fffffffLL || tile <= 0 || old_width < 0 || new_width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  rescale_migrate_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(old_edges), old_width, static_cast<uint2*>(new_edges), static_cast<float*>(new_mask),
      new_width, static_cast<const long long*>(pieces), static_cast<const int*>(tile_piece), tile);
  return static_cast<int>(cudaGetLastError());
}

// Loads the kernel on the current device and returns the cudaError_t as an
// int. The library's own CUDA runtime starts, and the module loads, at its
// first call (CUDA loads modules lazily): called where a program is
// prepared, it keeps that cost out of the program's first launch.
extern "C" int rescale_migrate_prepare() {
  cudaFuncAttributes attributes;
  return static_cast<int>(cudaFuncGetAttributes(&attributes, rescale_migrate_kernel));
}

extern "C" const char* rescale_migrate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
