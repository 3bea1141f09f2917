#!/usr/bin/env python3
"""Time the GEO greedy kernel (``csrc/full_reorder.cu``) beside a parent
version and variants of it, split each step's time by phase, and measure the
latencies that bound a step's chain.

    python3 tools/greedy_variants.py --parent build/parent/full_reorder.cu
    python3 tools/greedy_variants.py --parent build/parent/full_reorder.cu --parent-only

Needs a CUDA device and ``nvcc``; two to four minutes, most of it the host
mirror at RMAT-16 and at the chunk. Put the parent's source under
``build/`` (copied to the card's machine, not committed).

Shapes: ``path4``, path 4's slots (RMAT-14, edge factor 16, seed 0, k in
[4, 32]: 16,384 vertices); ``rmat16``, the smoke's ``GREEDY_WIDE_SCALE``
graph (RMAT-16, k in [26, 32]: 65,536 vertices); ``chunk60k``, a path-7-size
out-of-core chunk (200,000 random edges among 60,000 ids spread over 2**20,
compacted as ``core/hier_order.order_edge_block`` does, k in [4, 128]); and
``rmat9``, path 9 (b)'s graph (RMAT-9, edge factor 8, k in [4, 128]: 512
vertices).

Each shape is held against the host mirror ``_full_order_host`` (the
permutation the keys sort to, and the step count) for every build, then
timed parent, kernel, kernel, parent: CUDA events around the launch alone
(the incidence list is built before), the least of ``--reps`` launches. The
kernel is the package's own library behind the package's launch steps.

Variants, built from the sources by text substitution in a temporary
directory (one ``nvcc`` each, all started together; the script stops with a
message when a text it substitutes is missing):

- ``clock``: ``clock64()`` sums by phase in thread 0 (of CTA rank 0), read
  out through a ``__device__`` array: argmin (the scan and its block
  reduction, and the combine over a cluster), one-hop, frontier writes,
  two-hop collect (its batches' scans included), two-hop apply, and the
  waits at the barriers that close the phases. Made of the parent and of the
  kernel; each is timed once beside its own source.
- ``cluster-{n}`` (kernel only, n = 4, 8, 16): the smallest cluster of at
  least n CTAs that holds the state, wherever the kernel takes a cluster;
  ``one-cta-0``: a cluster always, where the kernel's size rule takes one
  CTA wherever its shared memory holds the state.

Micro-measurements: the latency of ``cluster.sync()`` (``barrier.cluster``
arrive and wait) at cluster sizes 2, 4, 8 and 16 and of ``__syncthreads()``,
1,024 threads a CTA; a dependent load from L2 (``ld.global.cg``, a random
cycle over 4 MiB) and from another CTA's shared memory (DSMEM); and
``cudaOccupancyMaxActiveClusters`` at each size with 200 KiB of shared
memory a CTA. The chain bound of a run is its steps times the least step:
the barriers a step waits at times their latencies, plus the dependent
global loads of a step's two walks times the L2 latency
(``barriers_a_step``, ``CHAIN_LOADS``).

The last line is one JSON object with every reading and the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PHASES = ("argmin", "one_hop", "frontier_writes", "two_hop_collect", "two_hop_apply", "barriers")
# A step's chain: the dependent global loads of the one-hop walk (ptr[vmin],
# inc, done, u) and of the two-hop walk (frontier, ptr[f], inc, done, u and
# v); the state's own loads are left out, so the bound stays a floor.
CHAIN_LOADS = 9
CLUSTER_SIZES = (2, 4, 8, 16)


def barriers_a_step(design: str, cluster: int) -> tuple:
    """(cluster barriers, CTA barriers) a step waits at, at least (a step
    with one frontier batch): the parent's one CTA 8 (two in the argmin's
    reduction, after the one-hop, after the frontier writes, three a batch,
    after the apply); the kernel's one CTA 7 (no frontier-write phase); its
    cluster 3 cluster-wide (after the partials, the one-hop and the collect)
    and 6 in each CTA (the reduction's two, a batch's three, after the
    apply, which writes only the CTA's own range)."""
    if design.startswith("parent"):
        return 0, 8
    return (0, 7) if cluster == 1 else (3, 6)

MICRO_SOURCE = r"""
#include <cuda_runtime.h>
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

__global__ void __launch_bounds__(1024, 1) cluster_sync_kernel(int iters, unsigned long long* out) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const unsigned long long t0 = clock64();
  for (int k = 0; k < iters; ++k) cl.sync();
  const unsigned long long t1 = clock64();
  if (threadIdx.x == 0 && cl.block_rank() == 0) out[0] = t1 - t0;
}

__global__ void __launch_bounds__(1024, 1) block_sync_kernel(int iters, unsigned long long* out) {
  const unsigned long long t0 = clock64();
  for (int k = 0; k < iters; ++k) __syncthreads();
  const unsigned long long t1 = clock64();
  if (threadIdx.x == 0) out[0] = t1 - t0;
}

__global__ void chase_kernel(const int* __restrict__ next, int iters, int* sink, unsigned long long* out) {
  int j = 0;
  const unsigned long long t0 = clock64();
  for (int k = 0; k < iters; ++k) j = __ldcg(next + j);
  const unsigned long long t1 = clock64();
  *sink = j;
  out[0] = t1 - t0;
}

// Rank 0's thread 0 follows a random cycle through rank 1's shared memory.
__global__ void __launch_bounds__(32, 1) dsmem_chase_kernel(const int* __restrict__ cycle, int n, int iters, int* sink,
                                                           unsigned long long* out) {
  extern __shared__ int arr[];
  cg::cluster_group cl = cg::this_cluster();
  for (int x = threadIdx.x; x < n; x += blockDim.x) arr[x] = cycle[x];
  cl.sync();
  if (cl.block_rank() == 0 && threadIdx.x == 0) {
    const int* remote = cl.map_shared_rank(arr, 1);
    int j = 0;
    const unsigned long long t0 = clock64();
    for (int k = 0; k < iters; ++k) j = remote[j];
    const unsigned long long t1 = clock64();
    *sink = j;
    out[0] = t1 - t0;
  }
  cl.sync();
}

static cudaError_t launch_cluster(const void* fn, int cluster, int threads, size_t smem, cudaStream_t stream,
                                  void** args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, fn, args);
}

extern "C" int micro_cluster_sync(int cluster, int iters, void* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(cluster_sync_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  void* args[] = {&iters, &out};
  err = launch_cluster((const void*)cluster_sync_kernel, cluster, 1024, 0, (cudaStream_t)stream, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

extern "C" int micro_block_sync(int iters, void* out, void* stream) {
  block_sync_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(iters, (unsigned long long*)out);
  return cudaGetLastError();
}

extern "C" int micro_chase(const void* next, int iters, void* sink, void* out, void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, iters, (int*)sink, (unsigned long long*)out);
  return cudaGetLastError();
}

extern "C" int micro_dsmem_chase(const void* cycle, int n, int iters, void* sink, void* out, void* stream) {
  const size_t smem = sizeof(int) * (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(dsmem_chase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&cycle, &n, &iters, &sink, &out};
  err = launch_cluster((const void*)dsmem_chase_kernel, 2, 32, smem, (cudaStream_t)stream, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters for the sync kernel at `cluster` CTAs of
// 1,024 threads with `smem` bytes of dynamic shared memory each.
extern "C" int micro_max_clusters(int cluster, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(cluster_sync_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cluster_sync_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, (const void*)cluster_sync_kernel, &cfg);
}
"""


# ---------------------------------------------------------------- the shapes
def shape(name: str):
    """``(u, v, valid, nv, k_min, k_max, seed)`` of one shape (int64 ends)."""
    from repro_torch.core.graph import rmat_graph

    if name in ("path4", "rmat16", "rmat9"):
        scale, ef, k_min, k_max = {"path4": (14, 16, 4, 32), "rmat16": (16, 16, 26, 32), "rmat9": (9, 8, 4, 128)}[name]
        g = rmat_graph(scale, ef, seed=0)
        return (g.src.astype(np.int64), g.dst.astype(np.int64), np.ones(g.num_edges, bool), g.num_vertices,
                k_min, k_max, 0)
    rng = np.random.default_rng(5)  # chunk60k: tests/test_torch_cuda.py _oc_block's "wide" recipe, scaled up
    ids = rng.choice(1 << 20, size=60_000, replace=False)
    e = ids[rng.integers(0, ids.shape[0], size=(200_000, 2))]
    e = np.sort(e[e[:, 0] != e[:, 1]], axis=1)
    verts = np.unique(e)
    local = np.searchsorted(verts, e)
    nv = int(verts.shape[0])
    uk = np.unique(local[:, 0] * np.int64(nv) + local[:, 1])
    return uk // nv, uk % nv, np.ones(uk.shape[0], bool), nv, 4, 128, 7


SHAPES = ("path4", "rmat16", "chunk60k", "rmat9")


# ------------------------------------------------------------------ variants
def _sub(source: str, what: str, *pairs) -> str:
    out = source
    for old, new in pairs:
        if out.count(old) != 1:
            raise RuntimeError(f"{what} no longer holds {old!r} once, where this script changes it; "
                               "update the variants to the kernel's new text")
        out = out.replace(old, new)
    return out


CLOCK_HEAD = """#include <cstdint>

__device__ unsigned long long g_phase_cycles[8];  // the phases' clock64() sums, then the loop's total
extern "C" int full_reorder_phase_cycles(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles)));
}
#define TICK(k) if (tick) { const unsigned long long c_ = clock64(); ph[k] += c_ - last; last = c_; }
"""
CLOCK_OUT = ("for (int k = 0; k < 6; ++k) g_phase_cycles[k] = ph[k]; g_phase_cycles[6] = clock64() - t_first; "
             "g_phase_cycles[7] = t;")


def clock_variant(source: str, what: str) -> str:
    """``clock64()`` sums by phase (``PHASES``) in thread 0, or in rank 0's
    thread 0 of a cluster, written to ``g_phase_cycles`` at the end."""
    if "barrier<kMode>()" not in source:  # the one-CTA design of the parent
        return _sub(
            source, what,
            ("#include <cstdint>\n", CLOCK_HEAD),
            ("  int t = 0, i = 0;\n",
             "  int t = 0, i = 0;\n  const bool tick = tid == 0;\n  unsigned long long ph[6] = {0, 0, 0, 0, 0, 0};\n"
             "  const unsigned long long t_first = clock64();\n  unsigned long long last = t_first;\n"),
            ("    const int vmin = best == kNone ? 0 : static_cast<int>(best & 0xffffffffu);  // argmin of all-MAX is 0\n",
             "    const int vmin = best == kNone ? 0 : static_cast<int>(best & 0xffffffffu);  // argmin of all-MAX is 0\n"
             "    TICK(0)\n"),
            ("      if (first) frontier[at] = other;\n    }\n    __syncthreads();\n",
             "      if (first) frontier[at] = other;\n    }\n    TICK(1)\n    __syncthreads();\n    TICK(5)\n"),
            ("      walked += hi - lo;\n    }\n    __syncthreads();\n",
             "      walked += hi - lo;\n    }\n    TICK(2)\n    __syncthreads();\n    TICK(5)\n"),
            ("    const int n2 = s_n2;\n", "    TICK(3)\n    const int n2 = s_n2;\n"),
            ("    for (int x = tid; x < nf; x += kThreads) S.fr[frontier[x] >> 5] = 0;  // only frontier bits are set\n"
             "    __syncthreads();\n",
             "    for (int x = tid; x < nf; x += kThreads) S.fr[frontier[x] >> 5] = 0;  // only frontier bits are set\n"
             "    TICK(4)\n    __syncthreads();\n    TICK(5)\n"),
            ("  if (tid == 0) {\n    *steps_out = t;\n", "  if (tid == 0) {\n    " + CLOCK_OUT + "\n    *steps_out = t;\n"),
        )
    return _sub(  # the cluster design: the frontier writes are a part of the apply phase
        source, what,
        ("#include <cstdint>\n", CLOCK_HEAD),
        ("  int t = 0, i = 0;\n",
         "  int t = 0, i = 0;\n  const bool tick = gt == 0;\n  unsigned long long ph[6] = {0, 0, 0, 0, 0, 0};\n"
         "  const unsigned long long t_first = clock64();\n  unsigned long long last = t_first;\n"),
        ("      if (tid == 0) sh.part[0] = best;\n      barrier<kMode>();\n",
         "      if (tid == 0) sh.part[0] = best;\n      TICK(0)\n      barrier<kMode>();\n      TICK(5)\n"),
        ("    const int vmin = best == kNone ? 0 : static_cast<int>(best & 0xffffffffu);  // argmin of all-MAX is 0\n",
         "    const int vmin = best == kNone ? 0 : static_cast<int>(best & 0xffffffffu);  // argmin of all-MAX is 0\n"
         "    TICK(0)\n"),
        ("      if (first) frontier[at] = other;\n    }\n    barrier<kMode>();\n",
         "      if (first) frontier[at] = other;\n    }\n    TICK(1)\n    barrier<kMode>();\n    TICK(5)\n"),
        ("    if constexpr (kMode != kOneCta) {\n      barrier<kMode>();\n",
         "    TICK(3)\n    if constexpr (kMode != kOneCta) {\n      barrier<kMode>();\n      TICK(5)\n"),
        ("        atomicMax(own.m + lb, i2);\n      }\n    }\n", "        atomicMax(own.m + lb, i2);\n      }\n    }\n    TICK(4)\n"),
        ("    __syncthreads();\n    if constexpr (kMode == kOneCta) {\n",
         "    TICK(2)\n    __syncthreads();\n    TICK(5)\n    if constexpr (kMode == kOneCta) {\n"),
        ("  if (lead) {\n    *steps_out = t;\n", "  if (lead) {\n    " + CLOCK_OUT + "\n    *steps_out = t;\n"),
    )


def variants(source: str) -> dict:
    """The kernel's variants (see the module's docstring)."""
    out = {"clock": clock_variant(source, "full_reorder.cu")}
    for n in (4, 8, 16):
        out[f"cluster-{n}"] = _sub(source, "full_reorder.cu", ("  for (int c = 2; c <= kMaxCluster; ++c) {\n",
                                                                f"  for (int c = {n}; c <= kMaxCluster; ++c) {{\n"))
    out["one-cta-0"] = _sub(source, "full_reorder.cu", ("  if (state_bytes(nvp) <= info.room_one)\n",
                                                         "  if (false)\n"))
    return out


def build(sources: dict, build_dir: pathlib.Path) -> dict:
    """Each source compiled, all at once: name -> the loaded library."""
    from repro_torch.kernels import _build

    nvcc = _build.find_nvcc()

    def one(name):
        cu, so = build_dir / f"{name}.cu", build_dir / f"{name}.so"
        cu.write_text(sources[name])
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(cu)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
        report = sorted({line.split("Used", 1)[1].strip() for line in proc.stdout.splitlines() + proc.stderr.splitlines()
                         if "Used" in line and "registers" in line})
        print(f"built {name}: {report}", flush=True)
        return so

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(sources)) as pool:
        paths = dict(zip(sources, pool.map(one, sources)))
    return {name: ctypes.CDLL(str(path)) for name, path in paths.items()}


# ---------------------------------------------------------------- launchers
class Launcher:
    """One library of the greedy's C interface behind the package wrapper's
    steps. Both designs export ``full_reorder_greedy`` with the same
    arguments; the scratch the state needs comes from
    ``full_reorder_plan`` (cluster size, global bytes) where the library has
    it, else from the parent's ``full_reorder_state_bytes``."""

    def __init__(self, lib):
        self.lib = lib
        fn = lib.full_reorder_greedy
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.fn = fn
        self.has_plan = hasattr(lib, "full_reorder_plan")
        if self.has_plan:
            lib.full_reorder_plan.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            lib.full_reorder_plan.restype = ctypes.c_int
        else:
            lib.full_reorder_state_bytes.argtypes = [ctypes.c_int]
            lib.full_reorder_state_bytes.restype = ctypes.c_longlong
        self.clock = hasattr(lib, "full_reorder_phase_cycles")

    def plan(self, nv: int) -> tuple:
        """(cluster size, global bytes): 1 CTA for the parent."""
        if self.has_plan:
            c, g = ctypes.c_int(0), ctypes.c_longlong(0)
            err = self.lib.full_reorder_plan(nv, ctypes.byref(c), ctypes.byref(g))
            if err:
                raise RuntimeError(f"full_reorder_plan failed: cudaError {err}")
            return c.value, g.value
        need = self.lib.full_reorder_state_bytes(nv)
        if need < 0:
            raise RuntimeError(f"full_reorder_state_bytes failed: cudaError {-need}")
        return 1, need

    def run(self, inputs: dict, nv: int, params: tuple) -> dict:
        """One launch on fresh keys and ``done``: keys, steps, work, the
        launch's ms (CUDA events around it alone) and, for a clock build,
        its phase cycles."""
        from repro_torch.kernels import full_reorder as FRK

        u, v, valid, permpos, ptr, inc = (inputs[k] for k in ("u", "v", "valid", "permpos", "ptr", "inc"))
        cap, dev = u.shape[0], u.device
        _, need = self.plan(nv)
        done = (~valid).to(torch.uint8)
        keys = torch.full((4, cap), FRK._PAD, dtype=torch.int32, device=dev)
        frontier = torch.empty(nv, dtype=torch.int32, device=dev)
        th = torch.empty((cap, 4), dtype=torch.int32, device=dev)
        state = torch.empty(max(1, need), dtype=torch.uint8, device=dev)
        steps = torch.empty(1, dtype=torch.int32, device=dev)
        work = torch.empty(2, dtype=torch.int64, device=dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        err = self.fn(u.data_ptr(), v.data_ptr(), done.data_ptr(), ptr.data_ptr(), inc.data_ptr(), permpos.data_ptr(),
                      keys.data_ptr(), frontier.data_ptr(), th.data_ptr(), state.data_ptr(), steps.data_ptr(),
                      work.data_ptr(), cap, nv, *params, torch.cuda.current_stream().cuda_stream)
        end.record()
        if err:
            raise RuntimeError(f"greedy launch failed: cudaError {err}")
        torch.cuda.synchronize()
        out = dict(keys=keys, steps=int(steps[0]), work=[int(x) for x in work.cpu()], ms=start.elapsed_time(end))
        if self.clock:
            cycles = (ctypes.c_ulonglong * 8)()
            if self.lib.full_reorder_phase_cycles(ctypes.byref(cycles)):
                raise RuntimeError("reading the phase cycles failed")
            out["cycles"] = list(cycles)
        return out


def exact(run: dict, host: np.ndarray, steps: int) -> bool:
    k = run["keys"].cpu().numpy()
    perm = np.lexsort((np.arange(k.shape[1]), k[3], k[2], k[1], k[0]))
    return bool(np.array_equal(perm, host)) and run["steps"] == steps


def split(run: dict) -> dict:
    """A clock build's phases as shares of its loop and as µs a step (the
    shares times the launch's µs a step)."""
    c = run["cycles"]
    total = max(1, c[6])
    us_step = run["ms"] * 1e3 / max(1, run["steps"])
    return dict(cycles=c[:6], loop_cycles=c[6], **{f"{p}_share": c[k] / total for k, p in enumerate(PHASES)},
                **{f"{p}_us_per_step": c[k] / total * us_step for k, p in enumerate(PHASES)},
                unaccounted_share=1 - sum(c[:6]) / total)


# ------------------------------------------------------------------- micro
def micro(lib) -> dict:
    """Latencies of ``cluster.sync()`` at 2, 8 and 16 CTAs and of
    ``__syncthreads()`` (1,024 threads a CTA), of a dependent L2 load and
    of a dependent DSMEM load (µs, from CUDA events over many in a row, and
    clock cycles), and the clusters that fit the card at each size."""
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    lib.micro_cluster_sync.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.micro_block_sync.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.micro_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.micro_dsmem_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p]
    lib.micro_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def timed(call, iters):
        call(iters // 10)  # warm-up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        err = call(iters)
        end.record()
        if err:
            raise RuntimeError(f"micro-measurement launch failed: cudaError {err}")
        torch.cuda.synchronize()
        return dict(us=start.elapsed_time(end) * 1e3 / iters, cycles=int(out[0]) / iters)

    res = {}
    iters = 100_000
    for c in CLUSTER_SIZES:
        res[f"cluster_sync_{c}"] = timed(lambda n: lib.micro_cluster_sync(c, n, out.data_ptr(), stream), iters)
        n_fit = ctypes.c_int(-1)
        err = lib.micro_max_clusters(c, 200 * 1024, ctypes.byref(n_fit))
        res[f"max_active_clusters_{c}"] = n_fit.value if not err else f"cudaError {err}"
    res["block_sync"] = timed(lambda n: lib.micro_block_sync(n, out.data_ptr(), stream), iters)
    rng = np.random.default_rng(0)
    n = 1 << 20  # 4 MiB of int32: in L2, past L1
    order = rng.permutation(n)
    nxt = np.empty(n, np.int32)
    nxt[order] = np.roll(order, -1)
    nxt_t = torch.from_numpy(nxt).to(dev)
    res["l2_load"] = timed(lambda k: lib.micro_chase(nxt_t.data_ptr(), k, sink.data_ptr(), out.data_ptr(), stream),
                           200_000)
    m = 16_384  # 64 KiB in the remote CTA's shared memory
    order = rng.permutation(m)
    cyc = np.empty(m, np.int32)
    cyc[order] = np.roll(order, -1)
    cyc_t = torch.from_numpy(cyc).to(dev)
    res["dsmem_load"] = timed(
        lambda k: lib.micro_dsmem_chase(cyc_t.data_ptr(), m, k, sink.data_ptr(), out.data_ptr(), stream), 200_000)
    return res


def chain_bound_ms(micro_res: dict, steps: int, design: str, cluster: int) -> float:
    """``steps`` steps, each at least its barriers (``barriers_a_step``: a
    cluster barrier at the latency measured for the largest measured size
    not above ``cluster``) and ``CHAIN_LOADS`` dependent L2 loads."""
    cs, bs = barriers_a_step(design, cluster)
    size = max([c for c in CLUSTER_SIZES if c <= max(cluster, 2)])
    step_us = (cs * micro_res[f"cluster_sync_{size}"]["us"] + bs * micro_res["block_sync"]["us"]
               + CHAIN_LOADS * micro_res["l2_load"]["us"])
    return steps * step_us / 1e3


# --------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True, help="the parent's full_reorder.cu")
    ap.add_argument("--shapes", default=",".join(SHAPES), help=f"comma-separated, of {', '.join(SHAPES)}")
    ap.add_argument("--reps", type=int, default=3, help="launches a timing, the least taken")
    ap.add_argument("--parent-only", action="store_true",
                    help="the parent, its clock variant and the micro-measurements alone (parent, parent)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("greedy_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import full_reorder as FRK

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    kernel_src = (_build.CSRC / "full_reorder.cu").read_text()
    parent_src = args.parent.read_text()
    sources = {} if args.parent_only else {f"kernel-{k}": s for k, s in variants(kernel_src).items()}
    sources["parent"] = parent_src
    sources["parent-clock"] = clock_variant(parent_src, str(args.parent))
    if not args.parent_only:
        sources["kernel"] = kernel_src
    sources["micro"] = MICRO_SOURCE
    order = ("parent", "parent") if args.parent_only else ("parent", "kernel", "kernel", "parent")
    report = dict(card=card, reps=args.reps, shapes={})
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, pathlib.Path(tmp))
        report["micro"] = micro(libs.pop("micro"))
        print("micro: " + ", ".join(f"{k} {v}" for k, v in report["micro"].items()), flush=True)
        runs = {name: Launcher(lib) for name, lib in libs.items()}
        for name in args.shapes.split(","):
            u, v, valid, nv, k_min, k_max, seed = shape(name)
            n = int(valid.sum())
            deg = np.bincount(np.concatenate([u[valid], v[valid]]), minlength=1)
            params = FRK.greedy_params(n, k_min, k_max, int(deg.max()))
            permpos = FRK.fallback_positions(nv, seed)
            t0 = time.perf_counter()
            host, steps = FRK._full_order_host(u, v, valid, nv, *params, permpos)
            mirror_s = time.perf_counter() - t0
            put = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).cuda()  # noqa: E731
            inputs = dict(u=put(u), v=put(v), valid=torch.from_numpy(valid).cuda(), permpos=put(permpos))
            inputs["ptr"], inputs["inc"] = FRK.incidence_device(inputs["u"], inputs["v"], inputs["valid"], nv)
            r = dict(slots=int(u.shape[0]), live=n, vertices=nv, k=[k_min, k_max], steps=steps, mirror_s=mirror_s,
                     plan={b: runs[b].plan(nv) for b in runs})
            first = {b: l.run(inputs, nv, params) for b, l in runs.items()}
            bad = [b for b, x in first.items() if not exact(x, host, steps)]
            if bad:
                raise AssertionError(f"{name}: {bad} differ from the host mirror "
                                     f"(steps {[first[b]['steps'] for b in bad]}, mirror {steps})")
            r["walked"], r["fallbacks"] = first["parent"]["work"]
            times = {b: [] for b in order}
            for b in order:
                times[b].append(min(runs[b].run(inputs, nv, params)["ms"] for _ in range(args.reps)))
            r["runs_ms"] = times
            for b in times:
                r[f"{b}_ms"] = min(times[b])
                r[f"{b}_us_per_step"] = r[f"{b}_ms"] / steps * 1e3
            r["parent_spread_ms"] = max(times["parent"]) - min(times["parent"])
            r["variants_ms"] = {b: min(first[b]["ms"], runs[b].run(inputs, nv, params)["ms"])
                                for b in runs if b not in ("parent", "kernel")}
            r["split"] = {b: split(x) for b, x in first.items() if "cycles" in x}
            r["bytes"] = steps * 10 * nv + r["walked"] * 13 + 16 * n
            r["byte_bound_ms"] = r["bytes"] / 3.35e12 * 1e3
            r["chain_bound_ms"] = {b: chain_bound_ms(report["micro"], steps, b, r["plan"][b][0]) for b in times}
            report["shapes"][name] = r
            print(f"{name} ({r['slots']} slots, {nv} vertices, {steps} steps; mirror {mirror_s:.1f} s; plans "
                  f"{r['plan']}): " + ", ".join(f"{b} {r[b + '_ms']:.3f} ms ({r[b + '_us_per_step']:.2f} us a step, "
                                                f"runs {times[b]})" for b in times)
                  + f"; byte bound {r['byte_bound_ms']:.4f} ms; chain bound "
                  + ", ".join(f"{b} {x:.3f} ms" for b, x in r["chain_bound_ms"].items())
                  + "; every build equal to the mirror", flush=True)
            for b, s in r["split"].items():
                print(f"  split {b}: " + ", ".join(f"{p} {s[p + '_share']:.3f} ({s[p + '_us_per_step']:.2f} us)"
                                                   for p in PHASES)
                      + f", unaccounted {s['unaccounted_share']:.3f}", flush=True)
            print("  variants ms: " + ", ".join(f"{b} {x:.3f}" for b, x in sorted(r["variants_ms"].items())),
                  flush=True)
            del inputs
            torch.cuda.empty_cache()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
