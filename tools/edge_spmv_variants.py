#!/usr/bin/env python3
"""Time the edge_spmv kernel beside variants of it that each take one part
of its design away, at chip_smoke.py's three full-size ``chunked_spmv`` calls.

    python3 tools/edge_spmv_variants.py

Needs a CUDA device and ``nvcc``; about four minutes, most of it the RMAT
scale-20 graph and its GEO order on the host (the smoke's: edge factor 16,
seed 0, k_min 4, k_max 128). Weights and x are uniform in [0.5, 1.5) and
[0, 1) from seed 0. The calls are the smoke's: (a) 16 chunks, full windows;
(b) 128 chunks, full windows; (c) 16 chunks, 65,536-wide windows at each
chunk's smallest src. Each call is packed on the card with
``ops.pack_windows_device``.

Builds, in a temporary directory, copies of
``src/repro_torch/kernels/csrc/edge_spmv.cu`` changed by text substitution:

- ``steps-8``, ``steps-16``: warp strips of 8 or 16 steps of 32 slots
  (the kernel: 4);
- ``chunk-fastest``: consecutive blocks on consecutive chunks, the order of
  the first CUDA kernel, so every chunk's rows are live in L2 at once;
- ``atomic-per-slot``: no warp reduction, one ``atomicAdd`` per valid slot;
- ``block-table``: the warp runs go into a 4,096-entry hash table in shared
  memory, and each block tile issues one atomic per distinct dst;
- ``no-atomics`` and ``no-gather`` compute a different function (no scatter,
  or x read as 1): they show what the scatter and the gather cost.

Every variant that computes the function is held against the plain version
(rtol 1e-4, atol 1e-5). The time of one call includes the zero fill of the
output, as in the smoke; each variant is timed twice, in the order listed
and then in reverse. Also printed per call: the zero fill alone, the
``index_add_`` yardstick of the smoke, the valid slots and the atomics the
kernel issues (one per run of equal dst in a warp's 128-slot strip). The
last line is one JSON object with every reading.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
STRIP = 128  # edge slots of one warp's strip in the kernel (32 * kSteps)

_SCAN_START = "    // Segmented reduction of each 32-slot step"
_SCAN_END = "  }\n}\n\n}  // namespace"
_PER_SLOT = """#pragma unroll
    for (int i = 0; i < kSteps; ++i)
      if (d[i] >= 0) atomicAdd(out_row + d[i], val[i]);
"""
_TABLE = """#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int di = d[i];
      float vi = val[i];
      if (__ballot_sync(kAll, di >= 0) == 0) continue;
      const int prev = __shfl_up_sync(kAll, di, 1);
      const bool head = di >= 0 && (lane == 0 || di != prev);
      const unsigned heads = __ballot_sync(kAll, head);
      const unsigned above = heads & ~((2u << lane) - 1u);
      const int end = above ? __ffs(above) - 1 : 32;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float other = __shfl_down_sync(kAll, vi, off);
        if (lane + off < end) vi += other;
      }
      if (head) {
        unsigned slot = (static_cast<unsigned>(di) * 2654435761u) >> 20;
        while (true) {
          const int k = atomicCAS(keys + slot, -1, di);
          if (k == -1 || k == di) { atomicAdd(vals + slot, vi); break; }
          slot = (slot + 1) & 4095;
        }
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < 4096; j += kThreads) {
      const int k = keys[j];
      if (k >= 0) { atomicAdd(out_row + k, vals[j]); keys[j] = -1; vals[j] = 0.0f; }
    }
    __syncthreads();
"""


def _swap_scan(source: str, body: str) -> str:
    for mark in (_SCAN_START, _SCAN_END):
        if source.count(mark) != 1:
            raise RuntimeError(f"edge_spmv.cu no longer holds {mark!r} once, where this script replaces the "
                               "warp reduction; update the variants to the kernel's new text")
    i, j = source.index(_SCAN_START), source.index(_SCAN_END)
    return source[:i] + body + source[j:]


def variants(source: str) -> dict:
    """Each variant's source, made from the kernel's by text substitution."""
    def sub(*pairs):
        out = source
        for old, new in pairs:
            if out.count(old) != 1:
                raise RuntimeError(f"edge_spmv.cu no longer holds {old!r} once, where this script changes it; "
                                   "update the variants to the kernel's new text")
            out = out.replace(old, new)
        return out

    order = ("const long long chunk = t / tiles_per_chunk;\n"
             "    const long long first = (t - chunk * tiles_per_chunk) * kTile",
             "const long long chunks = tiles / tiles_per_chunk, chunk = t % chunks;\n"
             "    const long long first = (t / chunks) * kTile")
    table_init = ("  const int warp = threadIdx.x >> 5;\n",
                  "  const int warp = threadIdx.x >> 5;\n  __shared__ int keys[4096];\n  __shared__ float vals[4096];\n"
                  "  for (int j = threadIdx.x; j < 4096; j += kThreads) { keys[j] = -1; vals[j] = 0.0f; }\n"
                  "  __syncthreads();\n")
    return {
        "kernel": source,
        "steps-8": sub(("kSteps = 4;", "kSteps = 8;")),
        "steps-16": sub(("kSteps = 4;", "kSteps = 16;")),
        "chunk-fastest": sub(order),
        "atomic-per-slot": _swap_scan(source, _PER_SLOT),
        "block-table": _swap_scan(sub(table_init), _TABLE),
        "no-atomics": _swap_scan(source, _PER_SLOT.replace("atomicAdd(out_row + d[i], val[i])",
                                                           "if (val[i] == 1234.5f) out_row[d[i]] = val[i]")),
        "no-gather": sub(("__ldg(x_row + s[i])", "1.0f")),
    }


COMPUTES_THE_FUNCTION = ("kernel", "steps-8", "steps-16", "chunk-fastest", "atomic-per-slot", "block-table")


def build_all(tmp: pathlib.Path, nvcc: str, flags) -> dict:
    sources = variants((CSRC / "edge_spmv.cu").read_text())

    def build(name: str):
        cu, so = tmp / f"{name}.cu", tmp / f"{name}.so"
        cu.write_text(sources[name])
        proc = subprocess.run([nvcc, *flags, "-o", str(so), str(cu)], check=True, capture_output=True, text=True)
        regs = [line.split(":", 1)[1].strip() for line in (proc.stdout + proc.stderr).splitlines() if "registers" in line]
        return so, regs

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources)))
    libs = {}
    for name, (so, regs) in built.items():
        print(f"built {name}: {'; '.join(regs)}", flush=True)
        fn = ctypes.CDLL(str(so)).edge_spmv_blocked
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("edge_spmv_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as smoke
    from repro_torch.core import cep, ordering
    from repro_torch.core.graph import rmat_graph
    from repro_torch.kernels import _build, edge_spmv, ops

    dev = torch.device("cuda")
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_all(pathlib.Path(tmp), _build.find_nvcc(), _build.NVCC_FLAGS)

        g = rmat_graph(scale=20, edge_factor=16, seed=0)
        order = ordering.geo_order(g, k_min=4, k_max=128)
        src, dst = g.src[order], g.dst[order]
        n, v = g.num_edges, g.num_vertices
        rng = np.random.default_rng(0)
        weights = (rng.random(n) + 0.5).astype(np.float32)
        x = torch.from_numpy(rng.random(v).astype(np.float32)).to(dev)
        b16, b128 = np.asarray(cep.chunk_bounds(n, 16)), np.asarray(cep.chunk_bounds(n, 128))
        narrow = min(1 << 16, v // 16)
        narrow_starts = [int(np.clip(src[b16[i]:b16[i + 1]].min(), 0, v - narrow)) for i in range(16)]
        calls = {"a": (b16, [0] * 16, v), "b": (b128, [0] * 128, v), "c": (b16, narrow_starts, narrow)}

        readings = {}
        for call, (bounds, starts, size) in calls.items():
            src_l, dst_l, wts, _ = ops.pack_windows_device(src, dst, weights, bounds, starts, size, device=dev)
            x_win = ops._x_windows(x, np.asarray(starts, dtype=np.int64), size)
            c, w_e = src_l.shape
            stream = torch.cuda.current_stream().cuda_stream

            def run(fn):
                out = torch.zeros((c, size), dtype=torch.float32, device=dev)
                err = fn(src_l.data_ptr(), dst_l.data_ptr(), wts.data_ptr(), x_win.data_ptr(), out.data_ptr(),
                         c, w_e, size, stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
                return out

            want = edge_spmv.spmv_blocked_torch(src_l, dst_l, wts, x_win)
            valid = (src_l < size) & (dst_l < size)
            d_or_none = torch.where(valid, dst_l, -1)
            prev = torch.nn.functional.pad(d_or_none[:, :-1], (1, 0), value=-1)
            strip_start = (torch.arange(w_e, device=dev) % STRIP == 0)[None, :]
            atomics = int((valid & (strip_start | (d_or_none != prev))).sum())
            flat = (torch.arange(c, device=dev)[:, None] * size + dst_l)[valid]
            prod = (wts * x_win.gather(1, torch.where(valid, src_l, 0).long()))[valid]
            r = dict(shape=[c, w_e, size], valid_slots=int(valid.sum()), atomics=atomics,
                     zero_fill_ms=smoke.cuda_ms(lambda: torch.zeros((c, size), device=dev), 20),
                     index_add_ms=smoke.cuda_ms(lambda: torch.zeros(c * size, device=dev).index_add_(0, flat, prod), 20))
            del flat, prod
            times = {name: [] for name in fns}
            for names in (list(fns), list(fns)[::-1]):
                for name in names:
                    if name in COMPUTES_THE_FUNCTION:
                        torch.testing.assert_close(run(fns[name]), want, rtol=1e-4, atol=1e-5,
                                                   msg=lambda m: f"{name} at call ({call}): {m}")
                    times[name].append(smoke.cuda_ms(lambda: run(fns[name]), 20))
            r["ms"] = {name: float(np.mean(t)) for name, t in times.items()}
            readings[call] = r
            print(f"call ({call}) (C, W_E, W_V) = ({c}, {w_e}, {size}): {r['valid_slots']} valid slots, "
                  f"{atomics} atomics issued by the kernel; zero fill {r['zero_fill_ms']:.4f} ms, "
                  f"index_add_ {r['index_add_ms']:.4f} ms", flush=True)
            for name, t in times.items():
                print(f"  {name:16s} {t[0]:.4f} / {t[1]:.4f} ms, mean {np.mean(t):.4f}", flush=True)
            del src_l, dst_l, wts, x_win, want, valid, d_or_none, prev
            torch.cuda.empty_cache()
    print(f"card: {card}")
    print(json.dumps({"card": card, "calls": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
