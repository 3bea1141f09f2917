#!/usr/bin/env python3
"""Time the ``segment_rf`` kernel beside variants of it and a parent version
at the row shapes the paths count, in two ways: as a caller pays it
(back-to-back wrapper calls between two CUDA events: host work shows
wherever it exceeds the card's) and on the card alone (the same calls
captured in one CUDA graph, whose replay is timed with events).

    python3 tools/segment_rf_variants.py --parent build/parent/segment_rf.cu

Needs a CUDA device and ``nvcc``; about a minute. Variants, built from
``src/repro_torch/kernels/csrc/segment_rf.cu`` by text substitution in a
temporary directory (all ``nvcc`` runs started together; the script stops
with a message when a text it substitutes is missing): ``t{threads}-u{n}``,
CTAs of that many threads with n int4 loads in flight a thread (all
but the kernel's own pair); ``lane0-late``, lane 0's predecessor read after its
vector has arrived instead of beside it; ``ctas-{n}-an-sm``, the kernel
with the rows split for n CTAs an SM (the wrapper: ``CTAS_PER_SM``, 4); and,
with ``--other NAME=PATH``, any source of the five-argument interface
(``segment_rf_counts(ids, out, rows, width, stream)``, every count
written), such as a design with one thread-block cluster a row. Variants are timed on
the card alone, each held exactly against the plain version. The parent source must
export the same C interface, ``segment_rf_counts(ids, out, rows, width,
stream)``, and add its counts into a zero-filled ``out``, as the kernel of
PR 13 did (a 2-D grid, one ``atomicAdd`` a block): its wrapper here
zero-fills ``out`` and sets the ctypes signature at every call, as that
wrapper did. The kernel is the package's own wrapper,
``segment_rf.segment_distinct_counts``.

Shapes (C, W): (16, 1,962,714), the k = 16 pack's rows at RMAT-20;
(4, 1,962,714), a rank's rows of it over four ranks; (3, 2,944,512), path
3's span keys; (3, 798,720) and (2, 161,792), the full rung's and a
gathered span's keys over ranks. Rows are sorted ids with repeats, each
padded at a random tail (numpy seed 0). Each is timed parent, kernel,
kernel, parent; every result is held exactly against the plain version. The
last line is one JSON object with every reading and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = [(16, 1_962_714), (4, 1_962_714), (3, 2_944_512), (3, 798_720), (2, 161_792)]
REPS = 50
H100_BYTES_PER_S = 3.35e12


def sorted_rows(rng: np.random.Generator, c: int, w: int, pad_id: int) -> np.ndarray:
    rows = np.cumsum(rng.integers(0, 3, size=(c, w), dtype=np.int8), axis=1, dtype=np.int32)
    n_valid = rng.integers(0, w + 1, size=c)
    rows[np.arange(w)[None, :] >= n_valid[:, None]] = pad_id
    return rows


def wrapper_ms(fn, reps: int) -> float:
    """Back-to-back calls between two events: what a caller pays."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """The card's time alone: ``reps`` calls captured in one CUDA graph,
    its replay timed with events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def variants(source: str) -> dict:
    """Each variant's source, made from the kernel's by text substitution."""
    def sub(*pairs):
        out = source
        for old, new in pairs:
            if out.count(old) != 1:
                raise RuntimeError(f"segment_rf.cu no longer holds {old!r} once, where this script changes it; "
                                   "update the variants to the kernel's new text")
            out = out.replace(old, new)
        return out

    threads = re.search(r"constexpr int kThreads = (\d+);", source)
    unroll = re.search(r"constexpr int kUnroll = (\d+);", source)
    if threads is None or unroll is None:
        raise RuntimeError("segment_rf.cu no longer names kThreads and kUnroll; update the variants")
    out = {}
    for t in (256, 512, 1024):
        for n in (4, 8):
            if (t, n) != (int(threads.group(1)), int(unroll.group(1))):  # not the kernel's own
                out[f"t{t}-u{n}"] = sub((threads.group(0), f"constexpr int kThreads = {t};"),
                                        (unroll.group(0), f"constexpr int kUnroll = {n};"))
    out["lane0-late"] = sub(("before[u] = lane == 0 && j < nvec && e > 0 ? __ldg(row + e - 1) : -1;", "before[u] = e;"),
                            ("const int32_t prev = lane == 0 ? before[u] : up;",
                             "const int32_t prev = lane == 0 ? (j < nvec && before[u] > 0 ? row[before[u] - 1] : -1) : up;"))
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
        regs = sorted({line.split("Used", 1)[1].strip() for line in proc.stdout.splitlines() + proc.stderr.splitlines()
                       if "Used" in line and "registers" in line})
        print(f"built {name}: {regs}", flush=True)
        return so

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(sources)) as pool:
        paths = dict(zip(sources, pool.map(one, sources)))
    return {name: ctypes.CDLL(str(path)) for name, path in paths.items()}


def variant_wrapper(lib, ctas_per_sm: int):
    """A library of the kernel's interface behind the package wrapper's
    steps (an empty output, CTAs a row from ``segment_rf.ctas_per_row`` at
    ``ctas_per_sm``, one zeroed counter array kept for the stream)."""
    from repro_torch.kernels import segment_rf

    fn = lib.segment_rf_counts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.segment_rf_chunk_ids.restype = ctypes.c_longlong
    chunk_ids = int(lib.segment_rf_chunk_ids())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tickets = {}

    def counts(rows: torch.Tensor) -> torch.Tensor:
        c, w = rows.shape
        out = torch.empty(c, dtype=torch.int32, device=rows.device)
        old, segment_rf.CTAS_PER_SM = segment_rf.CTAS_PER_SM, ctas_per_sm
        bpr = segment_rf.ctas_per_row(c, w, sms, chunk_ids)
        segment_rf.CTAS_PER_SM = old
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        partials = torch.empty(c * bpr, dtype=torch.int32, device=rows.device)
        if stream not in tickets:
            tickets[stream] = torch.zeros(1024, dtype=torch.int32, device=rows.device)
        err = fn(rows.data_ptr(), out.data_ptr(), c, w, bpr, partials.data_ptr(), tickets[stream].data_ptr(), stream)
        if err:
            raise RuntimeError(f"segment_rf variant launch failed: cudaError {err}")
        return out

    return counts


def other_wrapper(lib):
    """A source of the five-argument interface (ids, out, rows, width,
    stream) that writes every count: an empty output, the ctypes signature
    set once."""
    fn = lib.segment_rf_counts
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def counts(rows: torch.Tensor) -> torch.Tensor:
        c, w = rows.shape
        out = torch.empty(c, dtype=torch.int32, device=rows.device)
        err = fn(rows.data_ptr(), out.data_ptr(), c, w, torch.cuda.current_stream(rows.device).cuda_stream)
        if err:
            raise RuntimeError(f"segment_rf launch failed: cudaError {err}")
        return out

    return counts


def parent_wrapper(lib):
    """The parent kernel behind a wrapper as the parent had it."""
    def counts(rows: torch.Tensor) -> torch.Tensor:
        c, w = rows.shape
        out = torch.zeros(c, dtype=torch.int32, device=rows.device)
        fn = lib.segment_rf_counts
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(rows.device):
            err = fn(rows.data_ptr(), out.data_ptr(), c, w, torch.cuda.current_stream(rows.device).cuda_stream)
        if err:
            raise RuntimeError(f"parent segment_rf launch failed: cudaError {err}")
        return out

    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True, help="the parent's segment_rf.cu")
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH",
                    help="another segment_rf.cu of the five-argument interface that writes every count")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("segment_rf_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.compat import PAD_ID
    from repro_torch.kernels import _build, segment_rf

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    _build.build("segment_rf")
    sources = variants((_build.CSRC / "segment_rf.cu").read_text())
    sources["parent"] = args.parent.read_text()
    sources["kernel"] = (_build.CSRC / "segment_rf.cu").read_text()
    named = dict(o.split("=", 1) for o in args.other)
    sources.update({name: pathlib.Path(path).read_text() for name, path in named.items()})
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, pathlib.Path(tmp))
        parent = parent_wrapper(libs.pop("parent"))
        others = {name: other_wrapper(libs.pop(name)) for name in named}
        base = libs.pop("kernel")
        others.update({f"ctas-{n}-an-sm": variant_wrapper(base, n) for n in (2, 4, 8, 16, 32) if n != segment_rf.CTAS_PER_SM})
        others.update({name: variant_wrapper(lib, segment_rf.CTAS_PER_SM) for name, lib in libs.items()})
        kernel = segment_rf.segment_distinct_counts
        rng = np.random.default_rng(0)
        readings = []
        for c, w in SHAPES:
            rows = torch.from_numpy(sorted_rows(rng, c, w, PAD_ID)).cuda()
            want = segment_rf.segment_distinct_counts_torch(rows)
            for name, fn in (("parent", parent), ("kernel", kernel), *others.items()):
                got = fn(rows)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} differs from the plain version at {(c, w)}")
            times = {"parent": {"wrapper_ms": [], "card_ms": []}, "kernel": {"wrapper_ms": [], "card_ms": []}}
            for name, fn in (("parent", parent), ("kernel", kernel), ("kernel", kernel), ("parent", parent)):
                times[name]["wrapper_ms"].append(wrapper_ms(lambda: fn(rows), REPS))
                times[name]["card_ms"].append(graph_ms(lambda: fn(rows), REPS))
            bound_ms = (c * w * 4 + c * 4) / H100_BYTES_PER_S * 1e3
            r = dict(shape=[c, w], bound_ms=bound_ms, **{f"{n}_{k}": min(v) for n, t in times.items()
                                                          for k, v in t.items()}, runs=times,
                     variants_card_ms={name: graph_ms(lambda: fn(rows), REPS) for name, fn in others.items()})
            readings.append(r)
            print(f"(C, W) = ({c}, {w}): bound {bound_ms:.4f} ms; parent card {r['parent_card_ms']:.4f} ms, wrapper "
                  f"{r['parent_wrapper_ms']:.4f} ms; kernel card {r['kernel_card_ms']:.4f} ms "
                  f"({bound_ms / r['kernel_card_ms']:.3f} of the bound), wrapper {r['kernel_wrapper_ms']:.4f} ms; "
                  f"exact", flush=True)
            print("  variants, card ms: " + ", ".join(f"{n} {x:.4f}" for n, x in sorted(r["variants_card_ms"].items(),
                                                                                        key=lambda kv: kv[1])),
                  flush=True)
            del rows, want
    print(json.dumps({"card": card, "reps": REPS, "segment_rf": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
