#!/usr/bin/env python3
"""Time the decode_attention kernels beside variants of them that each change
one part of the design, at chip_smoke.py's full-size decode call.

    python3 tools/decode_variants.py
    python3 tools/decode_variants.py --parent build/parent/decode_attention.cu

Needs a CUDA device and ``nvcc``; about a minute. The call is the smoke's:
qwen3-8b width at batch 8, 64 cache rows of 32,768 bf16 positions, Gq 4,
D 128, ``cache_len`` from numpy seed 0 in [1, S] with row 0 full and row 1 at
16,507; q, K and V are normals from a torch generator on the card, seed 0.

Every variant is a merged call (split kernel, then combine kernel) on the
same inputs, held against the plain version (1e-4) and timed with CUDA
events. Variants:

- ``split-512`` ... ``split-4096``: the kernel with that many keys a work
  item (a run-time argument; the wrapper's is ``SPLIT``);
- ``stages-1``, ``stages-2``, ``stages-4``: the ring of K/V tiles that
  deep (the kernel: 3). Fewer stages need less shared memory, so more
  blocks fit an SM: each build prints its registers, spills and blocks an
  SM;
- ``tile-32``: tiles of at most 32 keys (the kernel: 64), so 8 KB of K a
  tile at bf16 D 128 and about half the shared memory a block;
- ``one-block-per-sm``: the kernel with 120 KB of unused shared memory a
  block, so that one block fits an SM;
- ``masked-v``: the merged path reading, and merging, the V of every split
  past ``cache_len`` as the per-tile contract does (same result: those
  splits weigh exactly 0);
- ``split kernel``: the kernel's merged mode without the combine kernel,
  and ``combine kernel``: the combine alone, again and again on one split
  kernel's partials;
- ``partials``: the partials entry point (block_s 512, every tile written)
  plus the torch ``merge_partials``, and the partials kernel alone;
- ``parent`` (with ``--parent``): a ``decode_attention.cu`` of the old
  design (per-tile partials kernel over every tile, q cast and merge in
  torch), timed first and last: parent, kernel, kernel, parent.

Variants other than the split are built from
``src/repro_torch/kernels/csrc/decode_attention.cu`` by text substitution, in
a temporary directory, all ``nvcc`` runs started together. The script stops
with a message when a text it substitutes is missing. The last line is one
JSON object with every reading.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
SPLITS = (512, 1024, 2048, 4096)
REPS = 20


def variants(source: str) -> dict:
    """Each variant's source, made from the kernel's by text substitution."""
    def sub(*pairs):
        out = source
        for old, new in pairs:
            if out.count(old) != 1:
                raise RuntimeError(f"decode_attention.cu no longer holds {old!r} once, where this script changes "
                                   "it; update the variants to the kernel's new text")
            out = out.replace(old, new)
        return out

    stages = "constexpr int kStages = 3;"
    return {
        "kernel": source,
        "stages-1": sub((stages, "constexpr int kStages = 1;")),
        "stages-2": sub((stages, "constexpr int kStages = 2;")),
        "stages-4": sub((stages, "constexpr int kStages = 4;")),
        "tile-32": sub(("constexpr int kMaxTileKeys = 64;", "constexpr int kMaxTileKeys = 32;")),
        "one-block-per-sm": sub(("static constexpr int kSmemBytes = kBarOff + kStages * 8;",
                                 "static constexpr int kSmemBytes = kBarOff + kStages * 8 + 120 * 1024;")),
        "masked-v": sub(("} else if (every_split || len <= 0) {", "} else if (true) {"),
                        ("const long long n = len >= 1 ? (valid + split - 1) / split : nsplit;",
                         "const long long n = nsplit + 0 * valid;")),
    }


def build_all(tmp: pathlib.Path, nvcc: str, flags, parent: pathlib.Path | None) -> dict:
    sources = variants((CSRC / "decode_attention.cu").read_text())
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, tmp / header.name)
    if parent is not None:
        (tmp / "parent").mkdir()
        for f in parent.parent.glob("*.cuh"):
            shutil.copy(f, tmp / "parent" / f.name)
        sources["parent"] = parent.read_text()

    def build(name: str):
        cu = tmp / ("parent" if name == "parent" else ".") / f"{name}.cu"
        so = tmp / f"{name}.so"
        cu.write_text(sources[name])
        proc = subprocess.run([nvcc, *flags, "-o", str(so), str(cu)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
        log = proc.stdout + proc.stderr
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines() if "registers" in line]
        spills = [line.strip() for line in log.splitlines() if "spill" in line and " 0 bytes spill stores" not in line]
        return so, regs, spills

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources)))
    libs = {}
    for name, (so, regs, spills) in built.items():
        libs[name] = lib = ctypes.CDLL(str(so))
        occupancy = ""
        if name != "parent":  # blocks an SM of the smoke's instantiation (bf16, D 128, Gq 4)
            lib.decode_attention_blocks_per_sm.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
            occupancy = f", {lib.decode_attention_blocks_per_sm(128, 1, 4)} blocks an SM at bf16 D 128 Gq 4"
        print(f"built {name}: {len(regs)} kernels, registers {sorted(set(regs))}, spills: {spills or 'none'}"
              f"{occupancy}", flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, help="a decode_attention.cu of the old design, timed beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec

    dev = torch.device("cuda")
    card = smoke.card_line()
    print(f"card: {card}", flush=True)
    cfg = smoke.QWEN3
    bh, gq, d, s = smoke.DECODE_BATCH * cfg["kv_heads"], cfg["heads"] // cfg["kv_heads"], cfg["head_dim"], \
        smoke.DECODE_CACHE
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((bh, gq, d), generator=gen, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn((bh, s, d), generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(2))
    cache_np = smoke.decode_cache_lengths(bh)
    cl = torch.from_numpy(cache_np).to(dev)
    scale = d**-0.5
    row_bytes = d * k.element_size()
    valid = np.minimum(cache_np.astype(np.int64), s)
    kv_bytes = {"merged": int((2 * valid).sum()) * row_bytes,
                "masked-v": int((valid + s).sum()) * row_bytes}
    plain = dec.merge_partials(*dec.decode_attention_partials_torch(q, k, v, cl, scale=scale,
                                                                    block_s=smoke.DECODE_BLOCK))[0]
    stream = torch.cuda.current_stream().cuda_stream

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(pathlib.Path(tmp), _build.find_nvcc(), _build.NVCC_FLAGS, args.parent)

        def merged(lib, split: int, combine: bool = True, split_once: bool = False):
            split_fn, merge_fn = lib.decode_attention_split_fwd, lib.decode_attention_merge_fwd
            split_fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 6
                                 + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                              ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
            merge_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
            nsplit = -(-s // split)
            parts = [torch.empty((bh, nsplit, gq, d), dtype=torch.float32, device=dev)]
            parts += [torch.empty((bh, nsplit, gq), dtype=torch.float32, device=dev) for _ in range(2)]

            def run():
                o, m, l = parts if split_once else (torch.empty_like(t) for t in parts)
                out = torch.empty((bh, gq, d), dtype=torch.float32, device=dev)
                err = 0
                if not split_once:
                    err = split_fn(q.data_ptr(), 1, d, k.data_ptr(), v.data_ptr(), cl.data_ptr(), o.data_ptr(),
                                   m.data_ptr(), l.data_ptr(), bh, gq, s, d, 1, split, 0, scale, 0.0, stream)
                if combine:
                    err = err or merge_fn(o.data_ptr(), m.data_ptr(), l.data_ptr(), cl.data_ptr(), out.data_ptr(),
                                          bh, gq, s, d, split, d, stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
                return out
            if split_once:  # the partials the combine alone reads in every run
                o, m, l = parts
                err = split_fn(q.data_ptr(), 1, d, k.data_ptr(), v.data_ptr(), cl.data_ptr(), o.data_ptr(),
                               m.data_ptr(), l.data_ptr(), bh, gq, s, d, 1, split, 0, scale, 0.0, stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            return run

        def partials(lib, with_merge: bool):
            fn = lib.decode_attention_split_fwd
            nb = s // smoke.DECODE_BLOCK

            def run():
                o = torch.empty((bh, nb, gq, d), dtype=torch.float32, device=dev)
                m = torch.empty((bh, nb, gq, 1), dtype=torch.float32, device=dev)
                l = torch.empty((bh, nb, gq, 1), dtype=torch.float32, device=dev)
                err = fn(q.data_ptr(), 1, d, k.data_ptr(), v.data_ptr(), cl.data_ptr(), o.data_ptr(), m.data_ptr(),
                         l.data_ptr(), bh, gq, s, d, 1, smoke.DECODE_BLOCK, 1, scale, 0.0, stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
                return dec.merge_partials(o, m, l)[0] if with_merge else o
            return run

        def parent(lib, with_merge: bool = True):
            fn = lib.decode_attention_partials_fwd
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
            nb = s // smoke.DECODE_BLOCK

            def run():
                qf = q.float()
                o = torch.empty((bh, nb, gq, d), dtype=torch.float32, device=dev)
                m = torch.empty((bh, nb, gq, 1), dtype=torch.float32, device=dev)
                l = torch.empty((bh, nb, gq, 1), dtype=torch.float32, device=dev)
                err = fn(qf.data_ptr(), k.data_ptr(), v.data_ptr(), cl.data_ptr(), o.data_ptr(), m.data_ptr(),
                         l.data_ptr(), bh, gq, s, d, 1, smoke.DECODE_BLOCK, scale, 0.0, stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
                return dec.merge_partials(o, m, l)[0] if with_merge else o
            return run

        kernel = libs["kernel"]
        runs = {f"split-{sp}": merged(kernel, sp) for sp in SPLITS}  # sets the argument types partials uses
        for name in ("stages-1", "stages-2", "stages-4", "tile-32", "one-block-per-sm", "masked-v"):
            runs[name] = merged(libs[name], dec.SPLIT)
        runs["split kernel"] = merged(kernel, dec.SPLIT, combine=False)
        runs["combine kernel"] = merged(kernel, dec.SPLIT, split_once=True)
        runs["partials+merge"] = partials(kernel, True)
        runs["partials kernel"] = partials(kernel, False)
        runs["entry point"] = lambda: dec.decode_attention(q, k, v, cl, block_s=smoke.DECODE_BLOCK)
        if args.parent is not None:
            runs["parent"] = parent(libs["parent"])
            runs["parent partials kernel"] = parent(libs["parent"], with_merge=False)
        for name, run in runs.items():
            if name not in ("split kernel", "partials kernel", "parent partials kernel"):  # those return no result
                torch.testing.assert_close(run(), plain, rtol=1e-4, atol=1e-4, msg=lambda m_: f"{name}: {m_}")
        order = list(runs)
        if args.parent is not None:  # parent, change, change, parent
            order = ["parent", "parent partials kernel"] + [n for n in order if not n.startswith("parent")]
            order = order + order[::-1]
        else:
            order = order + order[::-1]
        times = {name: [] for name in runs}
        for name in order:
            times[name].append(smoke.cuda_ms(runs[name], REPS))
        readings = {name: dict(ms=t, mean_ms=float(np.mean(t))) for name, t in times.items()}
        for name, r in readings.items():
            kvb = 0 if name == "combine kernel" else kv_bytes[
                "masked-v" if name == "masked-v" or "partials" in name or name.startswith("parent") else "merged"]
            r["kv_bytes"] = kvb
            r["tb_per_s"] = kvb / (r["mean_ms"] * 1e-3) / 1e12
            print(f"  {name:24s} {' / '.join(f'{t:.4f}' for t in r['ms'])} ms, mean {r['mean_ms']:.4f}; "
                  f"K/V {kvb / 1e9:.3f} GB at {r['tb_per_s']:.3f} TB/s", flush=True)
    bound_ms = kv_bytes["merged"] / smoke.H100_BYTES_PER_S * 1e3
    print(f"bound of the K/V bytes below cache_len: {bound_ms:.4f} ms ({kv_bytes['merged']} B)")
    print(f"card: {card}")
    print(json.dumps({"card": card, "shape": [bh, gq, s, d], "bound_ms": bound_ms, "kv_bytes": kv_bytes,
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
