#!/usr/bin/env python3
"""Time SSSP's and WCC's min-sweep at graph500-22's shapes: the torch sweep
that ``graphs/engine.py`` ran before the ``min_sweep`` kernel, against the
kernel.

    python3 tools/min_sweep_variants.py [--scale 22] [--ks 16,128] [--reps 5]

Needs a CUDA device and ``nvcc``; about a minute at scale 22. The graph is
``perfbench``'s graph500 instance of ``perfbench/configs/g500-s22.json``
(``--scale`` changes only its scale), made on the card and packed by
``engine.pack_ordered`` at each k of ``--ks``. At each k the tool runs one
whole SSSP query (from the highest-degree vertex) and one WCC query with the
torch sweep and keeps every sweep's state; the kernel then sweeps each of
those states, so both do the same work, and each of its results and stop
flags must equal the torch sweep's bit for bit.

Versions: ``torch`` (two gathers, two ``where`` and two float
``scatter_reduce_`` amin over an int64 copy of the pack, the copy made once a
query and timed apart) and ``kernel`` (the library as built). For each, a
sweep's time on the card (CUDA events around the enqueue: for the kernel the
x-to-nx copy, the flag's zeroing and the launch) and a whole call (host
clock, through the stop flag's readback), each the least of ``--reps`` runs,
in the order torch, kernel, kernel, torch. The byte bound is
``(12·S + 8·V) / 3.35e12`` s. The last line is one JSON object with every
reading.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from perfbench.generators import graph500  # noqa: E402
from repro_torch.graphs import engine as E  # noqa: E402
from repro_torch.kernels import min_sweep  # noqa: E402

H100_BYTES_PER_S = 3.35e12


def torch_sweep(e64, valid, x, step):
    """The sweep as ``graphs/engine.py`` ran it before the kernel (``e64``: the
    int64 copy of the pack made once a query)."""
    src, dst = e64[:, 0], e64[:, 1]
    cand = torch.full_like(x, 1e9)
    cand.scatter_reduce_(0, dst, torch.where(valid, x[src] + step, 1e9), "amin")
    cand.scatter_reduce_(0, src, torch.where(valid, x[dst] + step, 1e9), "amin")
    nx = torch.minimum(x, cand)
    return nx, (nx < x).any()


def time_sweeps(call, states, step, reps):
    """Per state: (least card ms, least whole-call ms) over ``reps`` runs."""
    card, whole = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for x in states:
        c_best = w_best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            nx, flag = call(x, step)
            end.record()
            bool(int(flag) & 1)  # the stop flag's readback
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            c_best = min(c_best, start.elapsed_time(end))
            w_best = min(w_best, (t1 - t0) * 1e3)
        card.append(c_best)
        whole.append(w_best)
    return card, whole


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--ks", default="16,128")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    params = dict(json.loads((ROOT / "perfbench/configs/g500-s22.json").read_text())["generator"])
    params["scale"] = args.scale
    src, dst, v, _ = graph500.generate(params, dev)
    src, dst = src.cpu().numpy(), dst.cpu().numpy()
    print(f"graph500-{args.scale}: {len(src)} edges, {v} vertices", flush=True)
    report = {"card": card, "scale": args.scale, "edges": int(len(src)), "vertices": int(v), "ks": {}}
    for k in (int(s) for s in args.ks.split(",")):
        data = E.pack_ordered(src, dst, v, k, device=dev)
        edges, mask = data.edges, data.mask
        slots = edges.shape[0] * edges.shape[1]
        bound_ms = min_sweep.sweep_bytes(slots, v) / H100_BYTES_PER_S * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e64 = edges.reshape(-1, 2).long()
        valid = mask.reshape(-1) > 0
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) * 1e3
        calls = {
            "torch": lambda x, step: torch_sweep(e64, valid, x, step),
            "kernel": lambda x, step: min_sweep.min_sweep(edges, mask, x, step),
        }
        xs = torch.arange(v, dtype=torch.float32, device=dev)
        nxs = torch.empty_like(xs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        x_copy_ms = float("inf")
        for _ in range(args.reps):  # the kernel's x-to-nx copy alone: subtract it for the kernel alone
            start.record()
            nxs.copy_(xs)
            end.record()
            torch.cuda.synchronize()
            x_copy_ms = min(x_copy_ms, start.elapsed_time(end))
        row = {"slots": slots, "bound_ms": bound_ms, "int64_copy_ms": copy_ms, "x_copy_ms": x_copy_ms,
               "queries": {}}
        source = int(torch.argmax(data.degrees))
        for kind, step in (("sssp", 1.0), ("wcc", 0.0)):
            if kind == "sssp":
                x = torch.full((v,), 1e9, device=dev)
                x[source] = 0.0
            else:
                x = torch.arange(v, dtype=torch.float32, device=dev)
            states, results = [], []
            changed = True
            while changed and len(states) < 64:
                nx, flag = torch_sweep(e64, valid, x, step)
                states.append(x)
                results.append((nx, bool(flag)))
                changed, x = bool(flag), nx
            for name, call in calls.items():  # both equal the torch sweep on every state
                for x, (want, want_flag) in zip(states, results):
                    nx, flag = call(x, step)
                    got_flag = bool(int(flag) & 1)
                    if not torch.equal(nx.view(torch.int32), want.view(torch.int32)) or got_flag != want_flag:
                        raise AssertionError(f"{name} at k={k} {kind}: a sweep differs from the torch sweep")
            order = list(calls) + list(reversed(calls))
            times = {name: {"card_ms": [], "call_ms": []} for name in calls}
            for name in order:
                c, w = time_sweeps(calls[name], states, step, args.reps)
                times[name]["card_ms"].append(c)
                times[name]["call_ms"].append(w)
            q = {"sweeps": len(states)}
            for name, t in times.items():
                card_ms = np.minimum(*t["card_ms"])
                call_ms = np.minimum(*t["call_ms"])
                q[name] = {"card_ms": card_ms.tolist(), "call_ms": call_ms.tolist(),
                           "card_median_ms": float(np.median(card_ms)), "call_median_ms": float(np.median(call_ms)),
                           "query_call_ms": float(call_ms.sum())}
                print(f"k={k} {kind} ({len(states)} sweeps, {slots} slots, bound {bound_ms:.4f} ms) {name}: "
                      f"card median {q[name]['card_median_ms']:.4f} ms, call median "
                      f"{q[name]['call_median_ms']:.4f} ms, query {q[name]['query_call_ms']:.3f} ms; card by "
                      f"sweep {[round(c, 4) for c in card_ms]}", flush=True)
            row["queries"][kind] = q
        print(f"k={k}: int64 copy of the pack {copy_ms:.3f} ms (the torch version's, once a query); x-to-nx "
              f"copy {x_copy_ms:.4f} ms (inside the kernel's card time)", flush=True)
        report["ks"][k] = row
        del e64, valid, data, edges, mask
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
