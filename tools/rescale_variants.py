#!/usr/bin/env python3
"""Time a rescale's migration on the card: the parent's loop of torch ops
against the ``rescale_migrate`` kernel, at slice 1's three plans on the
RMAT-20 edge count.

    python3 tools/rescale_variants.py            # RMAT scale 20, edge factor 16
    python3 tools/rescale_variants.py --scale 14 # a quick check of the tool itself

Needs a CUDA device and ``nvcc``; about a minute, most of it the RMAT graph
on the host. The CEP copy does not depend on the order of the edges, so the
graph is packed in its own order (no GEO order). Plans: 16→17 (on the k = 16
pack), 8→12 (on k = 8) and 12→8 (on k = 12), one rank.

Versions, each run on the same old pack and held byte-equal to the parent's
result (edges and mask):
- ``parent``: the migration as the port ran it before the kernel (the body
  of ``ElasticRescaler.execute``): ``torch.zeros`` of the new block, one
  slice assignment a local plan segment, a clone of the cached mask;
- ``kernel``: ``rescale_migrate.migrate`` on the cached program's table,
  allocating its block as ``execute`` does; ``kernel-alone``: the same into
  one block, its calls captured in a CUDA graph (the card's time alone);
- ``tile-{n}``: the kernel on a table cut into tiles of n slots;
- ``plain``: the kernel's plain PyTorch version (``migrate_torch``);
- ``index_select``: one ``index_select`` of every new slot's edge from the
  old edges with a zero edge appended, over a cached int64 gather map: the
  one PyTorch call that computes the same edges (not the mask);
- ``execute``: ``ElasticRescaler.execute`` whole (``recheck=False``), its
  ``elapsed_s``: the kernel, the (empty) exchange and a synchronize.
Each is timed with CUDA events around the migration alone, a synchronize
before each run, as the least of ``--reps`` runs, in the order parent,
kernel, kernel, parent (then the others). The bound is the bytes the
function must move (8 read an edge copied, 12 written a slot) over 3.35
TB/s. The last line is one JSON object with every reading and the card's
name and power limit.
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
PLANS = [("16to17", 16, 17), ("8to12", 8, 12), ("12to8", 12, 8)]
TILES = (1024, 2048, 8192, 16384)
H100_BYTES_PER_S = 3.35e12


def least_ms(fn, reps: int) -> float:
    """The least of ``reps`` runs of ``fn``, each between two CUDA events
    after a synchronize."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


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


def parent_loop(old: torch.Tensor, prog, mask_new: torch.Tensor) -> tuple:
    """The parent's migration on one rank: zeros, a slice copy a local
    segment, the cached mask cloned."""
    new_edges = torch.zeros((prog.table.rows, prog.table.width, 2), dtype=old.dtype, device=old.device)
    for r_old, a_old, b_old, r_new, a_new, b_new in prog.local:
        new_edges[r_new, a_new:b_new] = old[r_old, a_old:b_old]
    return new_edges, mask_new.clone()


def gather_map(table, old: torch.Tensor) -> torch.Tensor:
    """Every new slot's index into the old edges flattened, a zero slot at
    the index past them."""
    e_old = old.shape[1]
    out = np.full(table.rows * table.width, old.shape[0] * e_old, dtype=np.int64)
    for row, a, b, src, a_old, _ in table.pieces.tolist():
        if src >= 0:
            out[row * table.width + a:row * table.width + b] = np.arange(src * e_old + a_old, src * e_old + a_old + b - a)
    return torch.from_numpy(out).to(old.device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20, help="RMAT scale: 2**scale vertices")
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--reps", type=int, default=7, help="runs a version; the least is kept")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rescale_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import cep
    from repro_torch.core.graph import rmat_graph
    from repro_torch.elastic.rescale_exec import ElasticRescaler
    from repro_torch.graphs import engine as E
    from repro_torch.kernels import _build
    from repro_torch.kernels import rescale_migrate as RM
    from repro_torch.launch.mesh import make_graph_group

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    _build.build("rescale_migrate")
    t0 = time.perf_counter()
    g = rmat_graph(scale=args.scale, edge_factor=args.edge_factor, seed=0)
    n = g.num_edges
    print(f"graph: RMAT-{args.scale}, |E| {n}, {time.perf_counter() - t0:.3f} s on the host", flush=True)
    rx, group = ElasticRescaler(), make_graph_group(dev)
    readings = []
    for name, k_old, k_new in PLANS:
        data = E.pack_ordered(g.src, g.dst, g.num_vertices, k_old, device=dev)
        old = data.edges
        plan = cep.scale_plan(n, k_old, k_new)
        prog = rx._program(n, k_old, k_new, plan, group, dev)
        t = prog.table
        mask_new = (torch.arange(t.width, device=dev)[None, :]
                    < torch.from_numpy(t.sizes).to(dev)[:, None]).float()
        want = parent_loop(old, prog, mask_new)
        gmap = gather_map(t, old)
        flat = torch.cat([old.reshape(-1, 2), old.new_zeros((1, 2))])
        block = RM.migrate(old, t)
        tiled = {tile: RM.migrate_table(prog.local, [], t.sizes, t.width, dev, tile=tile) for tile in TILES}
        for what, got in [("kernel", block), ("plain", RM.migrate_torch(old, t)),
                          *((f"tile-{tile}", RM.migrate(old, tt)) for tile, tt in tiled.items())]:
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name}: {what} differs from the parent's migration")
        if not torch.equal(flat.index_select(0, gmap).view_as(want[0]), want[0]):
            raise AssertionError(f"{name}: index_select differs from the parent's migration")
        before = RM.launches
        stats = [rx.execute(data, plan, recheck=False)[1] for _ in range(args.reps)]
        if RM.launches != before + args.reps:
            raise AssertionError(f"{name}: execute launched the kernel {RM.launches - before} times in {args.reps} runs")
        ms = {}
        runs = {"parent": [], "kernel": []}
        for what in ("parent", "kernel", "kernel", "parent"):
            fn = (lambda: parent_loop(old, prog, mask_new)) if what == "parent" else (lambda: RM.migrate(old, t))
            runs[what].append(least_ms(fn, args.reps))
        ms.update({what: min(r) for what, r in runs.items()})
        ms["kernel-alone"] = graph_ms(lambda: RM.migrate(old, t, out=block), 20)
        ms.update({f"tile-{tile}": least_ms(lambda: RM.migrate(old, tt), args.reps) for tile, tt in tiled.items()})
        ms["plain"] = least_ms(lambda: RM.migrate_torch(old, t), args.reps)
        ms["index_select"] = least_ms(lambda: flat.index_select(0, gmap), args.reps)
        ms["execute"] = min(st.elapsed_s for st in stats) * 1e3
        copied = int(sum(b - a for _, a, b, src, *_ in t.pieces.tolist() if src >= 0))
        moved = 8 * copied + 12 * t.rows * t.width
        bound = moved / H100_BYTES_PER_S * 1e3
        r = dict(plan=name, rows=t.rows, width=t.width, copy_ops=prog.stats.copy_ops, pieces=len(t.pieces),
                 tiles=t.tiles, tile=t.tile, copied_edges=copied, bytes=moved, bound_ms=bound, ms=ms,
                 runs=runs)
        readings.append(r)
        print(f"{name}: {t.rows} rows of {t.width} (E_max {'odd' if t.width % 2 else 'even'}), {prog.stats.copy_ops} "
              f"segments, {len(t.pieces)} pieces, {t.tiles} tiles; bound {bound:.4f} ms ({moved} B); "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + " ms; parent runs "
              f"{[round(x, 4) for x in runs['parent']]}, kernel runs {[round(x, 4) for x in runs['kernel']]}",
              flush=True)
        del data, old, want, gmap, flat, block, tiled
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "scale": args.scale, "num_edges": n, "reps": args.reps, "plans": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
