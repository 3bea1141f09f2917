#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA GPU and check every result.

    python3 chip_smoke.py                 # RMAT scale 20, edge factor 16
    python3 chip_smoke.py --scale 14      # a quicker rehearsal

Phases, in order; any failure raises and the script exits nonzero:

1. the card's name and power limit (``nvidia-smi``);
2. build the ``segment_rf`` CUDA kernel from ``src/repro_torch/kernels/csrc``;
3. RMAT graph and GEO order on the host;
4. kernel parity: the kernel equals its plain PyTorch version exactly on
   random sorted rows (numpy, fixed seed) at the main path's row shapes and
   at edge cases (rows not a multiple of 8, widths not a multiple of the
   tile, all-PAD rows, single-id rows, W = 1, a row wider than 65535 tiles);
5. the main path, with the kernel's launch count set to 0 just before it:
   CEP packs at k = 4, 16, 64, 128 (RF and mirrors measured on the card,
   equal to the numpy oracle), rescale 16→17 and 8→12→8 with the
   from-scratch byte check, re-checked RF equal to the oracle, PageRank /
   SSSP / WCC on the packs at k = 17 and k = 4; the launch count must equal
   the number of packs plus re-checked rescales;
6. the kernel's time (CUDA events) beside its memory bound and the plain
   version's time, at the k = 16 row shape of the real pack.

Output: phase lines, then the card line, one ``{"kernels": [...]}`` JSON line
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository's ``src/`` beside this file, it exits nonzero and
prints no result.
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

ROOT = pathlib.Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12  # HBM3 rate of an H100 SXM (NVIDIA data sheet)
H100_FP32_OPS_PER_S = 67e12  # non-tensor-core f32 rate; the kernel's int compares run on the same ALUs
PACK_KS = (4, 16, 64, 128)
ROW_KS = (4, 8, 12, 16, 17, 64, 128)  # every k whose rows the main path counts
PAGERANK_RTOL = 1e-4  # CUDA scatter-add uses atomics: f32 sums in varying order


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sorted_rows(rng: np.random.Generator, c: int, w: int, pad_id: int) -> np.ndarray:
    """(c, w) int32 rows, ascending with repeats, each padded at a random tail."""
    rows = np.cumsum(rng.integers(0, 3, size=(c, w), dtype=np.int8), axis=1, dtype=np.int32)
    n_valid = rng.integers(0, w + 1, size=c)
    rows[np.arange(w)[None, :] >= n_valid[:, None]] = pad_id
    return rows


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20, help="RMAT scale: 2**scale vertices")
    ap.add_argument("--edge-factor", type=int, default=16, help="RMAT edges sampled per vertex")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.compat import PAD_ID
    from repro_torch.core import cep, metrics, ordering
    from repro_torch.core.graph import rmat_graph
    from repro_torch.elastic.rescale_exec import EDGE_BYTES, ElasticRescaler
    from repro_torch.graphs import engine as E
    from repro_torch.kernels import _build, ops, segment_rf
    from repro_torch.kernels.ref import segment_distinct_counts_ref

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    phases: dict = {}

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    lib_path = _build.build("segment_rf")
    _build.load("segment_rf")
    phases["build_s"] = time.perf_counter() - t0
    log(f"build: {lib_path.name} in {phases['build_s']:.3f} s")
    build_log = lib_path.with_name(lib_path.name + ".log")
    if build_log.exists():  # written by the build that made the library
        log(build_log.read_text().strip())

    # ------------------------------------------------------- graph + order
    t0 = time.perf_counter()
    g = rmat_graph(scale=args.scale, edge_factor=args.edge_factor, seed=0)
    phases["rmat_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    order = ordering.geo_order(g, k_min=4, k_max=128)
    phases["geo_order_s"] = time.perf_counter() - t0
    src, dst = g.src[order], g.dst[order]
    n, v = g.num_edges, g.num_vertices
    log(f"graph: |V|={v} |E|={n} rmat {phases['rmat_s']:.3f} s, geo_order {phases['geo_order_s']:.3f} s")

    # ------------------------------------------------------- kernel parity
    rng = np.random.default_rng(0)
    cases = [(k, 2 * int(np.diff(cep.chunk_bounds(n, k)).max())) for k in ROW_KS]
    cases += [(13, 1000), (9, 4097), (3, 3 * 4096 + 1), (5, 1), (1, 65535 * 4096 + 4097)]
    t0 = time.perf_counter()
    max_abs_err = 0
    for c, w in cases:
        rows = sorted_rows(rng, c, w, PAD_ID)
        if (c, w) == (13, 1000):
            rows[0] = PAD_ID  # an all-PAD row
            rows[1] = 7  # a single distinct id, no padding
            rows[2, :500], rows[2, 500:] = 7, PAD_ID  # a single id, then padding
        t = torch.from_numpy(rows).to(dev)
        got = segment_rf.segment_distinct_counts(t)
        want = segment_rf.segment_distinct_counts_torch(t)
        torch.cuda.synchronize()
        max_abs_err = max(max_abs_err, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"segment_rf parity failed at (C, W) = ({c}, {w})")
        if c * w <= 1 << 16:
            check(np.array_equal(got.cpu().numpy(), segment_distinct_counts_ref(rows, PAD_ID)),
                  f"segment_rf differs from the numpy oracle at ({c}, {w})")
        log(f"parity segment_rf (C, W) = ({c}, {w}): exact")
        del t, got, want
    all_pad = torch.full((8, 5000), PAD_ID, dtype=torch.int32, device=dev)
    check(int(segment_rf.segment_distinct_counts(all_pad).abs().sum()) == 0, "all-PAD rows must count 0")
    phases["parity_s"] = time.perf_counter() - t0

    # ------------------------------------------------------------ main path
    rescaler = ElasticRescaler()
    packs, expected_launches = {}, 0
    oracle_counts = {}

    def oracle(k: int):
        if k not in oracle_counts:
            oracle_counts[k] = (
                metrics.replication_factor_ordered(src, dst, k, v),
                metrics.mirror_count_ordered(src, dst, k, v),
            )
        return oracle_counts[k]

    segment_rf.launches = 0
    t_main = time.perf_counter()
    for k in PACK_KS + (8,):
        t0 = time.perf_counter()
        packs[k] = E.cep_engine_data(g, order, k, device=dev)
        torch.cuda.synchronize()
        phases[f"pack_k{k}_s"] = time.perf_counter() - t0
        expected_launches += 1
    rescales = {}
    for name, base, k_new in (("16to17", 16, 17), ("8to12", 8, 12), ("12to8", "8to12", 8)):
        data = packs[base] if isinstance(base, int) else rescales[base][0]
        plan = rescaler.plan(data, k_new)
        new, stats = rescaler.rescale(data, k_new, verify=True)
        expected_launches += 1
        rescales[name] = (new, stats, plan)
        phases[f"rescale_{name}_s"] = stats.elapsed_s
        phases[f"recheck_{name}_s"] = stats.recheck_s
    t0 = time.perf_counter()
    d17, d4 = rescales["16to17"][0], packs[4]
    pr17, pr4 = E.pagerank(d17, iterations=20), E.pagerank(d4, iterations=20)
    torch.cuda.synchronize()
    phases["pagerank_x2_s"] = time.perf_counter() - t0
    source = int(torch.argmax(d4.degrees))
    t0 = time.perf_counter()
    (ss17, it_s17), (ss4, it_s4) = E.sssp(d17, source=source), E.sssp(d4, source=source)
    phases["sssp_x2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (wc17, it_w17), (wc4, it_w4) = E.wcc(d17), E.wcc(d4)
    phases["wcc_x2_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    phases["main_path_s"] = time.perf_counter() - t_main
    launches = segment_rf.launches

    # ----------------------------------------------------------- the checks
    for k in PACK_KS + (8,):
        rf, mir = oracle(k)
        check(packs[k].replication_factor == rf and packs[k].mirrors == mir,
              f"k={k}: RF/mirrors {packs[k].replication_factor}/{packs[k].mirrors} != oracle {rf}/{mir}")
        log(f"pack k={k}: RF {rf} mirrors {mir} (equal to the numpy oracle), {phases[f'pack_k{k}_s']:.3f} s")
    for name, (new, stats, plan) in rescales.items():
        rf, mir = oracle(new.k)
        check(stats.oracle_checked, f"rescale {name} was not byte-checked")
        check(stats.migrated_bytes == plan.migrated_bytes(EDGE_BYTES), f"rescale {name} moved other bytes than its plan")
        check(new.replication_factor == rf and new.mirrors == mir, f"rescale {name}: re-checked RF/mirrors differ from the oracle")
        log(f"rescale {name}: byte-equal to a fresh pack, migrated {stats.migrated_bytes} B in {stats.copy_ops} copies, "
            f"{stats.elapsed_s * 1e3:.3f} ms; re-checked RF {rf} (oracle) in {stats.recheck_s:.3f} s")
    back, orig = rescales["12to8"][0], packs[8]
    check(torch.equal(back.edges, orig.edges) and torch.equal(back.mask, orig.mask), "8→12→8 is not byte-identical")
    check(bool(torch.isfinite(pr17).all()) and abs(float(pr17.double().sum()) - 1.0) < 1e-3, "PageRank is not a distribution")
    pr_rel = float(((pr17 - pr4).abs() / pr4.abs()).max())
    check(pr_rel <= PAGERANK_RTOL, f"PageRank differs across k by rel {pr_rel}")
    check(torch.equal(ss17, ss4) and it_s17 == it_s4, "SSSP differs across k")
    check(torch.equal(wc17, wc4) and it_w17 == it_w4, "WCC differs across k")
    reached = int((ss4 < 1e9).sum())
    components = int(torch.unique(wc4[d4.degrees > 0]).numel())
    log(f"apps: PageRank k=17 vs k=4 max rel diff {pr_rel:.3e} (limit {PAGERANK_RTOL}); "
        f"SSSP from {source}: {it_s4} iterations, {reached} reached, equal; "
        f"WCC: {it_w4} iterations, {components} components, equal")
    check(launches == expected_launches, f"segment_rf launched {launches} times on the main path, expected {expected_launches}")
    log(f"segment_rf launches on the main path: {launches} (= {len(packs)} packs + {len(rescales)} re-checked rescales)")

    # Split of a pack's time: the host part alone (the rest is the copy to
    # the card, the row sort, the kernel and the degree count).
    t0 = time.perf_counter()
    E.host_pack(src, dst, 16)
    phases["host_pack_k16_s"] = time.perf_counter() - t0

    # ----------------------------------------------- kernel time vs bound
    rows16 = ops.packed_rows(packs[16].edges, packs[16].mask)
    c, w = rows16.shape
    check(torch.equal(segment_rf.segment_distinct_counts(rows16), segment_rf.segment_distinct_counts_torch(rows16)),
          "segment_rf parity failed on the real k=16 rows")
    ms = cuda_ms(lambda: segment_rf.segment_distinct_counts(rows16), 50)
    plain_ms = cuda_ms(lambda: segment_rf.segment_distinct_counts_torch(rows16), 20)
    bytes_ms = (c * w * 4 + c * 4) / H100_BYTES_PER_S * 1e3
    ops_ms = 3 * c * w / H100_FP32_OPS_PER_S * 1e3
    log(f"segment_rf at (C, W) = ({c}, {w}): {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms")
    phases = {k: round(x, 6) for k, x in phases.items()}
    log(json.dumps({"phases": phases, "graph": {"scale": args.scale, "edge_factor": args.edge_factor,
                                                "num_vertices": v, "num_edges": n}}))
    log(f"card: {card}")
    log(json.dumps({"kernels": [{
        "name": "segment_rf",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_rf.cu",
        "replaces": "src/repro/kernels/segment_rf.py:44",
        "launches": launches,
        "parity": "exact",
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": [c, w],
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
