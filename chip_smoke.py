#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA GPU and check every result.

    python3 chip_smoke.py                 # RMAT scale 20, edge factor 16
    python3 chip_smoke.py --scale 14      # a quicker rehearsal of the graph path
    python3 chip_smoke.py --cards 4       # on four cards: slice 1, path 5 (a), (c) and path 6 (c) only

Phases, in order; any failure raises and the script exits nonzero:

1. the card's name and power limit (``nvidia-smi``);
2. build the five CUDA kernels from ``src/repro_torch/kernels/csrc``
   (``segment_rf``, ``edge_spmv``, ``flash_attention``, ``decode_attention``,
   ``full_reorder``, the full rung's greedy),
   one ``nvcc`` per source, all started together; print each ``ptxas`` report;
   check with ``cuobjdump -sass`` that every bf16 (tensor-core) flash
   instantiation issues HGMMA;
3. RMAT graph and GEO order on the host;
4. kernel parity, each kernel against its plain PyTorch version on the card:
   ``segment_rf`` exactly, at the main path's row shapes and at edge cases
   (rows not a multiple of 8, widths not a multiple of the tile, all-PAD
   rows, single-id rows, W = 1, a row wider than 65535 tiles);
   ``edge_spmv`` at rtol/atol 1e-5 (atomics sum in a varying order) at the
   JAX tests' shapes, C = 1, W_E = 1, all-padding rows, ids past W_V, a hub
   row (one dst in every slot: one run across warps and blocks), alternating
   dst, sorted dst at an odd W_E, and more chunks than the grid has blocks,
   so that blocks stride over them;
   ``flash_attention`` at the JAX tests' cases in f32 (2e-5, the CUDA-core
   kernel) and bf16 (one bf16 rounding step: 2^-7·|plain| + 1e-4, the
   tensor-core kernel), non-causal, D = 256 with window and softcap, ragged
   S at D 128 and 256, and D = 96 (phi-3-vision's head_dim, zero-padded to
   128 by the wrapper) causal and windowed with softcap; ``decode_attention``
   at the JAX tests' cases, a ``cache_len = 0`` row, softcap, a bf16 cache and
   a bf16 cache at D = 96 (1e-4, f32 outputs), each case through both entry
   points: the per-tile partials and the merged path (split kernel, then
   combine kernel), the latter also at ``cache_len`` 0, 1 and either side of
   a split boundary, at Gq 1 and 8, and with a bf16 query;
5. slice 1, the graph path, with every launch count set to 0 just before it:
   CEP packs at k = 4, 8, 16, 64, 128 (RF and mirrors measured on the card,
   equal to the numpy oracle), rescale 16→17 and 8→12→8 with the
   from-scratch byte check, re-checked RF equal to the oracle, PageRank /
   SSSP / WCC on the packs at k = 17 and k = 4; ``segment_rf`` must launch
   once per pack and re-checked rescale, and no other kernel;
6. slice 2, the entry points of the other three kernels, with every launch
   count set to 0 just before it: ``ops.chunked_spmv`` on the GEO-ordered
   edge list with weights 1/deg[src] and the k = 4 PageRank vector as x —
   (a) 16 chunks with full windows, (b) 128 chunks with full windows,
   (c) 16 chunks with 65,536-wide windows (|V|/16) and an out-of-window pass — each
   held against a float64 numpy oracle at rtol 1e-4, with the chunks packed
   on the card (``ops.pack_windows_device``); ``ops.flash_attention``
   at qwen3-8b width (32 heads, 8 KV heads repeated, S 8192, D 128, bf16,
   causal) and at gemma2-9b local-layer width (16 heads, D 256, window 4096,
   softcap 50); ``ops.decode_attention`` at qwen3-8b width (batch 8:
   64 cache rows of 32,768 bf16 positions, Gq 4, D 128); each attention
   result held against the plain version on the card (flash one group of
   heads at a time, to bound its memory; SDPA's ratio to the same limit at
   qwen3-8b width is printed as a reading); ``edge_spmv`` must launch 3
   times, ``flash_attention`` 2, both on its tensor-core kernel
   (``tc_launches``), and ``decode_attention`` once: its split kernel
   (``launches``) and its combine kernel (``merge_launches``) once each;
   then, for each
   ``chunked_spmv`` call, the device packing must be byte-equal to the numpy
   ``pack_windows`` at full size, and the call is timed again, whole and in
   phases (H2D and range check, packing, x windows, kernel, add-back,
   out-of-window pass), with a synchronize after each phase;
7. path 3, the streaming engine at full width, with every launch count set
   to 0 just before it: the slice-1 graph and GEO order in an
   ``IncrementalOrderer`` of 16 regions, a ``StreamingEngine`` on the card
   with device span repair, 3 batches of 1,024 ``SyntheticStream`` updates
   with a monitor after each (span repairs forced by ``partial_drift`` 1.0,
   the full rung held off), a rescale 16→20 after batch 2 through the
   compact gather (cut from 9 batches and two rescales: path 6 (a) scales in
   at full width), the pack checked byte-equal to the
   host ``pack_slots`` oracle after the first batch, each span repair, each
   rescale and the last batch, and PageRank on the live pack held against
   PageRank on the oracle pack; per batch the host apply and device scatter
   times, per repair the device program and host mirror times, per rescale
   its parts and bytes. No kernel of the port launches there;
8. path 4, the rungs with their selection on the card, at RMAT scale 14
   (8 regions, objective k in [4, 32]), with every launch count set to 0
   just before it: an engine in ``differential`` span and full mode and one
   in ``device`` full mode with two batches in flight, one rebuild aborted by
   a rescale and one committed, each event checked against ``pack_slots``;
   ``segment_rf`` must launch exactly twice per selection on the card, and
   the greedy kernel (``full_reorder``) in both engines, each launch tapped
   and held against the host mirror (permutation and step count). Then,
   with the counts set to 0 again, the rungs' device programs alone against
   their host mirrors: the span order and selection on path 3's last span;
   the greedy kernel on path 4's slots (beside its plain version's step loop
   on the card) and on an RMAT-16 graph's slots;
9. path 5, the multi-rank main path on the slice-1 graph and GEO order (saved
   once under ``build/multirank/`` for the ranks to load): (a) g = 4 ranks as
   2 processes × 2 over gloo, every rank on the one card (NCCL refuses two
   ranks of one communicator on one device), started by the port's
   ``launch_local_cluster``: ``pack_ordered_sharded`` at k = 16 and 8,
   rescales 16→17, 8→12→8 with ``verify=True``, PageRank / SSSP / WCC on the
   k = 17 pack, ``snapshot_global``; (b) the same at 16→17 with one rank over
   NCCL. Each rank writes its rows and results under ``build/multirank/``;
   the parent holds the reassembled buffers byte-equal to slice 1's packs,
   RF and mirrors equal, PageRank within rtol 1e-4 of slice 1's and SSSP /
   WCC exactly, the edges across ranks and processes against the plan (and,
   at RMAT-20, against their predicted counts), the bytes each rank sent and
   received against the plan's cross-rank bytes, and requires every rank's
   ``segment_rf`` launches (5 in (a), 2 in (b)), each exact against the plain
   version on its rows. Each app runs twice in each rank and the second run is
   its time (the first also loads the ops' kernels in that process).
   ``--cards 4`` runs slice 1 and then only (a) and (c): g = 4 over NCCL, one
   card per rank;
10. path 6, the streaming engine over the same 4 gloo ranks on the one card
   (``--stream-rank-worker``, started by ``launch_local_cluster``), each rank
   an orderer replica and a ``StreamingEngine`` over the group, its pack
   checked bit-identical to ``pack_slots`` after every event: (a) the slice-1
   graph at full width over 16 regions, device span repairs of 2 regions (the
   span crosses ranks, gathered to every rank), the full rung held off; a
   batch of 1,024 updates, a rescale 16→12 (the slots that change rank sent
   rank to rank), ``from_restored`` on the ranks' orderers (its pack equal to
   the live one on every rank) and one more batch; (b)
   path 4's RMAT-14 graph and rung settings, ``differential`` span and full
   rungs, one rebuild committed and one aborted by a rescale 8→10, every
   ``segment_rf`` launch of every rank tapped and held exactly against the
   plain version, 2 a selection, and every greedy launch held against the
   host mirror; the greedy kernel must launch on every rank. Each rank prints its time and bytes for
   each event (host apply and scatter; span gather, program and mirror;
   rescale re-layout, exchange and compact; the restore commit) and its peak
   RSS; the parent holds the ranks' ladders, logs and rescale counts equal
   and the bytes sent and received to the cross-rank bytes, and launches
   nothing. ``--cards 4`` runs (c): (a) and (b) over NCCL, a card a rank;
11. each kernel's time (CUDA events) beside its bound, the plain version's
   time and, where one PyTorch call computes the same function, that call's
   time, at the paths' full-size shapes; ``segment_rf`` on the card alone
   (calls captured in a CUDA graph) and as a caller pays it (back-to-back
   wrapper calls), at every row shape the paths count. A bound counts the bytes the
   function must move from this run's inputs (for ``edge_spmv``: its three
   edge arrays, its output, and of x only the distinct entries each chunk
   gathers) and, for flash, the operations of the key positions the masks
   leave; ``edge_spmv`` also reports its share of that bound. Decode is timed
   as the merged call (both kernels) and as the partials entry point, beside
   SDPA in two forms (3-D with a float mask, 4-D with a boolean mask; the
   faster is the library time), with the bytes the split kernel reads and
   the rate it reaches.

Output: phase lines, a ``{"stream": ..., "rungs": ...}`` JSON line of the
stream paths' readings, a ``{"multirank": ...}`` line of path 5's, a
``{"streamrank": ...}`` line of path 6's, then the card line, one ``{"kernels": [...]}`` JSON line
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository's ``src/`` beside this file, it exits nonzero and
prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12  # HBM3 rate of an H100 SXM (NVIDIA data sheet)
H100_FP32_OPS_PER_S = 67e12  # non-tensor-core f32 rate; the kernel's int compares run on the same ALUs
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core rate
KERNELS = ("segment_rf", "edge_spmv", "flash_attention", "decode_attention", "full_reorder")
PACK_KS = (4, 16, 64, 128)
ROW_KS = (4, 8, 12, 16, 17, 64, 128)  # every k whose rows the main path counts
PAGERANK_RTOL = 1e-4  # CUDA scatter-add uses atomics: f32 sums in varying order
# f32 sums in varying order (atomics): against a float64 oracle, and kernel
# against plain version at full size, where a hub vertex sums thousands of terms
SPMV_RTOL = 1e-4
SPMV_PARITY_TOL = 1e-5  # kernel against plain version at the small parity shapes
F32_TOL, DECODE_TOL = 2e-5, 1e-4
# A bf16 flash output: the kernel and the plain version each round an f32 sum
# to bf16 (8 significant bits), so they may differ by one rounding step, at
# most 2^-7 of the value, plus slack for outputs near zero.
BF16_RTOL, BF16_ATOL = 2**-7, 1e-4
# Model widths: src/repro/configs/qwen3_8b.py and gemma2_9b.py.
QWEN3 = dict(heads=32, kv_heads=8, head_dim=128)
GEMMA2 = dict(heads=16, kv_heads=8, head_dim=256, window=4096, softcap=50.0)
PREFILL_SEQ = 8192
DECODE_BATCH, DECODE_CACHE, DECODE_BLOCK = 8, 32768, 512
FLASH_HEAD_GROUP = 8  # heads per call of the dense plain version (its logits: 8 x S^2 f32)
# Path 3, the stream at full width: the slice-1 graph over 16 regions (span
# repairs forced by partial_drift 1.0, the full rung held off by full_drift 99),
# batches of 1,024 updates, a rescale 16→20 after batch 2. 3 batches and one
# rescale, cut from 9 batches and rescales 16→20, 20→12 to make room for path
# 6, whose (a) scales in at full width over four ranks: a batch costs 13–22 s
# of host time at RMAT-20 (apply, span mirror, two oracle checks), a rescale
# about 88 s of host re-layout. 4 batches took the smoke past 900 s.
STREAM_REGIONS, STREAM_BATCH, STREAM_BATCHES = 16, 1024, 3
STREAM_RESCALES = {2: 20}
# Path 4, both rungs with selection on the card, at a reduced size: RMAT scale
# 14. The objective range is k in [4, 32]: at [4, 128] the greedy's int32
# priority bound is 2.78e9 on this graph and the engine would apply the host
# order instead of running the greedy (its int32 fallback).
RUNGS_SCALE, RUNGS_REGIONS, RUNGS_BATCH, RUNGS_K_MAX = 14, 8, 1024, 32
# The greedy kernel alone at RMAT-16 (edge factor 16, seed 0: 65,536 vertices,
# 909,538 edges), beside path 4's 16,384 vertices, for its time a step against
# |V|. k in [26, 32]: the widest range with k_max 32 whose int32 priority bound
# holds on this graph (greedy_fits_int32; max degree 9,699).
GREEDY_WIDE_SCALE, GREEDY_WIDE_K_MIN = 16, 26
# Path 5, the multi-rank main path on the slice-1 graph and GEO order: (a) g = 4
# ranks as 2 processes x 2 over gloo, every rank on the one card (NCCL refuses
# two ranks of one communicator on one device); (b) one rank over NCCL; with
# --cards 4, (a) and (c) g = 4 over NCCL, one card per rank.
MULTIRANK_PROCS, MULTIRANK_DEVS = 2, 2
MULTIRANK_STEPS = dict(packs=[16, 8], rescales=[["16to17", "k16", 17], ["8to12", "k8", 12], ["12to8", "8to12", 8]],
                       apps_on="16to17")
MULTIRANK_STEPS_ONE = dict(packs=[16], rescales=[["16to17", "k16", 17]], apps_on="16to17")
MULTIRANK_GROUP_TIMEOUT_S, MULTIRANK_TIMEOUT_S = 300.0, 900.0
# Path 6, the streaming engine over the same 4 ranks. Steps: "batch" is an
# ingest and a monitor, "force" the same with the full rung forced, an int a
# rescale, "restore" from_restored on the ranks' orderers. (a) the slice-1
# graph at full width, 16 regions, a span of 2 regions (so it crosses ranks),
# the full rung held off: a batch, 16→12, the restore and one more batch (cut
# from 3 batches before the restore: a batch costs 20–27 s a rank there, four
# ranks sharing the host, and 3 took the smoke past 900 s). (b) path 4's
# graph and rung settings, both rungs in differential mode: one rebuild
# committed and one aborted by a rescale 8→10.
STREAMRANK_A = dict(regions=16, batch=STREAM_BATCH, seed=0, span_repair="device", full_rebuild="host", flight=0,
                    config=dict(partial_drift=1.0, full_drift=99.0, span_regions=2),
                    steps=["batch", 12, "restore", "batch"])
STREAMRANK_B = dict(regions=RUNGS_REGIONS, batch=RUNGS_BATCH, seed=3, span_repair="differential",
                    full_rebuild="differential", flight=1,
                    config=dict(partial_drift=1.0, full_drift=99.0, span_regions=2, k_min=4, k_max=RUNGS_K_MAX),
                    steps=["batch", "force", "batch", "force", RUNGS_REGIONS + 2, "batch", "batch"])
STREAMRANK_TIMEOUT_S = 900.0
# (|E|, g, processes, k_old, k_new) -> (migrated, across ranks, across processes)
# edges, by the port's cep.scale_plan at RMAT-20's 15,701,711 edges.
MULTIRANK_PLAN_COUNTS = {
    (15_701_711, 4, 2, 16, 17): (7_850_856, 7_850_856, 4_156_336),
    (15_701_711, 4, 2, 8, 12): (13_738_998, 11_776_284, 7_850_856),
    (15_701_711, 4, 2, 12, 8): (13_738_998, 11_776_284, 7_850_856),
}


def decode_cache_lengths(rows: int) -> np.ndarray:
    """``cache_len`` of the full-size decode call: numpy seed 0 in [1, S],
    with one full row and one not a multiple of 512."""
    cache_np = np.random.default_rng(0).integers(1, DECODE_CACHE + 1, size=rows).astype(np.int32)
    cache_np[0], cache_np[1] = DECODE_CACHE, DECODE_CACHE // 2 + 123
    return cache_np


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


def close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float, what: str) -> float:
    """Assert |got - want| <= atol + rtol·|want| element by element; return
    the max abs difference."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")
    return err


def tol_ratio(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """max |got - want| / (atol + rtol·|want|): at most 1 where ``close`` passes."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def rel_close(got: torch.Tensor, want: torch.Tensor, rtol: float, what: str) -> float:
    """Assert |got - want| <= rtol·|want| element by element (exact zeros stay
    zero); return the max relative difference."""
    diff = (got.double() - want.double()).abs()
    bad = int((diff > rtol * want.double().abs()).sum())
    rel = float((diff / want.double().abs()).nan_to_num(0.0, posinf=np.inf).max())
    check(bad == 0, f"{what}: {bad} elements differ by more than rtol {rtol} (max rel {rel:.3e})")
    return rel


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


def graph_ms(fn, reps: int) -> float:
    """The card's time alone for one ``fn()``: ``reps`` calls captured in one
    CUDA graph (the wrappers launch on the current stream, the capture
    stream there), its replay timed with events. Host work is left out."""
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
    del graph
    return start.elapsed_time(end) / (3 * reps)


def greedy_tap(FRK, tapped: list):
    """A stand-in for ``FRK.greedy_keys`` that calls the kernel's wrapper
    unchanged and keeps device copies of its inputs, keys and step count
    (no host read during the run)."""
    kernel = FRK.greedy_keys

    def tap(u, v, valid, nv, alpha, beta, delta, permpos):
        keys, steps, work = kernel(u, v, valid, nv, alpha, beta, delta, permpos)
        tapped.append(dict(u=u.clone(), v=v.clone(), valid=valid.clone(), nv=nv, params=(alpha, beta, delta),
                           permpos=permpos.clone(), keys=keys.clone(), steps=steps.clone(), work=work.clone()))
        return keys, steps, work

    return kernel, tap


def greedy_against_mirror(FRK, rec: dict) -> dict:
    """One tapped greedy launch held against the host mirror on its inputs:
    the permutation its keys sort to and its step count."""
    u, v, valid, permpos = (rec[k].cpu().numpy() for k in ("u", "v", "valid", "permpos"))
    host, steps = FRK._full_order_host(u.astype(np.int64), v.astype(np.int64), valid, rec["nv"], *rec["params"],
                                       permpos.astype(np.int64))
    k = rec["keys"].cpu().numpy()
    perm = np.lexsort((np.arange(len(u)), k[3], k[2], k[1], k[0]))
    return dict(slots=int(len(u)), live=int(valid.sum()), steps=int(rec["steps"][0]), mirror_steps=int(steps),
                walked=int(rec["work"][0]), fallbacks=int(rec["work"][1]),
                exact=bool(np.array_equal(perm, host)) and int(rec["steps"][0]) == int(steps))


def synced_s(fn):
    """``fn()`` and its seconds on the host clock, with the card idle before
    and after: ``(result, seconds)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def prefill_inputs(gen: torch.Generator, dev) -> list:
    """bf16 q, k, v and the keywords of the two full-size prefill calls:
    qwen3-8b (causal) and gemma2-9b local layer (window, softcap). K and V
    are made at the model's KV heads and repeated to its query heads, as the
    JAX callers do before they call the kernel."""
    calls = []
    for cfg, kw in ((QWEN3, dict(causal=True)),
                    (GEMMA2, dict(causal=True, window=GEMMA2["window"], softcap=GEMMA2["softcap"]))):
        heads, kv_heads, hd = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
        qkv = [torch.randn((1, kv_heads if i else heads, PREFILL_SEQ, hd), generator=gen, device=dev,
                           dtype=torch.bfloat16) for i in range(3)]
        qkv[1:] = [t.repeat_interleave(heads // kv_heads, dim=1) for t in qkv[1:]]
        calls.append((qkv, kw))
    return calls


def flash_plain(plain, qkv: list, kw: dict) -> torch.Tensor:
    """The dense plain version ``plain`` over FLASH_HEAD_GROUP heads a call,
    to bound the memory of its logits."""
    return torch.cat([plain(*(t[:, h0:h0 + FLASH_HEAD_GROUP] for t in qkv), **kw)
                      for h0 in range(0, qkv[0].shape[1], FLASH_HEAD_GROUP)], dim=1)


def visible_pairs(s: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs that the masks leave visible in one head."""
    q = np.arange(s, dtype=np.int64)
    hi = q + 1 if causal else np.full(s, s)
    lo = np.maximum(q - window + 1, 0) if window is not None else np.zeros(s, dtype=np.int64)
    return int((hi - lo).sum())


def span_sums(tracer) -> dict:
    """Seconds by span name over the tracer's retained spans."""
    out: dict = {}
    for sp in tracer.spans():
        out[sp.name] = out.get(sp.name, 0.0) + sp.duration_s
    return out


def stream_path(g, src, dst, dev, phases: dict) -> dict:
    """Path 3: the streaming engine on the slice-1 graph and GEO order at full
    width. Every ingest, span repair and rescale runs on ``dev``; the pack is
    checked against the host ``pack_slots`` oracle after the first batch,
    each span repair, each rescale and the last batch. Returns readings."""
    from repro_torch.graphs import engine as E
    from repro_torch.obs.trace import Tracer
    from repro_torch.stream import IncrementalOrderer, StreamConfig, StreamingEngine, SyntheticStream

    v = g.num_vertices
    tracer = Tracer()
    t0 = time.perf_counter()
    orderer = IncrementalOrderer(src.astype(np.int64), dst.astype(np.int64), v, regions=STREAM_REGIONS,
                                 config=StreamConfig(partial_drift=1.0, full_drift=99.0, span_regions=1))
    phases["stream_orderer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = StreamingEngine(orderer, device=dev, span_repair="device", tracer=tracer)
    phases["stream_upload_s"] = time.perf_counter() - t0
    edges_b, mask_b = (t.numel() * t.element_size() for t in (eng.data.edges, eng.data.mask))
    log(f"stream: {STREAM_BATCHES} batches of {STREAM_BATCH} updates and one rescale, 16->20 after batch 2 (cut "
        f"from 9 batches and rescales 16->20, 20->12 for the run's time: a batch's host apply, span mirror and "
        f"oracle checks take 13-22 s at RMAT-20, a rescale's host re-layout about 88 s; path 6 (a) scales in at "
        f"full width over four ranks, and 4 batches took the smoke past 900 s; the graph is not cut)")
    log(f"stream: {orderer.num_edges} edges in {orderer.capacity} slots over {orderer.regions} regions, "
        f"edges {edges_b} B and mask {mask_b} B on {dev}; orderer {phases['stream_orderer_s']:.3f} s, "
        f"pack_slots + upload {phases['stream_upload_s']:.3f} s")
    t0 = time.perf_counter()
    stream = SyntheticStream(g, batch_size=STREAM_BATCH, seed=0)
    phases["stream_generator_s"] = time.perf_counter() - t0
    checks: list = []

    def verify(what: str) -> None:
        t = time.perf_counter()
        eng.verify_bit_identity()
        checks.append(what)
        log(f"stream: bit-identical to pack_slots after {what} ({time.perf_counter() - t:.3f} s to check)")

    rows, repairs, rescales = [], [], []
    for b in range(1, STREAM_BATCHES + 1):
        tracer.clear()
        st = eng.ingest(stream.batch())
        rung = eng.monitor()
        sp = span_sums(tracer)
        row = dict(batch=b, inserted=st.inserted, deleted=st.deleted, scatter_ops=st.scatter_ops,
                   apply_ms=sp["ingest.apply"] * 1e3, device_ms=sp["ingest.device"] * 1e3, rung=rung,
                   repair=eng.last_repair, drift=orderer.drift())
        if rung == "partial" and eng.last_repair == "device":
            row.update(span_device_ms=sp["rung.span_device"] * 1e3, span_mirror_ms=sp["rung.span_mirror"] * 1e3)
            repairs.append(row)
        rows.append(row)
        log(f"stream batch {b}: +{st.inserted} -{st.deleted} ({st.scatter_ops} slot ops): host apply "
            f"{row['apply_ms']:.3f} ms, device scatter {row['device_ms']:.3f} ms; monitor: {rung} "
            f"({eng.last_repair or '-'}), drift {row['drift']:.6f}"
            + (f"; span rung: device {row['span_device_ms']:.3f} ms, host mirror {row['span_mirror_ms']:.3f} ms"
               if "span_device_ms" in row else ""))
        if b == 1:
            verify("the first batch")
        if "span_device_ms" in row:
            verify(f"span repair at batch {b}")
        if b in STREAM_RESCALES:
            tracer.clear()
            rs = eng.rescale(STREAM_RESCALES[b])
            sp = span_sums(tracer)
            slots_new = eng.data.edges.shape[0] * eng.data.edges.shape[1]
            # The compact moves, on the card: the gather map up (two int32
            # indices and an f32 mask a slot), the old edges read at the
            # gathered slots, the new edges and mask written.
            compact_bytes = slots_new * (4 + 4 + 4) + slots_new * 8 * 2 + slots_new * 4
            rescales.append(dict(k_old=rs.k_old, k_new=rs.k_new, ms=rs.elapsed_s * 1e3,
                                 relayout_ms=sp["rescale.relayout"] * 1e3, compact_ms=sp["rescale.compact"] * 1e3,
                                 moved_edges=rs.moved_edges, moved_bytes=rs.moved_edges * 8,
                                 cep_plan_edges=rs.cep_plan_edges, compact_bytes=compact_bytes))
            r = rescales[-1]
            log(f"stream rescale {rs.k_old}->{rs.k_new}: {r['ms']:.3f} ms (host relayout {r['relayout_ms']:.3f} ms, "
                f"gather-map upload + compact on the card {r['compact_ms']:.3f} ms); moved {rs.moved_edges} edges "
                f"({r['moved_bytes']} B; the CEP plan would move {rs.cep_plan_edges}), compact moves {compact_bytes} B")
            verify(f"rescale {rs.k_old}->{rs.k_new}")
    verify("the last batch")
    check(len(repairs) >= 3, f"stream: {len(repairs)} span repairs ran on the card, expected at least 3")
    check(eng.k == STREAM_RESCALES[max(STREAM_RESCALES)], "stream: the last rescale did not land")
    pr_live = E.pagerank(eng.data, iterations=20)
    pr_oracle = E.pagerank(eng.oracle_pack(), iterations=20)
    check(bool(torch.isfinite(pr_live).all()), "stream: PageRank on the live pack is not finite")
    pr_rel = float(((pr_live - pr_oracle).abs() / pr_oracle.abs()).max())
    check(pr_rel <= PAGERANK_RTOL, f"stream: PageRank on the live pack differs from the oracle pack's by rel {pr_rel}")
    log(f"stream: PageRank on the live pack vs the uploaded pack_slots oracle: max rel diff {pr_rel:.3e} "
        f"(limit {PAGERANK_RTOL}); {len(checks)} bit-identity checks passed")
    r0, r1 = orderer.span_bounds()
    return dict(batches=rows, span_repairs=repairs, rescales=rescales, checks=checks, pagerank_rel=pr_rel,
                edges=orderer.num_edges, slots=orderer.capacity, span=(*orderer.span_arrays(r0, r1), v))


def rungs_graph():
    """Path 4's graph (RMAT scale 14) and its GEO order over the objective's
    k range: ``(graph, ordered src, ordered dst)``."""
    from repro_torch.core import ordering
    from repro_torch.core.graph import rmat_graph

    g = rmat_graph(scale=RUNGS_SCALE, edge_factor=16, seed=0)
    order = ordering.geo_order(g, k_min=4, k_max=RUNGS_K_MAX)
    return g, g.src[order].astype(np.int64), g.dst[order].astype(np.int64)


def rungs_path(dev, phases: dict, segment_rf) -> dict:
    """Path 4: both rungs with their selection on ``dev``, at RMAT scale 14.
    Engine A repairs spans and rebuilds in ``differential`` mode (both
    objectives on the card through ``segment_rf``); engine B rebuilds in
    ``device`` mode with two batches in flight, one rebuild aborted by a
    rescale and one committed. Every event is checked against ``pack_slots``.
    Every ``segment_rf`` launch of the path is tapped: its rows and counts are
    kept and, once the launches are read, held exactly against the plain
    version on those rows. Every launch of the greedy kernel is tapped too and
    held against the host mirror on its inputs (permutation and step count);
    engine A (its selection) and engine B (its device rebuilds) must each
    launch it. Returns readings, with ``segment_rf``'s launches, selections
    and the tapped launches' row shapes, and the greedy's launches."""
    from repro_torch.kernels import full_reorder as FRK
    from repro_torch.kernels import span_reorder as SRK
    from repro_torch.obs.trace import Tracer
    from repro_torch.stream import IncrementalOrderer, StreamConfig, StreamingEngine, SyntheticStream

    # Both rungs' objectives call span_reorder's segment_distinct_counts; the
    # tap calls the kernel's wrapper unchanged and keeps what it was given.
    kernel, tapped = SRK.segment_distinct_counts, []

    def tap(rows):
        counts = kernel(rows)
        tapped.append((rows.clone(), counts.clone()))
        return counts

    SRK.segment_distinct_counts = tap
    greedy_tapped: list = []
    greedy_kernel, FRK.greedy_keys = greedy_tap(FRK, greedy_tapped)

    t0 = time.perf_counter()
    g, src, dst = rungs_graph()
    phases["rungs_graph_s"] = time.perf_counter() - t0
    log(f"rungs: RMAT scale {RUNGS_SCALE}, |V|={g.num_vertices} |E|={g.num_edges}, {RUNGS_REGIONS} regions, "
        f"objective k in [4, {RUNGS_K_MAX}] (cut from the stream path's RMAT-20: the greedy runs |V_selected| "
        f"sequential steps and 'differential' needs host geo_order candidates)")
    cfg = dict(partial_drift=1.0, full_drift=99.0, span_regions=2, k_min=4, k_max=RUNGS_K_MAX)
    events: list = []
    selections = 0

    def forced_monitor(eng) -> str:
        eng.orderer.drift = lambda: 200.0  # over full_drift: the full rung fires
        rung = eng.monitor()
        del eng.orderer.drift
        return rung

    def record(eng, what: str) -> None:
        eng.verify_bit_identity()
        events.append(what)

    # Engine A: differential span and full rungs, one batch in flight.
    tracer = Tracer()
    o = IncrementalOrderer(src, dst, g.num_vertices, regions=RUNGS_REGIONS, config=StreamConfig(**cfg))
    eng = StreamingEngine(o, device=dev, span_repair="differential", full_rebuild="differential",
                          rebuild_flight=1, tracer=tracer)
    stream = SyntheticStream(g, batch_size=RUNGS_BATCH, seed=1)
    for b in range(1, 6):
        eng.ingest(stream.batch())
        record(eng, f"A batch {b}")
        rung = forced_monitor(eng) if b == 2 else eng.monitor()
        if eng.last_repair == "differential" and rung == "partial":
            selections += 1  # a span selection: both objectives on the card
        record(eng, f"A monitor {b} ({rung}, {eng.rebuild_state or eng.last_repair})")
    log_a = eng.drain_rebuild_events()
    check([(r["mode"], r["committed"]) for r in log_a] == [("differential", True)],
          f"rungs: engine A's rebuild log {log_a}")
    selections += 1  # the full selection of its rebuild
    sp = span_sums(tracer)
    a_read = dict(rebuild=log_a[0], span_mirror_s=sp.get("rung.span_mirror", 0.0),
                  span_device_s=sp.get("rung.span_device", 0.0), rung_counts=dict(eng.rung_counts))
    greedy_a = len(greedy_tapped)
    del eng, o

    # Engine B: device greedy, two batches in flight; a rescale aborts the
    # first flight, the second commits.
    o = IncrementalOrderer(src, dst, g.num_vertices, regions=RUNGS_REGIONS, config=StreamConfig(**cfg))
    eng = StreamingEngine(o, device=dev, full_rebuild="device", rebuild_flight=2)
    stream = SyntheticStream(g, batch_size=RUNGS_BATCH, seed=2)
    for b in range(1, 9):
        if b == 4:
            rs = eng.rescale(RUNGS_REGIONS + 2)
            record(eng, f"B rescale {rs.k_old}->{rs.k_new} (aborts the flight)")
        eng.ingest(stream.batch())
        record(eng, f"B batch {b}")
        rung = forced_monitor(eng) if b in (2, 5) else eng.monitor()
        record(eng, f"B monitor {b} ({rung}, {eng.rebuild_state or eng.last_repair})")
    log_b = eng.drain_rebuild_events()
    check([(r["aborted"], r["committed"]) for r in log_b] == [(True, False), (False, True)],
          f"rungs: engine B's rebuild log {log_b}")
    check(log_b[1]["flight_batches"] == 2 and log_b[1]["splice_ops"] > 0,
          "rungs: the committed device flight must splice the batches ingested during it")
    for r in log_a + log_b:
        log(f"rungs rebuild: mode {r['mode']}, committed {r['committed']}, aborted {r['aborted']}, "
            f"{r['flight_batches']} batches in flight, {r['splice_ops']} slot ops spliced, "
            f"dispatch {r['dispatch_s'] * 1e3:.3f} ms (host: mirror + enqueue), commit {r['commit_s'] * 1e3:.3f} ms")
    SRK.segment_distinct_counts = kernel
    FRK.greedy_keys = greedy_kernel
    launches = segment_rf.launches
    check(selections > 0 and launches == 2 * selections == len(tapped),
          f"rungs: segment_rf launched {launches} times ({len(tapped)} tapped) for {selections} device "
          f"selections, expected 2 each")
    greedy_b = len(greedy_tapped) - greedy_a
    check(FRK.launches == len(greedy_tapped) and greedy_a > 0 and greedy_b > 0,
          f"rungs: the greedy kernel launched {FRK.launches} times ({greedy_a} tapped in engine A, {greedy_b} in "
          f"engine B); each engine must launch it")
    greedy = [greedy_against_mirror(FRK, rec) for rec in greedy_tapped]
    check(all(t["exact"] for t in greedy), f"rungs: a greedy launch differs from the host mirror: {greedy}")
    log(f"rungs: the greedy kernel launched {len(greedy)} times ({greedy_a} in engine A, {greedy_b} in engine B), "
        f"each equal to the host mirror in permutation and steps {[t['steps'] for t in greedy]}")
    log(f"rungs: {len(events)} bit-identity checks passed; {selections} device selections, segment_rf "
        f"launched {launches} times (2 each)")
    # The path's own launches against the plain version on the same rows.
    max_err = 0
    for i, (rows, counts) in enumerate(tapped):
        want = segment_rf.segment_distinct_counts_torch(rows)
        max_err = max(max_err, int((counts - want).abs().max()))
        check(torch.equal(counts, want), f"rungs: segment_rf launch {i} at {tuple(rows.shape)} differs from the "
                                         f"plain version")
    shapes = [list(rows.shape) for rows, _ in tapped]
    log(f"rungs: all {len(tapped)} segment_rf launches equal the plain version on their rows {shapes}")
    widest = max((rows for rows, _ in tapped), key=lambda r: r.numel())
    return dict(a=a_read, rebuilds=log_a + log_b, checks=len(events), selections=selections, launches=launches,
                greedy=greedy, greedy_by_engine=dict(a=greedy_a, b=greedy_b),
                segment_rf=dict(shapes=shapes, max_abs_err=max_err, widest=widest),
                slots=(o.slot_src.copy(), o.slot_dst.copy(), o.slot_valid.copy(), g.num_vertices),
                graph=(g, src, dst))


def rows_timing(rows, segment_rf) -> dict:
    """``segment_rf``'s time on one (C, W) array of sorted key rows: on the
    card alone (``ms``: wrapper calls captured in a CUDA graph) and as a
    caller pays it (``wrapper_ms``: back-to-back calls between two events,
    host work included); its plain version's time and its byte bound."""
    c, w = rows.shape
    return dict(shape=[c, w], ms=graph_ms(lambda: segment_rf.segment_distinct_counts(rows), 50),
                wrapper_ms=cuda_ms(lambda: segment_rf.segment_distinct_counts(rows), 50),
                plain_ms=cuda_ms(lambda: segment_rf.segment_distinct_counts_torch(rows), 5),
                bound_ms=(c * w * 4 + c * 4) / H100_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None)


def twin_times(dev, stream_span, rungs_slots, segment_rf) -> dict:
    """The rungs' device programs alone, each held exactly against its host
    mirror on the same slots: the span order and the span selection on path
    3's last worst span (full width); the greedy kernel on path 4's final
    slots, beside its plain version's step loop on the card, and on an
    RMAT-16 graph's slots (``greedy_times``). Times: the card's (CUDA events)
    and the host's enqueue; the mirror's on the host clock."""
    from repro_torch.core.graph import rmat_graph
    from repro_torch.kernels import full_reorder as FRK
    from repro_torch.kernels import span_reorder as SRK

    out = {}
    u, v, valid, nv = stream_span
    ut, vt = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (u, v))
    vd = torch.from_numpy(valid).to(dev)
    ks = SRK.eval_ks(4, 128)
    cand = SRK.identity_candidate(valid)
    ct = torch.from_numpy(cand).to(dev)

    def timed(fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = fn()
        end.record()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        return res, start.elapsed_time(end), enqueue * 1e3

    t0 = time.perf_counter()
    host_sel, _ = SRK.select_span_order_host(u, v, valid, nv, cand, ks)
    mirror_ms = (time.perf_counter() - t0) * 1e3
    got, order_ms, order_enq = timed(lambda: SRK.span_order_device(ut, vt, vd, nv))
    check(np.array_equal(got.cpu().numpy(), SRK.span_order_host(u, v, valid, nv)),
          "span_order_device differs from its host mirror at full width")
    before = segment_rf.launches
    got, sel_ms, sel_enq = timed(lambda: SRK.select_span_order_device(ut, vt, vd, nv, ct, ks, use_pallas=True))
    check(np.array_equal(got.cpu().numpy(), host_sel), "select_span_order_device differs from its host mirror")
    check(segment_rf.launches == before + 2, "the span selection must launch segment_rf twice")
    # segment_rf at the selection's row shape: the sorted (chunk, rank) keys.
    keys = torch.sort(SRK._chunk_keys_device(ut, vt, vd, ct, vd.sum(), ks), dim=-1).values.contiguous()
    check(torch.equal(segment_rf.segment_distinct_counts(keys), segment_rf.segment_distinct_counts_torch(keys)),
          "segment_rf parity failed on the span selection's key rows")
    out["segment_rf_rows"] = rows_timing(keys, segment_rf)
    out["span"] = dict(slots=int(u.shape[0]), live=int(valid.sum()), order_ms=order_ms, order_enqueue_ms=order_enq,
                       select_ms=sel_ms, select_enqueue_ms=sel_enq, select_mirror_ms=mirror_ms)
    log(f"span twin at path 3's span ({u.shape[0]} slots, {int(valid.sum())} live): order {order_ms:.3f} ms on "
        f"the card ({order_enq:.3f} ms to enqueue); selection with both objectives {sel_ms:.3f} ms "
        f"({sel_enq:.3f} ms to enqueue) against {mirror_ms:.3f} ms for the host mirror; equal to the mirror")
    del ut, vt, vd, ct

    u, v, valid, nv = rungs_slots
    out["greedy"] = greedy_times(FRK, dev, u, v, valid, nv, 4, RUNGS_K_MAX, "path 4's slots", plain=True)
    g = rmat_graph(scale=GREEDY_WIDE_SCALE, edge_factor=16, seed=0)
    out["greedy_wide"] = greedy_times(FRK, dev, g.src.astype(np.int64), g.dst.astype(np.int64),
                                      np.ones(g.num_edges, bool), g.num_vertices, GREEDY_WIDE_K_MIN, RUNGS_K_MAX,
                                      f"RMAT-{GREEDY_WIDE_SCALE}", plain=False)
    return out


def greedy_times(FRK, dev, u, v, valid, nv: int, k_min: int, k_max: int, what: str, plain: bool) -> dict:
    """The greedy kernel alone on one slot array, held against the host
    mirror (permutation and step count): its card time (CUDA events around
    ``greedy_keys``: the incidence list's torch ops and the one launch) and
    enqueue time, the whole ``full_order_device`` (with the 5-key sort) and,
    with ``plain``, the plain version's step loop on the card, run for the
    mirror's step count. The bound counts the bytes the run needs: each
    step's argmin reads 10 B a vertex, each incidence entry walked 13 B
    (inc, u, v, done), and 16 B of keys a live slot."""
    n = int(valid.sum())
    deg = np.bincount(np.concatenate([u[valid], v[valid]]), minlength=1)
    alpha, beta, delta = FRK.greedy_params(n, k_min, k_max, int(deg.max()))
    permpos = FRK.fallback_positions(nv)
    t0 = time.perf_counter()
    host_perm, steps = FRK._full_order_host(u, v, valid, nv, alpha, beta, delta, permpos)
    mirror_ms = (time.perf_counter() - t0) * 1e3
    ut, vt = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (u, v))
    vd = torch.from_numpy(valid).to(dev)
    pt = torch.from_numpy(permpos.astype(np.int32)).to(dev)

    def timed(fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = fn()
        end.record()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        return res, start.elapsed_time(end), enqueue * 1e3

    timed(lambda: FRK.greedy_keys(ut, vt, vd, nv, alpha, beta, delta, pt))  # warm-up
    (keys, k_steps, work), ms, enqueue_ms = timed(lambda: FRK.greedy_keys(ut, vt, vd, nv, alpha, beta, delta, pt))
    got, order_ms, order_enqueue_ms = timed(
        lambda: FRK.full_order_device(ut, vt, vd, nv, alpha, beta, delta, pt, steps=steps))
    check(np.array_equal(got.cpu().numpy(), host_perm) and int(k_steps[0]) == steps,
          f"the greedy kernel differs from its host mirror at {what} (steps {int(k_steps[0])}, mirror {steps})")
    walked, fallbacks = (int(x) for x in work.cpu())
    bytes_ = steps * 10 * nv + walked * 13 + 16 * n
    bytes_ms = bytes_ / H100_BYTES_PER_S * 1e3
    ops_ms = 4 * steps * nv / H100_FP32_OPS_PER_S * 1e3  # the argmin's test, priority, pack and min a vertex
    r = dict(slots=int(u.shape[0]), live=n, vertices=nv, k=[k_min, k_max], steps=steps, ms=ms,
             us_per_step=ms / steps * 1e3, enqueue_ms=enqueue_ms, order_ms=order_ms, order_enqueue_ms=order_enqueue_ms,
             mirror_ms=mirror_ms, walked=walked, fallbacks=fallbacks, bytes=bytes_,
             bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    if plain:
        got, r["plain_ms"], r["plain_enqueue_ms"] = timed(
            lambda: FRK.full_order_device_torch(ut, vt, vd, nv, alpha, beta, delta, pt, steps=steps))
        check(np.array_equal(got.cpu().numpy(), host_perm), f"the plain greedy differs from its mirror at {what}")
    log(f"greedy kernel at {what} ({r['slots']} slots, {n} live, {nv} vertices, {steps} steps): {ms:.3f} ms on the "
        f"card ({r['us_per_step']:.2f} us a step), {enqueue_ms:.3f} ms to enqueue; full_order_device {order_ms:.3f} "
        f"ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {bytes_} B, {walked} incidence entries walked); host "
        f"mirror {mirror_ms:.3f} ms"
        + (f"; the plain step loop on the card {r['plain_ms']:.3f} ms ({r['plain_enqueue_ms']:.3f} ms to enqueue)"
           if plain else "") + "; equal to the mirror")
    return r


def multirank_worker(run_dir: pathlib.Path) -> int:
    """One rank of path 5 (``--rank-worker``, started by ``multirank_path``
    through ``launch_local_cluster``): the sharded packs, the verified
    rescales and the apps of the run's ``config.json`` on the rank's device,
    every ``segment_rf`` launch tapped and held exactly against the plain
    version on its rows afterwards. Writes ``rank{r}.npz`` (its rows and the
    apps' vectors) and ``rank{r}.json`` (readings)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.elastic.rescale_exec import ElasticRescaler
    from repro_torch.graphs import engine as E
    from repro_torch.kernels import segment_rf
    from repro_torch.launch import multihost as MH
    from repro_torch.obs import metrics as OM

    cfg = json.loads((run_dir / "config.json").read_text())
    group = MH.initialize_from_env(timeout_s=cfg["timeout_s"])
    r, dev = group.rank, group.torch_device
    inputs = np.load(run_dir.parent / "ordered.npz")
    src, dst, v = inputs["src"], inputs["dst"], cfg["num_vertices"]
    kernel, tapped = segment_rf.segment_distinct_counts, []

    def tap(rows):
        counts = kernel(rows)
        tapped.append((rows.clone(), counts.clone()))
        return counts

    segment_rf.segment_distinct_counts = tap  # ops looks it up at each call

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t0

    reg = OM.MetricsRegistry()
    rx = ElasticRescaler(metrics_registry=reg)
    arrays, meta = {}, dict(rank=r, device=str(dev), backend=group.backend, processes=list(group.processes))

    def keep(name, d):
        arrays[f"{name}_edges"], arrays[f"{name}_mask"] = d.edges.cpu().numpy(), d.mask.cpu().numpy()
        meta[name] = dict(k=d.k, mirrors=d.mirrors, rf=d.replication_factor, rows=list(d.edges.shape))

    datas = {}
    for k in cfg["packs"]:
        datas[f"k{k}"], meta[f"k{k}_pack_s"] = timed(lambda: E.pack_ordered_sharded(src, dst, v, k, group))
        keep(f"k{k}", datas[f"k{k}"])
    for name, base, k_new in cfg["rescales"]:
        sent0, recv0 = (reg.counter(f"rescale.{c}_bytes").value for c in ("sent", "received"))
        datas[name], st = rx.rescale(datas[base], k_new, verify=True)
        keep(name, datas[name])
        meta[name].update(stats=dataclasses.asdict(st), sent=reg.counter("rescale.sent_bytes").value - sent0,
                          received=reg.counter("rescale.received_bytes").value - recv0)
        print(f"rank {r}: rescale {name} in {st.elapsed_s * 1e3:.3f} ms, sent {meta[name]['sent']:.0f} B, "
              f"received {meta[name]['received']:.0f} B", flush=True)
    d = datas[cfg["apps_on"]]
    apps = dict(pagerank=lambda: E.pagerank(d, iterations=20), sssp=lambda: E.sssp(d, source=cfg["source"]),
                wcc=lambda: E.wcc(d))
    for app, fn in apps.items():  # twice: the first run in this process also loads the ops' kernels
        _, meta[f"{app}_first_s"] = timed(fn)
        meta[f"{app}_result"], meta[f"{app}_s"] = timed(fn)
    pr = meta.pop("pagerank_result")
    ss, meta["sssp_iterations"] = meta.pop("sssp_result")
    wc, meta["wcc_iterations"] = meta.pop("wcc_result")
    arrays.update(pagerank=pr.cpu().numpy(), sssp=ss.cpu().numpy(), wcc=wc.cpu().numpy())
    meta["snapshot_global"] = {k: np.atleast_1d(x).tolist() for k, x in reg.snapshot_global(group).items()}
    segment_rf.segment_distinct_counts = kernel
    meta["segment_rf_launches"] = segment_rf.launches
    meta["segment_rf_tapped"] = [
        dict(shape=list(rows.shape), exact=bool(torch.equal(counts, segment_rf.segment_distinct_counts_torch(rows))))
        for rows, counts in tapped]
    dist.destroy_process_group()
    np.savez(run_dir / f"rank{r}.npz", **arrays)
    (run_dir / f"rank{r}.json").write_text(json.dumps(meta))
    print(f"rank {r}: apps {meta['pagerank_s']:.3f} / {meta['sssp_s']:.3f} / {meta['wcc_s']:.3f} s (second runs), "
          f"segment_rf launched {meta['segment_rf_launches']} times", flush=True)
    return 0


def multirank_path(tag: str, backend: str, n_procs: int, devs_per_proc: int, devices: list, steps: dict,
                   src: np.ndarray, dst: np.ndarray, v: int, source: int, want: dict) -> dict:
    """Path 5: the main path over g = n_procs · devs_per_proc ranks started
    by the port's ``launch_local_cluster``, each on its entry of ``devices``
    over ``backend``. ``steps`` names the packs, the rescales (name, base,
    k_new) and the pack the apps run on. The parent reassembles every rank's
    rows and holds them byte-equal to slice 1's pack at each k (``want``:
    the buffers, RF and mirrors by k, and slice 1's app results), PageRank
    within ``PAGERANK_RTOL`` of slice 1's and SSSP / WCC exactly, the
    cross-rank and cross-process edges against the plan, each rank's bytes
    sent and received against the plan's cross-rank bytes, and every rank's
    ``segment_rf`` launches exact against the plain version. Returns readings."""
    from repro_torch.core import cep
    from repro_torch.launch import multihost as MH
    from repro_torch.launch import sharding as SH

    g = n_procs * devs_per_proc
    run_dir = ROOT / "build" / "multirank" / tag
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    (run_dir / "config.json").write_text(json.dumps(dict(steps, num_vertices=v, source=source,
                                                         timeout_s=MULTIRANK_GROUP_TIMEOUT_S)))
    t0 = time.perf_counter()
    res = MH.spawn_local_cluster(n_procs, devs_per_proc, [str(ROOT / "chip_smoke.py"), "--rank-worker", str(run_dir)],
                                 backend=backend, devices=devices, timeout=MULTIRANK_TIMEOUT_S,
                                 env_extra={"PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    for p in res.procs:
        for line in p.stdout.splitlines():
            log(f"path 5 ({tag}) {line}")
    check(res.ok, f"path 5 ({tag}): a rank failed\n{res.format_logs()}")
    ranks = [(dict(np.load(run_dir / f"rank{r}.npz")), json.loads((run_dir / f"rank{r}.json").read_text()))
             for r in range(g)]
    names = [f"k{k}" for k in steps["packs"]] + [name for name, _, _ in steps["rescales"]]
    for name in names:
        k = ranks[0][1][name]["k"]
        rows = [SH.partition_row(p, k, g) for p in range(k)]
        pad = np.setdiff1d(np.arange(SH.padded_partition_count(k, g)), rows)
        for part in ("edges", "mask"):
            whole = np.concatenate([a[f"{name}_{part}"] for a, _ in ranks])
            ref = getattr(want["packs"][k], part)
            check(whole[rows].tobytes() == ref.cpu().numpy().tobytes() and not whole[pad].any(),
                  f"path 5 ({tag}): {name}'s {part}, reassembled, differ from slice 1's pack at k={k}")
        check(all((m[name]["rf"], m[name]["mirrors"]) == want["quality"][k] for _, m in ranks),
              f"path 5 ({tag}): {name}'s RF/mirrors differ from slice 1's")
    plans = {}
    for name, _, k_new in steps["rescales"]:
        st = ranks[0][1][name]["stats"]
        plan = plans[name] = cep.scale_plan(len(src), st["k_old"], k_new)
        cross = sum(hi - lo for lo, hi, s, d in plan.moves if s % g != d % g)
        xproc = sum(hi - lo for lo, hi, s, d in plan.moves if (s % g) // devs_per_proc != (d % g) // devs_per_proc)
        check(all(m[name]["stats"] == {**st, "elapsed_s": m[name]["stats"]["elapsed_s"],
                                       "recheck_s": m[name]["stats"]["recheck_s"]} for _, m in ranks),
              f"path 5 ({tag}): the ranks' stats of {name} differ")
        check(st["oracle_checked"] and (st["devices"], st["processes"]) == (g, n_procs),
              f"path 5 ({tag}): {name} was not verified, or ran over another group")
        check((st["cross_device_edges"], st["cross_process_edges"]) == (cross, xproc),
              f"path 5 ({tag}): {name} counts {st['cross_device_edges']} / {st['cross_process_edges']} edges "
              f"across ranks / processes, the plan {cross} / {xproc}")
        expected = MULTIRANK_PLAN_COUNTS.get((len(src), g, n_procs, st["k_old"], k_new))
        check(expected is None or (plan.migrated_edges, cross, xproc) == expected,
              f"path 5 ({tag}): {name} moves {(plan.migrated_edges, cross, xproc)}, predicted {expected}")
        sent = sum(m[name]["sent"] for _, m in ranks)
        received = sum(m[name]["received"] for _, m in ranks)
        check(sent == received == st["cross_device_bytes"],
              f"path 5 ({tag}): {name} sent {sent} B and received {received} B, the plan crosses ranks with "
              f"{st['cross_device_bytes']} B")
    for i, (arrays, meta) in enumerate(ranks):
        rel = rel_close(torch.from_numpy(arrays["pagerank"]), want["pagerank"].cpu(), PAGERANK_RTOL,
                        f"path 5 ({tag}) rank {i}: PageRank against slice 1's")
        check(np.array_equal(arrays["sssp"], want["sssp"].cpu().numpy()) and meta["sssp_iterations"] == want["sssp_it"],
              f"path 5 ({tag}) rank {i}: SSSP differs from slice 1's")
        check(np.array_equal(arrays["wcc"], want["wcc"].cpu().numpy()) and meta["wcc_iterations"] == want["wcc_it"],
              f"path 5 ({tag}) rank {i}: WCC differs from slice 1's")
        meta["pagerank_rel"] = rel
        launches = meta["segment_rf_launches"]
        check(launches == len(names) == len(meta["segment_rf_tapped"]) and all(t["exact"] for t in
                                                                                meta["segment_rf_tapped"]),
              f"path 5 ({tag}) rank {i}: segment_rf launched {launches} times for {len(names)} packs and "
              f"re-checks, exact {[t['exact'] for t in meta['segment_rf_tapped']]}")
        check(meta["snapshot_global"] == ranks[0][1]["snapshot_global"], f"path 5 ({tag}): global snapshots differ")
    glob = ranks[0][1]["snapshot_global"]
    total_cross = sum(ranks[0][1][name]["stats"]["cross_device_bytes"] for name, _, _ in steps["rescales"])
    check(glob["rescale.sent_bytes"] == glob["rescale.received_bytes"] == [total_cross],
          f"path 5 ({tag}): snapshot_global's sent/received bytes {glob['rescale.sent_bytes']} / "
          f"{glob['rescale.received_bytes']}, expected {total_cross}")
    out = dict(ranks=g, processes=n_procs, backend=backend, devices=devices, wall_s=wall, rescales={}, apps={},
               segment_rf_launches=[m["segment_rf_launches"] for _, m in ranks],
               segment_rf_shapes=[[t["shape"] for t in m["segment_rf_tapped"]] for _, m in ranks])
    for name, _, _ in steps["rescales"]:
        st = ranks[0][1][name]["stats"]
        ms = [m[name]["stats"]["elapsed_s"] * 1e3 for _, m in ranks]
        out["rescales"][name] = dict(
            ms_by_rank=ms, ms=max(ms), recheck_s=max(m[name]["stats"]["recheck_s"] for _, m in ranks),
            sent_by_rank=[m[name]["sent"] for _, m in ranks], received_by_rank=[m[name]["received"] for _, m in ranks],
            migrated_edges=st["migrated_edges"], cross_device_edges=st["cross_device_edges"],
            cross_process_edges=st["cross_process_edges"], copy_ops=st["copy_ops"])
        r5 = out["rescales"][name]
        log(f"path 5 ({tag}) rescale {name}: {r5['ms']:.3f} ms (largest over the ranks; by rank "
            f"{[round(x, 3) for x in ms]}), sent {r5['sent_by_rank']} B, received {r5['received_by_rank']} B by rank; "
            f"{r5['migrated_edges']} edges migrate, {r5['cross_device_edges']} across ranks, "
            f"{r5['cross_process_edges']} across processes (equal to the plan); re-check + verify up to "
            f"{r5['recheck_s']:.3f} s")
    for app in ("pagerank", "sssp", "wcc"):
        out["apps"][f"{app}_s_by_rank"] = [m[f"{app}_s"] for _, m in ranks]
        out["apps"][f"{app}_first_s_by_rank"] = [m[f"{app}_first_s"] for _, m in ranks]
    out["pagerank_rel"] = max(m["pagerank_rel"] for _, m in ranks)
    log(f"path 5 ({tag}): {g} ranks ({n_procs} processes x {devs_per_proc}) over {backend} on {sorted(set(devices))}, "
        f"{wall:.3f} s in all; apps by rank, second run (first run): "
        + "; ".join(f"{app} {[round(x, 3) for x in out['apps'][f'{app}_s_by_rank']]} s "
                    f"({[round(x, 3) for x in out['apps'][f'{app}_first_s_by_rank']]})"
                    for app in ("pagerank", "sssp", "wcc"))
        + f"; PageRank max rel {out['pagerank_rel']:.3e} "
        f"to slice 1's, SSSP and WCC equal; segment_rf launches by rank {out['segment_rf_launches']}, each exact")
    return out


def streamrank_worker(run_dir: pathlib.Path) -> int:
    """One rank of path 6 (``--stream-rank-worker``, started by
    ``streamrank_path`` through ``launch_local_cluster``): an orderer replica
    and a ``StreamingEngine`` over the group, driven through the run's
    ``config.json`` steps ("batch": ingest + monitor; "force": the same with
    the full rung forced; an int: a rescale; "restore": ``from_restored`` on
    the rank's orderer, its pack compared with the live engine's, which it
    then replaces), a bit-identity check after every event. Every
    ``segment_distinct_counts`` call is tapped and held exactly against the
    plain version afterwards. Prints each event's times and bytes; writes
    ``rank{r}.npz`` (its final rows; rank 0 also the narrowest and the widest
    rows it counted) and ``rank{r}.json`` (readings)."""
    sys.path.insert(0, str(ROOT / "src"))
    import types

    import torch.distributed as dist

    from repro_torch.kernels import full_reorder as FRK
    from repro_torch.kernels import segment_rf
    from repro_torch.kernels import span_reorder as SRK
    from repro_torch.launch import multihost as MH
    from repro_torch.obs import metrics as OM
    from repro_torch.obs.trace import Tracer
    from repro_torch.stream import IncrementalOrderer, StreamConfig, StreamingEngine, SyntheticStream

    cfg = json.loads((run_dir / "config.json").read_text())
    group = MH.initialize_from_env(timeout_s=cfg["timeout_s"])
    r, dev, g = group.rank, group.torch_device, group.size
    inputs = np.load(cfg["inputs"])
    v = cfg["num_vertices"]
    kernel, tapped = SRK.segment_distinct_counts, []

    def tap(rows):
        counts = kernel(rows)
        tapped.append((rows.clone(), counts.clone()))
        return counts

    SRK.segment_distinct_counts = tap  # both rungs' objectives look it up at each call
    greedy_tapped: list = []
    greedy_kernel, FRK.greedy_keys = greedy_tap(FRK, greedy_tapped)  # full_order_device looks it up at each call
    tracer, reg = Tracer(), OM.MetricsRegistry()
    meta = dict(rank=r, device=str(dev), backend=group.backend, events=[])
    byte_names = ("scatter.upload", "span.gather", "rebuild.gather", "rescale.sent", "rescale.received")

    def moved() -> dict:
        return {name: reg.counter(f"stream.{name}_bytes").value for name in byte_names}

    t0 = time.perf_counter()
    o = IncrementalOrderer(inputs["src"].astype(np.int64), inputs["dst"].astype(np.int64), v, regions=cfg["regions"],
                           config=StreamConfig(**cfg["config"]))
    meta["orderer_s"] = time.perf_counter() - t0
    OM.read_peak_rss()  # without VmHWM: a VmRSS sample for the running maximum
    engine_kw = dict(group=group, span_repair=cfg["span_repair"], full_rebuild=cfg["full_rebuild"],
                     rebuild_flight=cfg["flight"], tracer=tracer, metrics_registry=reg)
    t0 = time.perf_counter()
    eng = StreamingEngine(o, **engine_kw)
    meta["commit_s"] = time.perf_counter() - t0
    stream = SyntheticStream(types.SimpleNamespace(src=inputs["base_src"], dst=inputs["base_dst"], num_vertices=v),
                             batch_size=cfg["batch"], seed=cfg["seed"])
    eng.verify_bit_identity()
    selections, batch = 0, 0
    for step in cfg["steps"]:
        tracer.clear()
        before = moved()
        if isinstance(step, int):
            st = eng.rescale(step)
            ev = dict(kind="rescale", k_old=st.k_old, k_new=st.k_new, ms=st.elapsed_s * 1e3,
                      moved_edges=st.moved_edges, cep_plan_edges=st.cep_plan_edges,
                      cross_device_edges=st.cross_device_edges, cross_device_bytes=st.cross_device_bytes,
                      cross_process_edges=st.cross_process_edges)
        elif step == "restore":
            t0 = time.perf_counter()
            restored = StreamingEngine.from_restored(o, **engine_kw)
            torch.cuda.synchronize(dev)
            ev = dict(kind="restore", ms=(time.perf_counter() - t0) * 1e3,
                      uploaded=sum(t.numel() * t.element_size() for t in (restored.data.edges, restored.data.mask,
                                                                          restored.data.degrees)),
                      equal={n: bool(torch.equal(getattr(restored.data, n), getattr(eng.data, n)))
                             for n in ("edges", "mask", "degrees")})
            eng = restored  # the live engine's buffers go with it
        else:
            batch += 1
            st = eng.ingest(stream.batch())
            if step == "force":
                o.drift = lambda: 200.0  # over full_drift: the full rung fires
            rung = eng.monitor()
            if step == "force":
                del o.drift
            ev = dict(kind="batch", batch=batch, inserted=st.inserted, deleted=st.deleted, scatter_ops=st.scatter_ops,
                      rung=rung, repair=eng.last_repair, state=eng.rebuild_state)
            selections += rung == "partial" and eng.last_repair == "differential"
        ms = {name: t * 1e3 for name, t in span_sums(tracer).items()}
        ev.update(ms_by_span=ms, bytes={k: x - before[k] for k, x in moved().items() if x != before[k]})
        if ev["kind"] == "rescale":
            ev.update(sent=ev["bytes"].get("rescale.sent", 0), received=ev["bytes"].get("rescale.received", 0))
        t0 = time.perf_counter()
        eng.verify_bit_identity()
        ev["verify_s"] = time.perf_counter() - t0
        OM.read_peak_rss()
        meta["events"].append(ev)
        print(f"rank {r} {ev['kind']}: " + ", ".join(f"{k} {x:.3f} ms" for k, x in sorted(ms.items()))
              + f"; bytes {ev['bytes']}; " + ", ".join(f"{k} {x}" for k, x in ev.items()
                                                      if k not in ("ms_by_span", "bytes", "kind"))
              + "; bit-identical", flush=True)
    meta["log"] = [{k: x for k, x in rec.items() if not k.endswith("_s")} for rec in eng.drain_rebuild_events()]
    meta["selections"] = int(selections) + sum(rec["mode"] == "differential" for rec in meta["log"])
    meta["k"], meta["rung_counts"] = eng.k, eng.rung_counts
    meta["rss_field"], meta["peak_rss_mb"] = OM.read_peak_rss()
    SRK.segment_distinct_counts = kernel
    FRK.greedy_keys = greedy_kernel
    meta["segment_rf_launches"] = segment_rf.launches
    meta["segment_rf_tapped"] = [
        dict(shape=list(rows.shape), exact=bool(torch.equal(counts, segment_rf.segment_distinct_counts_torch(rows))))
        for rows, counts in tapped]
    meta["greedy_launches"] = FRK.launches
    meta["greedy_tapped"] = [greedy_against_mirror(FRK, rec) for rec in greedy_tapped]
    arrays = dict(edges=eng.data.edges.cpu().numpy(), mask=eng.data.mask.cpu().numpy())
    if r == 0 and tapped:
        by_width = sorted((rows for rows, _ in tapped), key=lambda t: t.shape[1])
        arrays.update(rows_narrowest=by_width[0].cpu().numpy(), rows_widest=by_width[-1].cpu().numpy())
    dist.destroy_process_group()
    np.savez(run_dir / f"rank{r}.npz", **arrays)
    (run_dir / f"rank{r}.json").write_text(json.dumps(meta))
    print(f"rank {r}: orderer {meta['orderer_s']:.3f} s, first commit {meta['commit_s']:.3f} s, peak RSS "
          f"{meta['peak_rss_mb']:.1f} MB ({meta['rss_field']}, read after the orderer's build and after each "
          f"event), segment_rf launched {meta['segment_rf_launches']} times for "
          f"{meta['selections']} selections, the greedy kernel {meta['greedy_launches']} times "
          f"{[(t['steps'], t['exact']) for t in meta['greedy_tapped']]}", flush=True)
    return 0


def streamrank_path(tag: str, backend: str, n_procs: int, devs_per_proc: int, devices: list, steps: dict,
                    inputs: pathlib.Path, v: int) -> dict:
    """Path 6: the streaming engine over g = n_procs · devs_per_proc ranks
    started by the port's ``launch_local_cluster``, each on its entry of
    ``devices`` over ``backend``, through the events of ``steps``. Every rank
    checks its pack bit-identical to its orderer's ``pack_slots`` after every
    event; the parent holds the ranks' ladders, rebuild logs and rescale
    counts equal, the bytes sent and received over the ranks equal to the
    cross-rank bytes, a restored pack equal to the live one on every rank,
    and every rank's ``segment_rf`` launches at twice its selections, each
    exact against the plain version. Returns readings."""
    from repro_torch.launch import multihost as MH

    g = n_procs * devs_per_proc
    run_dir = ROOT / "build" / "streamrank" / tag
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    (run_dir / "config.json").write_text(json.dumps(dict(steps, inputs=str(inputs), num_vertices=v,
                                                         timeout_s=MULTIRANK_GROUP_TIMEOUT_S)))
    t0 = time.perf_counter()
    res = MH.spawn_local_cluster(n_procs, devs_per_proc,
                                 [str(ROOT / "chip_smoke.py"), "--stream-rank-worker", str(run_dir)],
                                 backend=backend, devices=devices, timeout=STREAMRANK_TIMEOUT_S,
                                 env_extra={"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"})
    wall = time.perf_counter() - t0
    for p in res.procs:
        for line in p.stdout.splitlines():
            log(f"path 6 ({tag}) {line}")
    check(res.ok, f"path 6 ({tag}): a rank failed\n{res.format_logs()}")
    ranks = [(dict(np.load(run_dir / f"rank{r}.npz")), json.loads((run_dir / f"rank{r}.json").read_text()))
             for r in range(g)]
    first = ranks[0][1]
    for i, (_, meta) in enumerate(ranks):
        decisions = [(e["kind"], e.get("rung"), e.get("repair"), e.get("state"), e.get("k_new"),
                      e.get("moved_edges"), e.get("cross_device_edges"), e.get("cross_process_edges"))
                     for e in meta["events"]]
        check(decisions == [(e["kind"], e.get("rung"), e.get("repair"), e.get("state"), e.get("k_new"),
                             e.get("moved_edges"), e.get("cross_device_edges"), e.get("cross_process_edges"))
                            for e in first["events"]] and meta["log"] == first["log"] and meta["k"] == first["k"],
              f"path 6 ({tag}): rank {i}'s ladder, rescales or rebuild log differ from rank 0's")
        launches, tapped = meta["segment_rf_launches"], meta["segment_rf_tapped"]
        check(launches == 2 * meta["selections"] == len(tapped) and all(t["exact"] for t in tapped),
              f"path 6 ({tag}) rank {i}: segment_rf launched {launches} times ({len(tapped)} tapped) for "
              f"{meta['selections']} selections, exact {[t['exact'] for t in tapped]}")
        greedy = meta["greedy_tapped"]
        check(meta["greedy_launches"] == len(greedy) and all(t["exact"] for t in greedy),
              f"path 6 ({tag}) rank {i}: the greedy kernel launched {meta['greedy_launches']} times "
              f"({len(greedy)} tapped), equal to the mirror (permutation and steps) {[t['exact'] for t in greedy]}")
        for e in meta["events"]:
            if e["kind"] == "restore":
                check(all(e["equal"].values()), f"path 6 ({tag}) rank {i}: the restored pack differs: {e['equal']}")
    for j, e in enumerate(first["events"]):
        if e["kind"] == "rescale":
            sent = sum(m["events"][j]["sent"] for _, m in ranks)
            received = sum(m["events"][j]["received"] for _, m in ranks)
            check(sent == received == e["cross_device_bytes"] > 0,
                  f"path 6 ({tag}): rescale {e['k_old']}->{e['k_new']} sent {sent} B and received {received} B, "
                  f"{e['cross_device_bytes']} B cross ranks")
    out = dict(ranks=g, processes=n_procs, backend=backend, devices=devices, wall_s=wall, events=[],
               orderer_s_by_rank=[m["orderer_s"] for _, m in ranks], commit_s_by_rank=[m["commit_s"] for _, m in ranks],
               peak_rss_mb_by_rank=[m["peak_rss_mb"] for _, m in ranks], rss_field=first["rss_field"], log=first["log"],
               segment_rf_launches=[m["segment_rf_launches"] for _, m in ranks],
               greedy_launches=[m["greedy_launches"] for _, m in ranks],
               greedy_by_rank=[m["greedy_tapped"] for _, m in ranks],
               selections=[m["selections"] for _, m in ranks],
               segment_rf_shapes=sorted({tuple(t["shape"]) for _, m in ranks for t in m["segment_rf_tapped"]}))
    for j, e in enumerate(first["events"]):
        by_rank = [m["events"][j] for _, m in ranks]
        spans = sorted({k for x in by_rank for k in x["ms_by_span"]})
        out["events"].append(dict(
            {k: x for k, x in e.items() if k not in ("ms_by_span", "bytes", "verify_s", "sent", "received", "ms",
                                                      "uploaded", "equal")},
            ms_by_rank={k: [x["ms_by_span"].get(k, 0.0) for x in by_rank] for k in spans},
            bytes_by_rank={k: [x["bytes"].get(k, 0) for x in by_rank] for k in sorted({k for x in by_rank
                                                                                      for k in x["bytes"]})},
            verify_s_by_rank=[x["verify_s"] for x in by_rank],
            **({"ms_by_rank_total": [x["ms"] for x in by_rank]} if "ms" in e else {}),
            **({"sent_by_rank": [x["sent"] for x in by_rank], "received_by_rank": [x["received"] for x in by_rank]}
               if e["kind"] == "rescale" else {}),
            **({"uploaded_by_rank": [x["uploaded"] for x in by_rank]} if e["kind"] == "restore" else {})))
    if "rows_narrowest" in ranks[0][0]:
        out["rows"] = {name: ranks[0][0][f"rows_{name}"] for name in ("narrowest", "widest")}
    log(f"path 6 ({tag}): {g} ranks ({n_procs} processes x {devs_per_proc}) over {backend} on {sorted(set(devices))}, "
        f"{wall:.3f} s in all; {len(first['events'])} events, every one bit-identical on every rank; orderers "
        f"{[round(x, 3) for x in out['orderer_s_by_rank']]} s, peak RSS {[round(x, 1) for x in out['peak_rss_mb_by_rank']]} "
        f"MB by rank ({first['rss_field']}); segment_rf launches by rank {out['segment_rf_launches']} for {out['selections']} selections, "
        f"each exact; greedy kernel launches by rank {out['greedy_launches']}, each equal to the mirror")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20, help="RMAT scale: 2**scale vertices")
    ap.add_argument("--edge-factor", type=int, default=16, help="RMAT edges sampled per vertex")
    ap.add_argument("--cards", type=int, default=1,
                    help="4: only slice 1, path 5 (a) and (c) and path 6 (c), (c) being g = 4 ranks over NCCL, "
                         "one card each")
    ap.add_argument("--rank-worker", type=pathlib.Path, help=argparse.SUPPRESS)  # one rank of path 5
    ap.add_argument("--stream-rank-worker", type=pathlib.Path, help=argparse.SUPPRESS)  # one rank of path 6
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.rank_worker is not None:
        return multirank_worker(args.rank_worker)
    if args.stream_rank_worker is not None:
        return streamrank_worker(args.stream_rank_worker)
    check(args.cards in (1, 4) and torch.cuda.device_count() >= args.cards,
          f"--cards {args.cards}: 1 or 4 cards, and {torch.cuda.device_count()} are visible")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.compat import PAD_ID
    from repro_torch.core import cep, metrics, ordering
    from repro_torch.core.graph import rmat_graph
    from repro_torch.elastic.rescale_exec import EDGE_BYTES, ElasticRescaler
    from repro_torch.graphs import engine as E
    from repro_torch.kernels import _build, edge_spmv, ops, segment_rf
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import full_reorder as FRK
    from repro_torch.kernels.ref import segment_distinct_counts_ref

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    modules = {"segment_rf": segment_rf, "edge_spmv": edge_spmv, "flash_attention": fa, "decode_attention": dec,
               "full_reorder": FRK}

    def reset_launches() -> None:
        for m in modules.values():
            m.launches = 0
        fa.tc_launches = 0
        dec.merge_launches = 0

    def read_launches() -> dict:
        return {name: m.launches for name, m in modules.items()}

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    phases: dict = {}
    report = {name: {"max_abs_err": 0.0} for name in KERNELS}

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    built = KERNELS if args.cards == 1 else ("segment_rf", "full_reorder")  # what paths 5 and 6 launch
    lib_paths = _build.build_all(built)
    for name in built:
        _build.load(name)
    phases["build_s"] = time.perf_counter() - t0
    log(f"build: {', '.join(p.name for p in lib_paths)} in {phases['build_s']:.3f} s")
    for p in lib_paths:
        build_log = p.with_name(p.name + ".log")
        if build_log.exists():  # written by the build that made the library
            log(build_log.read_text().strip())
    if "flash_attention" in built:
        # The bf16 flash kernel must run on the tensor cores: HGMMA in its SASS.
        cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib_paths[KERNELS.index("flash_attention")])],
                              capture_output=True, text=True, check=True).stdout
        hgmma = {f.split()[0]: f.count("HGMMA") for f in sass.split("Function : ")[1:]
                 if "flash_tc_kernel" in f.split()[0]}
        check(len(hgmma) == len(fa.HEAD_DIMS) and all(hgmma.values()),
              f"flash_attention: every tensor-core instantiation must hold HGMMA instructions, got {hgmma}")
        log(f"flash_attention SASS: HGMMA instructions per tensor-core instantiation {sorted(hgmma.values())}")

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

    gen = torch.Generator(device=dev).manual_seed(0)
    if args.cards == 1:  # the four-card call runs slice 1, path 5 (a) and (c) and path 6 (c) only
        # ------------------------------------------------ kernel parity: segment_rf
        rng = np.random.default_rng(0)
        cases = [(k, 2 * int(np.diff(cep.chunk_bounds(n, k)).max())) for k in ROW_KS]
        cases += [(13, 1000), (9, 4097), (3, 3 * 4096 + 1), (5, 1), (1, 65535 * 4096 + 4097)]
        t0 = time.perf_counter()
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
            report["segment_rf"]["max_abs_err"] = max(report["segment_rf"]["max_abs_err"],
                                                      int((got.long() - want.long()).abs().max()))
            check(torch.equal(got, want), f"segment_rf parity failed at (C, W) = ({c}, {w})")
            if c * w <= 1 << 16:
                check(np.array_equal(got.cpu().numpy(), segment_distinct_counts_ref(rows, PAD_ID)),
                      f"segment_rf differs from the numpy oracle at ({c}, {w})")
            log(f"parity segment_rf (C, W) = ({c}, {w}): exact")
            del t, got, want
        all_pad = torch.full((8, 5000), PAD_ID, dtype=torch.int32, device=dev)
        check(int(segment_rf.segment_distinct_counts(all_pad).abs().sum()) == 0, "all-PAD rows must count 0")

        # ------------------------------------------------- kernel parity: edge_spmv
        # dst layouts: "random", "hub" (one dst in every slot), "alternating" (no
        # two neighbours share a dst), "sorted" (long runs, as GEO order makes).
        for c, we, wv, lo, hi, layout in [
                (2, 16, 32, 0, 33, "random"), (5, 64, 128, 0, 129, "random"), (3, 128, 256, 0, 257, "random"),
                (1, 1, 8, 0, 8, "random"), (1, 300, 64, 64, 100, "random"), (4, 5000, 512, -3, 600, "random"),
                (3, 5_001, 512, 0, 512, "hub"), (2, 9_999, 512, 0, 512, "alternating"),
                (5, 40_001, 4096, -1, 4097, "sorted"), (700, 6_001, 1024, 0, 1025, "sorted"),
                (70_000, 3, 8, 0, 9, "sorted")]:
            src_ids = rng.integers(lo, hi, size=(c, we)).astype(np.int32)
            dst_ids = {"random": lambda: rng.integers(lo, hi, size=(c, we)),
                       "hub": lambda: np.full((c, we), 7),
                       "alternating": lambda: np.broadcast_to(np.arange(we) % 2 * 5 + 3, (c, we)),
                       "sorted": lambda: np.sort(rng.integers(lo, hi, size=(c, we)), axis=1)}[layout]()
            ids = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev) for a in (src_ids, dst_ids)]
            w_t = torch.from_numpy(rng.standard_normal((c, we)).astype(np.float32)).to(dev)
            x_t = torch.from_numpy(rng.standard_normal((c, wv)).astype(np.float32)).to(dev)
            got = edge_spmv.spmv_blocked(*ids, w_t, x_t)
            what = f"(C, W_E, W_V) = ({c}, {we}, {wv}), ids in [{lo}, {hi}), {layout} dst"
            err = close(got, edge_spmv.spmv_blocked_torch(*ids, w_t, x_t), SPMV_PARITY_TOL, SPMV_PARITY_TOL,
                        f"edge_spmv parity at {what}")
            if lo >= wv:
                check(not bool(got.any()), "edge_spmv: all-padding rows must add exactly 0")
            report["edge_spmv"]["max_abs_err"] = max(report["edge_spmv"]["max_abs_err"], err)
            log(f"parity edge_spmv {what}: max abs err {err:.3e}")

        # ------------------------------------------- kernel parity: flash attention
        flash_cases = [(1, 2, 128, 64, None, None, True), (2, 1, 256, 32, None, None, True),
                       (1, 2, 256, 64, 128, None, True), (1, 1, 128, 64, None, 30.0, True),
                       (2, 2, 384, 128, 256, 50.0, True), (1, 1, 128, 32, None, None, False),
                       (1, 2, 512, 256, 256, 50.0, True), (1, 2, 1000, 128, None, None, True),
                       (1, 1, 777, 256, 300, 50.0, True),
                       (1, 2, 512, 96, None, None, True), (1, 2, 700, 96, 200, 50.0, True)]  # D = 96: padded to 128
        for b, h, s, d, window, softcap, causal in flash_cases:
            for dtype, rtol, atol in ((torch.float32, F32_TOL, F32_TOL), (torch.bfloat16, BF16_RTOL, BF16_ATOL)):
                q, k, vv = (torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype) for _ in range(3))
                kw = dict(causal=causal, window=window, softcap=softcap)
                tc_before = fa.tc_launches
                got = fa.flash_attention(q, k, vv, **kw)
                check(got.dtype == dtype and got.shape == q.shape, "flash_attention: wrong output type or shape")
                check(fa.tc_launches == tc_before + (dtype == torch.bfloat16),
                      "flash_attention: bf16 must run the tensor-core kernel and f32 the CUDA-core kernel")
                err = close(got, fa.flash_attention_torch(q, k, vv, **kw), rtol, atol,
                            f"flash_attention parity at {(b, h, s, d)} {dtype} {kw}")
                report["flash_attention"]["max_abs_err"] = max(report["flash_attention"]["max_abs_err"], err)
                log(f"parity flash_attention (B, H, S, D) = {(b, h, s, d)} {str(dtype)[6:]} {kw}: max abs err {err:.3e}")

        # ------------------------------------------ kernel parity: decode attention
        decode_cases = [(2, 4, 512, 64, 128, None, torch.float32, None), (1, 1, 1024, 32, 256, None, torch.float32, None),
                        (3, 8, 256, 128, 256, None, torch.float32, None),
                        (3, 4, 512, 64, 128, None, torch.float32, [0, 200, 512]),
                        (2, 4, 512, 128, 128, 20.0, torch.float32, None),
                        (4, 4, 2048, 128, 512, None, torch.bfloat16, [1, 700, 1536, 2048]),
                        (4, 4, 2048, 96, 512, None, torch.bfloat16, [1, 700, 1536, 2048])]  # D = 96: padded to 128
        for bh, gq, s, d, block_s, softcap, kv_dtype, cache in decode_cases:
            q = torch.randn((bh, gq, d), generator=gen, device=dev)
            k, vv = (torch.randn((bh, s, d), generator=gen, device=dev).to(kv_dtype) for _ in range(2))
            cl = (torch.randint(1, s + 1, (bh,), generator=gen, device=dev, dtype=torch.int32) if cache is None
                  else torch.tensor(cache, dtype=torch.int32, device=dev))
            got = dec.decode_attention_partials(q, k, vv, cl, block_s=block_s, softcap=softcap)
            want = dec.decode_attention_partials_torch(q, k, vv, cl, scale=d**-0.5, block_s=block_s, softcap=softcap)
            what = f"decode_attention parity at {(bh, gq, s, d, block_s)} softcap {softcap} {kv_dtype} cache_len {cache}"
            err = max(close(gv, wv_, DECODE_TOL, DECODE_TOL, f"{what} ({name})") for name, gv, wv_ in zip("oml", got, want))
            err = max(err, close(dec.merge_partials(*got)[0], dec.merge_partials(*want)[0], DECODE_TOL, DECODE_TOL, what))
            merged = dec.decode_attention(q, k, vv, cl, block_s=block_s, softcap=softcap)
            err = max(err, close(merged, dec.merge_partials(*want)[0], DECODE_TOL, DECODE_TOL, f"{what} (merged)"))
            if cache is not None and cache[0] == 0:
                mean_v = vv[0].float().mean(0).expand(gq, d)
                for name, out in (("partials", dec.merge_partials(*got)[0]), ("merged", merged)):
                    close(out[0], mean_v, DECODE_TOL, DECODE_TOL, f"cache_len = 0 must decode to the mean of v ({name})")
            report["decode_attention"]["max_abs_err"] = max(report["decode_attention"]["max_abs_err"], err)
            log(f"parity decode_attention (BH, Gq, S, D, block_s) = {(bh, gq, s, d, block_s)} softcap {softcap} "
                f"{str(kv_dtype)[6:]} cache_len {cache or 'random'}: max abs err {err:.3e} (partials and merged)")
        # The merged path at split boundaries, an empty row, Gq 1 and 8, a bf16 query.
        sp = dec.SPLIT
        for gq, d, kv_dtype, q_dtype in [(4, 128, torch.bfloat16, torch.bfloat16), (8, 128, torch.float32, torch.float32),
                                         (1, 96, torch.bfloat16, torch.float32), (8, 256, torch.bfloat16, torch.bfloat16)]:
            cache = [0, 1, sp - 1, sp, sp + 1, 3 * sp]
            q = torch.randn((len(cache), gq, d), generator=gen, device=dev).to(q_dtype)
            k, vv = (torch.randn((len(cache), 3 * sp, d), generator=gen, device=dev).to(kv_dtype) for _ in range(2))
            cl = torch.tensor(cache, dtype=torch.int32, device=dev)
            got = dec.decode_attention(q, k, vv, cl)
            want = dec.merge_partials(*dec.decode_attention_partials_torch(q, k, vv, cl, scale=d**-0.5, block_s=512))[0]
            what = f"decode_attention merged path at Gq {gq}, D {d}, {kv_dtype} cache, {q_dtype} q, cache_len {cache}"
            err = close(got, want, DECODE_TOL, DECODE_TOL, what)
            close(got[0], vv[0].float().mean(0).expand(gq, d), DECODE_TOL, DECODE_TOL,
                  f"{what}: cache_len = 0 must decode to the mean of v")
            report["decode_attention"]["max_abs_err"] = max(report["decode_attention"]["max_abs_err"], err)
            log(f"parity {what}: max abs err {err:.3e}")
        phases["parity_s"] = time.perf_counter() - t0

    # ------------------------------------------------- slice 1: the graph path
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

    reset_launches()
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
    slice1_launches = read_launches()

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
    check(slice1_launches == {**dict.fromkeys(KERNELS, 0), "segment_rf": expected_launches},
          f"slice 1 launched {slice1_launches}, expected segment_rf {expected_launches} times and nothing else")
    log(f"slice 1 launches: {slice1_launches} (segment_rf = {len(packs)} packs + {len(rescales)} re-checked rescales)")

    # Path 5's inputs: the slice-1 ordered list once, for every rank to load
    # (the GEO order is not computed again per rank), and slice 1's results.
    (ROOT / "build" / "multirank").mkdir(parents=True, exist_ok=True)
    ordered_npz = ROOT / "build" / "multirank" / "ordered.npz"
    np.savez(ordered_npz, src=src, dst=dst, base_src=g.src, base_dst=g.dst)  # path 6's stream draws from the base
    multirank_want = dict(
        packs={**{k: packs[k] for k in (16, 8)}, 17: rescales["16to17"][0], 12: rescales["8to12"][0]},
        quality={k: oracle(k) for k in (16, 8, 17, 12)},
        pagerank=pr17, sssp=ss17, sssp_it=it_s17, wcc=wc17, wcc_it=it_w17)

    def run_multirank(tag, backend, n_procs, devs, devices, steps) -> dict:
        reset_launches()
        t0 = time.perf_counter()
        read = multirank_path(tag, backend, n_procs, devs, devices, steps, src, dst, v, source, multirank_want)
        phases[f"multirank_{tag}_s"] = time.perf_counter() - t0
        parent = read_launches()
        check(parent == dict.fromkeys(KERNELS, 0), f"path 5 ({tag}): the parent launched {parent}, expected none")
        return read

    def run_streamrank(tag, backend, devices, steps, inputs, num_vertices) -> dict:
        reset_launches()
        t0 = time.perf_counter()
        read = streamrank_path(tag, backend, MULTIRANK_PROCS, MULTIRANK_DEVS, devices, steps, inputs, num_vertices)
        phases[f"streamrank_{tag}_s"] = time.perf_counter() - t0
        parent = read_launches()
        check(parent == dict.fromkeys(KERNELS, 0), f"path 6 ({tag}): the parent launched {parent}, expected none")
        return read

    def streamrank_inputs(rungs_g) -> pathlib.Path:
        """Path 6 (b)'s inputs: path 4's graph and its GEO order."""
        g14, src14, dst14 = rungs_g
        path = ROOT / "build" / "streamrank" / "rmat14.npz"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, src=src14, dst=dst14, base_src=g14.src, base_dst=g14.dst)
        return path

    def check_streamrank(read: dict) -> None:
        a, b = read["a"], read["b"]
        check(any(e.get("repair") == "device" for e in a["events"]), "path 6 (a): no span repair ran over the ranks")
        check([(r["committed"], r["aborted"]) for r in b["log"]] == [(True, False), (False, True)],
              f"path 6 (b): rebuild log {b['log']}")
        check(all(n > 0 for n in b["greedy_launches"]),
              f"path 6 (b): the greedy kernel must launch on every rank, launched {b['greedy_launches']}")

    g4_gloo = ("g4_gloo_1card", "gloo", MULTIRANK_PROCS, MULTIRANK_DEVS,
               ["cuda:0"] * (MULTIRANK_PROCS * MULTIRANK_DEVS), MULTIRANK_STEPS)
    if args.cards > 1:
        # The four-card call: (c) g = 4 over NCCL, one card per rank, as (a)'s
        # 2 x 2, beside (a) itself in the same call.
        multirank_read = {"g4_gloo_1card": run_multirank(*g4_gloo),
                          "g4_nccl_4cards": run_multirank("g4_nccl_4cards", "nccl", MULTIRANK_PROCS,
                                                          MULTIRANK_DEVS, [f"cuda:{i}" for i in range(4)],
                                                          MULTIRANK_STEPS)}
        # Path 6 (c): (a) and (b) over NCCL, one card a rank.
        cards = [f"cuda:{i}" for i in range(4)]
        g14 = rungs_graph()
        streamrank_read = {"a": run_streamrank("a_g4_nccl_4cards", "nccl", cards, STREAMRANK_A, ordered_npz, v),
                           "b": run_streamrank("b_g4_nccl_4cards", "nccl", cards, STREAMRANK_B,
                                               streamrank_inputs(g14), g14[0].num_vertices)}
        check_streamrank(streamrank_read)
        for read in streamrank_read.values():
            read.pop("rows", None)
        log(json.dumps({"multirank": multirank_read, "streamrank": streamrank_read, "phases": phases}))
        log(f"card: {card}")
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return 0

    # Split of a pack's time: the host part alone (the rest is the copy to
    # the card, the row sort, the kernel and the degree count).
    t0 = time.perf_counter()
    E.host_pack(src, dst, 16)
    phases["host_pack_k16_s"] = time.perf_counter() - t0

    # ----------------------------------------------- slice 2: the entry points
    deg = d4.degrees.cpu().numpy()
    weights = (1.0 / np.maximum(deg[src], 1.0)).astype(np.float32)  # PageRank's gather: x[src] / deg[src]
    x_pr = pr4
    bounds16, bounds128 = np.asarray(cep.chunk_bounds(n, 16)), np.asarray(cep.chunk_bounds(n, 128))
    narrow = min(1 << 16, v // 16)  # 65,536 at scale 20
    narrow_starts = [int(np.clip(src[bounds16[i]:bounds16[i + 1]].min(), 0, v - narrow)) for i in range(16)]
    spmv_calls = {
        "a": (bounds16, [0] * 16, v),
        "b": (bounds128, [0] * 128, v),
        "c": (bounds16, narrow_starts, narrow),
    }
    (qwen_qkv, _), (gemma_qkv, gemma_kw) = prefill_inputs(gen, dev)
    q_heads, kv_heads, hd = QWEN3["heads"], QWEN3["kv_heads"], QWEN3["head_dim"]
    rep = q_heads // kv_heads
    bh_dec = DECODE_BATCH * kv_heads
    dec_q = torch.randn((bh_dec, rep, hd), generator=gen, device=dev, dtype=torch.bfloat16)
    dec_k, dec_v = (torch.randn((bh_dec, DECODE_CACHE, hd), generator=gen, device=dev, dtype=torch.bfloat16)
                    for _ in range(2))
    cache_np = decode_cache_lengths(bh_dec)
    dec_len = torch.from_numpy(cache_np).to(dev)
    torch.cuda.synchronize()

    reset_launches()
    t_slice2 = time.perf_counter()
    spmv_out = {}
    for name, (bounds, starts, size) in spmv_calls.items():
        t0 = time.perf_counter()
        spmv_out[name] = ops.chunked_spmv(src, dst, weights, x_pr, bounds, starts, size, device=dev)
        torch.cuda.synchronize()
        phases[f"chunked_spmv_{name}_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qwen_out = ops.flash_attention(*qwen_qkv, causal=True)
    torch.cuda.synchronize()
    phases["flash_qwen3_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gemma_out = ops.flash_attention(*gemma_qkv, **gemma_kw)
    torch.cuda.synchronize()
    phases["flash_gemma2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec_out = ops.decode_attention(dec_q, dec_k, dec_v, dec_len, block_s=DECODE_BLOCK)
    torch.cuda.synchronize()
    phases["decode_qwen3_s"] = time.perf_counter() - t0
    phases["slice2_path_s"] = time.perf_counter() - t_slice2
    slice2_launches = read_launches()
    expected2 = {**dict.fromkeys(KERNELS, 0), "edge_spmv": len(spmv_calls), "flash_attention": 2, "decode_attention": 1}
    slice2_tc, slice2_merges = fa.tc_launches, dec.merge_launches
    check(slice2_launches == expected2, f"slice 2 launched {slice2_launches}, expected {expected2}")
    check(slice2_tc == 2, f"slice 2's two bf16 flash calls ran the tensor-core kernel {slice2_tc} times, expected 2")
    check(slice2_merges == 1, f"slice 2's decode call ran the combine kernel {slice2_merges} times, expected 1")
    log(f"slice 2 launches: {slice2_launches}; flash_attention on the tensor cores: {slice2_tc}; "
        f"decode_attention's combine kernel: {slice2_merges}")

    x64 = x_pr.double().cpu().numpy()
    spmv_oracle = torch.from_numpy(np.bincount(dst, weights=weights.astype(np.float64) * x64[src], minlength=v))
    spmv_packs = {}  # each call's kernel input from the host oracle, for its out-of-window count and its timing
    for name, (bounds, starts, size) in spmv_calls.items():
        y = spmv_out[name]
        check(y.shape == (v,) and y.dtype == torch.float32 and bool(torch.isfinite(y).all()),
              f"chunked_spmv ({name}): not a finite (V,) f32 vector")
        rel = rel_close(y.cpu(), spmv_oracle, SPMV_RTOL, f"chunked_spmv ({name}) against the float64 oracle")
        spmv_packs[name] = ops.pack_windows(src, dst, weights, bounds, starts, size)
        outside = spmv_packs[name][3].size
        log(f"chunked_spmv ({name}) C={len(starts)} window {size}: max rel diff {rel:.3e} to the float64 oracle "
            f"(limit {SPMV_RTOL}); {outside} of {n} edges in the out-of-window pass; {phases[f'chunked_spmv_{name}_s']:.3f} s")

        # The call once more, whole and then phase by phase, each phase
        # ended by a synchronize; the phases run the entry point's own steps.
        st = np.asarray(starts, dtype=np.int64)
        y_whole, whole_s = synced_s(lambda: ops.chunked_spmv(src, dst, weights, x_pr, bounds, starts, size, device=dev))
        (s_t, d_t, w_t), h2d_s = synced_s(lambda: ops._edges_to_device(src, dst, weights, v, dev))
        packed, pack_s = synced_s(lambda: ops.pack_windows_device(s_t, d_t, w_t, bounds, st, size, device=dev))
        x_win, xwin_s = synced_s(lambda: ops._x_windows(x_pr, st, size))
        y_win, kernel_s = synced_s(lambda: edge_spmv.spmv_blocked(*packed[:3], x_win))
        y2, add_s = synced_s(lambda: ops._add_back(y_win, st, v))
        _, outside_s = synced_s(lambda: ops._add_outside(y2, s_t, d_t, w_t, x_pr, packed[3]))
        rel_close(y2[:v].cpu(), spmv_oracle, SPMV_RTOL, f"chunked_spmv ({name}) run phase by phase")
        rel_close(y2[:v], y_whole, SPMV_RTOL, f"chunked_spmv ({name}): the phases against the entry point's own call")
        split = dict(again=whole_s, h2d=h2d_s, pack=pack_s, x_windows=xwin_s, kernel=kernel_s, add_back=add_s,
                     outside=outside_s)
        phases.update({f"chunked_spmv_{name}_{k}_s": t for k, t in split.items()})
        log(f"chunked_spmv ({name}) again: {whole_s * 1e3:.3f} ms; phases in ms: "
            + ", ".join(f"{k} {t * 1e3:.3f}" for k, t in split.items() if k != "again"))
        # The device packing, byte-equal to the host oracle at full size.
        for part, got_p, want_p in zip(("src_l", "dst_l", "wts", "outside"), packed, spmv_packs[name]):
            got_np = got_p.cpu().numpy()
            check(got_np.dtype == want_p.dtype and got_np.shape == want_p.shape and got_np.tobytes() == want_p.tobytes(),
                  f"pack_windows_device ({name}) {part}: not byte-equal to pack_windows")
        log(f"pack_windows_device ({name}): byte-equal to the numpy pack_windows, (C, W_E) = {tuple(packed[0].shape)}")
        del s_t, d_t, w_t, packed, x_win, y_win, y2, y_whole
    check(spmv_packs["c"][3].size > 0, "call (c) must have out-of-window edges")

    for what, out, qkv, kw in (("qwen3-8b", qwen_out, qwen_qkv, dict(causal=True)),
                               ("gemma2-9b local", gemma_out, gemma_qkv, gemma_kw)):
        check(out.dtype == torch.bfloat16 and out.shape == qkv[0].shape and bool(torch.isfinite(out).all()),
              f"flash_attention ({what}): not a finite bf16 tensor of q's shape")
        want = flash_plain(fa.flash_attention_torch, qkv, kw)
        err = close(out, want, BF16_RTOL, BF16_ATOL, f"flash_attention ({what}) against the plain version")
        report["flash_attention"]["max_abs_err"] = max(report["flash_attention"]["max_abs_err"], err)
        log(f"flash_attention ({what}) {tuple(out.shape)}: max abs err {err:.3e} to the plain version "
            f"(run {FLASH_HEAD_GROUP} heads at a time), {tol_ratio(out, want, BF16_RTOL, BF16_ATOL):.3f} of the "
            f"limit {BF16_ATOL} + 2^-7·|plain|")
        if kw.get("window") is None and kw.get("softcap") is None:
            # A reading, not a gate: SDPA rounds P to bf16 once before P·V.
            sdpa = torch.nn.functional.scaled_dot_product_attention(*qkv, is_causal=True)
            log(f"SDPA ({what}): {tol_ratio(sdpa, want, BF16_RTOL, BF16_ATOL):.3f} of the same limit "
                f"(max abs err {float((sdpa.float() - want.float()).abs().max()):.3e}; a reading, not a check)")
            del sdpa
        del want
    check(dec_out.shape == (bh_dec, rep, hd) and bool(torch.isfinite(dec_out).all()), "decode: not finite")
    dec_plain = dec.merge_partials(*dec.decode_attention_partials_torch(
        dec_q, dec_k, dec_v, dec_len, scale=hd**-0.5, block_s=DECODE_BLOCK))[0]
    err = close(dec_out, dec_plain, DECODE_TOL, DECODE_TOL, "decode_attention (qwen3-8b) against the plain version")
    report["decode_attention"]["max_abs_err"] = max(report["decode_attention"]["max_abs_err"], err)
    log(f"decode_attention (qwen3-8b) q {tuple(dec_q.shape)} cache {tuple(dec_k.shape)} bf16, cache_len "
        f"{int(dec_len.min())}..{int(dec_len.max())}: max abs err {err:.3e} to the plain version, limit {DECODE_TOL}")
    del spmv_out, qwen_out, gemma_out, dec_out, dec_plain
    torch.cuda.empty_cache()

    # ------------------------------------------- path 3: the stream at full width
    # span_repair="device" takes the host mirror's decision, so no objective
    # runs on the card and no kernel of the port launches: the path's device
    # work is torch ops (scatter, gather, label propagation, sorts).
    reset_launches()
    t0 = time.perf_counter()
    stream_read = stream_path(g, src, dst, dev, phases)
    torch.cuda.synchronize()
    phases["stream_path_s"] = time.perf_counter() - t0
    stream_launches = read_launches()
    check(stream_launches == dict.fromkeys(KERNELS, 0), f"stream path launched {stream_launches}, expected none")
    log(f"stream path: {phases['stream_path_s']:.3f} s, launches {stream_launches}")
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------- path 4: the rungs with their selection on the card
    reset_launches()
    t0 = time.perf_counter()
    rungs_read = rungs_path(dev, phases, segment_rf)
    torch.cuda.synchronize()
    phases["rungs_path_s"] = time.perf_counter() - t0
    rungs_launches = read_launches()
    check(rungs_launches == {**dict.fromkeys(KERNELS, 0), "segment_rf": 2 * rungs_read["selections"],
                             "full_reorder": len(rungs_read["greedy"])},
          f"rungs path launched {rungs_launches}, expected segment_rf twice per selection, the greedy kernel once "
          f"per device greedy, and nothing else")
    log(f"rungs path: {phases['rungs_path_s']:.3f} s, launches {rungs_launches}")
    rungs_rf = rungs_read.pop("segment_rf")
    report["segment_rf"]["max_abs_err"] = max(report["segment_rf"]["max_abs_err"], rungs_rf["max_abs_err"])
    reset_launches()
    t0 = time.perf_counter()
    stream_twins = twin_times(dev, stream_read.pop("span"), rungs_read.pop("slots"), segment_rf)
    phases["twins_s"] = time.perf_counter() - t0
    twin_launches = read_launches()
    check(twin_launches["full_reorder"] >= 4, f"the twin phase launched the greedy kernel {twin_launches['full_reorder']} "
                                              f"times, expected at least 4")
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------- path 5: the main path over several ranks
    # (a) g = 4 over gloo, 2 processes x 2 ranks, every rank on the one card;
    # (b) one rank over NCCL on the same card.
    multirank_read = {
        "g4_gloo_1card": run_multirank(*g4_gloo),
        "g1_nccl": run_multirank("g1_nccl", "nccl", 1, 1, ["cuda:0"], MULTIRANK_STEPS_ONE),
    }
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------- path 6: the streaming engine over several ranks
    # (a) and (b) over g = 4 gloo ranks, 2 processes x 2, every rank on the one card.
    g14 = rungs_read.pop("graph")
    streamrank_read = {
        "a": run_streamrank("a_g4_gloo_1card", "gloo", ["cuda:0"] * 4, STREAMRANK_A, ordered_npz, v),
        "b": run_streamrank("b_g4_gloo_1card", "gloo", ["cuda:0"] * 4, STREAMRANK_B, streamrank_inputs(g14),
                            g14[0].num_vertices),
    }
    del g14
    check_streamrank(streamrank_read)
    streamrank_rows = streamrank_read["b"].pop("rows")
    streamrank_read["a"].pop("rows", None)

    # ------------------------------------------------ kernel times vs bounds
    rows16 = ops.packed_rows(packs[16].edges, packs[16].mask)
    c, w = rows16.shape
    check(torch.equal(segment_rf.segment_distinct_counts(rows16), segment_rf.segment_distinct_counts_torch(rows16)),
          "segment_rf parity failed on the real k=16 rows")
    bytes_ms = (c * w * 4 + c * 4) / H100_BYTES_PER_S * 1e3
    ops_ms = 3 * c * w / H100_FP32_OPS_PER_S * 1e3
    report["segment_rf"].update(
        shape=[c, w], ms=graph_ms(lambda: segment_rf.segment_distinct_counts(rows16), 50),
        wrapper_ms=cuda_ms(lambda: segment_rf.segment_distinct_counts(rows16), 50),
        plain_ms=cuda_ms(lambda: segment_rf.segment_distinct_counts_torch(rows16), 20),
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=None,
        other_shapes=[stream_twins.pop("segment_rf_rows"), rows_timing(rungs_rf.pop("widest"), segment_rf)],
        rungs_shapes=rungs_rf["shapes"])
    # Path 5's per-rank rows: rank 0 of 4 holds partitions 0, 4, 8 and 12 of the k = 16 pack.
    rank0 = ops.packed_rows(packs[16].edges[0::4].contiguous(), packs[16].mask[0::4].contiguous())
    check(torch.equal(segment_rf.segment_distinct_counts(rank0), segment_rf.segment_distinct_counts_torch(rank0)),
          "segment_rf parity failed on path 5's rank-0 rows")
    report["segment_rf"]["multirank_rows"] = rows_timing(rank0, segment_rf)
    del rows16, rank0
    # Path 6 (b)'s rows on rank 0: the narrowest (a gathered span's sorted
    # keys) and the widest (the full snapshot's) it counted.
    report["segment_rf"]["streamrank_rows"] = {}
    for name, rows_np in streamrank_rows.items():
        rows = torch.from_numpy(rows_np).to(dev)
        check(torch.equal(segment_rf.segment_distinct_counts(rows), segment_rf.segment_distinct_counts_torch(rows)),
              f"segment_rf parity failed on path 6 (b)'s {name} rows")
        report["segment_rf"]["streamrank_rows"][name] = rows_timing(rows, segment_rf)
        t = report["segment_rf"]["streamrank_rows"][name]
        log(f"segment_rf at path 6 (b)'s {name} rows {t['shape']}: {t['ms']:.4f} ms on the card, "
            f"{t['wrapper_ms']:.4f} ms a wrapper call, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
        del rows

    spmv_times = []
    for name, (bounds, starts, size) in spmv_calls.items():
        src_l, dst_l, wts, _ = spmv_packs.pop(name)
        args_t = [torch.from_numpy(a).to(dev) for a in (src_l, dst_l, wts)]
        x_pad = torch.cat([x_pr, x_pr.new_zeros(size)])
        x_win = x_pad.unfold(0, size, 1)[torch.tensor(starts, device=dev)]
        got = edge_spmv.spmv_blocked(*args_t, x_win)
        want = edge_spmv.spmv_blocked_torch(*args_t, x_win)
        rel = rel_close(got, want, SPMV_RTOL, f"edge_spmv ({name}) against the plain version")
        report["edge_spmv"]["max_abs_err"] = max(report["edge_spmv"]["max_abs_err"], float((got - want).abs().max()))
        # The library yardstick: index_add_ of the precomputed products into
        # the flat output. It leaves out the gather of x, the product and the
        # padding filter, which the kernel does.
        valid = args_t[0] < size
        flat = (torch.arange(len(starts), device=dev)[:, None] * size + args_t[1])[valid]
        prod = (args_t[2] * x_win.gather(1, torch.where(valid, args_t[0], 0).long()))[valid]
        lib_ms = cuda_ms(lambda: torch.zeros(len(starts) * size, device=dev).index_add_(0, flat, prod), 20)
        c_, w_e = src_l.shape
        # Bytes the function must move: the two ids of every slot, the weight
        # of every valid slot only (a padding slot's weight adds nothing), the
        # (C, W_V) output, and of x_win only the entries the gather reads
        # (the distinct in-window src ids of each chunk).
        n_valid = int(valid.sum())
        gathered = int(torch.unique((torch.arange(c_, device=dev)[:, None] * size + args_t[0])[valid]).numel())
        spmv_bytes = 8 * c_ * w_e + 4 * n_valid + 4 * c_ * size + 4 * gathered
        ms = cuda_ms(lambda: edge_spmv.spmv_blocked(*args_t, x_win), 20)
        bound_ms = spmv_bytes / H100_BYTES_PER_S * 1e3
        spmv_times.append(dict(
            shape=[c_, w_e, size], ms=ms, plain_ms=cuda_ms(lambda: edge_spmv.spmv_blocked_torch(*args_t, x_win), 5),
            bound_ms=bound_ms, bound_by="bytes", bound_share=bound_ms / ms, library_ms=lib_ms, valid_slots=n_valid,
            x_read=gathered))
        log(f"edge_spmv ({name}) (C, W_E, W_V) = ({c_}, {w_e}, {size}): {ms:.4f} ms, plain "
            f"{spmv_times[-1]['plain_ms']:.4f} ms, index_add_ {lib_ms:.4f} ms ({lib_ms / ms:.3f}× the kernel's time), "
            f"bound {bound_ms:.4f} ms ({bound_ms / ms:.3f} of it; {spmv_bytes} B, {n_valid} valid slots, {gathered} "
            f"distinct x entries gathered); max rel diff to the plain version {rel:.3e}")
        del args_t, x_pad, x_win, got, want, valid, flat, prod
    report["edge_spmv"].update(spmv_times[0], other_shapes=spmv_times[1:])

    flash_times = []
    for what, qkv, kw in (("qwen3-8b", qwen_qkv, dict(causal=True)), ("gemma2-9b local", gemma_qkv, gemma_kw)):
        b, h, s, d = qkv[0].shape
        flops = 4 * b * h * d * visible_pairs(s, kw["causal"], kw.get("window"))
        bytes_ms = 4 * qkv[0].numel() * qkv[0].element_size() / H100_BYTES_PER_S * 1e3
        ops_ms = flops / H100_BF16_OPS_PER_S * 1e3
        lib_ms = None
        if kw.get("window") is None and kw.get("softcap") is None:
            lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*qkv, is_causal=True), 10)
        flash_times.append(dict(
            shape=[b, h, s, d], ms=cuda_ms(lambda: fa.flash_attention(*qkv, **kw), 10),
            plain_ms=cuda_ms(lambda: flash_plain(fa.flash_attention_torch, qkv, kw), 2),
            bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=lib_ms, gflop=flops / 1e9))
        ft = flash_times[-1]
        log(f"flash_attention ({what}) {ft['shape']}: {ft['ms']:.3f} ms, plain {ft['plain_ms']:.3f} ms, "
            f"SDPA {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound {ft['bound_ms']:.4f} ms "
            f"({ft['gflop']:.1f} GFLOP, {ft['gflop'] / ft['ms']:.2f} TFLOP/s achieved)")
    report["flash_attention"].update(flash_times[0], other_shapes=flash_times[1:])
    del qwen_qkv, gemma_qkv
    torch.cuda.empty_cache()

    row_bytes = hd * dec_k.element_size()
    valid = np.minimum(cache_np.astype(np.int64), DECODE_CACHE)
    dec_bytes = int(valid.sum()) * 2 * row_bytes  # K and V below cache_len
    dec_bytes += dec_q.numel() * dec_q.element_size() + bh_dec * rep * hd * 4 + bh_dec * 4
    # What the two kernels move: the split kernel reads q, cache_len and K/V
    # below cache_len (V of every key of a row with cache_len = 0) and writes
    # (o, m, l) of each split it runs; the combine reads those and writes out.
    splits_run = int(np.where(valid >= 1, -(-valid // dec.SPLIT), -(-DECODE_CACHE // dec.SPLIT)).sum())
    kv_read = int(np.where(valid >= 1, 2 * valid, DECODE_CACHE).sum()) * row_bytes
    partial_bytes = splits_run * rep * (hd + 2) * 4
    kernel_bytes = kv_read + dec_q.numel() * dec_q.element_size() + 2 * bh_dec * 4 + 2 * partial_bytes \
        + bh_dec * rep * hd * 4
    partials_kv_read = int((valid + DECODE_CACHE).sum()) * row_bytes  # the V of every tile, K below cache_len
    mask3 = torch.arange(DECODE_CACHE, device=dev)[None, None, :] < dec_len[:, None, None]
    q4, k4, v4 = dec_q[:, None], dec_k[:, None], dec_v[:, None]  # (64, 1, 4, 128) and (64, 1, 32768, 128)
    mask4 = mask3[:, None]  # (64, 1, 1, 32768) bool
    sdpa3 = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(dec_q, dec_k, dec_v, attn_mask=mask3), 20)
    sdpa4 = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask4), 20)
    ms = cuda_ms(lambda: dec.decode_attention(dec_q, dec_k, dec_v, dec_len, block_s=DECODE_BLOCK), 20)
    report["decode_attention"].update(
        shape=[bh_dec, rep, DECODE_CACHE, hd], ms=ms,
        plain_ms=cuda_ms(lambda: dec.merge_partials(*dec.decode_attention_partials_torch(
            dec_q, dec_k, dec_v, dec_len, scale=hd**-0.5, block_s=DECODE_BLOCK)), 3),
        bound_ms=dec_bytes / H100_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=min(sdpa3, sdpa4),
        sdpa_3d_mask_ms=sdpa3, sdpa_4d_bool_mask_ms=sdpa4, kernel_bytes=kernel_bytes,
        kernel_tb_per_s=kernel_bytes / (ms * 1e-3) / 1e12, splits_run=splits_run,
        partials_ms=cuda_ms(lambda: dec.decode_attention_partials(dec_q, dec_k, dec_v, dec_len, block_s=DECODE_BLOCK),
                            20),
        partials_kv_bytes=partials_kv_read)
    r = report["decode_attention"]
    log(f"decode_attention (qwen3-8b) {r['shape']}: {r['ms']:.4f} ms (split kernel + combine kernel), plain "
        f"{r['plain_ms']:.4f} ms, SDPA with a cache_len mask {sdpa3:.4f} ms (3-D, float mask) / {sdpa4:.4f} ms "
        f"(4-D, bool mask), bound {r['bound_ms']:.4f} ms ({dec_bytes / 1e9:.3f} GB below cache_len, "
        f"{r['bound_ms'] / r['ms']:.3f} of it); the kernels move {kernel_bytes} B ({kv_read} B of K/V, "
        f"{splits_run} splits of {dec.SPLIT} keys) at {r['kernel_tb_per_s']:.3f} TB/s; "
        f"partials entry point {r['partials_ms']:.4f} ms "
        f"({partials_kv_read} B of K/V: V of every tile)")
    del dec_q, dec_k, dec_v, mask3, mask4, q4, k4, v4

    greedy = stream_twins["greedy"]
    report["full_reorder"].update(
        shape=[greedy["slots"], greedy["vertices"]], ms=greedy["ms"], plain_ms=greedy["plain_ms"],
        bound_ms=greedy["bound_ms"], bound_by=greedy["bound_by"], library_ms=None,
        **{key: greedy[key] for key in ("steps", "us_per_step", "enqueue_ms", "order_ms", "mirror_ms", "walked")},
        wide=stream_twins["greedy_wide"])
    rs = report["segment_rf"]
    log(f"segment_rf at {rs['shape']}: {rs['ms']:.4f} ms on the card, {rs['wrapper_ms']:.4f} ms a wrapper call; "
        + "; ".join(f"{t['shape']}: {t['ms']:.4f} / {t['wrapper_ms']:.4f} ms"
                    for t in rs["other_shapes"] + [rs["multirank_rows"], *rs["streamrank_rows"].values()]))
    phases = {k: round(x, 6) for k, x in phases.items()}
    log(json.dumps({"phases": phases, "graph": {"scale": args.scale, "edge_factor": args.edge_factor,
                                                "num_vertices": v, "num_edges": n}}))
    sources = {
        "segment_rf": "src/repro/kernels/segment_rf.py:44",
        "edge_spmv": "src/repro/kernels/edge_spmv.py:52",
        "flash_attention": "src/repro/kernels/flash_attention.py:117",
        "decode_attention": "src/repro/kernels/decode_attention.py:76",
        "full_reorder": "src/repro/kernels/full_reorder.py:231",
    }
    launches = {**{k: n_ for k, n_ in slice1_launches.items() if n_}, **{k: n_ for k, n_ in slice2_launches.items() if n_},
                "full_reorder": rungs_launches["full_reorder"]}
    by_path = {"slice1": slice1_launches, "slice2": slice2_launches, "stream": stream_launches,
               "rungs": rungs_launches, "twins": twin_launches}
    for tag, read in multirank_read.items():  # path 5: each rank's own launches, counted from 0 in its process
        by_path[f"multirank_{tag}"] = {**dict.fromkeys(KERNELS, 0), "segment_rf": sum(read["segment_rf_launches"])}
        report["segment_rf"][f"multirank_{tag}_by_rank"] = read["segment_rf_launches"]
    for tag, read in streamrank_read.items():  # path 6: the same
        by_path[f"streamrank_{tag}"] = {**dict.fromkeys(KERNELS, 0), "segment_rf": sum(read["segment_rf_launches"]),
                                        "full_reorder": sum(read["greedy_launches"])}
        report["segment_rf"][f"streamrank_{tag}_by_rank"] = read["segment_rf_launches"]
        report["full_reorder"][f"streamrank_{tag}_by_rank"] = read["greedy_launches"]
    log(json.dumps({"stream": {**stream_read, **stream_twins}, "rungs": rungs_read}))
    log(json.dumps({"multirank": multirank_read}))
    log(json.dumps({"streamrank": streamrank_read}))
    kernels = []
    for name in KERNELS:
        r = report[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": sources[name],
            "launches": launches[name],
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "parity": "exact" if name in ("segment_rf", "full_reorder") else "allclose",
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": r["shape"],
            **({"tc_launches": slice2_tc} if name == "flash_attention" else {}),
            **({"merge_launches": slice2_merges} if name == "decode_attention" else {}),
            **{key: r[key] for key in ("wrapper_ms", "partials_ms", "sdpa_3d_mask_ms", "sdpa_4d_bool_mask_ms",
                                       "kernel_bytes", "kernel_tb_per_s", "steps", "us_per_step", "enqueue_ms",
                                       "order_ms", "mirror_ms", "walked", "wide") if key in r},
            **({"bound_share": r["bound_share"]} if "bound_share" in r else {}),
            **({"other_shapes": r["other_shapes"]} if "other_shapes" in r else {}),
            **({"rungs_shapes": r["rungs_shapes"]} if "rungs_shapes" in r else {}),
            **{key: r[key] for key in r if key.startswith(("multirank_", "streamrank_"))},
        })
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
