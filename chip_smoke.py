#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA GPU and check every result.

    python3 chip_smoke.py                 # RMAT scale 20, edge factor 16
    python3 chip_smoke.py --scale 14      # a quicker rehearsal of the graph path
    python3 chip_smoke.py --cards 4       # on four cards: slice 1, path 5 (a), (c), paths 6-9 (c) only

Phases, in order; any failure raises and the script exits nonzero:

1. the card's name and power limit (``nvidia-smi``);
2. the slice-1 graph's GEO order starts in a spawned, daemonic child process
   (the RMAT graph at ``--scale``, then ``geo_order`` on the host, 100-190 s
   at scale 20), which runs while phases 3-9 and paths 6 (b) and 8 (b) run
   here; the parent waits for it before slice 1;
3. build the seven CUDA kernels from ``src/repro_torch/kernels/csrc``
   (``segment_rf``, ``edge_spmv``, ``flash_attention``, ``decode_attention``,
   ``full_reorder``, the full rung's greedy, ``rescale_migrate``, a
   rescale's migration, ``min_sweep``, a sweep of SSSP or WCC),
   one ``nvcc`` per source, all started together; print each ``ptxas`` report;
   check with ``cuobjdump -sass`` that every bf16 (tensor-core) flash
   instantiation issues HGMMA;
4. the same RMAT graph in this process (the packs and the stream paths use it);
5. kernel parity, each kernel against its plain PyTorch version on the card:
   ``segment_rf`` exactly, at the main path's row shapes and at edge cases
   (rows not a multiple of 8, widths not a multiple of the tile, all-PAD
   rows, single-id rows, W = 1, a row wider than 65535 tiles);
   ``edge_spmv`` (atomics sum in a varying order), kernel and plain version
   each within the order-independent summation bound of the float64 sum
   (``within_summation_bound``), at the JAX tests' shapes, C = 1, W_E = 1,
   all-padding rows, ids past W_V, a hub row (one dst in every slot: one run
   across warps and blocks), alternating dst, sorted dst at an odd W_E, and
   more chunks than the grid has blocks, so that blocks stride over them;
   and exactly, bit for bit, at the hub row with integer weights and x in
   [-8, 8] (every partial sum exact in f32);
   ``rescale_migrate`` byte for byte, edges and mask, into blocks holding a
   sentinel (the receive ranges must keep it), at odd and even E_max, a
   single-row plan, padded rows with receive ranges, and views 8 bytes off a
   16-byte boundary;
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
6. path 10, the LM harness's forward pass (``repro_torch.models``), with
   every launch count set to 0 just before it (it launches none of the
   kernels: the reference's models compute attention in jnp, and the port's
   in torch ops): (a) ``examples/serve_decode.py``'s loop on gemma3-4b at
   full width in bf16 (random weights from a seed): ``forward_train``'s CE
   within 2 of ln V, 8 prompts of 2,048 tokens, a prefill and 64 greedy
   decode steps, their times beside their bounds (decode: the weights and
   the K/V the masks leave, over the card's memory rate; prefill: the
   matmuls at the bf16 rate and the attention at the float32 rate), tokens/s
   and peak memory; the first step's logits against a fresh prefill over
   prompt + first token in float32 within 1e-3, and in bf16 against the
   float32 forward on the same weights: the prefill within 6e-2, the first
   step within 1.1 times the prefill's distance, and the step against the
   fresh bf16 prefill below that distance;
   (b) deepseek-moe-16b, mamba2-1.3b, hymba-1.5b, whisper-small and
   phi-3-vision at full width and depth 2 in float32: CE near ln V, prefill
   against the full forward and decode against a fresh prefill within 1e-3
   (relative L2), MoE decode held for finiteness and its dropped entries
   printed (counted by a layer loop of the smoke's own, its logits held to
   the model's within 1e-3); (c) the 10 smoke configs in float32 against the committed JAX
   fixture ``tests/torch_lm_fixture.npz`` at rtol 1e-4, atol 1e-5;
   then path 11, LM training (``repro_torch.train``, ``launch/train.py``),
   its launch counts set to 0 just before it (it launches none of the
   kernels either): (a) gemma3-4b at full width in bf16, 3 AdamW steps of
   ``make_train_step`` with remat on 2 x 2,048 tokens of ``data/pipeline``,
   each step's forward + backward and AdamW timed by CUDA events beside the
   step's bound, tokens/s and peak memory; gates: finite losses, step 0's CE
   within 2 of ln V, the step counter at 3, float32 moments, bf16
   parameters, every parameter leaf moved; (b) ``launch/train.py``'s
   ``main`` on the card at the reference launcher's defaults (qwen2-1.5b's
   smoke config, batches of 16 x 128 over 4 hosts, a checkpoint every 50
   steps) but 300 steps: the mean of the last 10 losses below the mean of
   the first 5 less 1.0 (``tests/test_system.py:14``'s bar), and the step-50
   checkpoint restored at k = 3 and k = 4 into equal trees whose next-step
   losses equal each other and the launcher's own step 51; (c) one plain and
   one 2-microbatch step of each of the 10 smoke configs in float32 against
   the committed JAX fixture ``tests/torch_train_fixture.npz`` (the step's
   scalars at rtol 1e-5, each leaf's gradient L2 and projection at 1e-4);
   then path 12, the LM over ranks (``models/dist.py``,
   ``train/compression.py``, ``launch/dryrun.py``), its launch counts set to
   0 just before it (it launches none of the kernels; each rank's own
   counts must stay 0 too): four gloo ranks, one process each, on the one
   card; (a) sequence-parallel decode of gemma3-4b at full width in bf16 on
   a 2 x 2 ("data", "model") grid, path 10's prompts and 64 greedy steps
   over a cache of 3,072 split in two slices; gates: on the first two steps
   only the owner's slice changes, at the written position only, and every
   rank of model index 0 decodes its rows again on one rank, fed the same
   tokens, within 6e-2 relative L2 at every step (and in float32 at 6 layers
   within rtol and atol 5e-4); readings: prefill and decode ms, tokens/s,
   the all-gather's ms and bytes a step and peak memory, by rank; (b)
   compressed data-parallel gradients of qwen2-1.5b at depth 2 in float32
   on a 4 x 1 grid, 3 steps carrying the error; gates: the reduced
   gradients byte-equal across ranks, within 0.05 of the uncompressed mean,
   the new error exactly g - q·scale; (c) the dry run's plan of every cell,
   then one step of each cell whose plan fits one card (its run set equal to
   the plan's, every result finite), peak memory beside the plan's bytes;
7. path 9 (b), the reference's serving scenario (``benchmarks/bench_serve.py``
   at its defaults, as ``tests/torch_serve_harness.py`` builds it), with
   every launch count set to 0 just before it: RMAT scale 9, 4 regions, two
   days of 96 ticks with an ingest of 32 updates every tick, span
   ``differential`` and full ``device`` on the card, the autoscaler free in
   both directions, a probe every 8 ticks; gates: the trajectory (decisions,
   moved edges, served, shed, SLO misses, modeled p50 / p99, every record)
   equal to the committed ``tests/torch_serve_trajectory.json``, at least
   two scale-outs and two scale-ins with no flap pair, the pack
   bit-identical after every event, every ``segment_rf`` launch (two a span
   selection) exact and every greedy launch equal to the host mirror, each
   kernel launched, ``min_sweep`` once a sweep of the warm-up's and the
   probes' SSSP and WCC, each sweep exact. ``--cards 4`` runs (c): (b) on
   one rank, then over 4 NCCL ranks, a card each, every rank's trajectory
   equal to the committed one, each probe's answer to the one-rank run's,
   and ``min_sweep`` once a sweep on every rank;
8. path 4, the rungs with their selection on the card, at RMAT scale 14
   (8 regions, objective k in [4, 32]), with every launch count set to 0
   just before it: an engine in ``differential`` span and full mode and one
   in ``device`` full mode with two batches in flight, one rebuild aborted by
   a rescale and one committed, each event checked against ``pack_slots``;
   ``segment_rf`` must launch exactly twice per selection on the card, and
   the greedy kernel (``full_reorder``) in both engines, each launch tapped
   and held against the host mirror (permutation and step count).
   (its second part, the device programs alone, runs after path 9 (a));
9. path 8, the control plane, at path 4's size and rung settings (RMAT-14,
   8 regions, span ``differential``, full ``device`` with two batches in
   flight), with every launch count set to 0 just before it: (a) in this
   process, an ``ElasticController`` on an injected clock with a
   ``SlotCheckpoint`` and an autoscaler drives the engine: batches through
   ``ingest``, a host that stops heartbeating (``poll``: 8 -> 7 and a WAL
   scale barrier), a backlog (``autoscale``: 7 -> 9), the full rung forced
   and one more batch in flight; then the kill (the live slots kept, the
   controller, engine and orderer dropped, the card's memory freed), the
   restore from disk, ``from_restored``, ``report_failure`` (9 -> 8) and two
   batches in which both rungs fire again. Gates: the restored slots
   byte-equal to the live ones at the kill, the restored pack equal to
   ``pack_slots``, ``verify_bit_identity`` after every event, the event seqs
   and the JSONL round trip, the checkpoint counters, a valid Chrome trace,
   every ``segment_rf`` launch exact and every greedy launch equal to the
   host mirror, each kernel launched before and after the restore. Then
   path 6 (b) (item 15) and path 8 (b), the drill (item 17), which need no
   RMAT-20 order, run here before the wait;
10. slice 1, the graph path, with every launch count set to 0 just before it:
   CEP packs at k = 4, 8, 16, 64, 128 (RF and mirrors measured on the card,
   equal to the numpy oracle), rescale 16→17 and 8→12→8 with the
   from-scratch byte check, re-checked RF equal to the oracle, PageRank /
   SSSP / WCC on the packs at k = 17 and k = 4; ``segment_rf`` must launch
   once per pack and re-checked rescale, ``rescale_migrate`` once per
   rescale, ``min_sweep`` once per sweep of SSSP and WCC (each sweep tapped
   and held after the path against the plain version on the same inputs:
   nx bit for bit and the flags word), and no other kernel;
11. slice 2, the entry points of the other three kernels, with every launch
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
12. path 3, the streaming engine at full width, with every launch count set
   to 0 just before it: the slice-1 graph and GEO order in an
   ``IncrementalOrderer`` of 16 regions, a ``StreamingEngine`` on the card
   with device span repair, 3 batches of 1,024 ``SyntheticStream`` updates
   with a monitor after each (span repairs forced by ``partial_drift`` 1.0,
   the full rung held off; cut from 9 batches and two rescales: path 6 (a)
   scales in at full width, and path 9 (a) scales this engine out), the
   pack checked byte-equal to the host ``pack_slots`` oracle after the first
   batch, each span repair and the last batch, and PageRank on the live pack
   held against PageRank on the oracle pack; per batch the host apply and
   device scatter times, per repair the device program and host mirror
   times. No kernel of the port launches there. Then, on the same engine
   and with the counts set to 0 again, path 9 (a), serving at full width:
   the serve-only loop of ``launch/serve.py`` (``ServeLoop`` over an
   ``ElasticController`` of 16 hosts with an autoscaler, an open-loop
   workload whose burst on tick 8 passes 3 queued queries a host, a
   measured probe every tick, 16 ticks and the drain) until the autoscaler
   executes the rescale 16→20 through the compact gather, printed as path
   3's rescale line was (its parts and bytes); gates: exactly one scale
   event, the pack bit-identical after it, PageRank / SSSP / WCC on the live
   pack right after it equal to the answers on the pack the decision was
   taken on and to those on the ``pack_slots`` oracle (PageRank within
   rtol 1e-4, SSSP and WCC exactly with the same iteration counts); the
   probe times by kind and the modeled latencies are readings. Of the
   port's kernels only ``min_sweep`` launches there, once a sweep of the
   loop's and those queries' SSSP and WCC, the latter's sweeps each held at
   once against the plain version;
13. the rungs' device programs alone against their host mirrors, with the
   counts set to 0 again: the span order and selection on the worst span of
   path 3's engine after path 9 (a)'s rescale; the greedy kernel on path 4's
   slots (one CTA, beside its plain version's step loop on the card) and on
   an RMAT-16 graph's slots (a thread-block cluster), each with its cluster
   size and state branch beside its time a step;
14. path 5, the multi-rank main path on the slice-1 graph and GEO order (saved
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
   version on its rows, one ``rescale_migrate`` launch a rescale on every
   rank (3 in (a), 1 in (b)), and one ``min_sweep`` launch a sweep of SSSP
   and WCC, the first runs' each exact against the plain version on the
   rank's rows. Each app runs twice in each rank and the second run is
   its time (the first also loads the ops' kernels in that process).
   ``--cards 4`` runs slice 1 and then only (a) and (c): g = 4 over NCCL, one
   card per rank;
15. path 6 ((b) runs after path 8 (a), before the wait for the order), the
   streaming engine over the same 4 gloo ranks on the one card
   (``--stream-rank-worker``, started by ``launch_local_cluster``), each rank
   an orderer replica and a ``StreamingEngine`` over the group, its pack
   checked bit-identical to ``pack_slots`` after every event: (a) the slice-1
   graph at full width over 16 regions, device span repairs of 2 regions (the
   span crosses ranks, gathered to every rank), the full rung held off; a
   batch of 1,024 updates, a rescale 16→12 (the slots that change rank sent
   rank to rank) and ``from_restored`` on the ranks' orderers (its pack equal
   to the live one on every rank); (b)
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
16. path 7, the out-of-core pipeline (``--oc-worker``) over the same 4 gloo
   ranks on the one card: a stateless RMAT plan of scale 17 in 4 shards,
   each rank regenerating what it needs; (A) a stride-2 sample's locality
   rank, each rank's shards' chunk-load histogram summed by ``psum_host``,
   16 chunk splits; (B) the commit at k = 8 through
   ``pack_slots_sharded_stream``, one chunk materialized at a time and
   ordered on the card (``order_edge_block``, chunk mode "device": one launch
   of the greedy kernel a chunk); (C) rescales 8 -> 12 -> 8 re-checked
   through ``segment_rf``, one ``rescale_migrate`` launch each on every rank; (D) the spill-bounded ingest of 6 batches. The
   parent computes the in-core oracle with every chunk on the greedy's host
   mirror while the ranks run, and holds the reassembled commit byte-equal to
   it, each rank's greedy launches equal to its blocks inside the int32
   bound, the re-checked RF equal to the oracle's, the round trip and the
   k = 12 sequence, and the ranks' stream phases equal and within their
   resident bound; each chunk's greedy time, steps, cluster size and state
   branch, the
   bytes of the rescales, peak RSS by rank and the RF ratio to host
   ``geo_order`` are readings; the oracle orders its chunks, and takes the
   ``geo_order`` reading, in a pool of 4 spawned processes. ``--cards 4``
   runs (c): the same over NCCL, a card a rank;
17. path 8 (b) (run after path 6 (b), before the wait for the order), the
   SIGKILL drill of ``tests/torch_faults_harness.py`` on 4 gloo ranks on the
   one card (escalation parked, 12 batches of 1,024), process 1's ranks
   killed after batch 5, the lease board's detection within the lease + 2 s,
   recovery on 2 ranks from disk with ``report_failure`` 8 -> 4 across them;
   the restore point, the final slots and the reassembled final pack
   byte-equal to the no-failure host oracle, the two ranks' event logs
   equal. ``--cards 4`` runs (c): (b) over NCCL, a card a rank;
18. each kernel's time (CUDA events) beside its bound, the plain version's
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
   the rate it reaches; ``rescale_migrate`` at slice 1's three plans on the
   packs they ran on, beside one ``index_select`` of every new slot's edge
   over a cached gather map, each held byte-equal to the kernel's block;
   ``min_sweep`` on the k = 16 pack, WCC's first sweep and a sweep from
   SSSP's answer, on the card alone (a CUDA graph) and a wrapper call,
   beside its byte bound (``min_sweep.sweep_bytes``).

Output: phase lines, a ``{"stream": ..., "rungs": ...}`` JSON line of the
stream paths' readings, a ``{"multirank": ...}`` line of path 5's, a
``{"streamrank": ...}`` line of path 6's, an ``{"outofcore": ...}`` line of
path 7's, a ``{"control": ...}`` line of path 8's, a ``{"serve": ...}`` line
of path 9's, an ``{"lm": ...}`` line of path 10's, a ``{"train": ...}`` line
of path 11's, an ``{"lmrank": ...}`` line of path 12's, then the card line, one
``{"kernels": [...]}`` JSON line
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository's ``src/`` beside this file, it exits nonzero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import multiprocessing
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
KERNELS = ("segment_rf", "edge_spmv", "flash_attention", "decode_attention", "full_reorder", "rescale_migrate",
           "min_sweep")
PACK_KS = (4, 16, 64, 128)
ROW_KS = (4, 8, 12, 16, 17, 64, 128)  # every k whose rows the main path counts
PAGERANK_RTOL = 1e-4  # CUDA scatter-add uses atomics: f32 sums in varying order
# f32 sums in varying order (atomics): the entry point against a float64
# oracle. The kernel and its plain version are each held to the
# order-independent bound of ``within_summation_bound`` instead.
SPMV_RTOL = 1e-4
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
# rescale_migrate's parity cases, (|E|, k_old, k_new, g, rank, offset of the
# old view in edges, of the new one): E_max at k_new odd (every other row 8
# bytes off a 16-byte boundary, so segments' source and destination
# parities differ) and even; a single-row plan; padded rows (k_new not a
# multiple of g) with receive ranges; views 8 bytes off a 16-byte boundary;
# more partitions than edges.
MIGRATE_PARITY = [(100_003, 16, 17, 1, 0, 0, 0), (100_000, 8, 12, 1, 0, 0, 0), (100_000, 12, 8, 1, 0, 0, 0),
                  (99_999, 5, 1, 1, 0, 0, 0), (100_003, 7, 5, 4, 1, 0, 0), (100_003, 6, 9, 4, 3, 0, 0),
                  (100_003, 16, 17, 1, 0, 1, 0), (100_003, 16, 17, 1, 0, 0, 1), (100_001, 3, 7, 2, 1, 1, 1),
                  (13, 2, 18, 1, 0, 0, 0)]
# Path 3, the stream at full width: the slice-1 graph over 16 regions (span
# repairs forced by partial_drift 1.0, the full rung held off by full_drift 99),
# 3 batches of 1,024 updates, cut from 9 batches and rescales 16→20, 20→12 to
# make room for path 6, whose (a) scales in at full width over four ranks: a
# batch costs 13–22 s of host time at RMAT-20 (apply, span mirror, two oracle
# checks), a rescale about 50 s of host re-layout. 4 batches took the smoke
# past 900 s. Its rescale 16→20 runs in path 9 (a), on the same engine, where
# the autoscaler executes it.
STREAM_REGIONS, STREAM_BATCH, STREAM_BATCHES = 16, 1024, 3
# Path 9 (a), serving at full width on path 3's engine (the serve-only loop of
# launch/serve.py: no ingest, which path 3 covers at this width): 16 hosts
# retire 32 queries a tick; the workload sends 18-30 a tick (base 24, jitter
# 0.25, no diurnal swing) and 6x that on tick 8, so the backlog's EMA passes
# 3 a host x 16 there and the autoscaler scales 16 -> 20 once (the out-cooldown
# holds the burst of tick 16, k_max 20 would; no ingest, so no wall sample, so
# no scale-in). A probe every tick.
SERVE_TICKS, SERVE_K_MAX = 16, 20
SERVE_WORKLOAD = dict(base_rate=24.0, day_ticks=SERVE_TICKS, diurnal_amp=0.0, burst_every=8, burst_factor=6.0, seed=0)
SERVE_POLICY = dict(k_min=STREAM_REGIONS, k_max=SERVE_K_MAX, step_out=SERVE_K_MAX - STREAM_REGIONS,
                    queue_high_per_host=3.0, queue_low=0.5, ema=0.6, out_cooldown_s=1e6, in_cooldown_s=1e6)
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
# the full rung held off: a batch, 16→12 and the restore (cut from 3 batches
# before the restore, and then from the batch after it: a batch costs 20–27 s
# a rank there, four ranks sharing the host; 3 took the smoke past 900 s, and
# path 8 drives an engine restored from disk through batches). (b) path 4's
# graph and rung settings, both rungs in differential mode: one rebuild
# committed and one aborted by a rescale 8→10.
STREAMRANK_A = dict(regions=16, batch=STREAM_BATCH, seed=0, span_repair="device", full_rebuild="host", flight=0,
                    config=dict(partial_drift=1.0, full_drift=99.0, span_regions=2),
                    steps=["batch", 12, "restore"])
STREAMRANK_B = dict(regions=RUNGS_REGIONS, batch=RUNGS_BATCH, seed=3, span_repair="differential",
                    full_rebuild="differential", flight=1,
                    config=dict(partial_drift=1.0, full_drift=99.0, span_regions=2, k_min=4, k_max=RUNGS_K_MAX),
                    steps=["batch", "force", "batch", "force", RUNGS_REGIONS + 2, "batch", "batch"])
STREAMRANK_TIMEOUT_S = 900.0
# Path 7, the out-of-core pipeline: the JAX package's harness
# (tests/outofcore_harness.py) at a larger scale, with every chunk ordered on
# the card (chunk mode "device"): a stateless RMAT plan of scale 17, edge
# factor 16 (2,096,989 candidate edges), 4 shards, a stride-2 locality sample,
# chunks of at most 2**17 edges (16 chunks), no seam repair, packs at k = 8
# and rescales 8 -> 12 -> 8, then the spill-bounded stream of
# tests/torch_outofcore_harness.py (6 batches of 256 inserts, 64 regions of
# 128 slots, 8 resident). Cut from the JAX package's benchmark scale 19,
# edge factor 17 (benchmarks/bench_outofcore.py) for the smoke's time limit;
# that benchmark's 2**20-edge chunks would break the greedy's int32 priority
# bound, so its device mode would order every chunk on the host and launch no
# kernel. Here every chunk fits the bound at k in [4, 128].
OC_PLAN = dict(scale=17, edge_factor=16, seed=0, num_shards=4)
OC_CFG = dict(num_chunks=4, max_chunk_edges=1 << 17, seam_window=0, seed=0, chunk_mode="device")
OC_STRIDE, OC_RF_KS = 2, (4, 8, 16, 32, 64, 128)
OC_TIMEOUT_S = 600.0
# The parent's in-core oracle orders its 16 chunk mirrors, and takes its
# geo_order RF reading, in a pool of spawned processes (the parent holds a
# CUDA context, so it does not fork) beside the 4 ranks.
OC_ORACLE_WORKERS = 4
# Path 8, the control plane on the card, at path 4's size (RMAT-14, 8 regions,
# objective k in [4, 32], span "differential", full "device" with two batches
# in flight): the reference measures recovery at RMAT-12 (BENCH_recovery.json);
# RMAT-20 would break the greedy's int32 bound (no kernel would run) and its
# checkpoint of about 500 MB would take about 50 s a rank to restore. (a) one
# rank in this process: an ElasticController with a SlotCheckpoint (a
# snapshot every CONTROL_INTERVAL batches) and an autoscaler, a host lost to
# poll (8 -> 7), a backlog scale-out (7 -> 9), the full rung forced and one
# batch in flight, the kill, the restore from disk, a reported failure (9 ->
# 8) and CONTROL_AFTER batches after it. (b) tests/torch_faults_harness.py's
# drill on 4 gloo ranks on the one card: 8 regions, escalation parked,
# process 1's ranks SIGKILLed after batch 5 of 12, recovery on 2 ranks
# (8 -> 4); a snapshot every 4 batches, so the restore replays a WAL tail.
# (c) with --cards 4: (b) over NCCL, a card a rank.
CONTROL_INTERVAL, CONTROL_AFTER = 3, 2
# Path 10, the LM harness's forward pass (models/, configs/). (a)
# examples/serve_decode.py's loop on gemma3-4b at full width in bf16: 8
# prompts of 2,048 tokens (past the 1,024-token window of the local layers),
# a prefill, 64 greedy decode steps. The cache holds 3,072 positions: there
# the reference's halving cuts the key axis into three 1,024-wide blocks,
# where 2,112 (prompt and steps) would give 33 blocks of 64. Its first decode
# step is held against a fresh prefill over prompt + first token, in
# float32 within LM_DEPTH2_RTOL. In bf16, over 34 layers, rounding moves the
# logits by about 4.4e-2 from a float32 forward on the same weights, and two
# bf16 runs of other shapes by about 3.4e-2 from each other, so bf16 is held
# to the float32 forward: the prefill within LM_BF16_RTOL, the first decode
# step within LM_BF16_DECODE_SHARE times the prefill's distance, and the
# step against the fresh bf16 prefill below that distance. (b) the families
# (a) does not cover, at full width and depth 2, in float32 (TF32 off): 2
# prompts of 1,024 tokens, a cache of 2,048. (c) the 10 smoke configs in
# float32 against the committed fixture of the JAX package's outputs.
LM_ARCH = "gemma3-4b"
LM_BATCH, LM_PROMPT, LM_STEPS, LM_MAX_LEN = 8, 2048, 64, 3072
LM_CE_SLACK = 2.0  # |CE - ln V| at random init, as tests/test_models_smoke.py
LM_DEPTH2 = ("deepseek-moe-16b", "mamba2-1.3b", "hymba-1.5b", "whisper-small", "phi-3-vision-4.2b")
LM_DEPTH2_BATCH, LM_DEPTH2_PROMPT, LM_DEPTH2_MAX_LEN = 2, 1024, 2048
LM_DEPTH2_RTOL = 1e-3  # float32, relative L2; also (a)'s float32 decode against a fresh prefill
LM_FIXTURE_RTOL, LM_FIXTURE_ATOL = 1e-4, 1e-5  # the CPU parity tests' tolerance
LM_BF16_RTOL = 6e-2  # (a) bf16 prefill against float32, relative L2 (4.371e-2 read on the H100)
LM_BF16_DECODE_SHARE = 1.1  # (a) bf16 decode's distance from float32 over the prefill's (1.017 read)
# Path 11, LM training (train/, launch/train.py). (a) gemma3-4b at full width
# in bf16, path 10 (a)'s weights: 3 steps of make_train_step with remat, one
# microbatch, each on data/pipeline's global batch of 2 x 2,048 tokens. The
# schedule starts at its peak (warmup 1): the parameters are bf16 with no
# float32 master copy, as in the reference, and the default warmup's first
# rate, 3e-6, is below half a bf16 ulp of every weight of magnitude above
# 1e-3, so it would move almost none. (b) launch/train.py's main at its
# defaults but 300 steps, held to the bar of tests/test_system.py:14: at the
# default 100 its schedule is all warmup (100 steps) and the loss falls by
# about 0.6. (c) the 10 smoke configs against the committed JAX fixture.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
TRAIN_OPT = dict(warmup_steps=1)
TRAIN_LAUNCH_STEPS = 300
TRAIN_LEARN_MARGIN = 1.0  # tests/test_system.py:28: mean(last 10) < mean(first 5) - 1.0
TRAIN_SAMPLE = 4096  # elements a leaf kept to see it move
# Path 12, the LM over ranks (models/dist.py, train/compression.py,
# launch/dryrun.py): four gloo ranks, one process each, on the one card (NCCL
# refuses two ranks of one communicator on one device). (a) sequence-parallel
# decode on a 2 x 2 ("data", "model") grid: gemma3-4b at full width in bf16,
# path 10's seeded weights regenerated on every rank, path 10's 8 prompts of
# 2,048 tokens (4 a data index), a cache of 3,072 split into two slices of
# 1,536, 64 greedy steps. Each rank of model index 0 decodes its rows again
# on one rank (no distribution, a whole cache), fed the same tokens, and its
# SP logits are held to that within LM_BF16_RTOL (relative L2) at every step;
# the same in float32 at one cycle of SP_F32_LAYERS layers over SP_F32_STEPS
# steps within SP_F32_TOL. (b) compressed data-parallel gradients on a 4 x 1
# grid: qwen2-1.5b at its published widths, depth cut to DP_LAYERS, float32,
# DP_ROWS x DP_SEQ tokens a rank from data/pipeline's host shards, DP_STEPS
# steps carrying the error. (c) the dry run's plan for every cell, then
# --run of the cells whose plan fits one card.
SP_GRID = (2, 2)
SP_WRITE_STEPS = 2  # the first decode steps' cache writes checked slice by slice
SP_F32_LAYERS, SP_F32_STEPS = 6, 4  # one cycle of gemma3-4b's 5 local layers and 1 global
SP_F32_TOL = 5e-4  # rtol and atol, tests/test_multidevice.py:120
DP_ARCH, DP_LAYERS, DP_ROWS, DP_SEQ, DP_STEPS = "qwen2-1.5b", 2, 4, 512, 3
DP_REL_BOUND = 0.05  # tests/test_multidevice.py:146
LMRANK_RANKS = 4
LMRANK_GROUP_TIMEOUT_S = 300.0
LMRANK_TIMEOUT_S = 900.0
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


def spmv_sums64(src, dst, w, x) -> tuple:
    """Per flat element of ``edge_spmv``'s ``(C, W_V)`` output: the float64
    sum of the float64 products that reach it, the sum of their magnitudes,
    and their count, on the tensors' device. (The float64 additions run in
    any order too; their error, n·2⁻⁵³ of the magnitudes, is 2⁻²⁹ of the
    bound below.)"""
    c, wv = x.shape
    rows = torch.arange(c, device=x.device)[:, None].expand_as(src)
    ok = (src >= 0) & (src < wv) & (dst >= 0) & (dst < wv)
    flat = (rows * wv + dst.long())[ok]
    prod = w.double()[ok] * x.double()[rows[ok], src.long()[ok]]
    exact = torch.zeros(c * wv, dtype=torch.float64, device=x.device).index_add_(0, flat, prod)
    mag = torch.zeros_like(exact).index_add_(0, flat, prod.abs())
    n = torch.zeros_like(exact).index_add_(0, flat, torch.ones_like(prod))
    return exact, mag, n


def within_summation_bound(got, plain, src, dst, w, x, what: str) -> float:
    """Assert that the kernel's ``got`` and the plain version's ``plain``
    each lie within n·2⁻²⁴·Σ|wᵢxᵢ|·(1 + n·2⁻²⁴) + 1e-30 of the float64 sum
    of the same terms, element by element, and so within twice that of each
    other: (n − 1) roundings of the f32 additions in any order and one of
    each f32 product, n the terms that reach the element (the bound of
    ``tests/test_torch_cuda.py _assert_within_summation_bound``). Returns the
    kernel's largest error as a share of its bound."""
    exact, mag, n = spmv_sums64(src, dst, w, x)
    u = 2.0**-24
    bound = n * u * mag * (1 + n * u) + 1e-30
    ratios = [float(((t.double().reshape(-1) - exact).abs() / bound).max()) for t in (got, plain)]
    between = float(((got.double() - plain.double()).reshape(-1).abs() / (2 * bound)).max())
    check(max(ratios) <= 1 and between <= 1,
          f"{what}: |err| / bound {ratios[0]:.3f} (kernel), {ratios[1]:.3f} (plain), kernel against plain "
          f"{between:.3f} of twice the bound, at n up to {int(n.max())}")
    return ratios[0]


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


@contextlib.contextmanager
def sweeps_tapped(MS, tapped: list, at_once: bool):
    """Inside the block, ``MS.min_sweep`` (``graphs/engine.py`` looks it up at
    each sweep) calls the kernel's wrapper unchanged and keeps each sweep on a
    card. ``at_once``: each is held at once by ``sweep_exact`` (for packs that
    change later); else device copies of x, nx and the flags are kept, with
    the pack by reference, and ``sweep_exact`` holds them after the run (no
    host read during it)."""
    kernel = MS.min_sweep

    def tap(edges, mask, x, step):
        nx, flags = kernel(edges, mask, x, step)
        if x.is_cuda:
            rec = dict(edges=edges, mask=mask, x=x.clone(), step=step, nx=nx.clone(), flags=flags.clone())
            tapped.append(sweep_exact(MS, rec) if at_once else rec)
        return nx, flags

    MS.min_sweep = tap
    yield  # a failure inside ends the run: nothing to restore then
    MS.min_sweep = kernel


def sweep_exact(MS, rec: dict) -> dict:
    """One tapped sweep against ``MS.min_sweep_torch`` on the same inputs: nx
    bit for bit and the whole flags word (no out-of-range bit)."""
    want, want_flag = MS.min_sweep_torch(rec["edges"], rec["mask"], rec["x"], rec["step"])
    flags = int(rec["flags"])
    exact = torch.equal(rec["nx"].view(torch.int32), want.view(torch.int32)) and flags == int(want_flag)
    return dict(shape=list(rec["edges"].shape[:2]), step=rec["step"], changed=bool(flags & MS.CHANGED),
                exact=bool(exact))


def sweep_timing(MS, edges, mask, x, step: float) -> dict:
    """``min_sweep`` on one pack from the state ``x``: on the card alone (a CUDA
    graph: the x-to-nx copy, the flag's zeroing and the launch), a wrapper
    call, the plain version, beside the byte bound; held exact first."""
    rec = dict(edges=edges, mask=mask, x=x, step=step)
    rec["nx"], rec["flags"] = MS.min_sweep(edges, mask, x, step)
    held = sweep_exact(MS, rec)
    check(held["exact"], f"min_sweep at {held['shape']}, step {step}: differs from the plain version")
    slots, v = edges.shape[0] * edges.shape[1], x.numel()
    bound_ms = MS.sweep_bytes(slots, v) / H100_BYTES_PER_S * 1e3
    ms = graph_ms(lambda: MS.min_sweep(edges, mask, x, step), 20)
    return dict(shape=[edges.shape[0], edges.shape[1], v], step=step, changed=held["changed"], ms=ms,
                wrapper_ms=cuda_ms(lambda: MS.min_sweep(edges, mask, x, step), 20),
                plain_ms=cuda_ms(lambda: MS.min_sweep_torch(edges, mask, x, step), 5), bound_ms=bound_ms,
                bound_by="bytes", bound_share=bound_ms / ms, library_ms=None, bytes=MS.sweep_bytes(slots, v))


def greedy_branch(FRK, nv: int, device=None) -> dict:
    """The greedy kernel's launch for ``nv`` vertices (``FRK.greedy_plan``):
    its CTAs and where the per-vertex state lies ("one CTA", "cluster",
    its distributed shared memory, or "global")."""
    cluster, global_bytes = FRK.greedy_plan(nv, device)
    return dict(cluster=cluster, branch="one CTA" if cluster == 1 else "global" if global_bytes else "cluster")


def greedy_against_mirror(FRK, rec: dict) -> dict:
    """One tapped greedy launch held against the host mirror on its inputs:
    the permutation its keys sort to and its step count, and the launch's
    cluster size and state branch."""
    u, v, valid, permpos = (rec[k].cpu().numpy() for k in ("u", "v", "valid", "permpos"))
    host, steps = FRK._full_order_host(u.astype(np.int64), v.astype(np.int64), valid, rec["nv"], *rec["params"],
                                       permpos.astype(np.int64))
    k = rec["keys"].cpu().numpy()
    perm = np.lexsort((np.arange(len(u)), k[3], k[2], k[1], k[0]))
    return dict(slots=int(len(u)), live=int(valid.sum()), steps=int(rec["steps"][0]), mirror_steps=int(steps),
                walked=int(rec["work"][0]), fallbacks=int(rec["work"][1]),
                **greedy_branch(FRK, rec["nv"], rec["u"].device),
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


def stream_path(g, src, dst, dev, phases: dict):
    """Path 3: the streaming engine on the slice-1 graph and GEO order at full
    width. Every ingest and span repair runs on ``dev``; the pack is checked
    against the host ``pack_slots`` oracle after the first batch, each span
    repair and the last batch. Returns readings and the engine, which path 9
    (a) serves from."""
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
    log(f"stream: {STREAM_BATCHES} batches of {STREAM_BATCH} updates (cut from 9 batches and rescales 16->20, "
        f"20->12 for the run's time: a batch's host apply, span mirror and oracle checks take 13-22 s at RMAT-20, "
        f"a rescale's host re-layout about 50 s; path 6 (a) scales in at full width over four ranks, path 9 (a) "
        f"scales this engine out 16->20 under query load, and 4 batches took the smoke past 900 s; the graph is "
        f"not cut)")
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

    rows, repairs = [], []
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
    verify("the last batch")
    check(len(repairs) >= 3, f"stream: {len(repairs)} span repairs ran on the card, expected at least 3")
    check(eng.k == STREAM_REGIONS, f"stream: the engine holds {eng.k} regions, expected {STREAM_REGIONS}")
    pr_live = E.pagerank(eng.data, iterations=20)
    pr_oracle = E.pagerank(eng.oracle_pack(), iterations=20)
    check(bool(torch.isfinite(pr_live).all()), "stream: PageRank on the live pack is not finite")
    pr_rel = float(((pr_live - pr_oracle).abs() / pr_oracle.abs()).max())
    check(pr_rel <= PAGERANK_RTOL, f"stream: PageRank on the live pack differs from the oracle pack's by rel {pr_rel}")
    log(f"stream: PageRank on the live pack vs the uploaded pack_slots oracle: max rel diff {pr_rel:.3e} "
        f"(limit {PAGERANK_RTOL}); {len(checks)} bit-identity checks passed")
    return dict(batches=rows, span_repairs=repairs, checks=checks, pagerank_rel=pr_rel, edges=orderer.num_edges,
                slots=orderer.capacity), eng


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


def migrate_program(rescaler, n: int, k_old: int, k_new: int, g: int, rank: int, dev):
    """Rank ``rank`` of ``g``'s cached migration program on ``dev``: its
    table is built from the plan alone, so no process group is needed."""
    from repro_torch.core import cep
    from repro_torch.launch.mesh import GraphGroup, make_graph_group

    group = make_graph_group(dev) if g == 1 else GraphGroup(size=g, rank=rank, device=str(dev), backend="gloo",
                                                            processes=(0,) * g)
    return rescaler._program(n, k_old, k_new, cep.scale_plan(n, k_old, k_new), group, dev)


def migrate_parity(RM, old, prog, new_off: int, what: str) -> int:
    """``rescale_migrate``'s kernel and plain version on ``old`` into blocks
    that hold a sentinel (-7), their views ``new_off`` edges past an
    allocation's start: byte-equal, edges and mask, every slot but the
    receive ranges' edges written. Returns the slots left to the exchange."""
    t = prog.table
    outs = []
    for fn in (RM.migrate, RM.migrate_torch):
        e = torch.full((t.rows * t.width * 2 + 2 * new_off,), -7, dtype=torch.int32, device=old.device)
        m = torch.full((t.rows * t.width + new_off,), -7.0, device=old.device)
        outs.append(fn(old, t, out=(e[2 * new_off:].view(t.rows, t.width, 2), m[new_off:].view(t.rows, t.width))))
    torch.cuda.synchronize()
    left = sum(b - a for _, _, a, b, _ in prog.recvs)
    check(torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1]),
          f"{what}: the kernel's block is not byte-equal to the plain version's")
    check(int((outs[0][0] == -7).all(dim=2).sum()) == left and not bool((outs[0][1] == -7.0).any()),
          f"{what}: the kernel wrote a receive range, or left a slot outside them unwritten")
    return left


def migrate_timing(RM, prog, old) -> dict:
    """``rescale_migrate`` at one of slice 1's plans on the pack it ran on:
    held byte-equal to the plain version and to the library call; its time
    on the card alone (calls into one block, captured in a CUDA graph) and
    as a caller pays it (back-to-back wrapper calls, each allocating its
    block), the plain version's, and the time of one ``index_select`` of
    every new slot's edge from the old edges (a zero edge appended, the
    gather map cached: the edges alone, no mask). The bound counts the
    bytes the function must move: 8 read an edge copied, 12 written a slot."""
    t = prog.table
    got, want = RM.migrate(old, t), RM.migrate_torch(old, t)
    e_old = old.shape[1]
    zero = old.shape[0] * e_old  # the appended zero edge
    gather = np.full(t.rows * t.width, zero, dtype=np.int64)
    for row, a, b, src, a_old, _ in t.pieces.tolist():
        if src >= 0:
            gather[row * t.width + a:row * t.width + b] = np.arange(src * e_old + a_old, src * e_old + a_old + b - a)
    gather_t = torch.from_numpy(gather).to(old.device)
    flat = torch.cat([old.reshape(-1, 2), old.new_zeros((1, 2))])
    lib = flat.index_select(0, gather_t).view(t.rows, t.width, 2)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and torch.equal(lib, got[0]),
          f"rescale_migrate at {prog.stats.k_old}->{prog.stats.k_new}: the kernel, the plain version and "
          f"index_select disagree")
    copied = int(sum(b - a for _, a, b, src, *_ in t.pieces.tolist() if src >= 0))
    slots = t.rows * t.width
    moved = 8 * copied + 12 * slots
    bound_ms = moved / H100_BYTES_PER_S * 1e3
    ms = graph_ms(lambda: RM.migrate(old, t, out=got), 20)
    del want, lib
    return dict(shape=[t.rows, t.width], plan=[prog.stats.k_old, prog.stats.k_new], pieces=len(t.pieces),
                tiles=t.tiles, copy_ops=prog.stats.copy_ops, copied_edges=copied, bytes=moved, ms=ms,
                wrapper_ms=cuda_ms(lambda: RM.migrate(old, t), 20),
                plain_ms=cuda_ms(lambda: RM.migrate_torch(old, t), 10),
                library_ms=cuda_ms(lambda: flat.index_select(0, gather_t), 20), bound_ms=bound_ms,
                bound_by="bytes", bound_share=bound_ms / ms)


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
    mirror on the same slots: the span order and the span selection on the
    worst span of path 3's engine at 20 regions, after path 9 (a)'s rescale
    (full width); the greedy kernel on path 4's final
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
    r = dict(slots=int(u.shape[0]), live=n, vertices=nv, k=[k_min, k_max], **greedy_branch(FRK, nv, dev), steps=steps,
             ms=ms,
             us_per_step=ms / steps * 1e3, enqueue_ms=enqueue_ms, order_ms=order_ms, order_enqueue_ms=order_enqueue_ms,
             mirror_ms=mirror_ms, walked=walked, fallbacks=fallbacks, bytes=bytes_,
             bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    if plain:
        got, r["plain_ms"], r["plain_enqueue_ms"] = timed(
            lambda: FRK.full_order_device_torch(ut, vt, vd, nv, alpha, beta, delta, pt, steps=steps))
        check(np.array_equal(got.cpu().numpy(), host_perm), f"the plain greedy differs from its mirror at {what}")
    log(f"greedy kernel at {what} ({r['slots']} slots, {n} live, {nv} vertices, {steps} steps; {r['branch']}, "
        f"{r['cluster']} CTA{'s' if r['cluster'] > 1 else ''}): {ms:.3f} ms on the "
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
    from repro_torch.kernels import min_sweep, rescale_migrate, segment_rf
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
    rescale_migrate.launches = 0
    for name, base, k_new in cfg["rescales"]:
        sent0, recv0 = (reg.counter(f"rescale.{c}_bytes").value for c in ("sent", "received"))
        datas[name], st = rx.rescale(datas[base], k_new, verify=True)
        keep(name, datas[name])
        meta[name].update(stats=dataclasses.asdict(st), sent=reg.counter("rescale.sent_bytes").value - sent0,
                          received=reg.counter("rescale.received_bytes").value - recv0)
        print(f"rank {r}: rescale {name} in {st.elapsed_s * 1e3:.3f} ms, sent {meta[name]['sent']:.0f} B, "
              f"received {meta[name]['received']:.0f} B", flush=True)
    meta["rescale_migrate_launches"] = rescale_migrate.launches
    d = datas[cfg["apps_on"]]
    apps = dict(pagerank=lambda: E.pagerank(d, iterations=20), sssp=lambda: E.sssp(d, source=cfg["source"]),
                wcc=lambda: E.wcc(d))
    min_sweep.launches, sweeps = 0, []
    for app, fn in apps.items():  # twice: the first run in this process also loads the ops' kernels
        with sweeps_tapped(min_sweep, sweeps, at_once=False):  # the first run's sweeps, held after the apps
            _, meta[f"{app}_first_s"] = timed(fn)
        meta[f"{app}_result"], meta[f"{app}_s"] = timed(fn)
    meta["min_sweep_launches"] = min_sweep.launches
    meta["min_sweep_tapped"] = [sweep_exact(min_sweep, rec) for rec in sweeps]
    del sweeps
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
          f"segment_rf launched {meta['segment_rf_launches']} times, rescale_migrate "
          f"{meta['rescale_migrate_launches']}, min_sweep {meta['min_sweep_launches']}", flush=True)
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
    sent and received against the plan's cross-rank bytes, every rank's
    ``segment_rf`` launches exact against the plain version, and its
    ``min_sweep`` launches equal to its sweeps (SSSP's and WCC's iterations,
    each app run twice), those of the first runs each exact against the
    plain version on the rank's rows. Returns readings."""
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
        check(meta["rescale_migrate_launches"] == len(steps["rescales"]),
              f"path 5 ({tag}) rank {i}: rescale_migrate launched {meta['rescale_migrate_launches']} times for "
              f"{len(steps['rescales'])} rescales, each held byte-equal to a from-scratch pack (verify=True)")
        sweeps = meta["sssp_iterations"] + meta["wcc_iterations"]
        check(meta["min_sweep_launches"] == 2 * sweeps and len(meta["min_sweep_tapped"]) == sweeps
              and all(t["exact"] for t in meta["min_sweep_tapped"]),
              f"path 5 ({tag}) rank {i}: min_sweep launched {meta['min_sweep_launches']} times for twice {sweeps} "
              f"sweeps, {len(meta['min_sweep_tapped'])} tapped, exact {[t['exact'] for t in meta['min_sweep_tapped']]}")
        check(meta["snapshot_global"] == ranks[0][1]["snapshot_global"], f"path 5 ({tag}): global snapshots differ")
    glob = ranks[0][1]["snapshot_global"]
    total_cross = sum(ranks[0][1][name]["stats"]["cross_device_bytes"] for name, _, _ in steps["rescales"])
    check(glob["rescale.sent_bytes"] == glob["rescale.received_bytes"] == [total_cross],
          f"path 5 ({tag}): snapshot_global's sent/received bytes {glob['rescale.sent_bytes']} / "
          f"{glob['rescale.received_bytes']}, expected {total_cross}")
    out = dict(ranks=g, processes=n_procs, backend=backend, devices=devices, wall_s=wall, rescales={}, apps={},
               segment_rf_launches=[m["segment_rf_launches"] for _, m in ranks],
               segment_rf_shapes=[[t["shape"] for t in m["segment_rf_tapped"]] for _, m in ranks],
               rescale_migrate_launches=[m["rescale_migrate_launches"] for _, m in ranks],
               min_sweep_launches=[m["min_sweep_launches"] for _, m in ranks],
               min_sweep_shapes=sorted({tuple(t["shape"]) for _, m in ranks for t in m["min_sweep_tapped"]}))
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
        f"to slice 1's, SSSP and WCC equal; segment_rf launches by rank {out['segment_rf_launches']}, each exact; "
        f"rescale_migrate launches by rank {out['rescale_migrate_launches']}, one a rescale; min_sweep launches by "
        f"rank {out['min_sweep_launches']}, one a sweep, the first runs' each exact at {out['min_sweep_shapes']}")
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


def greedy_fits_block(FRK, block: np.ndarray, k_min: int, k_max: int) -> bool:
    """Whether ``order_edge_block`` in the device chunk mode sends this block
    to the greedy kernel: two rows or more, and the int32 priority bound of
    its compacted unique edges holds (else host ``geo_order`` orders it)."""
    if block.shape[0] <= 1:
        return False
    uniq = np.unique(block, axis=0)
    deg = np.bincount(np.searchsorted(np.unique(block), uniq).ravel())
    return FRK.greedy_fits_int32(uniq.shape[0], k_min, k_max, int(deg.max()))


def outofcore_worker(run_dir: pathlib.Path) -> int:
    """One rank of path 7 (``--oc-worker``, started by ``outofcore_path``
    through ``launch_local_cluster``): the phases of
    ``tests/torch_outofcore_harness.py`` at the run's plan, every chunk
    ordered on the rank's card. A: the sample, ``locality_rank``, this rank's
    shards' ``chunk_load``, ``psum_host``, ``chunk_splits``; B: the commit
    through ``pack_slots_sharded_stream``, one chunk materialized at a time;
    C: ``ElasticRescaler.execute`` 8 -> 12 -> 8, both re-checked through
    ``segment_rf``; D: the spill-bounded ingest through
    ``ElasticController.ingest``, its spill counters read off the last
    ``IngestEvent``. Every greedy launch is
    timed with CUDA events and every ``segment_rf`` launch tapped and held
    against the plain version afterwards. Writes ``rank{r}.npz`` (its row
    blocks) and ``rank{r}.json`` (readings)."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import torch.distributed as dist
    import torch_outofcore_harness as OH

    from repro_torch.core import cep
    from repro_torch.core import hier_order as HO
    from repro_torch.data import shards as DS
    from repro_torch.elastic.rescale_exec import ElasticRescaler
    from repro_torch.kernels import full_reorder as FRK
    from repro_torch.kernels import rescale_migrate, segment_rf
    from repro_torch.launch import multihost as MH
    from repro_torch.obs import metrics as OM

    cfg = json.loads((run_dir / "config.json").read_text())
    group = MH.initialize_from_env(timeout_s=cfg["timeout_s"])
    r, dev = group.rank, group.torch_device
    plan, hcfg = DS.RmatShardPlan(**cfg["plan"]), HO.HierConfig(**cfg["hier"])
    rf_kernel, rf_tapped = segment_rf.segment_distinct_counts, []

    def rf_tap(rows):
        counts = rf_kernel(rows)
        rf_tapped.append((rows.clone(), counts.clone()))
        return counts

    segment_rf.segment_distinct_counts = rf_tap  # ops looks it up at each call
    greedy_kernel, blocks, wall, rss = FRK.greedy_keys, [], {}, {}

    def greedy_tap(u, v, valid, nv, alpha, beta, delta, permpos):  # the launches of the block being ordered
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        keys, steps, work = greedy_kernel(u, v, valid, nv, alpha, beta, delta, permpos)
        end.record()
        blocks[-1]["runs"].append(dict(nv=int(nv), unique=int(u.shape[0]), events=(start, end), steps=steps))
        return keys, steps, work

    FRK.greedy_keys = greedy_tap  # full_order_device looks it up at each call

    def on_block(c, block):
        blocks.append(dict(chunk=int(c), rows=int(block.shape[0]), vertices=int(np.unique(block).shape[0]),
                           greedy=greedy_fits_block(FRK, block, hcfg.k_min, hcfg.k_max), runs=[]))

    def phase(name, fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        wall[name] = time.perf_counter() - t0
        rss[name] = OM.read_peak_rss()[1]
        print(f"rank {r} phase {name}: {wall[name]:.3f} s, peak RSS {rss[name]:.1f} MB", flush=True)
        return out

    rank, splits, sizes = phase("A", lambda: OH.rank_and_splits(group, plan, hcfg, cfg["stride"]))
    mat = OH.ChunkMaterializer(rank, splits, sizes, plan, hcfg, device=dev, on_block=on_block)
    data = phase("B", lambda: OH.commit_pack(mat, group, OH.K_PACK))
    arrays = dict(commit_edges=data.edges.cpu().numpy(), commit_mask=data.mask.cpu().numpy(),
                  commit_degrees=data.degrees.cpu().numpy())
    reg = OM.MetricsRegistry()
    rx, n = ElasticRescaler(metrics_registry=reg), data.num_edges
    rescales = []

    def rescale(d, k_new):
        sent0, recv0 = (reg.counter(f"rescale.{c}_bytes").value for c in ("sent", "received"))
        new, st = rx.execute(d, cep.scale_plan(n, d.k, k_new), recheck=True)
        rescales.append(dict(k_old=st.k_old, k_new=k_new, ms=st.elapsed_s * 1e3, recheck_s=st.recheck_s,
                             rf=new.replication_factor, mirrors=new.mirrors, migrated_edges=st.migrated_edges,
                             cross_device_edges=st.cross_device_edges,
                             sent=reg.counter("rescale.sent_bytes").value - sent0,
                             received=reg.counter("rescale.received_bytes").value - recv0))
        return new

    def phase_c():
        up = rescale(data, OH.K_UP)
        return up, rescale(up, OH.K_PACK)

    rescale_migrate.launches = 0
    up, back = phase("C", phase_c)
    migrations = rescale_migrate.launches
    arrays.update(up_edges=up.edges.cpu().numpy(), up_mask=up.mask.cpu().numpy(),
                  back_edges=back.edges.cpu().numpy(), back_mask=back.mask.cpu().numpy())
    stream = phase("D", lambda: OH.stream_phase(plan))
    segment_rf.segment_distinct_counts, FRK.greedy_keys = rf_kernel, greedy_kernel
    for b in blocks:
        runs = b.pop("runs")
        b["launches"] = len(runs)
        for run in runs:
            ms, steps = run["events"][0].elapsed_time(run["events"][1]), int(run["steps"][0])
            b.update(ms=ms, steps=steps, us_per_step=ms / steps * 1e3, unique=run["unique"],
                     **greedy_branch(FRK, run["nv"], dev))
    meta = dict(rank=r, device=str(dev), backend=group.backend, splits=[int(x) for x in splits], chunk_sizes=sizes,
                num_edges=int(data.num_edges), parts=data.local_partitions(), k_pad_up=up.k_pad, wall=wall,
                peak_rss_mb=rss, rss_field=OM.read_peak_rss()[0], blocks=blocks, rescales=rescales, stream=stream,
                greedy_launches=FRK.launches, segment_rf_launches=segment_rf.launches,
                rescale_migrate_launches=migrations,
                segment_rf_tapped=[dict(shape=list(rows.shape), exact=bool(torch.equal(
                    counts, segment_rf.segment_distinct_counts_torch(rows)))) for rows, counts in rf_tapped])
    dist.destroy_process_group()
    np.savez(run_dir / f"rank{r}.npz", **arrays)
    (run_dir / f"rank{r}.json").write_text(json.dumps(meta))
    print(f"rank {r}: chunks {[b['chunk'] for b in blocks]}, greedy kernel launched {meta['greedy_launches']} times "
          + ", ".join(f"chunk {b['chunk']} {b['ms']:.3f} ms ({b['steps']} steps, {b['us_per_step']:.2f} us a step, "
                      f"{b['vertices']} vertices, {b['branch']}, {b['cluster']} CTAs)" for b in blocks if "ms" in b)
          + f"; segment_rf {meta['segment_rf_launches']} times; rescale_migrate {migrations}; rescales "
          + ", ".join(f"{x['k_old']}->{x['k_new']} {x['ms']:.3f} ms, sent {x['sent']:.0f} B, received "
                      f"{x['received']:.0f} B" for x in rescales)
          + f"; stream {stream['num_edges']} edges, spills {stream['spill']['spills']}, faults "
            f"{stream['spill']['faults']}, resident {stream['resident']}", flush=True)
    return 0


def outofcore_oracle(plan_kw: dict, cfg_kw: dict, stride: int, k: int, pool):
    """Path 7's in-core oracle on the host, beside the running ranks: the whole
    edge list, ``hier_order_edges`` in the mirror chunk mode (the greedy's
    host mirror on every chunk), its chunks ordered in ``pool``
    (``pooled_mirror_order``, byte-equal to the serial call), and the slot
    pack at k; the ``geo_order`` RF reading is submitted to the same pool
    first. Returns the ordered list, the chunk splits and sizes, the pack's
    (edges, mask, degrees), the reading's future and the oracle's seconds."""
    import torch_outofcore_harness as OH

    from repro_torch.core import cep
    from repro_torch.core import hier_order as HO
    from repro_torch.data import shards as DS
    from repro_torch.graphs import engine as E

    t0 = time.perf_counter()
    plan = DS.RmatShardPlan(**plan_kw)
    edges = np.concatenate([DS.shard_edges(plan, s) for s in range(plan.num_shards)])
    geo = pool.submit(OH.geo_rf_by_k, edges, plan.num_vertices, OC_RF_KS)
    cfg = HO.HierConfig(**{**cfg_kw, "chunk_mode": "mirror"})
    ordered, info = OH.pooled_mirror_order(edges, plan.num_vertices, cfg, DS.sample_edges(plan, stride), pool)
    bounds = cep.chunk_bounds(ordered.shape[0], k)
    spr = int(np.diff(bounds).max())
    slots = [np.zeros(k * spr, dtype=np.int64), np.zeros(k * spr, dtype=np.int64), np.zeros(k * spr, dtype=bool)]
    for p in range(k):
        at = slice(p * spr, p * spr + int(bounds[p + 1] - bounds[p]))
        slots[0][at], slots[1][at], slots[2][at] = ordered[bounds[p]:bounds[p + 1], 0], \
            ordered[bounds[p]:bounds[p + 1], 1], True
    pack = E.host_pack_slots(*slots, k, plan.num_vertices)
    return ordered, info, pack, geo, time.perf_counter() - t0


def outofcore_path(tag: str, backend: str, devices: list) -> dict:
    """Path 7: the out-of-core pipeline over g = 4 ranks (2 processes x 2)
    started by the port's ``launch_local_cluster``, each on its entry of
    ``devices`` over ``backend``. While the ranks run, the parent computes the
    in-core oracle (``outofcore_oracle``, every chunk on the greedy's host
    mirror, in a pool of ``OC_ORACLE_WORKERS`` spawned processes). Gates:
    every rank derived the same splits and chunk sizes, equal to the
    oracle's; the commit, reassembled from the ranks' row blocks, is
    byte-equal to the oracle's pack at k = 8 (so every greedy launch equals the
    mirror on its chunk); each rank's greedy launches equal the blocks it
    ordered with two rows or more inside the int32 bound, at least one; each
    re-checked rescale's RF equals the oracle order's at its k, with
    ``segment_rf`` launched on every rank, each launch exact; 8 -> 12 -> 8
    returns every partition's live prefix; at k = 12 the prefixes concatenate
    to the oracle's order; the ranks' stream phases agree, resident <= 8.
    The worst RF ratio against host ``geo_order`` over k in ``OC_RF_KS`` is
    a reading. Returns readings."""
    import concurrent.futures
    import multiprocessing

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_outofcore_harness as OH

    from repro_torch.core import cep
    from repro_torch.core.metrics import replication_factor_ordered
    from repro_torch.launch import multihost as MH
    from repro_torch.launch import sharding as SH

    g = MULTIRANK_PROCS * MULTIRANK_DEVS
    run_dir = ROOT / "build" / "outofcore" / tag
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    (run_dir / "config.json").write_text(json.dumps(dict(plan=OC_PLAN, hier=OC_CFG, stride=OC_STRIDE,
                                                         timeout_s=MULTIRANK_GROUP_TIMEOUT_S)))
    t0 = time.perf_counter()
    cluster = MH.launch_local_cluster(MULTIRANK_PROCS, MULTIRANK_DEVS,
                                      [str(ROOT / "chip_smoke.py"), "--oc-worker", str(run_dir)],
                                      backend=backend, devices=devices,
                                      env_extra={"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"})
    with concurrent.futures.ProcessPoolExecutor(OC_ORACLE_WORKERS,
                                                mp_context=multiprocessing.get_context("spawn")) as pool:
        ordered, info, (want_e, want_m, want_deg), geo, oracle_s = outofcore_oracle(
            OC_PLAN, OC_CFG, OC_STRIDE, OH.K_PACK, pool)
        t1 = time.perf_counter()
        unique_edges, geo_rf = geo.result()
        geo_s = time.perf_counter() - t1  # what the reading adds after the oracle
    res = cluster.wait(OC_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for p in res.procs:
        for line in p.stdout.splitlines():
            log(f"path 7 ({tag}) {line}")
    check(res.ok, f"path 7 ({tag}): a rank failed\n{res.format_logs()}")
    ranks = [(dict(np.load(run_dir / f"rank{r}.npz")), json.loads((run_dir / f"rank{r}.json").read_text()))
             for r in range(g)]
    first = ranks[0][1]
    check(all((m["splits"], m["chunk_sizes"], m["num_edges"]) == (first["splits"], first["chunk_sizes"],
                                                                   first["num_edges"]) for _, m in ranks),
          f"path 7 ({tag}): the ranks derived different splits or chunk sizes")
    check(first["splits"] == info["splits"].tolist() and first["chunk_sizes"] == info["chunk_sizes"]
          and first["num_edges"] == ordered.shape[0], f"path 7 ({tag}): the ranks' splits differ from the oracle's")

    def whole(name, k):
        """Partition-major rows of the ranks' blocks, and whether the padding rows are empty."""
        e, m = (np.concatenate([a[f"{name}_{part}"] for a, _ in ranks]) for part in ("edges", "mask"))
        rows = [SH.partition_row(p, k, g) for p in range(k)]
        pad = np.setdiff1d(np.arange(e.shape[0]), rows)
        return e[rows], m[rows], not e[pad].any() and not m[pad].any()

    ce, cm, pad_ok = whole("commit", OH.K_PACK)
    check(ce.tobytes() == want_e.tobytes() and cm.tobytes() == want_m.tobytes() and pad_ok
          and all(a["commit_degrees"].tobytes() == want_deg.tobytes() for a, _ in ranks),
          f"path 7 ({tag}): the commit, reassembled, differs from the in-core mirror oracle's pack")
    rf_want = {k: replication_factor_ordered(ordered[:, 0], ordered[:, 1], k, 1 << OC_PLAN["scale"])
               for k in (OH.K_UP, OH.K_PACK)}
    for i, (_, m) in enumerate(ranks):
        fits = sum(b["greedy"] for b in m["blocks"])
        check(m["greedy_launches"] == fits >= 1 and all(b["launches"] == b["greedy"] for b in m["blocks"]),
              f"path 7 ({tag}) rank {i}: the greedy kernel launched {m['greedy_launches']} times "
              f"{[b['launches'] for b in m['blocks']]} for {fits} blocks inside its int32 bound "
              f"{[b['greedy'] for b in m['blocks']]}")
        check([(x["k_new"], x["rf"]) for x in m["rescales"]] == [(k, rf_want[k]) for k in (OH.K_UP, OH.K_PACK)],
              f"path 7 ({tag}) rank {i}: re-checked RF {[x['rf'] for x in m['rescales']]}, the oracle's {rf_want}")
        tapped = m["segment_rf_tapped"]
        check(m["segment_rf_launches"] == len(tapped) == 2 and all(t["exact"] for t in tapped),
              f"path 7 ({tag}) rank {i}: segment_rf launched {m['segment_rf_launches']} times, exact "
              f"{[t['exact'] for t in tapped]}")
        check(m["rescale_migrate_launches"] == len(m["rescales"]) == 2,
              f"path 7 ({tag}) rank {i}: rescale_migrate launched {m['rescale_migrate_launches']} times for "
              f"{len(m['rescales'])} rescales")
        s = m["stream"]
        check(s == first["stream"] and s["peak_resident"] <= OH.SPILL_RESIDENT and s["spill"]["spills"] > 0,
              f"path 7 ({tag}) rank {i}: stream phase {s}, rank 0's {first['stream']}")
    be, bm, pad_ok = whole("back", OH.K_PACK)
    for p in range(OH.K_PACK):
        n_live = int((want_m[p] > 0).sum())
        check(int((bm[p] > 0).sum()) == n_live and (bm[p][:n_live] > 0).all() and pad_ok
              and np.array_equal(be[p][:n_live], want_e[p][want_m[p] > 0]),
              f"path 7 ({tag}): partition {p} did not return to the commit after 8 -> 12 -> 8")
    ue, um, pad_ok = whole("up", OH.K_UP)
    sizes = np.diff(cep.chunk_bounds(ordered.shape[0], OH.K_UP))
    check(pad_ok and [int((x > 0).sum()) for x in um] == sizes.tolist()
          and np.array_equal(np.concatenate([e[x > 0] for e, x in zip(ue, um)]), ordered.astype(np.int32)),
          f"path 7 ({tag}): at k = {OH.K_UP} the partition prefixes differ from the oracle's order")
    for j, x in enumerate(first["rescales"]):
        sent, received = (sum(m["rescales"][j][c] for _, m in ranks) for c in ("sent", "received"))
        check(sent == received == x["cross_device_edges"] * 8,
              f"path 7 ({tag}): rescale {x['k_old']}->{x['k_new']} sent {sent} B, received {received} B")

    # The reading of quality: the hierarchical order's RF against host
    # geo_order of the deduplicated graph (duplicates ride in the order).
    v = 1 << OC_PLAN["scale"]
    ratios = {k: replication_factor_ordered(ordered[:, 0], ordered[:, 1], k, v) / geo_rf[k] for k in OC_RF_KS}
    out = dict(ranks=g, processes=MULTIRANK_PROCS, backend=backend, devices=devices, wall_s=wall, oracle_s=oracle_s,
               geo_reading_s=geo_s, num_edges=int(ordered.shape[0]), unique_edges=int(unique_edges),
               chunk_sizes=first["chunk_sizes"], rf_ratio_by_k=ratios, worst_rf_ratio=max(ratios.values()),
               wall_by_rank={ph: [m["wall"][ph] for _, m in ranks] for ph in "ABCD"},
               peak_rss_mb_by_rank=[max(m["peak_rss_mb"].values()) for _, m in ranks], rss_field=first["rss_field"],
               greedy_launches=[m["greedy_launches"] for _, m in ranks],
               segment_rf_launches=[m["segment_rf_launches"] for _, m in ranks],
               rescale_migrate_launches=[m["rescale_migrate_launches"] for _, m in ranks],
               chunks=[{k: b[k] for k in ("chunk", "rows", "unique", "vertices", "steps", "ms", "us_per_step", "branch",
                                          "cluster") if k in b} | {"rank": i}
                       for i, (_, m) in enumerate(ranks) for b in m["blocks"]],
               rescales=[dict(k_old=x["k_old"], k_new=x["k_new"], ms_by_rank=[m["rescales"][j]["ms"] for _, m in ranks],
                              sent_by_rank=[m["rescales"][j]["sent"] for _, m in ranks],
                              received_by_rank=[m["rescales"][j]["received"] for _, m in ranks], rf=x["rf"])
                         for j, x in enumerate(first["rescales"])],
               stream=first["stream"])
    log(f"path 7 ({tag}): {g} ranks over {backend} on {sorted(set(devices))}, {wall:.3f} s in all (the oracle "
        f"{oracle_s:.3f} s beside the ranks); {len(first['chunk_sizes'])} chunks of {first['chunk_sizes']} edges; "
        f"phases A/B/C/D by rank "
        + "; ".join(f"{ph} {[round(x, 3) for x in out['wall_by_rank'][ph]]} s" for ph in "ABCD")
        + f"; greedy launches by rank {out['greedy_launches']}, segment_rf {out['segment_rf_launches']}, "
        f"rescale_migrate {out['rescale_migrate_launches']}; commit "
        f"byte-equal to the mirror oracle; RF at 12 and 8 equal to the oracle's; round trip and k = 12 sequence "
        f"equal; peak RSS {[round(x, 1) for x in out['peak_rss_mb_by_rank']]} MB by rank ({first['rss_field']}); "
        f"stream {first['stream']}; worst RF ratio to geo_order {out['worst_rf_ratio']:.4f} (a reading; geo_order in "
        f"the oracle's pool, waited {geo_s:.3f} s after the oracle)")
    return out


def control_path(dev, graph, segment_rf) -> dict:
    """Path 8 (a): the control plane on ``dev`` at path 4's size, one rank in
    this process. An ``ElasticController`` on an injected clock drives a
    ``StreamingEngine`` (span ``differential``, full ``device``, two batches
    in flight) with a ``SlotCheckpoint`` and an autoscaler: batches through
    ``ingest``, a host that stops heartbeating (``poll``: 8 -> 7, a WAL scale
    barrier), a backlog (``autoscale``: 7 -> 9), the full rung forced and one
    more batch in flight; then the kill (the live slots kept; controller,
    engine and orderer dropped, the card's memory freed), the restore from
    disk, ``from_restored``, ``report_failure`` (9 -> 8) and more batches, in
    which both rungs fire again. Gates: the restored slots byte-equal to the
    live ones at the kill, the restored pack equal to ``pack_slots`` of the
    restored orderer, ``verify_bit_identity`` after every event, the event
    seqs 0..n-1 and the JSONL round trip, the checkpoint counters, a valid
    Chrome trace, every ``segment_rf`` launch exact against its plain version
    and every greedy launch equal to ``_full_order_host``, each kernel
    launched before and after the restore. Returns readings."""
    from repro_torch.checkpoint import SlotCheckpoint
    from repro_torch.elastic.autoscale import AutoscaleConfig, AutoscalePolicy
    from repro_torch.elastic.controller import ElasticController
    from repro_torch.graphs import engine as E
    from repro_torch.kernels import full_reorder as FRK
    from repro_torch.kernels import span_reorder as SRK
    from repro_torch.obs import chrome_trace, events_from_jsonl, validate_chrome_trace
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer
    from repro_torch.stream import IncrementalOrderer, StreamConfig, StreamingEngine, SyntheticStream

    kernel, tapped = SRK.segment_distinct_counts, []

    def tap(rows):
        counts = kernel(rows)
        tapped.append((rows.clone(), counts.clone()))
        return counts

    SRK.segment_distinct_counts = tap
    greedy_tapped: list = []
    greedy_kernel, FRK.greedy_keys = greedy_tap(FRK, greedy_tapped)
    g, src, dst = graph
    ck_dir = ROOT / "build" / "control" / "ckpt8"
    shutil.rmtree(ck_dir, ignore_errors=True)
    t = [0.0]  # the controllers' injected clock: liveness and autoscale decisions replay exactly
    tracer, reg = Tracer(), MetricsRegistry()
    cfg = StreamConfig(partial_drift=1.0, full_drift=99.0, span_regions=2, k_min=4, k_max=RUNGS_K_MAX)
    engine_kw = dict(device=dev, span_repair="differential", full_rebuild="device", rebuild_flight=2,
                     tracer=tracer, metrics_registry=reg)
    policy = AutoscaleConfig(k_min=4, k_max=RUNGS_K_MAX, step_out=2, ema=1.0, out_cooldown_s=5.0, in_cooldown_s=5.0)
    stream = SyntheticStream(g, batch_size=RUNGS_BATCH, seed=4)
    checks, batch = [], 0

    def controller(k):
        ctl = ElasticController(k, dead_after_s=5.0, clock=lambda: t[0], tracer=tracer, metrics_registry=reg)
        ctl.attach_autoscaler(AutoscalePolicy(policy))
        return ctl

    def event(ctl, what: str) -> None:
        ctl.stream.verify_bit_identity()
        checks.append(what)

    def ingest(ctl, force=False, silent=()):
        nonlocal batch
        batch += 1
        t[0] += 1.0
        for h, st in ctl.hosts.items():
            if st.alive and h not in silent:
                ctl.heartbeat(h, batch)
        if force:
            ctl.stream.orderer.drift = lambda: 200.0  # over full_drift: the full rung fires
        ev = ctl.ingest(stream.batch())
        if force:
            del ctl.stream.orderer.drift
        event(ctl, f"batch {batch} ({ev.escalation}, {ev.rebuild_state or ev.repair})")
        return ev

    t0 = time.perf_counter()
    o = IncrementalOrderer(src, dst, g.num_vertices, regions=RUNGS_REGIONS, config=cfg)
    eng = StreamingEngine(o, **engine_kw)
    ctl = controller(RUNGS_REGIONS)
    ctl.attach_stream(eng)
    ctl.attach_checkpoint(SlotCheckpoint(ck_dir, interval=CONTROL_INTERVAL, tracer=tracer, metrics_registry=reg))
    lost = RUNGS_REGIONS - 1
    ingest(ctl)
    ingest(ctl, silent=(lost,))
    t[0] += 6.0  # host `lost` has not beaten for 7 s
    for h, st in ctl.hosts.items():
        if st.alive and h != lost:
            ctl.heartbeat(h, batch)
    ev_poll = ctl.poll()
    check(ev_poll is not None and ev_poll.kind == "scale_in" and ev_poll.executed and ev_poll.lost_hosts == (lost,),
          f"path 8 (a): poll gave {ev_poll}, expected an executed scale-in of host {lost}")
    event(ctl, f"poll {ev_poll.k_old}->{ev_poll.k_new}")
    wal = [json.loads(line) for line in (ck_dir / "wal.jsonl").read_text().splitlines()]
    check(wal[-1]["kind"] == "scale" and wal[-1]["k_new"] == ev_poll.k_new,
          f"path 8 (a): the checkpoint's WAL ends {wal[-1:]}, expected the scale barrier to {ev_poll.k_new}")
    ingest(ctl)
    ctl.note_backlog(1000)
    ev_out = ctl.autoscale()
    check(ev_out is not None and ev_out.kind == "scale_out" and ev_out.executed,
          f"path 8 (a): autoscale gave {ev_out}, expected an executed scale-out")
    event(ctl, f"autoscale {ev_out.k_old}->{ev_out.k_new}")
    ctl.note_backlog(0)
    ev_force = ingest(ctl, force=True)
    check(ev_force.escalation == "full" and ev_force.rebuild_state == "dispatch",
          f"path 8 (a): the forced full rung gave {ev_force.escalation}, {ev_force.rebuild_state}")
    ev_flight = ingest(ctl)
    check(ev_flight.rebuilds_in_flight == 1, "path 8 (a): the rebuild must still be in flight at the kill")
    live_events = list(ctl.events)
    live_jsonl = ctl.events_jsonl()
    live_rescale_ms = [s.elapsed_s * 1e3 for s in ctl.rescale_stats]
    rf_at_kill, greedy_at_kill = len(tapped), len(greedy_tapped)
    live_s = time.perf_counter() - t0

    # The kill: what survives is the checkpoint directory (and, for the gate,
    # the live slot arrays).
    want = (o.slot_src.copy(), o.slot_dst.copy(), o.slot_valid.copy())
    torch.cuda.synchronize()
    held_mb = torch.cuda.memory_allocated() / 2**20
    del ctl, eng, o
    gc.collect()
    torch.cuda.empty_cache()
    freed_mb = held_mb - torch.cuda.memory_allocated() / 2**20

    t0 = time.perf_counter()
    o, info = SlotCheckpoint(ck_dir, interval=CONTROL_INTERVAL, tracer=tracer, metrics_registry=reg).restore(
        config=cfg)
    restore_s = time.perf_counter() - t0
    check(all(np.array_equal(a, b) for a, b in zip((o.slot_src, o.slot_dst, o.slot_valid), want)),
          "path 8 (a): the slots restored from disk differ from the live slots at the kill")
    eng, commit_s = synced_s(lambda: StreamingEngine.from_restored(o, **engine_kw))
    want_pack = E.pack_slots(o.slot_src, o.slot_dst, o.slot_valid, o.regions, o.num_vertices, device=dev)
    got_pack = E.unshard_engine_data(eng.data)
    check(all(torch.equal(getattr(got_pack, n), getattr(want_pack, n)) for n in ("edges", "mask", "degrees")),
          "path 8 (a): the restored engine's pack differs from pack_slots of the restored orderer")
    del want_pack, got_pack
    ctl = controller(o.regions)
    ctl.attach_stream(eng)
    ctl.attach_checkpoint(SlotCheckpoint(ck_dir, interval=CONTROL_INTERVAL, tracer=tracer, metrics_registry=reg))
    ctl._batch_step = info["step"]  # continue the durable step numbering
    fev, sev = ctl.report_failure([o.regions - 1], detect_s=0.0, reason="host lost at the kill",
                                  restored_bytes=info["bytes_read"], restore_s=restore_s,
                                  replayed_records=info["replayed"])
    check(sev is not None and sev.executed and (fev.k_old, fev.k_new) == (o.regions + 1, o.regions)
          and fev.seq == 0 and sev.seq == 1,
          f"path 8 (a): report_failure gave {fev}, {sev}")
    event(ctl, f"failure {fev.k_old}->{fev.k_new}")
    after = [ingest(ctl, force=(i == CONTROL_AFTER - 1)) for i in range(CONTROL_AFTER)]
    check(after[-1].rebuild_state == "dispatch", "path 8 (a): the full rung did not fire again after the restore")
    restored_rescale_ms = [s.elapsed_s * 1e3 for s in ctl.rescale_stats]

    # The logs: seqs 0..n-1 in each controller, and the JSONL round trip.
    for name, evs, text in (("live", live_events, live_jsonl), ("restored", ctl.events, ctl.events_jsonl())):
        check([e.seq for e in evs] == list(range(len(evs))) and events_from_jsonl(text) == evs,
              f"path 8 (a): the {name} controller's event log is out of order or does not round-trip")
    counters = {n: reg.counter(f"checkpoint.{n}").value for n in ("snapshots", "snapshot_bytes", "wal_records",
                                                                  "wal_bytes", "restore_bytes")}
    check(counters["snapshots"] > 0 and counters["wal_records"] > 0
          and counters["restore_bytes"] == info["bytes_read"] > 0 and info["replayed"] > 0,
          f"path 8 (a): checkpoint counters {counters}, restore {info}")
    trace = chrome_trace(tracer)
    problems = validate_chrome_trace(trace)
    check(problems == [], f"path 8 (a): the Chrome trace is malformed: {problems[:5]}")
    phases_traced = sorted({e["cat"] for e in trace["traceEvents"] if e["ph"] == "X"})
    check({"checkpoint", "ingest", "rescale"} <= set(phases_traced), f"path 8 (a): trace phases {phases_traced}")

    SRK.segment_distinct_counts = kernel
    FRK.greedy_keys = greedy_kernel
    selections = sum(e.escalation == "partial" and e.repair == "differential"
                     for e in live_events + ctl.events if e.kind == "ingest")
    check(segment_rf.launches == len(tapped) == 2 * selections and 0 < rf_at_kill < len(tapped),
          f"path 8 (a): segment_rf launched {segment_rf.launches} times ({len(tapped)} tapped, {rf_at_kill} before "
          f"the kill) for {selections} span selections; it must launch twice a selection, before and after the "
          f"restore")
    check(FRK.launches == len(greedy_tapped) and 0 < greedy_at_kill < len(greedy_tapped),
          f"path 8 (a): the greedy kernel launched {FRK.launches} times ({greedy_at_kill} before the kill); it must "
          f"launch before and after the restore")
    max_err = 0
    for i, (rows, counts) in enumerate(tapped):
        want_counts = segment_rf.segment_distinct_counts_torch(rows)
        max_err = max(max_err, int((counts - want_counts).abs().max()))
        check(torch.equal(counts, want_counts), f"path 8 (a): segment_rf launch {i} differs from the plain version")
    greedy = [greedy_against_mirror(FRK, rec) for rec in greedy_tapped]
    check(all(x["exact"] for x in greedy), f"path 8 (a): a greedy launch differs from the host mirror: {greedy}")
    read = dict(
        live_s=live_s, restore_s=restore_s, restore_bytes_read=info["bytes_read"], wal_replayed=info["replayed"],
        restore_step=info["step"], manifest_step=info["manifest_step"], from_restored_ms=commit_s * 1e3,
        rescale_ms=dict(poll=live_rescale_ms[0], autoscale=live_rescale_ms[1], failure=restored_rescale_ms[0]),
        rescales=[f"{e.k_old}->{e.k_new}" for e in live_events + ctl.events if e.kind in ("scale_in", "scale_out")],
        events=len(live_events) + len(ctl.events), checks=len(checks), checkpoint=counters,
        freed_at_kill_mb=freed_mb, trace_phases=phases_traced, trace_events=len(trace["traceEvents"]),
        launches=dict(segment_rf=[rf_at_kill, len(tapped) - rf_at_kill],
                      full_reorder=[greedy_at_kill, len(greedy_tapped) - greedy_at_kill]),
        selections=selections, segment_rf_max_abs_err=max_err, greedy=greedy)
    log(f"path 8 (a): {len(checks)} bit-identity checks passed ({', '.join(checks)}); restore from disk "
        f"{restore_s:.3f} s ({info['bytes_read']} B, {info['replayed']} WAL records replayed onto manifest "
        f"{info['manifest_step']}), byte-equal to the live slots at the kill; from_restored {commit_s * 1e3:.3f} ms, "
        f"pack equal to pack_slots; rescales {read['rescales']} in {read['rescale_ms']} ms; checkpoint {counters}; "
        f"segment_rf {read['launches']['segment_rf']} launches before / after the restore, each exact; greedy "
        f"{read['launches']['full_reorder']}, each equal to the host mirror; {freed_mb:.1f} MB freed at the kill; "
        f"trace {len(trace['traceEvents'])} events, valid")
    return read


def control_drill(tag: str, backend: str, live_devices: list, recover_devices: list, graph) -> dict:
    """Path 8 (b), or (c) over NCCL: ``tests/torch_faults_harness.py``'s
    SIGKILL drill on the ranks of ``live_devices`` (2 processes x 2), at path
    4's graph, then the recovery on ``recover_devices`` (2 ranks). Gates: the
    restore point and the final slots of both recovery ranks byte-equal to
    the no-failure host oracle (the harness's ``drill_oracle``), the final
    pack reassembled from their row blocks byte-equal to the oracle's, the
    detection within the lease + 2 s, the two ranks' event logs equal, and
    the rescale's bytes sent and received equal to its cross-rank bytes.
    Returns readings."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_faults_harness as FH

    from repro_torch.graphs import engine as E

    g, src, dst = graph
    run_dir = ROOT / "build" / "control" / tag
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    inputs = run_dir / "graph.npz"
    np.savez(inputs, src=src, dst=dst, base_src=g.src, base_dst=g.dst, num_vertices=g.num_vertices)
    t0 = time.perf_counter()
    res = FH.run_drill(run_dir / "shared", run_dir / "out", device=torch.device(live_devices[0]).type,
                       backend=backend, live_devices=live_devices, recover_devices=recover_devices,
                       batch=RUNGS_BATCH, graph=str(inputs))
    wall = time.perf_counter() - t0
    for p in res["live"].procs + res["recover"].procs:
        for line in p.stdout.splitlines():
            if "live: batch" not in line:
                log(f"path 8 ({tag}) {line}")
    recs, arrays = res["records"], res["arrays"]
    last = recs[0]["restore"]["step"]
    check(FH.KILL_STEP <= last < FH.BATCHES - 1,
          f"path 8 ({tag}): restored to batch {last}, expected a tail of batches to finish")
    t1 = time.perf_counter()
    oracle, point = FH.drill_oracle(last, batch=RUNGS_BATCH, graph=str(inputs))
    oracle_s = time.perf_counter() - t1
    for r, a in enumerate(arrays):
        check(all(np.array_equal(x, y) for x, y in zip((a["restore_src"], a["restore_dst"], a["restore_valid"]),
                                                       point)),
              f"path 8 ({tag}) rank {r}: the restore point differs from the no-failure oracle's")
        check(all(np.array_equal(x, y) for x, y in zip((a["final_src"], a["final_dst"], a["final_valid"]),
                                                       (oracle.slot_src, oracle.slot_dst, oracle.slot_valid))),
              f"path 8 ({tag}) rank {r}: the final slots differ from the no-failure oracle's")
    want_e, want_m, _ = E.host_pack_slots(oracle.slot_src, oracle.slot_dst, oracle.slot_valid, oracle.regions,
                                          oracle.num_vertices)
    got_e, got_m = FH.reassemble(recs, arrays)
    check(got_e.tobytes() == want_e.tobytes() and got_m.tobytes() == want_m.tobytes(),
          f"path 8 ({tag}): the final pack, reassembled from the ranks' rows, differs from the oracle's pack")
    check(0.0 < res["detect_s"] <= FH.LEASE_S + 2.0, f"path 8 ({tag}): detection took {res['detect_s']:.3f} s")
    check(recs[0]["events_jsonl"] == recs[1]["events_jsonl"],
          f"path 8 ({tag}): the recovery ranks' event logs differ")
    moved = [r["scale_event"] for r in recs]
    check(sum(m["sent_bytes"] for m in moved) == sum(m["received_bytes"] for m in moved)
          == moved[0]["cross_device_bytes"] > 0 and all(r["k_final"] == FH.K_RECOVER for r in recs),
          f"path 8 ({tag}): the failure shrink moved {moved}")
    check(all(p.returncode == -9 for p in res["live"].procs[2:]), f"path 8 ({tag}): process 1 was not SIGKILLed")
    read = dict(ranks_live=len(live_devices), ranks_recover=len(recover_devices), backend=backend,
                devices=sorted(set(live_devices)), wall_s=wall, live_s=res["live_s"], recover_s=res["recover_s"],
                startup_s=res["startup_s"],
                detect_s=res["detect_s"], restore_step=last, manifest_step=recs[0]["restore"]["manifest_step"],
                wal_replayed=recs[0]["restore"]["replayed"], restore_bytes_read=recs[0]["restore"]["bytes_read"],
                restore_s_by_rank=[r["restore_s"] for r in recs], from_restored_ms_by_rank=[r["commit_s"] * 1e3
                                                                                            for r in recs],
                rescale_ms_by_rank=[r["scale_event"]["ms"] for r in recs],
                rescale_sent_by_rank=[r["scale_event"]["sent_bytes"] for r in recs],
                rescale_cross_device_bytes=moved[0]["cross_device_bytes"],
                continue_s_by_rank=[r["continue_s"] for r in recs], oracle_s=oracle_s,
                peak_rss_mb_by_rank=[r["peak_rss_mb"] for r in recs], events=recs[0]["event_kinds"])
    log(f"path 8 ({tag}): live {len(live_devices)} ranks over {backend}, process 1 SIGKILLed after batch "
        f"{FH.KILL_STEP}, detected in {res['detect_s']:.3f} s; recovery on {len(recover_devices)} ranks "
        f"restored batch {last} (manifest {read['manifest_step']}, {read['wal_replayed']} WAL records, "
        f"{read['restore_bytes_read']} B) in {[round(x, 3) for x in read['restore_s_by_rank']]} s, from_restored "
        f"{[round(x, 3) for x in read['from_restored_ms_by_rank']]} ms, 8 -> 4 in "
        f"{[round(x, 3) for x in read['rescale_ms_by_rank']]} ms ({read['rescale_cross_device_bytes']} B across "
        f"ranks); restore point, final slots and final pack byte-equal to the no-failure oracle; {wall:.3f} s in all")
    return read


def serve_answers(data, group, qe, source: int) -> dict:
    """Each query kind once on ``data``'s operands, with ``qe``'s iteration
    settings and SSSP from ``source``: ``{kind: (answer, iterations)}`` (-1
    for PageRank)."""
    from repro_torch.graphs import engine as E

    out = {}
    for kind in E.QUERY_KINDS:
        prog = E.query_program(kind, num_vertices=data.num_vertices, group=group, iterations=qe.pagerank_iters,
                               max_iters=qe.query_max_iters)
        if kind == "pagerank":
            out[kind] = (prog(data.edges, data.mask, data.degrees), -1)
        else:
            out[kind] = prog(data.edges, data.mask, *((source,) if kind == "sssp" else ()))
    return out


def same_answers(got: dict, want: dict, what: str) -> dict:
    """PageRank within ``PAGERANK_RTOL``, SSSP and WCC exact with the same
    iteration count; returns PageRank's max relative difference and the
    iteration counts."""
    pr_rel = rel_close(got["pagerank"][0], want["pagerank"][0], PAGERANK_RTOL, f"{what}: PageRank")
    for kind in ("sssp", "wcc"):
        (a, it), (b, it_want) = got[kind], want[kind]
        check(it == it_want and torch.equal(a, b), f"{what}: {kind} differs ({it} against {it_want} iterations)")
    return dict(pagerank_rel=pr_rel, sssp_iters=got["sssp"][1], wcc_iters=got["wcc"][1])


def probe_times(records) -> dict:
    """Measured probe seconds by query kind: count, median and maximum (ms)."""
    by_kind: dict = {}
    for r in records:
        if r.measured_s > 0:
            by_kind.setdefault(r.kind, []).append(r.measured_s * 1e3)
    return {kind: dict(count=len(ms), median_ms=float(np.median(ms)), max_ms=max(ms)) for kind, ms in by_kind.items()}


def serve_full_width(eng, phases: dict):
    """Path 9 (a): the serve-only loop of ``launch/serve.py`` over path 3's
    engine at full width. An ``ElasticController`` of 16 hosts with the
    autoscaler of ``SERVE_POLICY`` and the ``SERVE_WORKLOAD`` traffic, a
    probe every tick; the burst of tick 8 scales it 16 -> 20, the engine's
    rescale (host re-layout, compact on the card). Gates: exactly one
    executed scale event, 16 -> 20; the pack bit-identical after it (the
    loop's own check); each query kind on the live pack at the decision
    (before the rescale) and right after it equal within ``PAGERANK_RTOL`` /
    exactly, and after it equal to the same query on ``oracle_pack()``;
    ``min_sweep`` launched once a sweep of the loop's and those queries' SSSP
    and WCC, those queries' sweeps each exact against the plain version.
    Returns readings and the worst span's host slots for the twin phase."""
    from repro_torch.elastic.autoscale import AutoscaleConfig, AutoscalePolicy
    from repro_torch.elastic.controller import ElasticController
    from repro_torch.kernels import min_sweep as MS
    from repro_torch.launch import serve as LS
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.stream.workload import OpenLoopWorkload

    reg = MetricsRegistry()
    loop_ref: list = []
    ctl = ElasticController(STREAM_REGIONS, clock=lambda: loop_ref[0].now if loop_ref else 0.0, metrics_registry=reg)
    ctl.attach_stream(eng)
    policy = AutoscalePolicy(AutoscaleConfig(**SERVE_POLICY))
    ctl.attach_autoscaler(policy)
    loop = LS.ServeLoop(ctl, OpenLoopWorkload(num_vertices=eng.num_vertices, **SERVE_WORKLOAD),
                        config=LS.ServeConfig(probe_every=1), registry=reg)
    loop_ref.append(loop)
    qe = loop.queries
    source = int(torch.argmax(eng.data.degrees))  # SSSP from the hub: the graph does not change here
    answers: dict = {}
    decide = policy.decide
    on_card, launches0 = eng.data.edges.is_cuda, MS.launches
    loop_sweeps, tapped = [0], []
    query = qe.query

    def counted(kind, source=0):  # the loop's own queries (the warm-up and the probes): their sweeps counted
        out, elapsed = query(kind, source)
        loop_sweeps[0] += 0 if kind == "pagerank" else out[1]
        return out, elapsed

    qe.query = counted

    def answered(data, group):  # each query kind once, every sweep tapped and held at once
        with sweeps_tapped(MS, tapped, at_once=True):
            return serve_answers(data, group, qe, source)

    def decide_then_answer(**kw):
        decision = decide(**kw)
        if decision is not None and "before" not in answers:  # the pack the decision was taken on
            answers["before"], phases["serve_a_before_s"] = synced_s(lambda: answered(eng.data, eng.data.group))
        return decision

    policy.decide = decide_then_answer
    _, phases["serve_a_warm_s"] = synced_s(qe.warm)
    eng.tracer.clear()
    t0 = time.perf_counter()
    decision_tick = None
    for _ in range(SERVE_TICKS):
        loop.tick()
        if loop.scale_events and decision_tick is None:
            decision_tick = loop.tick_index - 1
            answers["after"], phases["serve_a_after_s"] = synced_s(lambda: answered(eng.data, eng.data.group))
    loop.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scale_events = [e for e in ctl.events if e.kind in ("scale_in", "scale_out")]
    check(len(scale_events) == 1 and loop.scale_events == scale_events,
          f"path 9 (a): {len(scale_events)} scale events {[(e.k_old, e.k_new) for e in scale_events]}, expected one")
    ev = scale_events[0]
    check((ev.kind, ev.k_old, ev.k_new, ev.executed) == ("scale_out", STREAM_REGIONS, SERVE_K_MAX, True)
          and eng.k == SERVE_K_MAX, f"path 9 (a): the autoscaler gave {ev}, expected an executed 16 -> 20")
    rs = ctl.rescale_stats[-1]
    sp = span_sums(eng.tracer)
    slots_new = eng.data.edges.shape[0] * eng.data.edges.shape[1]
    # The compact moves, on the card: the gather map up (two int32 indices and
    # an f32 mask a slot), the old edges read at the gathered slots, the new
    # edges and mask written.
    compact_bytes = slots_new * (4 + 4 + 4) + slots_new * 8 * 2 + slots_new * 4
    rescale = dict(k_old=rs.k_old, k_new=rs.k_new, ms=rs.elapsed_s * 1e3, relayout_ms=sp["rescale.relayout"] * 1e3,
                   compact_ms=sp["rescale.compact"] * 1e3, moved_edges=rs.moved_edges, moved_bytes=rs.moved_edges * 8,
                   cep_plan_edges=rs.cep_plan_edges, compact_bytes=compact_bytes)
    log(f"stream rescale {rs.k_old}->{rs.k_new}: {rescale['ms']:.3f} ms (host relayout {rescale['relayout_ms']:.3f} "
        f"ms, gather-map upload + compact on the card {rescale['compact_ms']:.3f} ms); moved {rs.moved_edges} edges "
        f"({rescale['moved_bytes']} B; the CEP plan would move {rs.cep_plan_edges}), compact moves {compact_bytes} B "
        f"(path 9 (a): executed by the autoscaler)")
    oracle = eng.oracle_pack()
    answers["oracle"], phases["serve_a_oracle_s"] = synced_s(lambda: answered(oracle, None))
    del oracle
    qe.query = query
    sweeps = loop_sweeps[0] + sum(a["sssp"][1] + a["wcc"][1] for a in answers.values())
    launched = MS.launches - launches0
    check(launched == (sweeps if on_card else 0) and len(tapped) == launched - loop_sweeps[0] * on_card
          and all(x["exact"] for x in tapped),
          f"path 9 (a): min_sweep launched {launched} times for {sweeps} sweeps ({loop_sweeps[0]} in the loop's "
          f"queries); {len(tapped)} tapped, exact {[x['exact'] for x in tapped]}")
    across = same_answers(answers["after"], answers["before"], "path 9 (a): the query after the rescale against "
                                                                "the one at the decision")
    to_oracle = same_answers(answers["after"], answers["oracle"], "path 9 (a): the query after the rescale against "
                                                                  "the oracle pack")
    s = loop.summary()
    probes = probe_times(loop.records)
    read = dict(ticks=s["ticks"], served=s["served"], shed=s["shed"], latency_p50_s=s["latency_p50_s"],
                latency_p99_s=s["latency_p99_s"], slo_violations=s["slo_violations"], k_path=s["k_path"],
                reason=ev.reason, decision_tick=decision_tick, rescale=rescale, wall_s=wall, probes=probes,
                across_rescale=across, to_oracle=to_oracle, sssp_source=source, evaluations=len(policy.log),
                held=sorted({sig.held_by for sig in policy.log if sig.held_by}),
                min_sweep=dict(launches=launched, loop_sweeps=loop_sweeps[0], tapped=len(tapped),
                               shapes=sorted({tuple(x["shape"]) for x in tapped})))
    log(f"path 9 (a): {s['served']} queries served over {s['ticks']} ticks in {wall:.3f} s, shed {s['shed']}, "
        f"modeled latency p50 {s['latency_p50_s']:.2f} s p99 {s['latency_p99_s']:.2f} s, k {s['k_path']} at tick "
        f"{decision_tick} ({ev.reason}); bit-identical after the rescale; PageRank / SSSP / WCC after it equal to the answers at "
        f"the decision (PageRank max rel {across['pagerank_rel']:.3e}) and to the oracle pack's (max rel "
        f"{to_oracle['pagerank_rel']:.3e}), SSSP from vertex {source} {across['sssp_iters']} and WCC "
        f"{across['wcc_iters']} iterations; min_sweep {launched} launches, one a sweep ({loop_sweeps[0]} in "
        f"the loop's queries), the other {len(tapped)} each exact; "
        + "; ".join(f"{kind} probe median {p['median_ms']:.3f} ms, max {p['max_ms']:.3f} ms ({p['count']})"
                    for kind, p in sorted(probes.items())))
    o = eng.orderer
    r0, r1 = o.span_bounds()
    return read, (*o.span_arrays(r0, r1), eng.num_vertices)


def serve_scenario(dev, phases: dict, segment_rf) -> dict:
    """Path 9 (b): the reference's serving scenario (``tests/torch_serve_harness.py``,
    after ``benchmarks/bench_serve.py`` at its defaults) on ``dev``, an
    ingest every tick, both rungs on the card. Gates: the trajectory equal to
    the committed ``tests/torch_serve_trajectory.json`` (the JAX package's
    loop over a port CPU engine), at least 2 scale-outs and 2 scale-ins and no
    flap pair, the pack bit-identical after every event (the loop's own
    checks), every ``segment_rf`` launch (two a span selection) exact against
    its plain version and every greedy launch equal to the host mirror, each
    kernel launched, ``min_sweep`` once a sweep of the warm-up's and the
    probes' SSSP and WCC, each sweep exact against the plain version.
    Returns readings, with the probe answers."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_serve_harness as SH

    from repro_torch.kernels import full_reorder as FRK
    from repro_torch.kernels import min_sweep as MS
    from repro_torch.kernels import span_reorder as SRK

    kernel, tapped = SRK.segment_distinct_counts, []

    def tap(rows):
        counts = kernel(rows)
        tapped.append((rows.clone(), counts.clone()))
        return counts

    SRK.segment_distinct_counts = tap
    greedy_tapped: list = []
    greedy_kernel, FRK.greedy_keys = greedy_tap(FRK, greedy_tapped)
    sc = SH.SCENARIO
    launches0, sweep_checks = MS.launches, []
    t0 = time.perf_counter()
    loop, ctl, policy, eng = SH.build_loop(SH.build_ordered(**sc), device=dev, **sc)
    probes = SH.record_probes(loop)
    with sweeps_tapped(MS, sweep_checks, at_once=True):  # the packs change from tick to tick: held at once
        loop.queries.warm()
        warm_sweeps = sum(iters for _, kind, _, _, iters in probes if kind != "pagerank")
        del probes[:]  # the warm-up's answers are not probes of the run
        phases["serve_b_setup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        SH.run_scenario(loop, **sc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    SRK.segment_distinct_counts = kernel
    FRK.greedy_keys = greedy_kernel
    traj = SH.trajectory(loop, policy)
    want = json.loads(SH.TRAJECTORY_FILE.read_text())
    diff = sorted(key for key in want if traj.get(key) != want[key])
    check(not diff, f"path 9 (b): the trajectory differs from tests/torch_serve_trajectory.json in {diff}")
    check(traj["scale_outs"] >= 2 and traj["scale_ins"] >= 2 and traj["flap_pairs"] == 0,
          f"path 9 (b): {traj['scale_outs']} scale-outs, {traj['scale_ins']} scale-ins, {traj['flap_pairs']} flaps")
    ingests = [e for e in ctl.events if e.kind == "ingest"]
    selections = sum(e.escalation == "partial" and e.repair == "differential" for e in ingests)
    check(segment_rf.launches == len(tapped) == 2 * selections > 0,
          f"path 9 (b): segment_rf launched {segment_rf.launches} times ({len(tapped)} tapped) for {selections} span "
          f"selections, expected 2 each")
    check(FRK.launches == len(greedy_tapped) > 0, f"path 9 (b): the greedy kernel launched {FRK.launches} times")
    max_err = 0
    for i, (rows, counts) in enumerate(tapped):
        want_counts = segment_rf.segment_distinct_counts_torch(rows)
        max_err = max(max_err, int((counts - want_counts).abs().max()))
        check(torch.equal(counts, want_counts), f"path 9 (b): segment_rf launch {i} differs from the plain version")
    greedy = [greedy_against_mirror(FRK, rec) for rec in greedy_tapped]
    check(all(x["exact"] for x in greedy), f"path 9 (b): a greedy launch differs from the host mirror: {greedy}")
    sweeps = warm_sweeps + sum(iters for _, kind, _, _, iters in probes if kind != "pagerank")
    sweeps_on_card = sweeps if dev.type == "cuda" else 0
    check(MS.launches - launches0 == len(sweep_checks) == sweeps_on_card
          and all(x["exact"] for x in sweep_checks),
          f"path 9 (b): min_sweep launched {MS.launches - launches0} times ({len(sweep_checks)} tapped) for "
          f"{sweeps} sweeps, exact {[x['exact'] for x in sweep_checks]}")
    s = loop.summary()
    times = probe_times(loop.records)
    read = dict(ticks=s["ticks"], served=s["served"], shed=s["shed"], slo_violations=s["slo_violations"],
                latency_p50_s=s["latency_p50_s"], latency_p99_s=s["latency_p99_s"], k_path=s["k_path"],
                scale_outs=s["scale_outs"], scale_ins=s["scale_ins"], flap_pairs=traj["flap_pairs"],
                moved_edges=s["moved_edges_per_decision"], wall_s=wall, checks=len(ingests) + len(loop.scale_events),
                rung_counts=dict(eng.rung_counts), selections=selections,
                launches=dict(segment_rf=len(tapped), full_reorder=len(greedy_tapped), min_sweep=sweeps_on_card),
                greedy_steps=[x["steps"] for x in greedy], probes=times,
                rescale_ms=[st.elapsed_s * 1e3 for st in ctl.rescale_stats])
    log(f"path 9 (b): {s['ticks']} ticks ({sc['days']} days of {sc['day_ticks']}, {sc['ingest_batch']} updates a "
        f"tick) in {wall:.3f} s, {s['served']} served, {s['shed']} shed, {s['slo_violations']} over the SLO, modeled "
        f"p50 {s['latency_p50_s']:.2f} s p99 {s['latency_p99_s']:.2f} s, k {s['k_path']} ({s['scale_outs']} out, "
        f"{s['scale_ins']} in, no flap), equal to the committed trajectory; {read['checks']} bit-identity checks; "
        f"rungs {read['rung_counts']}; segment_rf {len(tapped)} launches, each exact; greedy {len(greedy_tapped)}, "
        f"each equal to the host mirror; min_sweep {sweeps_on_card}, one a sweep, each exact; rescales "
        f"{min(read['rescale_ms']):.3f}-{max(read['rescale_ms']):.3f} ms; "
        + "; ".join(f"{kind} probe median {p['median_ms']:.3f} ms, max {p['max_ms']:.3f} ms ({p['count']})"
                    for kind, p in sorted(times.items())))
    read["segment_rf_max_abs_err"] = max_err
    read["answers"] = probes
    return read


def serve_ranks(tag: str, backend: str, devices: list, one_rank: dict) -> dict:
    """Path 9 (c): path 9 (b) over g ranks of ``tests/torch_serve_harness.py``
    (one process a rank, a card each over NCCL). Gates: every rank's
    trajectory equal to the committed one, the ranks' event logs equal, and
    each probe's answer equal to the one-rank run's ``one_rank`` (PageRank
    within ``PAGERANK_RTOL``, SSSP and WCC exact with the same iterations);
    each rank launched ``segment_rf`` and the greedy kernel, and
    ``min_sweep`` once a sweep of its warm-up's and probes' SSSP and WCC."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_serve_harness as SH

    run_dir = ROOT / "build" / "serve" / tag
    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = SH.run_cluster(run_dir, backend=backend, n_procs=len(devices), devs_per_proc=1, devices=devices,
                           scenario=SH.SCENARIO, timeout=STREAMRANK_TIMEOUT_S)
    wall = time.perf_counter() - t0
    want = json.loads(SH.TRAJECTORY_FILE.read_text())
    for r in ranks:
        check(r["trajectory"] == want,
              f"path 9 ({tag}) rank {r['rank']}: the trajectory differs from the committed one")
        check(r["launches"]["segment_rf"] > 0 and r["launches"]["full_reorder"] > 0
              and r["launches"]["min_sweep"] == r["sweeps"] > 0,
              f"path 9 ({tag}) rank {r['rank']}: launches {r['launches']} for {r['sweeps']} sweeps")
        check(len(r["probes"]) == len(one_rank["answers"]), f"path 9 ({tag}) rank {r['rank']}: probe count")
        for (tick, kind, source, iters), answer, (t1, k1, s1, a1, i1) in zip(r["probes"], r["answers"],
                                                                             one_rank["answers"]):
            check((tick, kind, source, iters) == (t1, k1, s1, i1), f"path 9 ({tag}) rank {r['rank']}: probe at tick "
                                                                   f"{tick} differs from the one-rank run's")
            if kind == "pagerank":
                rel_close(torch.from_numpy(answer), torch.from_numpy(a1), PAGERANK_RTOL,
                          f"path 9 ({tag}) rank {r['rank']}: PageRank probe at tick {tick}")
            else:
                check(np.array_equal(answer, a1), f"path 9 ({tag}) rank {r['rank']}: {kind} probe at tick {tick}")
    check(len({r["events_jsonl"] for r in ranks}) == 1, f"path 9 ({tag}): the ranks' event logs differ")
    read = dict(ranks=len(ranks), backend=backend, devices=devices, wall_s=wall,
                wall_s_by_rank=[r["wall_s"] for r in ranks], launches_by_rank=[r["launches"] for r in ranks],
                k_path=ranks[0]["trajectory"]["k_path"],
                probe_ms_median_by_rank=[float(np.median(r["probe_s"])) * 1e3 for r in ranks])
    log(f"path 9 ({tag}): {len(ranks)} ranks over {backend}, each {[round(x, 3) for x in read['wall_s_by_rank']]} s, "
        f"k path {read['k_path']} on every rank, equal to the committed trajectory; {len(one_rank['answers'])} probes "
        f"a rank, each equal to the one-rank run's; launches {read['launches_by_rank']}; {wall:.3f} s in all")
    return read


def serve_over_cards(cards: list, phases: dict, segment_rf) -> dict:
    """Path 9 (c): path 9 (b) on one rank on ``cards[0]`` in this process,
    then over one NCCL rank a card of ``cards``, held to it."""
    t0 = time.perf_counter()
    one = serve_scenario(torch.device(cards[0]), phases, segment_rf)
    phases["serve_b_s"] = time.perf_counter() - t0
    one.pop("segment_rf_max_abs_err")
    t0 = time.perf_counter()
    read = {"b": one, "c": serve_ranks("c_g4_nccl_4cards", "nccl", cards, one)}
    phases["serve_c_s"] = time.perf_counter() - t0
    del one["answers"]
    return read


def graph_digest(g) -> str:
    """A digest of a graph's edge list, to hold two processes' graphs equal."""
    h = hashlib.blake2b(digest_size=16)
    for a in (g.src, g.dst):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def order_job(scale: int, edge_factor: int, out: str) -> None:
    """The slice-1 graph's GEO order, in a spawned child process: the same
    RMAT graph (a pure function of its seed), ``geo_order`` over it, and the
    permutation, the time it took and the graph's edge count and digest (the
    parent holds its own graph to them) written to ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ordering
    from repro_torch.core.graph import rmat_graph

    g = rmat_graph(scale=scale, edge_factor=edge_factor, seed=0)
    t0 = time.perf_counter()
    order = ordering.geo_order(g, k_min=4, k_max=128)
    np.savez(out, order=order, geo_order_s=time.perf_counter() - t0, num_edges=g.num_edges, digest=graph_digest(g))


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.double() - want.double()) / torch.linalg.vector_norm(want.double()))


def lm_last_logits(M, model, cfg, batch: dict) -> torch.Tensor:
    """The full forward (no cache, as ``forward_train`` runs it): the
    last position's logits."""
    x = M._embed(cfg, model, batch["tokens"], batch)
    enc_out = M._encode(cfg, model, batch["frames"]) if cfg.family == "encdec" else None
    x, _ = M._run_layers(cfg, model, x, enc_out=enc_out)
    x = M.layers.rms_norm(x, model["final_norm"], cfg.norm_eps)
    return M._final_logits(model, cfg, x[:, -1:])[:, 0]


def lm_attention_ops(cfg, batch: int, q_len: int, kv_len: int) -> float:
    """Q·Kᵀ and P·V operations over the key positions each layer's mask
    leaves, for q_len queries ending at position kv_len - 1."""
    ops = 0.0
    for w in cfg.layer_windows():
        vis = sum(min(qp + 1, w) if w else qp + 1 for qp in range(kv_len - q_len, kv_len))
        ops += 4.0 * cfg.head_dim * cfg.num_heads * batch * vis
    return ops


def lm_full_width(dev) -> dict:
    """Path 10 (a): examples/serve_decode.py's loop on gemma3-4b at full width."""
    from repro_torch import configs
    from repro_torch.models import model as M

    cfg = configs.get_config(LM_ARCH)
    b, s, steps = LM_BATCH, LM_PROMPT, LM_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    targets = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    out: dict = {"arch": cfg.name, "batch": b, "prompt": s, "steps": steps, "max_len": LM_MAX_LEN,
                 "params": n_params, "param_count": cfg.param_count(), "param_bytes": param_bytes,
                 "init_s": init_s}
    with torch.inference_mode():
        t0 = time.perf_counter()
        loss, metrics = M.forward_train(model, cfg, {"tokens": prompts, "targets": targets})
        ce = float(metrics["ce_loss"])
        out["train_s"] = time.perf_counter() - t0
        check(bool(torch.isfinite(loss)) and abs(ce - float(np.log(cfg.vocab_size))) < LM_CE_SLACK,
              f"path 10 (a): forward_train's CE {ce} is not within {LM_CE_SLACK} of ln V = {np.log(cfg.vocab_size):.4f}")
        out["ce_loss"], out["ln_v"] = ce, float(np.log(cfg.vocab_size))

        cache = M.init_cache(cfg, b, LM_MAX_LEN, dtype=torch.bfloat16, device=dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        logits, cache = M.forward_prefill(model, cfg, {"tokens": prompts}, cache)
        ev[1].record()
        tok = logits.argmax(-1)[:, None]
        first_tok, finite = tok, torch.isfinite(logits).all()
        for i in range(steps):
            logits, cache = M.forward_decode(model, cfg, tok, cache)
            ev[i + 2].record()
            if i == 0:
                first_logits = logits.clone()
            finite &= torch.isfinite(logits).all()
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        check(bool(finite), "path 10 (a): non-finite logits in prefill or decode")
        check(cache["pos"] == s + steps, f"path 10 (a): the cache ends at {cache['pos']}, expected {s + steps}")
        step_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(steps)]
        out["prefill_ms"] = ev[0].elapsed_time(ev[1])
        out["decode_ms"] = ev[1].elapsed_time(ev[steps + 1])
        out["decode_ms_per_step"] = out["decode_ms"] / steps
        out["decode_step_ms_median"] = float(np.median(step_ms))
        out["decode_step_ms_min_max"] = [min(step_ms), max(step_ms)]
        out["tokens_per_s"] = b * steps / (out["decode_ms"] / 1e3)
        out["serve_wall_s"] = wall_s
        del cache
        # Consistency: the first decode step against a fresh prefill over
        # prompt + first token; then the same in float32 on the same weights.
        full_tokens = {"tokens": torch.cat([prompts, first_tok], dim=1)}
        ref, _ = M.forward_prefill(model, cfg, full_tokens, M.init_cache(cfg, b, LM_MAX_LEN, dtype=torch.bfloat16,
                                                                         device=dev))
        torch.cuda.synchronize()
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        model = model.float()
        cache = M.init_cache(cfg, b, LM_MAX_LEN, device=dev)
        _, cache = M.forward_prefill(model, cfg, {"tokens": prompts}, cache)
        dec32, cache = M.forward_decode(model, cfg, first_tok, cache)
        del cache
        ref32, _ = M.forward_prefill(model, cfg, full_tokens, M.init_cache(cfg, b, LM_MAX_LEN, device=dev))
        torch.cuda.synchronize()
        out["f32_check_s"] = time.perf_counter() - t0
    out["consistency_rel_l2"] = rel_l2(first_logits, ref)
    out["bf16_vs_f32_rel_l2"] = {"prefill": rel_l2(ref, ref32), "decode": rel_l2(first_logits, ref32)}
    out["f32_consistency_rel_l2"] = rel_l2(dec32, ref32)
    check(out["f32_consistency_rel_l2"] < LM_DEPTH2_RTOL,
          f"path 10 (a): in float32, decode against a fresh prefill, relative L2 {out['f32_consistency_rel_l2']:.3e} "
          f"(limit {LM_DEPTH2_RTOL})")
    d16 = out["bf16_vs_f32_rel_l2"]
    check(d16["prefill"] < LM_BF16_RTOL,
          f"path 10 (a): the bf16 prefill against the float32 one, relative L2 {d16['prefill']:.3e} "
          f"(limit {LM_BF16_RTOL})")
    check(d16["decode"] <= LM_BF16_DECODE_SHARE * d16["prefill"],
          f"path 10 (a): the bf16 decode against the float32 prefill, relative L2 {d16['decode']:.3e}, is more than "
          f"{LM_BF16_DECODE_SHARE} times the bf16 prefill's {d16['prefill']:.3e}")
    check(out["consistency_rel_l2"] < d16["prefill"],
          f"path 10 (a): in bf16, decode against a fresh prefill, relative L2 {out['consistency_rel_l2']:.3e}, is not "
          f"below the bf16 prefill's distance from the float32 one ({d16['prefill']:.3e})")
    # Bounds, from this run's shapes. Decode: every weight read once a step,
    # and the K/V each layer's mask leaves (a local layer's window, a global
    # layer's whole prefix), 2 bytes each. Prefill: the layers' matmuls at the
    # bf16 rate (2 operations a weight a token; the embedding is a gather),
    # the lm head's last position and the attention in float32 outside the
    # tensor cores (the reference's mea_attention computes in float32).
    kv_row = 2 * b * cfg.num_kv_heads * cfg.head_dim * 2
    kv_bytes = [kv_row * sum(min(pos + 1, w) if w else pos + 1 for w in cfg.layer_windows())
                for pos in range(s, s + steps)]
    out["decode_bound_ms"] = (param_bytes + float(np.mean(kv_bytes))) / H100_BYTES_PER_S * 1e3
    out["decode_bound_by"] = "bytes"
    embed_params = cfg.vocab_size * cfg.d_model
    mm_ops = 2.0 * (n_params - embed_params) * b * s
    head_ops = 2.0 * b * cfg.d_model * cfg.vocab_size
    attn_ops = lm_attention_ops(cfg, b, s, s)
    out["prefill_ops"] = {"matmul_bf16": mm_ops, "attention_f32": attn_ops, "head_f32": head_ops}
    out["prefill_bound_ms"] = (mm_ops / H100_BF16_OPS_PER_S + (attn_ops + head_ops) / H100_FP32_OPS_PER_S) * 1e3
    out["prefill_bound_by"] = "operations"
    out["tokens_per_s_bound"] = b / (out["decode_bound_ms"] / 1e3)
    log(f"path 10 (a) {cfg.name} at full width, bf16: {n_params:,} parameters built ({cfg.param_count():,} by "
        f"param_count(); {param_bytes / 1e9:.3f} GB), init {init_s:.3f} s; forward_train CE {ce:.4f} "
        f"(ln V {np.log(cfg.vocab_size):.4f}) in {out['train_s']:.3f} s")
    log(f"path 10 (a) serve: prefill {b} x {s} tokens {out['prefill_ms']:.3f} ms (bound {out['prefill_bound_ms']:.3f} "
        f"ms, operations); decode {steps} steps {out['decode_ms_per_step']:.3f} ms a step (median "
        f"{out['decode_step_ms_median']:.3f}, bound {out['decode_bound_ms']:.3f} ms, bytes), "
        f"{out['tokens_per_s']:.1f} tokens/s (bound {out['tokens_per_s_bound']:.1f}); peak memory "
        f"{out['peak_mem_gb']:.3f} GB in bf16")
    log(f"path 10 (a) consistency: decode against a fresh prefill, relative L2 {out['consistency_rel_l2']:.3e} in "
        f"bf16 (limit: the bf16 prefill's distance from the float32 one on the same weights, {d16['prefill']:.3e}, "
        f"itself limited to {LM_BF16_RTOL}; the bf16 decode's {d16['decode']:.3e}, limit "
        f"{LM_BF16_DECODE_SHARE} times the prefill's), {out['f32_consistency_rel_l2']:.3e} in float32 (limit "
        f"{LM_DEPTH2_RTOL}); the float32 runs {out['f32_check_s']:.3f} s")
    del model
    return out


def lm_moe_drops(M, cfg, model, x, cache: dict, q_offset: int) -> tuple:
    """A MoE model's layers one by one, as ``model._block`` runs them, on the
    cache ``cache`` (a copy the caller gives up): each layer's router input
    rms_norm(x + attention, ln2) also routed by ``layers.moe_route`` alone, to
    count the (token, k) entries past the capacity. Returns (the entries
    dropped a layer, the last position's logits)."""
    L = M.layers
    windows = [w or 0 for w in cfg.layer_windows()]
    dropped = []
    for i, p in enumerate(model["layers"]):
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        attn, _ = L.attention_block(p, h, cfg, window=windows[i], q_offset=q_offset,
                                    cache={"k": cache["k"][i], "v": cache["v"][i], "pos": q_offset})
        x = x + attn
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        dropped.append(int((~L.moe_route(h.reshape(1, -1, h.shape[-1]), p["router"], cfg)["kept"]).sum()))
        x = x + L.moe_block(p, h, cfg)[0]
    x = L.rms_norm(x, model["final_norm"], cfg.norm_eps)
    return dropped, M._final_logits(model, cfg, x[:, -1:])[:, 0]


def lm_depth_two(dev, arch: str) -> dict:
    """Path 10 (b): one family at full width and depth 2, in float32."""
    from repro_torch import configs
    from repro_torch.models import model as M

    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, num_layers=2, **({"encoder_layers": 2} if full.encoder_layers else {}))
    b, s = LM_DEPTH2_BATCH, LM_DEPTH2_PROMPT
    t0 = time.perf_counter()
    model = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device=dev)
    batch = {"tokens": tokens[:, :s], "targets": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = 0.02 * torch.randn((b, cfg.num_patches, cfg.d_model), generator=gen, device=dev)
    if cfg.family == "encdec":
        batch["frames"] = 0.02 * torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen, device=dev)
    out: dict = {"arch": arch, "layers": cfg.num_layers, "batch": b, "prompt": s}
    with torch.inference_mode():
        loss, metrics = M.forward_train(model, cfg, batch)
        ce = float(metrics["ce_loss"])
        check(bool(torch.isfinite(loss)) and abs(ce - float(np.log(cfg.vocab_size))) < LM_CE_SLACK,
              f"path 10 (b) {arch}: forward_train's CE {ce} is not within {LM_CE_SLACK} of ln V")
        out["ce_loss"], out["aux_loss"] = ce, float(metrics["aux_loss"])
        want = lm_last_logits(M, model, cfg, batch)
        cache = M.init_cache(cfg, b, LM_DEPTH2_MAX_LEN, device=dev)
        logits, cache = M.forward_prefill(model, cfg, batch, cache)
        check(bool(torch.isfinite(logits).all()), f"path 10 (b) {arch}: non-finite prefill logits")
        out["prefill_rel_l2"] = rel_l2(logits, want)
        check(out["prefill_rel_l2"] < LM_DEPTH2_RTOL,
              f"path 10 (b) {arch}: prefill against the full forward, relative L2 {out['prefill_rel_l2']:.3e}")
        if cfg.family == "moe":
            # The counts of entries dropped, read by a layer loop of their own,
            # whose logits are held to the model's own prefill and decode.
            pre_drops, pre_logits = lm_moe_drops(M, cfg, model, M._embed(cfg, model, batch["tokens"], batch),
                                                 M.init_cache(cfg, b, LM_DEPTH2_MAX_LEN, device=dev), 0)
            dec_drops, dec_logits = lm_moe_drops(M, cfg, model, model["embed"][tokens[:, s:]],
                                                 {k: cache[k].clone() for k in ("k", "v")}, s)
        dec, cache = M.forward_decode(model, cfg, tokens[:, s:], cache)
        check(bool(torch.isfinite(dec).all()), f"path 10 (b) {arch}: non-finite decode logits")
        if cfg.family == "moe":  # drops depend on the token count: decode is held for finiteness only
            out["dropped"] = {"prefill": pre_drops, "decode": dec_drops}
            out["drop_loop_rel_l2"] = {"prefill": rel_l2(pre_logits, logits), "decode": rel_l2(dec_logits, dec)}
            check(max(out["drop_loop_rel_l2"].values()) < LM_DEPTH2_RTOL,
                  f"path 10 (b) {arch}: the drop-counting layer loop strays from the model: relative L2 "
                  f"{out['drop_loop_rel_l2']}")
        else:
            ref, _ = M.forward_prefill(model, cfg, dict(batch, tokens=tokens),
                                       M.init_cache(cfg, b, LM_DEPTH2_MAX_LEN, device=dev))
            out["decode_rel_l2"] = rel_l2(dec, ref)
            check(out["decode_rel_l2"] < LM_DEPTH2_RTOL,
                  f"path 10 (b) {arch}: decode against a fresh prefill over s + 1, relative L2 "
                  f"{out['decode_rel_l2']:.3e}")
    torch.cuda.synchronize()
    out["s"] = time.perf_counter() - t0
    log(f"path 10 (b) {arch} at full width, depth 2, f32: CE {ce:.4f} (ln V {np.log(cfg.vocab_size):.4f}); prefill "
        f"against the full forward {out['prefill_rel_l2']:.3e}"
        + (f", decode against a fresh prefill {out['decode_rel_l2']:.3e}" if "decode_rel_l2" in out else
           "; MoE entries dropped a layer: " + ", ".join(f"{k} {v}" for k, v in out["dropped"].items())
           + f" (the counting loop's logits against the model's, prefill {out['drop_loop_rel_l2']['prefill']:.3e}, "
           f"decode {out['drop_loop_rel_l2']['decode']:.3e})")
        + f" (limit {LM_DEPTH2_RTOL}); {out['s']:.3f} s")
    del model
    return out


def lm_fixture_check(dev) -> dict:
    """Path 10 (c): the 10 smoke configs on the card against the JAX
    package's outputs in ``tests/torch_lm_fixture.npz``."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_lm_harness as LH

    from repro_torch import configs
    from repro_torch.models import model as M

    committed = LH.read_fixture()
    check(sorted(committed) == sorted(configs.ARCH_NAMES), f"path 10 (c): the fixture holds {sorted(committed)}")
    st = LH.FIXTURE_SETUP
    worst = {}
    for arch in configs.ARCH_NAMES:
        cfg = configs.get_smoke(arch)
        got = LH.port_outputs(cfg, LH.numpy_params(M.param_shapes(cfg)), LH.numpy_inputs(cfg, st["batch"], st["seq"]),
                              st["max_len"], dev)
        ratios = {}
        for k, want in committed[arch].items():
            check(got[k].shape == want.shape, f"path 10 (c) {arch} {k}: shape {got[k].shape}, fixture {want.shape}")
            ratios[k] = tol_ratio(torch.from_numpy(got[k]), torch.from_numpy(want), LM_FIXTURE_RTOL, LM_FIXTURE_ATOL)
        key = max(ratios, key=ratios.get)
        check(ratios[key] <= 1.0, f"path 10 (c) {arch}: {key} differs from the JAX fixture "
                                  f"({ratios[key]:.3f} of rtol {LM_FIXTURE_RTOL}, atol {LM_FIXTURE_ATOL})")
        worst[arch] = {"leaves": len(ratios), "worst": key, "ratio": ratios[key]}
    log(f"path 10 (c): the 10 smoke configs on the card equal the JAX fixture (rtol {LM_FIXTURE_RTOL}, atol "
        f"{LM_FIXTURE_ATOL}); worst share of the tolerance by arch: "
        + ", ".join(f"{a} {w['ratio']:.3f} ({w['worst']})" for a, w in worst.items()))
    return worst


def lm_path(dev) -> dict:
    """Path 10: (a), (b) and (c) in turn, the card's memory freed between."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    read = {"a": lm_full_width(dev)}
    gc.collect()
    torch.cuda.empty_cache()
    read["b"] = {}
    for arch in LM_DEPTH2:
        read["b"][arch] = lm_depth_two(dev, arch)
        gc.collect()
        torch.cuda.empty_cache()
    read["c"] = lm_fixture_check(dev)
    torch.cuda.synchronize()
    read["s"] = time.perf_counter() - t0
    return read


def leaf_sample(p: torch.Tensor) -> torch.Tensor:
    """About ``TRAIN_SAMPLE`` elements of a parameter, evenly strided."""
    flat = p.detach().reshape(-1)
    return flat[:: max(1, flat.numel() // TRAIN_SAMPLE)].clone()


def train_full_width(dev) -> dict:
    """Path 11 (a): gemma3-4b's AdamW steps at full width in bf16."""
    from repro_torch import configs
    from repro_torch.data import pipeline as dp
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import steps as S

    cfg = configs.get_config(LM_ARCH)
    b, s, steps = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16, device=dev)
    state = O.init_opt_state(model)
    opt = O.OptConfig(**TRAIN_OPT)
    train_step = S.make_train_step(cfg, opt, remat=True)
    dc = dp.DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b)
    before = {n: leaf_sample(p) for n, p in model.named_parameters()}
    n_params = sum(p.numel() for p in model.parameters())
    # AdamW's share of the step: events around the optimizer's own call.
    real_update = O.adamw_update
    marks: list = []

    def timed_update(*args, **kw):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        out = real_update(*args, **kw)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return out

    O.adamw_update = timed_update
    rows, t0 = [], time.perf_counter()
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in dp.global_batch(dc, step).items()}
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model, state, m = train_step(model, state, batch)
        stop.record()
        rows.append((start, stop, {k: v for k, v in m.items()}))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    O.adamw_update = real_update
    read: dict = {"arch": cfg.name, "batch": b, "seq": s, "params": n_params, "opt": dict(TRAIN_OPT),
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "wall_s": wall_s, "steps": []}
    for i, (start, stop, m) in enumerate(rows):
        adamw_ms = marks[2 * i].elapsed_time(marks[2 * i + 1])
        step_ms = start.elapsed_time(stop)
        read["steps"].append({"loss": float(m["loss"]), "ce_loss": float(m["ce_loss"]),
                              "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]), "step_ms": step_ms,
                              "fwd_bwd_ms": start.elapsed_time(marks[2 * i]), "adamw_ms": adamw_ms,
                              "tokens_per_s": b * s / (step_ms / 1e3)})
    first = read["steps"][0]
    check(all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in read["steps"]),
          f"path 11 (a): a non-finite loss or grad norm: {read['steps']}")
    check(abs(first["ce_loss"] - float(np.log(cfg.vocab_size))) < LM_CE_SLACK,
          f"path 11 (a): step 0's CE {first['ce_loss']} is not within {LM_CE_SLACK} of ln V")
    check(int(state["step"]) == steps, f"path 11 (a): the optimizer's step counter reads {int(state['step'])}")
    moments = [t for key in ("m", "v") for _, t in M._leaves(state[key])]
    check(all(t.dtype == torch.float32 for t in moments), "path 11 (a): a moment is not float32")
    check(all(p.dtype == torch.bfloat16 for p in model.parameters()), "path 11 (a): a parameter is not bf16")
    moved = {n: float((leaf_sample(p) != before[n]).float().mean()) for n, p in model.named_parameters()}
    still = [n for n, share in moved.items() if share == 0]
    check(not still, f"path 11 (a): {len(still)} parameter leaves did not move, e.g. {still[:4]}")
    read["moved_share_min"] = min(moved.values())
    read["leaves"] = len(moved)
    # The step's bound: the forward's operations four times over (the
    # forward, remat's recompute, and a backward of twice the forward's),
    # the layers' matmuls at the bf16 rate, the attention (in float32, as
    # the reference's mea_attention) and the loss's float32 logits at the
    # float32 rate; then AdamW's bytes: each parameter and gradient (bf16)
    # read, m and v (float32) read and written, the parameter written.
    embed_params = cfg.vocab_size * cfg.d_model
    tokens = b * s
    mm_ops = 2.0 * (n_params - embed_params) * tokens
    attn_ops = lm_attention_ops(cfg, b, s, s)
    head_ops = 2.0 * tokens * cfg.d_model * cfg.vocab_size
    read["ops_per_pass"] = {"matmul_bf16": mm_ops, "attention_f32": attn_ops, "loss_logits_f32": head_ops}
    read["fwd_bwd_bound_ms"] = 4 * (mm_ops / H100_BF16_OPS_PER_S + (attn_ops + head_ops) / H100_FP32_OPS_PER_S) * 1e3
    read["adamw_bytes"] = n_params * (2 + 2 + 2 * 4 + 2 + 2 * 4)
    read["adamw_bound_ms"] = read["adamw_bytes"] / H100_BYTES_PER_S * 1e3
    read["step_bound_ms"] = read["fwd_bwd_bound_ms"] + read["adamw_bound_ms"]
    read["tokens_per_s_bound"] = tokens / (read["step_bound_ms"] / 1e3)
    for i, r in enumerate(read["steps"]):
        log(f"path 11 (a) {cfg.name} at full width, bf16, step {i}: loss {r['loss']:.4f} (CE {r['ce_loss']:.4f}, "
            f"ln V {np.log(cfg.vocab_size):.4f}), grad norm {r['grad_norm']:.4f}, lr {r['lr']:.3e}; "
            f"{r['step_ms']:.3f} ms (forward + backward {r['fwd_bwd_ms']:.3f}, AdamW {r['adamw_ms']:.3f}), "
            f"{r['tokens_per_s']:.1f} tokens/s")
    log(f"path 11 (a): bound {read['step_bound_ms']:.3f} ms a step (forward + backward "
        f"{read['fwd_bwd_bound_ms']:.3f} ms, operations; AdamW {read['adamw_bound_ms']:.3f} ms, bytes), "
        f"{read['tokens_per_s_bound']:.1f} tokens/s; peak memory {read['peak_mem_gb']:.3f} GB; every one of "
        f"{read['leaves']} leaves moved (the least moved share {read['moved_share_min']:.3f}); {wall_s:.3f} s")
    del model, state, before
    return read


def train_entry_point(dev) -> dict:
    """Path 11 (b): launch/train.py's main on the card, then its step-50
    checkpoint restored at k = 3 and k = 4."""
    from repro_torch import configs
    from repro_torch.checkpoint import store
    from repro_torch.data import pipeline as dp
    from repro_torch.launch import train as LT
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import steps as S

    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    run = LT.main(["--ckpt-dir", str(ckpt), "--steps", str(TRAIN_LAUNCH_STEPS)])
    torch.cuda.synchronize()
    read: dict = {"s": time.perf_counter() - t0, "loop_s": run["seconds"], "checkpoints": run["checkpoints"]}
    losses = run["losses"]
    check(run["model"]["embed"].device.type == "cuda", "path 11 (b): the launcher did not train on the card")
    check(np.isfinite(losses).all(), "path 11 (b): a non-finite loss")
    read["first5"], read["last10"] = float(np.mean(losses[:5])), float(np.mean(losses[-10:]))
    check(read["last10"] < read["first5"] - TRAIN_LEARN_MARGIN,
          f"path 11 (b): the mean of the last 10 losses {read['last10']:.4f} is not below the first 5's "
          f"{read['first5']:.4f} less {TRAIN_LEARN_MARGIN}")
    want_ckpts = list(range(50, TRAIN_LAUNCH_STEPS, 50))
    check(run["checkpoints"] == want_ckpts, f"path 11 (b): checkpoints at {run['checkpoints']}, expected {want_ckpts}")
    cfg = configs.get_smoke("qwen2-1.5b")
    opt = O.OptConfig(total_steps=TRAIN_LAUNCH_STEPS)
    template = LT.checkpoint_tree(run["model"], O.init_opt_state(run["model"]))
    gb = {k: torch.from_numpy(v).to(dev)
          for k, v in dp.global_batch(dp.DataConfig(cfg.vocab_size, 128, 16), 51).items()}
    trees = {}
    for k in (3, 4):
        trees[k], touched = store.restore(ckpt, 50, k_new=k, template=template)
        read[f"restore_k{k}_bytes_touched"] = int(touched)
    p3, p4 = (dict(M._leaves(trees[k]["params"])) for k in (3, 4))
    o3, o4 = (dict(M._leaves(trees[k]["opt"])) for k in (3, 4))
    same = p3.keys() == p4.keys() and all(np.array_equal(p3[n], p4[n]) for n in p3)
    same = same and o3.keys() == o4.keys() and all(torch.equal(o3[n], o4[n]) for n in o3)
    same = same and int(trees[3]["opt"]["step"]) == int(trees[4]["opt"]["step"]) == 51
    check(same, "path 11 (b): the step-50 checkpoint restored at k = 3 and k = 4 gives two different trees")
    nxt = {k: float(S.make_train_step(cfg, opt)(M.params_from_numpy(cfg, trees[k]["params"], device=dev),
                                                 trees[k]["opt"], gb)[2]["loss"]) for k in (3, 4)}
    read["next_loss"] = {"k3": nxt[3], "k4": nxt[4], "launcher_step_51": losses[51]}
    check(nxt[3] == nxt[4], f"path 11 (b): the next-step losses from k = 3 and k = 4 differ: {nxt}")
    check(abs(nxt[3] - losses[51]) <= 1e-6 * abs(losses[51]),
          f"path 11 (b): the restored next-step loss {nxt[3]} is not the launcher's own step 51, {losses[51]}")
    log(f"path 11 (b) launch/train.py main on the card, qwen2-1.5b smoke, {TRAIN_LAUNCH_STEPS} steps of 16 x 128, "
        f"4 hosts: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 5 {read['first5']:.4f}, of the last 10 "
        f"{read['last10']:.4f}); the step-50 checkpoint restored at k = 3 and 4: equal trees, next-step loss "
        f"{nxt[3]:.6f} (the launcher's step 51: {losses[51]:.6f}); {read['s']:.3f} s")
    shutil.rmtree(ckpt, ignore_errors=True)
    return read


def train_fixture_check(dev) -> dict:
    """Path 11 (c): the 10 smoke configs' train steps on the card against
    the JAX package's in ``tests/torch_train_fixture.npz``."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_lm_harness as LH

    from repro_torch import configs
    from repro_torch.models import model as M

    committed = LH.read_train_fixture()
    want = sorted((a, mb) for a in configs.ARCH_NAMES for mb in LH.TRAIN_MODES)
    check(sorted(committed) == want, f"path 11 (c): the fixture holds {sorted(committed)}")
    worst = {}
    for arch, mb in want:
        cfg = configs.get_smoke(arch)
        got = LH.port_train_outputs(cfg, LH.numpy_params(M.param_shapes(cfg)), LH.train_inputs(cfg), dev, mb)
        ratios = LH.train_fixture_ratios(got, committed[(arch, mb)])
        key = max(ratios, key=ratios.get)
        check(ratios[key] <= 1.0, f"path 11 (c) {arch}, {mb} microbatches: {key} differs from the JAX fixture "
                                  f"({ratios[key]:.3f} of its tolerance)")
        worst[f"{arch}/mb{mb}"] = {"readings": len(ratios), "worst": key, "ratio": ratios[key]}
    log(f"path 11 (c): the 10 smoke configs' train steps on the card equal the JAX fixture (rtol "
        f"{LH.TRAIN_RTOL}, gradients {LH.TRAIN_GRAD_RTOL}); worst share of the tolerance: "
        + ", ".join(f"{k} {w['ratio']:.3f}" for k, w in worst.items()))
    return worst


def train_path(dev) -> dict:
    """Path 11: (a), (b) and (c) in turn, the card's memory freed between."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    read = {"a": train_full_width(dev)}
    gc.collect()
    torch.cuda.empty_cache()
    read["b"] = train_entry_point(dev)
    gc.collect()
    torch.cuda.empty_cache()
    read["c"] = train_fixture_check(dev)
    torch.cuda.synchronize()
    read["s"] = time.perf_counter() - t0
    return read


def lmrank_sp(group, dev) -> dict:
    """Path 12 (a) on this rank: SP decode of gemma3-4b on the 2 x 2 grid."""
    from repro_torch import configs
    from repro_torch.launch import mesh as MM
    from repro_torch.launch import multihost as MH
    from repro_torch.models import dist as D
    from repro_torch.models import model as M

    grid = MM.make_test_mesh(*SP_GRID, group=group)
    dist = D.Distribution(mesh=grid)
    coords = grid.coords
    cfg = configs.get_config(LM_ARCH)
    b, s, steps = LM_BATCH, LM_PROMPT, LM_STEPS
    lo, hi = dist.batch_rows(b)
    slo, shi = dist.seq_slice(LM_MAX_LEN)
    gather = {"calls": 0, "s": 0.0, "bytes": 0}
    real_gather = MH.all_gather_rows

    def timed_gather(t, line):  # models/dist.py reads MH.all_gather_rows at each call
        t0 = time.perf_counter()
        res = real_gather(t, line)
        gather["s"] += time.perf_counter() - t0
        gather["calls"] += 1
        gather["bytes"] += t.numel() * t.element_size() * (line.size - 1)  # received from the line's others
        return res

    MH.all_gather_rows = timed_gather
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    model = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    rows = prompts[lo:hi]
    out: dict = {"coords": coords, "rows": [lo, hi], "slice": [slo, shi]}
    writes, sp_logits, toks = [], [], []
    with torch.inference_mode():
        with D.use_distribution(dist):
            cache = M.init_cache(cfg, b, LM_MAX_LEN, dtype=torch.bfloat16, device=dev)
            check(tuple(cache["k"].shape) == (cfg.num_layers, hi - lo, cfg.num_kv_heads, shi - slo, cfg.head_dim),
                  f"path 12 (a): rank {group.rank}'s cache is {tuple(cache['k'].shape)}")
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 2)]
            torch.cuda.synchronize(dev)
            ev[0].record()
            logits, cache = M.forward_prefill(model, cfg, {"tokens": rows}, cache)
            ev[1].record()
            sp_prefill = logits.float()
            tok = logits.argmax(-1)[:, None]
            gather.update(calls=0, s=0.0, bytes=0)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for i in range(steps):
                pos = cache["pos"]
                if i < SP_WRITE_STEPS:
                    before = [cache[n].clone() for n in ("k", "v")]
                toks.append(tok)
                logits, cache = M.forward_decode(model, cfg, tok, cache)
                ev[i + 2].record()
                if i < SP_WRITE_STEPS:
                    owner, off = slo <= pos < shi, pos - slo
                    rest, written = True, True
                    for old, new in zip(before, (cache["k"], cache["v"])):
                        if owner:
                            keep = [j for j in range(shi - slo) if j != off]
                            rest &= torch.equal(old[:, :, :, keep], new[:, :, :, keep])
                            written &= bool(new[:, :, :, off].any()) and not bool(old[:, :, :, off].any())
                        else:
                            rest &= torch.equal(old, new)
                    writes.append({"pos": pos, "owner": owner, "rest_unchanged": bool(rest),
                                   "written": bool(written) if owner else None})
                    del before
                sp_logits.append(logits.float())
                tok = logits.argmax(-1)[:, None]
            torch.cuda.synchronize(dev)
            decode_wall = time.perf_counter() - t0
        step_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(steps)]
        out.update(prefill_ms=ev[0].elapsed_time(ev[1]), decode_ms=ev[1].elapsed_time(ev[steps + 1]),
                   decode_step_ms_median=float(np.median(step_ms)), decode_wall_s=decode_wall,
                   gather_calls_per_step=gather["calls"] / steps, gather_ms_per_step=gather["s"] * 1e3 / steps,
                   gather_bytes_per_step=gather["bytes"] / steps, writes=writes,
                   finite=bool(torch.isfinite(torch.stack(sp_logits)).all()))
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        MH.all_gather_rows = real_gather
        del cache
        if coords["model"] == 0:  # the plain one-rank decode of the same rows, fed the same tokens
            cache = M.init_cache(cfg, hi - lo, LM_MAX_LEN, dtype=torch.bfloat16, device=dev)
            logits, cache = M.forward_prefill(model, cfg, {"tokens": rows}, cache)
            out["plain_prefill_rel_l2"] = rel_l2(sp_prefill, logits.float())
            dists = []
            for i in range(steps):
                logits, cache = M.forward_decode(model, cfg, toks[i], cache)
                dists.append(rel_l2(sp_logits[i], logits.float()))
            out["plain_rel_l2"] = {"first": dists[0], "last": dists[-1], "max": max(dists)}
            del cache
        del model, sp_logits
        torch.cuda.empty_cache()

        # float32 at one cycle: SP against plain within rtol / atol SP_F32_TOL
        cfg6 = dataclasses.replace(cfg, num_layers=SP_F32_LAYERS)
        model = M.init_params(cfg6, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        with D.use_distribution(dist):
            cache = M.init_cache(cfg6, b, LM_MAX_LEN, device=dev)
            logits, cache = M.forward_prefill(model, cfg6, {"tokens": rows}, cache)
            got, feed = [logits], []
            for _ in range(SP_F32_STEPS):
                feed.append(got[-1].argmax(-1)[:, None])
                got.append(M.forward_decode(model, cfg6, feed[-1], cache)[0])
        del cache
        if coords["model"] == 0:
            cache = M.init_cache(cfg6, hi - lo, LM_MAX_LEN, device=dev)
            want = [M.forward_prefill(model, cfg6, {"tokens": rows}, cache)[0]]
            want += [M.forward_decode(model, cfg6, t, cache)[0] for t in feed]
            out["f32_tol_ratio"] = max(tol_ratio(g, w, SP_F32_TOL, SP_F32_TOL) for g, w in zip(got, want))
            out["f32_max_abs"] = max(float((g - w).abs().max()) for g, w in zip(got, want))
            del cache
        del model
    torch.cuda.empty_cache()
    return out


def lmrank_dp(group, dev) -> dict:
    """Path 12 (b) on this rank: compressed data-parallel gradients of
    qwen2-1.5b (depth DP_LAYERS) on a 4 x 1 grid, every compressed
    all-reduce tapped and checked."""
    from repro_torch import configs
    from repro_torch.data import pipeline as DP
    from repro_torch.launch import mesh as MM
    from repro_torch.launch import multihost as MH
    from repro_torch.models import model as M
    from repro_torch.train import compression as C

    grid = MM.make_rank_grid((group.size, 1), ("data", "model"), group)
    line, n = grid.line("data"), group.size
    cfg = dataclasses.replace(configs.get_config(DP_ARCH), num_layers=DP_LAYERS)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    model = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    dc = DP.DataConfig(vocab_size=cfg.vocab_size, seq_len=DP_SEQ, global_batch=DP_ROWS * n)
    real, tapped = C.compressed_allreduce, []

    def tap(grads, error, group_):  # make_compressed_dp_grad_fn reads it at each call
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        red, new_e = real(grads, error, group_)
        torch.cuda.synchronize(dev)
        tapped[:] = [dict(grads=grads, error=error, reduced=red, new_error=new_e, s=time.perf_counter() - t0)]
        return red, new_e

    C.compressed_allreduce = tap
    fn = C.make_compressed_dp_grad_fn(lambda m, bt: M.forward_train(m, cfg, bt)[0], grid, axis="data")
    err = {name: torch.zeros(p.shape, dtype=torch.float32, device=dev) for name, p in model.named_parameters()}
    out: dict = {"data": grid.coords["data"], "params": sum(p.numel() for p in model.parameters()), "steps": []}
    for step in range(DP_STEPS):
        hb = DP.host_batch(dc, step, n, grid.coords["data"])
        batch = {k: torch.from_numpy(hb[k]).long().to(dev) for k in ("tokens", "targets")}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss, red, new_err = fn(model, batch, err)
        torch.cuda.synchronize(dev)
        total_s = time.perf_counter() - t0
        t = tapped[0]
        names = sorted(red)
        digest = hashlib.sha256(b"".join(red[k].cpu().numpy().tobytes() for k in names)).digest()
        digests = MH.all_gather_rows(torch.tensor(list(digest), dtype=torch.uint8)[None], line)
        rel, exact = 0.0, True
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for k in names:
            C.quantize(t["grads"][k].float() + t["error"][k])
        ev[1].record()
        for k in names:
            gp = t["grads"][k].float() + t["error"][k]
            want = MH.all_reduce(gp, line, "sum") / n
            rel = max(rel, float((red[k] - want).abs().max() / want.abs().max().clamp_min(1e-30)))
            scale = MH.all_reduce(C._div(gp.abs().max() + 1e-12, 127.0), line, "max")
            q = torch.clamp(torch.round(gp / scale), -127, 127)
            exact &= torch.equal(new_err[k], (gp.double() - q.double() * scale.double()).float())
        torch.cuda.synchronize(dev)
        out["steps"].append({
            "loss": float(loss), "total_ms": total_s * 1e3, "allreduce_ms": t["s"] * 1e3,
            "grad_ms": (total_s - t["s"]) * 1e3, "quantize_ms": ev[0].elapsed_time(ev[1]),
            "int32_bytes": sum(red[k].numel() * 4 + 4 for k in names), "max_rel_err": rel,
            "digests_equal": bool((digests == digests[0]).all()), "error_exact": bool(exact)})
        err = new_err
        del red, t, loss
        tapped.clear()
    C.compressed_allreduce = real
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del model, err
    torch.cuda.empty_cache()
    return out


def lmrank_worker(run_dir: pathlib.Path) -> int:
    """One rank of path 12 (``--lm-rank-worker``, started by ``lmrank_path``
    through ``launch_local_cluster``): (a) and (b) on the rank's device,
    with the port's kernel counters read at the end. Writes ``rank{r}.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import (decode_attention, edge_spmv, flash_attention, full_reorder, min_sweep,
                                     rescale_migrate, segment_rf)
    from repro_torch.launch import multihost as MH

    group = MH.initialize_from_env(timeout_s=LMRANK_GROUP_TIMEOUT_S)
    dev = group.torch_device
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 stays float32, as in path 10 (b)
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"segment_rf": segment_rf, "edge_spmv": edge_spmv, "flash_attention": flash_attention,
               "decode_attention": decode_attention, "full_reorder": full_reorder, "rescale_migrate": rescale_migrate,
               "min_sweep": min_sweep}
    out = {"rank": group.rank, "sp": lmrank_sp(group, dev), "dp": lmrank_dp(group, dev)}
    out["launches"] = {name: m.launches for name, m in kernels.items()}
    (run_dir / f"rank{group.rank}.json").write_text(json.dumps(out))
    log(f"rank {group.rank}: SP decode {out['sp']['decode_ms'] / LM_STEPS:.3f} ms a step, compressed DP "
        f"{[round(st['total_ms'], 1) for st in out['dp']['steps']]} ms")
    return 0


def lmrank_path() -> dict:
    """Path 12 (a) and (b): four gloo ranks on the one card, each a process
    running ``lmrank_worker``; the parent checks every rank's gates and
    returns the readings by rank."""
    from repro_torch.launch import multihost as MH

    run_dir = ROOT / "build" / "lmrank"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    res = MH.spawn_local_cluster(LMRANK_RANKS, 1, [str(ROOT / "chip_smoke.py"), "--lm-rank-worker", str(run_dir)],
                                 backend="gloo", devices=["cuda:0"] * LMRANK_RANKS, timeout=LMRANK_TIMEOUT_S,
                                 env_extra={"PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    for p in res.procs:
        for line in p.stdout.splitlines():
            log(f"path 12 {line}")
    check(res.ok, f"path 12: a rank failed\n{res.format_logs()}")
    ranks = [json.loads((run_dir / f"rank{r}.json").read_text()) for r in range(LMRANK_RANKS)]
    shutil.rmtree(run_dir, ignore_errors=True)
    for rk in ranks:
        r, sp, dp = rk["rank"], rk["sp"], rk["dp"]
        check(rk["launches"] == dict.fromkeys(KERNELS, 0), f"path 12: rank {r} launched {rk['launches']}")
        check(sp["finite"], f"path 12 (a): rank {r}'s SP logits are not finite")
        check(len(sp["writes"]) == SP_WRITE_STEPS and all(w["rest_unchanged"] and w["written"] in (True, None)
                                                          for w in sp["writes"]),
              f"path 12 (a): rank {r}'s cache writes {sp['writes']}: only the owner of a position may write it")
        if sp["coords"]["model"] == 0:
            check(sp["plain_rel_l2"]["max"] < LM_BF16_RTOL,
                  f"path 12 (a): rank {r}'s SP logits against the plain decode, relative L2 {sp['plain_rel_l2']} "
                  f"(limit {LM_BF16_RTOL})")
            check(sp["f32_tol_ratio"] <= 1.0,
                  f"path 12 (a): in float32 at {SP_F32_LAYERS} layers, rank {r}'s SP logits miss the plain ones by "
                  f"{sp['f32_tol_ratio']:.3f} of rtol = atol = {SP_F32_TOL}")
        for i, st in enumerate(dp["steps"]):
            check(st["digests_equal"], f"path 12 (b): step {i}: the reduced gradients differ across ranks")
            check(st["max_rel_err"] < DP_REL_BOUND,
                  f"path 12 (b): rank {r} step {i}: relative error {st['max_rel_err']:.4f} against the uncompressed "
                  f"mean (limit {DP_REL_BOUND})")
            check(st["error_exact"], f"path 12 (b): rank {r} step {i}: new_error is not g - q·scale")
    owners = [[w["owner"] for w in rk["sp"]["writes"]] for rk in ranks]
    check(all(sum(col) == 2 for col in zip(*owners)),
          f"path 12 (a): each decode position must have one owner a data row, got {owners}")
    decode_s = max(rk["sp"]["decode_ms"] for rk in ranks) / 1e3
    read = {
        "wall_s": wall, "grid": list(SP_GRID), "arch": LM_ARCH, "batch": LM_BATCH, "prompt": LM_PROMPT,
        "steps": LM_STEPS, "cache": LM_MAX_LEN,
        "prefill_ms_by_rank": [rk["sp"]["prefill_ms"] for rk in ranks],
        "decode_ms_per_step_by_rank": [rk["sp"]["decode_ms"] / LM_STEPS for rk in ranks],
        "decode_step_ms_median_by_rank": [rk["sp"]["decode_step_ms_median"] for rk in ranks],
        "tokens_per_s": LM_BATCH * LM_STEPS / decode_s,
        "gather_ms_per_step_by_rank": [rk["sp"]["gather_ms_per_step"] for rk in ranks],
        "gather_bytes_per_step_by_rank": [rk["sp"]["gather_bytes_per_step"] for rk in ranks],
        "gather_calls_per_step": ranks[0]["sp"]["gather_calls_per_step"],
        "peak_mem_gb_by_rank": [rk["sp"]["peak_mem_gb"] for rk in ranks],
        "plain_rel_l2": {rk["rank"]: rk["sp"]["plain_rel_l2"] for rk in ranks if "plain_rel_l2" in rk["sp"]},
        "plain_prefill_rel_l2": {rk["rank"]: rk["sp"]["plain_prefill_rel_l2"] for rk in ranks
                                 if "plain_prefill_rel_l2" in rk["sp"]},
        "f32_tol_ratio": {rk["rank"]: rk["sp"]["f32_tol_ratio"] for rk in ranks if "f32_tol_ratio" in rk["sp"]},
        "f32_max_abs": {rk["rank"]: rk["sp"]["f32_max_abs"] for rk in ranks if "f32_max_abs" in rk["sp"]},
        "writes": {rk["rank"]: rk["sp"]["writes"] for rk in ranks},
        "dp": {"arch": DP_ARCH, "layers": DP_LAYERS, "tokens_per_rank": DP_ROWS * DP_SEQ,
               "params": ranks[0]["dp"]["params"], "steps_by_rank": [rk["dp"]["steps"] for rk in ranks],
               "peak_mem_gb_by_rank": [rk["dp"]["peak_mem_gb"] for rk in ranks]},
    }
    log(f"path 12 (a) SP decode over {SP_GRID} gloo ranks on one card, {LM_ARCH} bf16: prefill "
        f"{[round(x, 1) for x in read['prefill_ms_by_rank']]} ms, decode "
        f"{[round(x, 2) for x in read['decode_ms_per_step_by_rank']]} ms a step, {read['tokens_per_s']:.1f} tokens/s; "
        f"all-gather {[round(x, 2) for x in read['gather_ms_per_step_by_rank']]} ms and "
        f"{read['gather_bytes_per_step_by_rank'][0]:.0f} bytes a step a rank; peak "
        f"{[round(x, 2) for x in read['peak_mem_gb_by_rank']]} GB; against plain: {read['plain_rel_l2']}; float32 "
        f"tolerance ratio {read['f32_tol_ratio']}")
    log(f"path 12 (b) compressed DP over {LMRANK_RANKS} ranks, {DP_ARCH} depth {DP_LAYERS} float32: "
        + "; ".join(f"rank {r}: " + ", ".join(f"{st['total_ms']:.0f} ms (all-reduce {st['allreduce_ms']:.0f}, "
                                              f"quantize {st['quantize_ms']:.2f}) rel {st['max_rel_err']:.4f}"
                                              for st in steps)
                    for r, steps in enumerate(read["dp"]["steps_by_rank"])))
    return read


def dryrun_path() -> dict:
    """Path 12 (c): the dry run's plan for every cell, then ``--run`` of the
    cells whose plan fits one card."""
    from repro_torch.launch import dryrun as DR

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # a line a cell; the records are in artifacts/dryrun_torch
        plans = DR.main(["--all", "--mesh", "both"])
    plan_s = time.perf_counter() - t0
    fits = sorted((r["arch"], r["shape"]) for r in plans
                  if not r.get("skipped") and r["mesh"] == "16x16" and r["one_card"]["fits"])
    t0 = time.perf_counter()
    runs = DR.main(["--run"])
    run_s = time.perf_counter() - t0
    check(sorted((r["arch"], r["shape"]) for r in runs) == fits,
          f"path 12 (c): --run ran {[(r['arch'], r['shape']) for r in runs]}, the plan fits {fits}")
    check(all(r["finite"] for r in runs), "path 12 (c): a run's step gave non-finite values")
    keep = ("arch", "shape", "step_ms", "bound_ms", "bound_by", "step_over_bound", "max_memory_allocated",
            "memory_over_plan")
    read = {"plan_s": plan_s, "run_s": run_s, "cells": len(plans), "fits": fits,
            "runs": [{**{k: r[k] for k in keep}, "plan_bytes": r["plan"]["plan_bytes_per_device"],
                      "input_bytes": r["plan"]["input_bytes_per_device"]["total"]} for r in runs]}
    for r in read["runs"]:
        log(f"path 12 (c) {r['arch']} x {r['shape']}: step {min(r['step_ms']):.3f} ms (bound {r['bound_ms']:.3f} ms, "
            f"{r['bound_by']}, {r['step_over_bound']:.2f}x); peak {r['max_memory_allocated'] / 1e9:.3f} GB against "
            f"the plan's {r['plan_bytes'] / 1e9:.3f} GB")
    return read


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20, help="RMAT scale: 2**scale vertices")
    ap.add_argument("--edge-factor", type=int, default=16, help="RMAT edges sampled per vertex")
    ap.add_argument("--cards", type=int, default=1,
                    help="4: only slice 1, path 5 (a) and (c), and paths 6 (c), 7 (c), 8 (c) and 9 (c), (c) being "
                         "g = 4 ranks over NCCL, one card each")
    ap.add_argument("--rank-worker", type=pathlib.Path, help=argparse.SUPPRESS)  # one rank of path 5
    ap.add_argument("--stream-rank-worker", type=pathlib.Path, help=argparse.SUPPRESS)  # one rank of path 6
    ap.add_argument("--oc-worker", type=pathlib.Path, help=argparse.SUPPRESS)  # one rank of path 7
    ap.add_argument("--lm-rank-worker", type=pathlib.Path, help=argparse.SUPPRESS)  # one rank of path 12
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.rank_worker is not None:
        return multirank_worker(args.rank_worker)
    if args.stream_rank_worker is not None:
        return streamrank_worker(args.stream_rank_worker)
    if args.oc_worker is not None:
        return outofcore_worker(args.oc_worker)
    if args.lm_rank_worker is not None:
        return lmrank_worker(args.lm_rank_worker)
    check(args.cards in (1, 4) and torch.cuda.device_count() >= args.cards,
          f"--cards {args.cards}: 1 or 4 cards, and {torch.cuda.device_count()} are visible")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.compat import PAD_ID
    from repro_torch.core import cep, metrics
    from repro_torch.core.graph import rmat_graph
    from repro_torch.elastic.rescale_exec import EDGE_BYTES, ElasticRescaler
    from repro_torch.graphs import engine as E
    from repro_torch.kernels import _build, edge_spmv, ops, segment_rf
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import min_sweep as MS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import full_reorder as FRK
    from repro_torch.kernels import rescale_migrate as RM
    from repro_torch.kernels.ref import segment_distinct_counts_ref

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    modules = {"segment_rf": segment_rf, "edge_spmv": edge_spmv, "flash_attention": fa, "decode_attention": dec,
               "full_reorder": FRK, "rescale_migrate": RM, "min_sweep": MS}

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

    # The slice-1 graph's GEO order (host, 100-190 s at RMAT-20) runs in a
    # spawned child while this process builds, checks parity and drives the
    # paths that need no RMAT-20 order; the child is daemonic, so it ends
    # with this process whatever happens.
    order_out = ROOT / "build" / "order" / "geo_order.npz"
    order_out.parent.mkdir(parents=True, exist_ok=True)
    order_out.unlink(missing_ok=True)
    order_proc = multiprocessing.get_context("spawn").Process(
        target=order_job, args=(args.scale, args.edge_factor, str(order_out)), daemon=True)
    order_proc.start()

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    built = KERNELS if args.cards == 1 else ("segment_rf", "full_reorder", "rescale_migrate", "min_sweep")  # paths 5-7
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

    # ------------------------------------------------------- graph
    t0 = time.perf_counter()
    g = rmat_graph(scale=args.scale, edge_factor=args.edge_factor, seed=0)
    phases["rmat_s"] = time.perf_counter() - t0
    n, v = g.num_edges, g.num_vertices
    log(f"graph: |V|={v} |E|={n} rmat {phases['rmat_s']:.3f} s")

    # Paths 6 (b) and 8 (b) on path 4's graph: they need no RMAT-20 order.
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

    def run_control_drill(tag, backend, live_devices, recover_devices, graph) -> dict:
        reset_launches()
        t0 = time.perf_counter()
        read = control_drill(tag, backend, live_devices, recover_devices, graph)
        phases[f"control_{tag}_s"] = time.perf_counter() - t0
        parent = read_launches()
        check(parent == dict.fromkeys(KERNELS, 0), f"path 8 ({tag}): the parent launched {parent}, expected none")
        return read

    def check_streamrank_a(a: dict) -> None:
        check(any(e.get("repair") == "device" for e in a["events"]), "path 6 (a): no span repair ran over the ranks")

    def check_streamrank_b(b: dict) -> None:
        check([(r["committed"], r["aborted"]) for r in b["log"]] == [(True, False), (False, True)],
              f"path 6 (b): rebuild log {b['log']}")
        check(all(n > 0 for n in b["greedy_launches"]),
              f"path 6 (b): the greedy kernel must launch on every rank, launched {b['greedy_launches']}")

    gen = torch.Generator(device=dev).manual_seed(0)
    if args.cards == 1:  # the four-card call runs slice 1, path 5 (a) and (c), paths 6 (c), 7 (c), 8 (c), 9 (c) only
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
        # The kernel adds with atomics in a varying order: every float case is
        # held to the order-independent summation bound; "hub-integer" draws
        # weights and x from the integers in [-8, 8], so every partial sum of
        # its 5,001 products (|sum| <= 5,001 * 64 < 2^24) is exact in f32 and
        # the kernel must equal the plain version bit for bit.
        for c, we, wv, lo, hi, layout in [
                (2, 16, 32, 0, 33, "random"), (5, 64, 128, 0, 129, "random"), (3, 128, 256, 0, 257, "random"),
                (1, 1, 8, 0, 8, "random"), (1, 300, 64, 64, 100, "random"), (4, 5000, 512, -3, 600, "random"),
                (3, 5_001, 512, 0, 512, "hub"), (3, 5_001, 512, 0, 512, "hub-integer"),
                (2, 9_999, 512, 0, 512, "alternating"),
                (5, 40_001, 4096, -1, 4097, "sorted"), (700, 6_001, 1024, 0, 1025, "sorted"),
                (70_000, 3, 8, 0, 9, "sorted")]:
            src_ids = rng.integers(lo, hi, size=(c, we)).astype(np.int32)
            dst_ids = {"random": lambda: rng.integers(lo, hi, size=(c, we)),
                       "hub": lambda: np.full((c, we), 7), "hub-integer": lambda: np.full((c, we), 7),
                       "alternating": lambda: np.broadcast_to(np.arange(we) % 2 * 5 + 3, (c, we)),
                       "sorted": lambda: np.sort(rng.integers(lo, hi, size=(c, we)), axis=1)}[layout]()
            ids = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev) for a in (src_ids, dst_ids)]
            draw = (lambda shape: rng.integers(-8, 9, size=shape)) if layout == "hub-integer" else rng.standard_normal
            w_t = torch.from_numpy(draw((c, we)).astype(np.float32)).to(dev)
            x_t = torch.from_numpy(draw((c, wv)).astype(np.float32)).to(dev)
            got = edge_spmv.spmv_blocked(*ids, w_t, x_t)
            plain = edge_spmv.spmv_blocked_torch(*ids, w_t, x_t)
            what = f"(C, W_E, W_V) = ({c}, {we}, {wv}), ids in [{lo}, {hi}), {layout} dst"
            err = float((got - plain).abs().max())
            if layout == "hub-integer":
                check(torch.equal(got, plain) and torch.equal(got.double().reshape(-1), spmv_sums64(*ids, w_t, x_t)[0]),
                      f"edge_spmv parity at {what}: integer sums must be exact")
                log(f"parity edge_spmv {what}: exact, equal to the plain version bit for bit")
            else:
                share = within_summation_bound(got, plain, *ids, w_t, x_t, f"edge_spmv parity at {what}")
                log(f"parity edge_spmv {what}: max abs err {err:.3e} to the plain version; {share:.3f} of the "
                    f"summation bound")
            if lo >= wv:
                check(not bool(got.any()), "edge_spmv: all-padding rows must add exactly 0")
            report["edge_spmv"]["max_abs_err"] = max(report["edge_spmv"]["max_abs_err"], err)

        # -------------------------------------------- kernel parity: rescale_migrate
        # Each case's table is rank `rank` of g's, built from the plan alone.
        migrate_gen = torch.Generator(device=dev).manual_seed(2)
        for case in MIGRATE_PARITY:
            n_, k_old, k_new, g_, rank, old_off, new_off = case
            prog = migrate_program(ElasticRescaler(), n_, k_old, k_new, g_, rank, dev)
            m_old = -(-k_old // g_)
            e_old = -(-n_ // k_old)
            buf = torch.randint(-2**30, 2**30, (m_old * e_old * 2 + 2 * old_off,), dtype=torch.int32, device=dev,
                                generator=migrate_gen)
            left = migrate_parity(RM, buf[2 * old_off:].view(m_old, e_old, 2), prog, new_off,
                                  f"rescale_migrate parity at {case}")
            log(f"parity rescale_migrate (|E|, k_old, k_new, g, rank, old/new view offsets) = {case}: E_max "
                f"{prog.table.width}, {prog.table.rows} rows, {len(prog.table.pieces)} pieces, {prog.table.tiles} "
                f"tiles: byte-equal, {left} slots of receive ranges left unwritten")

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

    if args.cards == 1:
        # Paths 10, 9 (b), 4 and 8 (a) need no RMAT-20 order: they run while
        # the child process orders the slice-1 graph.
        # ------------------------------------- path 10: the LM harness's forward pass
        reset_launches()
        t0 = time.perf_counter()
        lm_read = lm_path(dev)
        torch.cuda.synchronize()
        phases["lm_s"] = time.perf_counter() - t0
        lm_launches = read_launches()
        check(lm_launches == dict.fromkeys(KERNELS, 0), f"path 10 launched {lm_launches}, expected none")
        log(f"path 10: {phases['lm_s']:.3f} s, launches {lm_launches}")
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------------------------- path 11: LM training
        reset_launches()
        t0 = time.perf_counter()
        train_read = train_path(dev)
        torch.cuda.synchronize()
        phases["train_s"] = time.perf_counter() - t0
        train_launches = read_launches()
        check(train_launches == dict.fromkeys(KERNELS, 0), f"path 11 launched {train_launches}, expected none")
        log(f"path 11: {phases['train_s']:.3f} s, launches {train_launches}")
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------------------------ path 12: the LM over ranks
        reset_launches()
        t0 = time.perf_counter()
        lmrank_read = lmrank_path()
        phases["lmrank_ab_s"] = time.perf_counter() - t0
        lmrank_read["dryrun"] = dryrun_path()
        torch.cuda.synchronize()
        phases["lmrank_s"] = time.perf_counter() - t0
        lmrank_launches = read_launches()
        check(lmrank_launches == dict.fromkeys(KERNELS, 0), f"path 12 launched {lmrank_launches}, expected none")
        log(f"path 12: {phases['lmrank_s']:.3f} s, launches {lmrank_launches}")
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------------- path 9 (b): the reference's serving scenario
        reset_launches()
        t0 = time.perf_counter()
        serve_b = serve_scenario(dev, phases, segment_rf)
        torch.cuda.synchronize()
        phases["serve_b_s"] = time.perf_counter() - t0
        serve_b_launches = read_launches()
        check(serve_b_launches == {**dict.fromkeys(KERNELS, 0), **serve_b["launches"]},
              f"path 9 (b) launched {serve_b_launches}, expected segment_rf {serve_b['launches']['segment_rf']} times, the "
              f"greedy kernel {serve_b['launches']['full_reorder']} times, min_sweep {serve_b['launches']['min_sweep']} "
              f"times, and nothing else")
        log(f"path 9 (b): {phases['serve_b_s']:.3f} s, launches {serve_b_launches}")
        report["segment_rf"]["max_abs_err"] = max(report["segment_rf"]["max_abs_err"],
                                                  serve_b.pop("segment_rf_max_abs_err"))
        del serve_b["answers"]
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

        # ------------------------------------------------- path 8: the control plane
        # (a) one rank in this process, the kernels tapped ((b), the drill, runs
        # after path 7).
        reset_launches()
        t0 = time.perf_counter()
        control_read = {"a": control_path(dev, rungs_read["graph"], segment_rf)}
        torch.cuda.synchronize()
        phases["control_a_s"] = time.perf_counter() - t0
        control_launches = read_launches()
        ca = control_read["a"]["launches"]
        check(control_launches == {**dict.fromkeys(KERNELS, 0), "segment_rf": sum(ca["segment_rf"]),
                                   "full_reorder": sum(ca["full_reorder"])},
              f"path 8 (a) launched {control_launches}, expected segment_rf {sum(ca['segment_rf'])} times, the greedy "
              f"kernel {sum(ca['full_reorder'])} times, and nothing else")
        log(f"path 8 (a): {phases['control_a_s']:.3f} s, launches {control_launches}")
        report["segment_rf"]["max_abs_err"] = max(report["segment_rf"]["max_abs_err"],
                                                  control_read["a"].pop("segment_rf_max_abs_err"))
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------ path 6 (b): the streaming engine over ranks
        # on path 4's graph, 4 gloo ranks (2 processes x 2) on the one card ((a),
        # on the slice-1 graph, runs after path 5).
        g14 = rungs_read.pop("graph")
        streamrank_read = {"b": run_streamrank("b_g4_gloo_1card", "gloo", ["cuda:0"] * 4, STREAMRANK_B,
                                               streamrank_inputs(g14), g14[0].num_vertices)}
        check_streamrank_b(streamrank_read["b"])
        streamrank_rows = streamrank_read["b"].pop("rows")
        gc.collect()
        torch.cuda.empty_cache()

        # ----------------------------------------- path 8 (b): the SIGKILL drill
        # over 4 gloo ranks on the one card, recovered on 2.
        control_read["b"] = run_control_drill("b_g4_gloo_1card", "gloo", ["cuda:0"] * 4, ["cuda:0"] * 2, g14)
        del g14
        gc.collect()
        torch.cuda.empty_cache()

    # -------------------------------------------- the slice-1 graph's GEO order
    t0 = time.perf_counter()
    order_proc.join()
    check(order_proc.exitcode == 0, f"the GEO order's child process exited with {order_proc.exitcode}")
    phases["order_wait_s"] = time.perf_counter() - t0
    with np.load(order_out) as z:
        order = z["order"]
        phases["geo_order_s"] = float(z["geo_order_s"])
        check(int(z["num_edges"]) == g.num_edges and str(z["digest"]) == graph_digest(g),
              f"the GEO order's child built another graph ({int(z['num_edges'])} edges, digest {z['digest']}) than "
              f"the parent's ({g.num_edges} edges, digest {graph_digest(g)})")
    src, dst = g.src[order], g.dst[order]
    log(f"graph: GEO order {phases['geo_order_s']:.3f} s in the child process; waited {phases['order_wait_s']:.3f} s "
        f"for it after the paths that need no order")

    # ------------------------------------------------- slice 1: the graph path
    rescaler = ElasticRescaler()
    packs, expected_launches, expected_migrations = {}, 0, 0
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
        expected_migrations += 1
        rescales[name] = (new, stats, plan)
        phases[f"rescale_{name}_s"] = stats.elapsed_s
        phases[f"recheck_{name}_s"] = stats.recheck_s
    t0 = time.perf_counter()
    d17, d4 = rescales["16to17"][0], packs[4]
    pr17, pr4 = E.pagerank(d17, iterations=20), E.pagerank(d4, iterations=20)
    torch.cuda.synchronize()
    phases["pagerank_x2_s"] = time.perf_counter() - t0
    source = int(torch.argmax(d4.degrees))
    slice1_sweeps: list = []  # every sweep's x, nx and flags, held after the path (the packs stay as they are)
    with sweeps_tapped(MS, slice1_sweeps, at_once=False):
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
    slice1_sweeps = [sweep_exact(MS, rec) for rec in slice1_sweeps]
    sweeps = it_s17 + it_s4 + it_w17 + it_w4
    check(slice1_launches == {**dict.fromkeys(KERNELS, 0), "segment_rf": expected_launches,
                              "rescale_migrate": expected_migrations, "min_sweep": sweeps},
          f"slice 1 launched {slice1_launches}, expected segment_rf {expected_launches} times, rescale_migrate "
          f"{expected_migrations}, min_sweep {sweeps} and nothing else")
    check(len(slice1_sweeps) == sweeps and all(x["exact"] for x in slice1_sweeps),
          f"slice 1: {len(slice1_sweeps)} min_sweep launches tapped for {sweeps} sweeps, exact "
          f"{[x['exact'] for x in slice1_sweeps]}")
    report["min_sweep"]["slice1_sweeps"] = {f"{kind}_k{k}": it for kind, k, it in (
        ("sssp", 17, it_s17), ("sssp", 4, it_s4), ("wcc", 17, it_w17), ("wcc", 4, it_w4))}
    log(f"slice 1 launches: {slice1_launches} (segment_rf = {len(packs)} packs + {len(rescales)} re-checked rescales; "
        f"rescale_migrate one a rescale; min_sweep one a sweep of SSSP and WCC at k = 17 and 4, each equal to the "
        f"plain version bit for bit: x, nx and the flags)")
    del slice1_sweeps

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

    def run_outofcore(tag, backend, devices) -> dict:
        reset_launches()
        t0 = time.perf_counter()
        read = outofcore_path(tag, backend, devices)
        phases[f"outofcore_{tag}_s"] = time.perf_counter() - t0
        parent = read_launches()
        check(parent == dict.fromkeys(KERNELS, 0), f"path 7 ({tag}): the parent launched {parent}, expected none")
        return read

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
        check_streamrank_a(streamrank_read["a"])
        check_streamrank_b(streamrank_read["b"])
        for read in streamrank_read.values():
            read.pop("rows", None)
        # Path 7 (c): the out-of-core pipeline over NCCL, one card a rank.
        outofcore_read = {"c": run_outofcore("c_g4_nccl_4cards", "nccl", cards)}
        log(json.dumps({"outofcore": outofcore_read}))
        # Path 8 (c): the SIGKILL drill over NCCL, one card a rank.
        control_read = {"c": run_control_drill("c_g4_nccl_4cards", "nccl", cards, cards[:2], g14)}
        log(json.dumps({"control": control_read}))
        # Path 9 (c): the serving scenario over NCCL, one card a rank, against
        # the same scenario on one rank in this process.
        reset_launches()
        log(json.dumps({"serve": serve_over_cards(cards, phases, segment_rf)}))
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
    stream_read, stream_eng = stream_path(g, src, dst, dev, phases)
    torch.cuda.synchronize()
    phases["stream_path_s"] = time.perf_counter() - t0
    stream_launches = read_launches()
    check(stream_launches == dict.fromkeys(KERNELS, 0), f"stream path launched {stream_launches}, expected none")
    log(f"stream path: {phases['stream_path_s']:.3f} s, launches {stream_launches}")

    # --------------------------- path 9 (a): serving at full width on path 3's engine
    # Run here, where path 3 hands its engine over (no second orderer build or
    # upload); the rescale 16->20 is the autoscaler's. Of the port's kernels
    # only min_sweep launches (SSSP's and WCC's sweeps); PageRank and the
    # compact are torch ops.
    reset_launches()
    t0 = time.perf_counter()
    serve_a, stream_read["span"] = serve_full_width(stream_eng, phases)
    torch.cuda.synchronize()
    phases["serve_a_s"] = time.perf_counter() - t0
    serve_a_launches = read_launches()
    check(serve_a_launches == {**dict.fromkeys(KERNELS, 0), "min_sweep": serve_a["min_sweep"]["launches"]},
          f"path 9 (a) launched {serve_a_launches}, expected min_sweep {serve_a['min_sweep']['launches']} times "
          f"and nothing else")
    log(f"path 9 (a): {phases['serve_a_s']:.3f} s, launches {serve_a_launches}")
    del stream_eng
    gc.collect()
    torch.cuda.empty_cache()

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

    # --------------------------------- path 6 (a): the streaming engine over several ranks
    # over g = 4 gloo ranks, 2 processes x 2, every rank on the one card ((b) ran
    # while the slice-1 graph was being ordered).
    streamrank_read = {"a": run_streamrank("a_g4_gloo_1card", "gloo", ["cuda:0"] * 4, STREAMRANK_A, ordered_npz, v),
                       **streamrank_read}
    check_streamrank_a(streamrank_read["a"])
    streamrank_read["a"].pop("rows", None)
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------- path 7: the out-of-core pipeline
    # (a) g = 4 over gloo, 2 processes x 2 ranks, every rank on the one card.
    outofcore_read = {"a": run_outofcore("a_g4_gloo_1card", "gloo", ["cuda:0"] * 4)}
    gc.collect()
    torch.cuda.empty_cache()

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

    # rescale_migrate at slice 1's three plans, on the packs they ran on (the
    # programs are the ones slice 1's rescaler cached).
    migrate_times = []
    for name, (new, stats, plan) in rescales.items():
        old = {"16to17": packs[16], "8to12": packs[8], "12to8": rescales["8to12"][0]}[name]
        prog = migrate_program(rescaler, n, plan.k_old, plan.k_new, 1, 0, old.edges.device)
        mt = migrate_timing(RM, prog, old.edges)
        mt.update(execute_ms=stats.elapsed_s * 1e3)
        migrate_times.append(mt)
        log(f"rescale_migrate {name} ({mt['shape'][0]} rows of {mt['shape'][1]}, {mt['pieces']} pieces, {mt['tiles']} "
            f"tiles): {mt['ms']:.4f} ms on the card alone, {mt['wrapper_ms']:.4f} ms a wrapper call, plain "
            f"{mt['plain_ms']:.4f} ms, index_select {mt['library_ms']:.4f} ms, bound {mt['bound_ms']:.4f} ms "
            f"({mt['bytes']} B; {mt['bound_share']:.3f} of it); execute {mt['execute_ms']:.3f} ms in slice 1; "
            f"byte-equal to the plain version and to index_select")
        torch.cuda.empty_cache()
    report["rescale_migrate"].update(migrate_times[0], other_shapes=migrate_times[1:])

    # min_sweep on slice 1's k = 16 pack: WCC's first sweep (nearly every
    # slot lowers its higher endpoint: the most atomics) and a sweep from
    # SSSP's answer (nothing lowers: the loads and gathers alone).
    sweep_times = [sweep_timing(MS, packs[16].edges, packs[16].mask, torch.arange(v, dtype=torch.float32, device=dev),
                                0.0),
                   sweep_timing(MS, packs[16].edges, packs[16].mask, ss4, 1.0)]
    for what, st in zip(("WCC's first sweep", "a sweep from SSSP's answer"), sweep_times):
        log(f"min_sweep {what} {st['shape']} (changed {st['changed']}): {st['ms']:.4f} ms on the card alone, "
            f"{st['wrapper_ms']:.4f} ms a wrapper call, plain {st['plain_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms "
            f"({st['bytes']} B; {st['bound_share']:.3f} of it); exact against the plain version")
    report["min_sweep"].update(sweep_times[0], other_shapes=sweep_times[1:])

    spmv_times = []
    for name, (bounds, starts, size) in spmv_calls.items():
        src_l, dst_l, wts, _ = spmv_packs.pop(name)
        args_t = [torch.from_numpy(a).to(dev) for a in (src_l, dst_l, wts)]
        x_pad = torch.cat([x_pr, x_pr.new_zeros(size)])
        x_win = x_pad.unfold(0, size, 1)[torch.tensor(starts, device=dev)]
        got = edge_spmv.spmv_blocked(*args_t, x_win)
        want = edge_spmv.spmv_blocked_torch(*args_t, x_win)
        share = within_summation_bound(got, want, *args_t, x_win, f"edge_spmv ({name}) against the plain version")
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
            x_read=gathered, summation_bound_share=share))
        log(f"edge_spmv ({name}) (C, W_E, W_V) = ({c_}, {w_e}, {size}): {ms:.4f} ms, plain "
            f"{spmv_times[-1]['plain_ms']:.4f} ms, index_add_ {lib_ms:.4f} ms ({lib_ms / ms:.3f}× the kernel's time), "
            f"bound {bound_ms:.4f} ms ({bound_ms / ms:.3f} of it; {spmv_bytes} B, {n_valid} valid slots, {gathered} "
            f"distinct x entries gathered); {share:.3f} of the summation bound, max abs diff to the plain version "
            f"{float((got - want).abs().max()):.3e}")
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
        **{key: greedy[key] for key in ("cluster", "branch", "steps", "us_per_step", "enqueue_ms", "order_ms",
                                        "mirror_ms", "walked")},
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
        "rescale_migrate": "src/repro/elastic/rescale_exec.py:470",  # the jitted migrate: no pl.pallas_call
        "min_sweep": "src/repro/graphs/engine.py:434",  # SSSP's and WCC's .at[].min sweeps: no pl.pallas_call
    }
    launches = {**{k: n_ for k, n_ in slice1_launches.items() if n_}, **{k: n_ for k, n_ in slice2_launches.items() if n_},
                "full_reorder": rungs_launches["full_reorder"]}
    by_path = {"slice1": slice1_launches, "slice2": slice2_launches, "stream": stream_launches,
               "rungs": rungs_launches, "twins": twin_launches}
    for tag, read in multirank_read.items():  # path 5: each rank's own launches, counted from 0 in its process
        by_path[f"multirank_{tag}"] = {**dict.fromkeys(KERNELS, 0), "segment_rf": sum(read["segment_rf_launches"]),
                                       "rescale_migrate": sum(read["rescale_migrate_launches"]),
                                       "min_sweep": sum(read["min_sweep_launches"])}
        report["segment_rf"][f"multirank_{tag}_by_rank"] = read["segment_rf_launches"]
        report["rescale_migrate"][f"multirank_{tag}_by_rank"] = read["rescale_migrate_launches"]
        report["min_sweep"][f"multirank_{tag}_by_rank"] = read["min_sweep_launches"]
    for tag, read in streamrank_read.items():  # path 6: the same
        by_path[f"streamrank_{tag}"] = {**dict.fromkeys(KERNELS, 0), "segment_rf": sum(read["segment_rf_launches"]),
                                        "full_reorder": sum(read["greedy_launches"])}
        report["segment_rf"][f"streamrank_{tag}_by_rank"] = read["segment_rf_launches"]
        report["full_reorder"][f"streamrank_{tag}_by_rank"] = read["greedy_launches"]
    by_path["control_a"] = control_launches  # path 8 (a), in this process; (b) launches nothing
    by_path["serve_a"], by_path["serve_b"] = serve_a_launches, serve_b_launches  # path 9, in this process
    by_path["lm"] = lm_launches  # path 10: the models call none of the kernels
    by_path["train"] = train_launches  # path 11: the same
    by_path["lmrank"] = lmrank_launches  # path 12, in this process (each rank's own counts are checked as zero)
    report["segment_rf"]["control_a_before_after_restore"] = control_read["a"]["launches"]["segment_rf"]
    report["full_reorder"]["control_a_before_after_restore"] = control_read["a"]["launches"]["full_reorder"]
    for tag, read in outofcore_read.items():  # path 7: the same
        by_path[f"outofcore_{tag}"] = {**dict.fromkeys(KERNELS, 0), "segment_rf": sum(read["segment_rf_launches"]),
                                       "full_reorder": sum(read["greedy_launches"]),
                                       "rescale_migrate": sum(read["rescale_migrate_launches"])}
        report["rescale_migrate"][f"outofcore_{tag}_by_rank"] = read["rescale_migrate_launches"]
        report["segment_rf"][f"outofcore_{tag}_by_rank"] = read["segment_rf_launches"]
        report["full_reorder"][f"outofcore_{tag}_by_rank"] = read["greedy_launches"]
        report["full_reorder"][f"outofcore_{tag}_chunks"] = [
            {k: c[k] for k in ("chunk", "vertices", "steps", "ms", "us_per_step", "branch", "cluster")}
            for c in read["chunks"] if "ms" in c]
    log(json.dumps({"stream": {**stream_read, **stream_twins}, "rungs": rungs_read}))
    log(json.dumps({"multirank": multirank_read}))
    log(json.dumps({"streamrank": streamrank_read}))
    log(json.dumps({"outofcore": outofcore_read}))
    log(json.dumps({"control": control_read}))
    log(json.dumps({"serve": {"a": serve_a, "b": serve_b}}))
    log(json.dumps({"lm": lm_read}))
    log(json.dumps({"train": train_read}))
    log(json.dumps({"lmrank": lmrank_read}))
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
            "parity": "exact" if name in ("segment_rf", "full_reorder", "rescale_migrate", "min_sweep") else "allclose",
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
                                       "order_ms", "mirror_ms", "walked", "wide", "plan", "execute_ms", "bytes",
                                       "slice1_sweeps") if key in r},
            **({"bound_share": r["bound_share"]} if "bound_share" in r else {}),
            **({"other_shapes": r["other_shapes"]} if "other_shapes" in r else {}),
            **({"rungs_shapes": r["rungs_shapes"]} if "rungs_shapes" in r else {}),
            **{key: r[key] for key in r if key.startswith(("multirank_", "streamrank_", "outofcore_", "control_"))},
        })
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
