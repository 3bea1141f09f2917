"""One rank of the port's out-of-core pipeline (tests/test_torch_outofcore.py).

``spawn_local_cluster`` starts this file once per rank
(``python tests/torch_outofcore_harness.py <dir>``). It imports no JAX. Each
rank runs the out-of-core pipeline end to end without ever holding the full
edge list in one array, as the JAX package's ``tests/outofcore_harness.py``
does over its processes:

* **generate** — the graph is an ``RmatShardPlan``: any rank regenerates any
  shard statelessly (data/shards.py), so there is no ingest shuffle;
* **rank + count** (phase A) — the locality rank comes from a bounded stride
  sample; each rank bincounts the chunk-load histogram over its own shards
  only and the ranks sum it with ``psum_host``;
* **order + commit** (phase B) — chunk membership and each chunk's GEO order
  are pure functions of (plan, rank, splits), so the partitions this rank
  holds are filled by regenerating and ordering one chunk at a time (a cache
  of one ordered chunk) and committed through ``pack_slots_sharded_stream``,
  partition p holding CEP chunk p of the ordered sequence;
* **rescale** (phase C) — ``ElasticRescaler.execute`` 8 → 12 → 8 on the
  committed pack across the ranks, both re-checked through ``segment_rf``;
* **stream** (phase D) — a bounded-memory ``OutOfCoreIngestor`` (the spill
  layer) behind ``ElasticController.attach_stream`` ingests stateless
  ``stream_edges`` batches through ``ElasticController.ingest``; the spill
  counters are read off the last ``IngestEvent``, as the JAX package's
  harness reads them.

The rank writes its row blocks and a JSON of readings; the parent reassembles
the blocks and holds them against the JAX package's in-core oracle
(``hier_order_edges`` + ``pack_slots``).

``pooled_mirror_order`` is that in-core composition with its chunks ordered
in a process pool: ``chip_smoke.py``'s path 7 computes its oracle with it.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":  # the worker: make the port importable without pytest's path setup
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import cep  # noqa: E402
from repro_torch.core import hier_order as HO  # noqa: E402
from repro_torch.data import shards as DS  # noqa: E402

# One configuration, shared with the parent's oracle, which imports it from
# here: the JAX package's harness defaults (tests/outofcore_harness.py).
PLAN = DS.RmatShardPlan(scale=12, edge_factor=8, seed=0, num_shards=4)
CFG = HO.HierConfig(num_chunks=4, max_chunk_edges=1 << 17, seam_window=0, seed=0)
SAMPLE_STRIDE = 2
K_PACK, K_UP = 8, 12
STREAM_BATCHES, STREAM_BATCH_SIZE = 6, 256
SPILL_REGIONS, SPILL_SPR, SPILL_RESIDENT = 64, 128, 8
GROUP_TIMEOUT_S = 45.0  # every collective of the worker's group


def rank_and_splits(group, plan=PLAN, cfg=CFG, stride=SAMPLE_STRIDE):
    """Phase A: every rank derives the identical rank from the identical
    bounded sample, then the chunk-load histogram summed over the ranks, each
    bincounting only its own shards."""
    from repro_torch.launch import multihost as MH

    sample = DS.sample_edges(plan, stride)
    rank = HO.locality_rank(sample, plan.num_vertices, cfg.seed, mode=cfg.rank_mode)
    load_local = np.zeros(plan.num_vertices, dtype=np.int64)
    for s in range(group.rank, plan.num_shards, group.size):
        load_local += HO.chunk_load(rank, DS.shard_edges(plan, s))
    load = MH.psum_host(load_local, group)
    splits = HO.chunk_splits(load, cfg)
    sizes = [int(load[int(splits[c]): int(splits[c + 1])].sum()) for c in range(splits.shape[0] - 1)]
    return rank, splits, sizes


class ChunkMaterializer:
    """Ordered chunk edges as a pure function of (plan, rank, splits, cfg):
    regenerate every shard, keep only this chunk's edges (candidate order,
    the order the in-core oracle filters in), GEO-order the block. Caches
    ONE chunk — the resident bound the pipeline promises. ``on_block(c,
    block)`` sees each block before it is ordered."""

    def __init__(self, rank, splits, sizes, plan=PLAN, cfg=CFG, *, device=None, on_block=None):
        self.rank, self.splits, self.plan, self.cfg = rank, splits, plan, cfg
        self.device, self.on_block = device, on_block
        self.bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self._cached = (-1, None)

    def chunk(self, c: int) -> np.ndarray:
        if self._cached[0] == c:
            return self._cached[1]
        blocks = []
        for s in range(self.plan.num_shards):
            es = DS.shard_edges(self.plan, s)
            blocks.append(es[HO.chunk_of_edges(self.splits, self.rank, es) == c])
        block = np.concatenate(blocks)
        if self.on_block is not None:
            self.on_block(c, block)
        perm = HO.order_edge_block(block, self.cfg, seed=self.cfg.seed + c, device=self.device)
        self._cached = (c, block[perm])
        return self._cached[1]

    def ordered_range(self, lo: int, hi: int) -> np.ndarray:
        """Edges [lo, hi) of the global ordered sequence — touches only the
        chunks overlapping the range."""
        out = []
        c = int(np.searchsorted(self.bounds, lo, side="right") - 1)
        while lo < hi:
            ce = self.chunk(c)
            s = lo - int(self.bounds[c])
            e = min(hi, int(self.bounds[c + 1])) - int(self.bounds[c])
            out.append(ce[s:e])
            lo += e - s
            c += 1
        return np.concatenate(out) if out else np.empty((0, 2), np.int64)


def commit_pack(mat: ChunkMaterializer, group, k: int = K_PACK):
    """Phase B's commit: partition p holds CEP chunk p of the ordered sequence
    (prefix-valid slots, so the pack rescales by range copies), staged one
    partition at a time through ``pack_slots_sharded_stream``."""
    from repro_torch.graphs import engine as E

    total = int(mat.bounds[-1])
    cep_bounds = cep.chunk_bounds(total, k)
    spr = int(np.diff(cep_bounds).max())

    def part_fn(p):
        ed = mat.ordered_range(int(cep_bounds[p]), int(cep_bounds[p + 1]))
        src = np.zeros(spr, dtype=np.int64)
        dst = np.zeros(spr, dtype=np.int64)
        valid = np.zeros(spr, dtype=bool)
        n = ed.shape[0]
        src[:n], dst[:n], valid[:n] = ed[:, 0], ed[:, 1], True
        return src, dst, valid

    return E.pack_slots_sharded_stream(part_fn, k, mat.plan.num_vertices, group, spr)


def stream_phase(plan=PLAN) -> dict:
    """Phase D: the bounded-memory ingest tail, through the elastic
    controller. Every rank runs the identical deterministic script; the
    parent holds the ranks' states equal."""
    from repro_torch.elastic.controller import ElasticController
    from repro_torch.stream import EdgeUpdateBatch, OutOfCoreIngestor, SpillConfig

    ing = OutOfCoreIngestor(plan.num_vertices, SPILL_REGIONS, SPILL_SPR,
                            config=SpillConfig(max_resident=SPILL_RESIDENT))
    ctl = ElasticController(1)
    ctl.attach_stream(ing)
    inserted = skipped = peak_resident = 0
    for b in range(STREAM_BATCHES):
        ev = ctl.ingest(EdgeUpdateBatch(insert=DS.stream_edges(plan, b, STREAM_BATCH_SIZE),
                                        delete=np.empty((0, 2), np.int64)))
        inserted += ev.inserted
        skipped += ev.skipped
        peak_resident = max(peak_resident, ev.spill["resident"])
    return dict(num_edges=ing.num_edges, inserted=inserted, skipped=skipped, resident=ing.store.resident,
                peak_resident=peak_resident, spill=dict(ctl.events[-1].spill), batches=STREAM_BATCHES,
                seqs=[e.seq for e in ctl.events])


def order_chunk(block: np.ndarray, cfg, seed: int) -> np.ndarray:
    """One chunk's ``order_edge_block`` permutation; a module-level function,
    so a spawned pool worker can import it."""
    return HO.order_edge_block(block, cfg, seed=seed)


def geo_rf_by_k(edges: np.ndarray, num_vertices: int, ks) -> tuple[int, dict]:
    """The quality reading's yardstick: host ``geo_order`` of the edge list
    deduplicated (first occurrences, in order), and its RF at each k.
    Returns ``(unique edges, {k: RF})``; a module-level function, so a pool
    worker can run it."""
    from repro_torch.core import ordering
    from repro_torch.core.graph import Graph
    from repro_torch.core.metrics import replication_factor_ordered

    _, first = np.unique(edges[:, 0] * np.int64(num_vertices) + edges[:, 1], return_index=True)
    dedup = Graph.from_edges(edges[np.sort(first)], num_vertices)
    o = ordering.geo_order(dedup, seed=0)
    return int(dedup.num_edges), {k: replication_factor_ordered(dedup.src[o], dedup.dst[o], k, num_vertices)
                                  for k in ks}


def pooled_mirror_order(edges: np.ndarray, num_vertices: int, cfg, sample: np.ndarray, pool):
    """``hier_order_edges(edges, num_vertices, cfg, sample)`` with each
    chunk's ``order_edge_block`` submitted to ``pool`` (a
    ``concurrent.futures`` executor) and the results joined in chunk order:
    the same rank, splits, chunk seeds and seam repair, so the result is
    byte-equal to the serial call. ``cfg``'s chunk mode must not be
    "device": the workers own no card. Returns ``(ordered, info)``."""
    if cfg.chunk_mode == "device":
        raise ValueError("the pooled oracle orders chunks on the host: chunk mode 'device' is not one")
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    rank = HO.locality_rank(sample, num_vertices, cfg.seed, mode=cfg.rank_mode)
    splits = HO.chunk_splits(HO.chunk_load(rank, edges), cfg)
    cid = HO.chunk_of_edges(splits, rank, edges)
    num_chunks = splits.shape[0] - 1
    blocks = [edges[cid == c] for c in range(num_chunks)]
    sizes = [int(b.shape[0]) for b in blocks]
    # The greedy's steps grow with a chunk's vertices: the widest chunks go
    # first, so the longest mirror does not start last.
    widest_first = sorted((c for c in range(num_chunks) if sizes[c]), key=lambda c: -np.unique(blocks[c]).size)
    perms = {c: pool.submit(order_chunk, blocks[c], cfg, cfg.seed + c) for c in widest_first}
    parts = [blocks[c][perms[c].result()] for c in sorted(perms)]
    ordered = np.concatenate(parts, axis=0) if parts else np.empty((0, 2), dtype=np.int64)
    ordered = HO.repair_seams(ordered, sizes, cfg)
    return ordered, {"splits": splits, "chunk_sizes": sizes, "num_chunks": num_chunks}


def worker(out_dir: pathlib.Path) -> None:
    import torch.distributed as dist

    from repro_torch.elastic.rescale_exec import ElasticRescaler
    from repro_torch.kernels import segment_rf
    from repro_torch.launch import multihost as MH
    from repro_torch.obs import metrics as OM

    group = MH.initialize_from_env(timeout_s=GROUP_TIMEOUT_S)
    r = group.rank
    arrays, wall = {}, {}

    def keep(name, data):
        arrays[f"{name}_edges"], arrays[f"{name}_mask"] = data.edges.cpu().numpy(), data.mask.cpu().numpy()

    t0 = time.perf_counter()
    rank, splits, sizes = rank_and_splits(group)
    wall["rank"] = time.perf_counter() - t0
    ordered_chunks = []
    mat = ChunkMaterializer(rank, splits, sizes, on_block=lambda c, block: ordered_chunks.append(c))
    t0 = time.perf_counter()
    data = commit_pack(mat, group)
    wall["commit"] = time.perf_counter() - t0
    keep("commit", data)
    arrays["commit_degrees"] = data.degrees.cpu().numpy()

    t0 = time.perf_counter()
    rx, n = ElasticRescaler(), data.num_edges
    up, s_up = rx.execute(data, cep.scale_plan(n, K_PACK, K_UP), recheck=True)
    back, s_back = rx.execute(up, cep.scale_plan(n, K_UP, K_PACK), recheck=True)
    wall["rescale"] = time.perf_counter() - t0
    keep("rescale_up", up)
    keep("rescale_back", back)

    t0 = time.perf_counter()
    stream = stream_phase()
    wall["stream"] = time.perf_counter() - t0
    meta = dict(
        rank=r, group=[group.size, group.backend, list(group.processes)],
        splits=[int(x) for x in splits], chunk_sizes=sizes, num_edges=int(data.num_edges),
        ordered_chunks=ordered_chunks, parts=data.local_partitions(), k_pad_up=up.k_pad,
        rescale=[dict(k_new=st.k_new, rf=d.replication_factor, mirrors=d.mirrors,
                      cross_device_edges=st.cross_device_edges, cross_process_edges=st.cross_process_edges)
                 for st, d in ((s_up, up), (s_back, back))],
        segment_rf_launches=segment_rf.launches, stream=stream, wall=wall, peak_rss=list(OM.read_peak_rss()),
        jax_loaded=any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules),
    )
    dist.destroy_process_group()
    np.savez(out_dir / f"rank{r}.npz", **arrays)
    (out_dir / f"rank{r}.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(f"usage: {sys.argv[0]} <out dir>")
    worker(pathlib.Path(sys.argv[1]))
