"""Cold-region spill layer: bounded-resident host mirror of the slot array.

``IncrementalOrderer`` keeps the WHOLE slot mirror hot (dense arrays plus
per-edge dicts — O(|E|) host memory), which is exactly what an out-of-core
ingest path must not do. This module bounds the resident set at the region
granularity the slot layout already has:

* ``SpillStore`` holds at most ``max_resident`` region blocks in memory;
  the rest live serialized on disk (or in a cold byte store when no
  directory is given — same code path, for tests without tmpdirs). Eviction
  is least-recently-ESCALATED: ``touch`` bumps a region's clock when ingest
  lands in it or a repair escalates it, so the regions the stream is
  actively mutating stay hot and long-cold spans pay the fault only when an
  ingest actually returns to them.
* ``OutOfCoreIngestor`` is the lean ingest front-end over that store. A new
  edge is CONTENT-ADDRESSED: region = splitmix64(u·V + v) mod regions — a
  pure function of the edge, so insert and delete touch exactly one region
  block and a delete is an O(spr) scan of it, with no global edge→slot dict.
  Content addressing gives up GEO placement quality for the ingest tail —
  the hierarchical preprocess (core/hier_order.py) owns bulk quality; this
  path owns the stream-of-updates tail under a memory bound, the same
  split the escalation ladder already makes (DESIGN.md §9/§11).

Counters (``spill_counters``) ride on every IngestEvent the elastic
controller emits (``ElasticController.attach_stream`` / ``ingest``), so
spill/fault traffic is visible in the same event log as escalations and
rebuilds.
"""
from __future__ import annotations

import dataclasses
import io
import os
import time
from typing import Optional

import numpy as np

from ..core.baselines import splitmix64
from ..obs import metrics as OM

__all__ = ["SpillConfig", "SpillStore", "OutOfCoreIngestor", "LeanIngestStats"]


@dataclasses.dataclass(frozen=True)
class SpillConfig:
    """``max_resident`` bounds hot region blocks (the memory knob);
    ``directory`` is the spill target — None keeps spilled bytes in a cold
    in-process store (identical control flow, no filesystem)."""

    max_resident: int = 4
    directory: Optional[str] = None

    def __post_init__(self):
        if self.max_resident < 1:
            raise ValueError("max_resident must be >= 1")


class SpillStore:
    """Region-block store with an LRU-by-escalation resident set.

    A block is the (src, dst, valid) slot triple of one region. Blocks are
    created zeroed on first access; ``get`` faults spilled blocks back in
    and counts it; ``evict_to_budget`` (called after every mutation burst)
    serializes the least-recently-escalated blocks out until the resident
    count is within budget."""

    def __init__(
        self,
        regions: int,
        slots_per_region: int,
        config: SpillConfig,
        *,
        metrics_registry=None,
    ):
        if regions < 1:
            raise ValueError("regions must be >= 1")
        if slots_per_region < 1:
            raise ValueError("slots_per_region must be >= 1")
        self.regions = int(regions)
        self.spr = int(slots_per_region)
        self.config = config
        # Observability: spill/fault traffic histograms (block sizes) on top
        # of the exact counters below; the registry's snapshot aggregates
        # them across processes (obs/metrics.py). Defaults to the inert
        # registry — zero cost when unused.
        self.metrics = OM.NULL if metrics_registry is None else metrics_registry
        self._m_spill_bytes = self.metrics.histogram("spill.spill_block_bytes", OM.BYTE_BUCKETS)
        self._m_fault_bytes = self.metrics.histogram("spill.fault_block_bytes", OM.BYTE_BUCKETS)
        self._hot: dict[int, tuple] = {}  # region → (src, dst, valid)
        self._cold: dict[int, bytes] = {}  # region → serialized block
        self._clock = 0
        self._last_touch: dict[int, int] = {}
        self.counters = {
            "spills": 0,
            "faults": 0,
            "bytes_spilled": 0,
            "bytes_faulted": 0,
        }
        if config.directory is not None:
            os.makedirs(config.directory, exist_ok=True)

    # ------------------------------------------------------------- byte store
    def _path(self, p: int) -> str:
        return os.path.join(self.config.directory, f"region_{p:06d}.npz")

    def _write_cold(self, p: int, blob: bytes) -> None:
        if self.config.directory is None:
            self._cold[p] = blob
        else:
            with open(self._path(p), "wb") as f:
                f.write(blob)
            self._cold[p] = b""  # presence marker; bytes live on disk

    def _read_cold(self, p: int) -> bytes:
        if self.config.directory is None:
            return self._cold.pop(p)
        del self._cold[p]
        path = self._path(p)
        with open(path, "rb") as f:
            blob = f.read()
        os.remove(path)
        return blob

    # ---------------------------------------------------------------- access
    def touch(self, p: int) -> None:
        """Bump region p's escalation clock (it was ingested into / repaired)
        WITHOUT faulting it in — recency is free to maintain for cold spans."""
        self._clock += 1
        self._last_touch[p] = self._clock

    def get(self, p: int) -> tuple:
        """The (src, dst, valid) block of region p, faulting it in if
        spilled, creating it zeroed if never written. Marks recency."""
        if not 0 <= p < self.regions:
            raise IndexError(f"region {p} outside [0, {self.regions})")
        self.touch(p)
        if p in self._hot:
            return self._hot[p]
        if p in self._cold:
            blob = self._read_cold(p)
            with np.load(io.BytesIO(blob)) as z:
                block = (z["src"].copy(), z["dst"].copy(), z["valid"].copy())
            self.counters["faults"] += 1
            self.counters["bytes_faulted"] += len(blob)
            self._m_fault_bytes.observe(len(blob))
        else:
            block = (
                np.zeros(self.spr, dtype=np.int64),
                np.zeros(self.spr, dtype=np.int64),
                np.zeros(self.spr, dtype=bool),
            )
        self._hot[p] = block
        return block

    @property
    def resident(self) -> int:
        return len(self._hot)

    def evict_to_budget(self) -> int:
        """Spill least-recently-escalated hot blocks until resident ≤
        ``max_resident``; returns how many spilled. All-invalid blocks are
        dropped, not serialized (an empty region has no bytes worth keeping)."""
        spilled = 0
        while len(self._hot) > self.config.max_resident:
            victim = min(self._hot, key=lambda q: self._last_touch.get(q, 0))
            src, dst, valid = self._hot.pop(victim)
            if not valid.any():
                continue
            buf = io.BytesIO()
            np.savez(buf, src=src, dst=dst, valid=valid)
            blob = buf.getvalue()
            self._write_cold(victim, blob)
            self.counters["spills"] += 1
            self.counters["bytes_spilled"] += len(blob)
            self._m_spill_bytes.observe(len(blob))
            spilled += 1
        return spilled


@dataclasses.dataclass(frozen=True)
class LeanIngestStats:
    """Shape-compatible subset of ``ingest.IngestStats`` — what the elastic
    controller reads when an OutOfCoreIngestor is the attached stream."""

    inserted: int
    deleted: int
    skipped: int
    scatter_ops: int
    resynced: bool
    elapsed_s: float
    num_edges: int


class OutOfCoreIngestor:
    """Bounded-memory streaming ingest over a SpillStore.

    Implements the attached-stream protocol the elastic controller speaks
    (``ingest``/``monitor``/``k``), with O(max_resident · spr) hot state:
    no edge→slot dict, no incident sets. Dedup within the hot/faulted region
    is exact (content addressing sends a duplicate to the same region);
    quality maintenance is delegated to the preprocess/escalation machinery,
    so ``monitor`` always answers "none".
    """

    def __init__(
        self,
        num_vertices: int,
        regions: int,
        slots_per_region: int,
        config: SpillConfig = SpillConfig(),
        *,
        metrics_registry=None,
    ):
        self.num_vertices = int(num_vertices)
        self.store = SpillStore(
            regions, slots_per_region, config, metrics_registry=metrics_registry
        )
        self._num_edges = 0
        self.last_repair = ""

    @property
    def k(self) -> int:
        return self.store.regions

    @property
    def num_edges(self) -> int:
        return self._num_edges

    def region_of(self, u: int, v: int) -> int:
        """Content address: pure in the canonical edge, so every process (and
        every later delete) resolves the same region with zero state."""
        lo, hi = (u, v) if u <= v else (v, u)
        key = np.uint64(lo) * np.uint64(self.num_vertices) + np.uint64(hi)
        return int(splitmix64(key) % np.uint64(self.store.regions))

    def _insert(self, u: int, v: int) -> bool:
        src, dst, valid = self.store.get(self.region_of(u, v))
        lo, hi = (u, v) if u <= v else (v, u)
        if bool(((src == lo) & (dst == hi) & valid).any()):
            return False  # duplicate — idempotent skip
        free = np.flatnonzero(~valid)
        if free.shape[0] == 0:
            return False  # region full — skip, counted by the caller
        s = int(free[0])
        src[s], dst[s], valid[s] = lo, hi, True
        self._num_edges += 1
        return True

    def _delete(self, u: int, v: int) -> bool:
        src, dst, valid = self.store.get(self.region_of(u, v))
        lo, hi = (u, v) if u <= v else (v, u)
        hit = np.flatnonzero((src == lo) & (dst == hi) & valid)
        if hit.shape[0] == 0:
            return False
        valid[hit[0]] = False
        self._num_edges -= 1
        return True

    def ingest(self, batch) -> LeanIngestStats:
        """Apply an EdgeUpdateBatch; spill back to budget afterwards, so peak
        resident exceeds the budget only by the batch's own working set."""
        t0 = time.perf_counter()
        inserted = deleted = skipped = 0
        for u, v in np.asarray(batch.delete, dtype=np.int64).reshape(-1, 2):
            if self._delete(int(u), int(v)):
                deleted += 1
            else:
                skipped += 1
        for u, v in np.asarray(batch.insert, dtype=np.int64).reshape(-1, 2):
            if self._insert(int(u), int(v)):
                inserted += 1
            else:
                skipped += 1
        self.store.evict_to_budget()
        return LeanIngestStats(
            inserted=inserted,
            deleted=deleted,
            skipped=skipped,
            scatter_ops=inserted + deleted,
            resynced=False,
            elapsed_s=time.perf_counter() - t0,
            num_edges=self._num_edges,
        )

    def monitor(self) -> str:
        return "none"

    @property
    def spill_counters(self) -> dict:
        """What IngestEvent.spill carries: store counters + the resident set
        size at event time."""
        return dict(self.store.counters, resident=self.store.resident)

    def snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) of all live edges — faults EVERY region in; an oracle /
        test affordance, not part of the bounded-memory path."""
        srcs, dsts = [], []
        for p in range(self.store.regions):
            src, dst, valid = self.store.get(p)
            srcs.append(src[valid])
            dsts.append(dst[valid])
        self.store.evict_to_budget()
        return np.concatenate(srcs), np.concatenate(dsts)
