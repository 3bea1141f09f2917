"""Streaming-graph subsystem: incremental edge ordering + on-device ingest.

The paper's pipeline is preprocess-once (GEO) then rescale-forever; this
package extends it to evolving graphs without giving up the O(k)-plan,
Thm.-2-minimal rescale property:

* ``updates``     — ``EdgeUpdateBatch`` (inserts + deletes) and a deterministic
                    splitmix-style synthetic dynamic-graph generator.
* ``incremental`` — host-side incremental maintenance of the GEO-ordered edge
                    list under updates (gap-buffer slot layout, locality-best
                    placement, bounded partial re-order).
* ``ingest``      — on-device ingest: scatter of update batches into the
                    per-partition slack slots of the engine pack, a compact
                    gather that rescales the streaming pack k→k', and the span
                    and full re-order rungs as device programs.
* ``spill``       — cold-region spill layer: bounded-resident host mirror
                    (LRU-by-escalation region blocks to host/disk) and the
                    lean content-addressed ingestor the out-of-core path
                    streams through.
* ``workload``    — open-loop query traffic model (bursty + diurnal arrival
                    process, stateless-hash deterministic).
"""
from .updates import EdgeUpdateBatch, SyntheticStream  # noqa: F401
from .incremental import IncrementalOrderer, StreamConfig, best_insert_position  # noqa: F401
from .ingest import StreamingEngine, IngestStats, StreamRescaleStats  # noqa: F401
from .spill import SpillConfig, SpillStore, OutOfCoreIngestor  # noqa: F401
from .workload import OpenLoopWorkload, QueryArrival  # noqa: F401
