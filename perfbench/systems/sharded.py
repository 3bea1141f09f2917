"""The port's multi-rank layout as the system under test: one rank a device.

A configuration names it with ``"system": "sharded"``. Each rank of the run
(``ranks.World``) holds the partitions p with p % g equal to its rank, in the
port's ``ShardedEngineData``:

* the pack: ``graphs.engine.pack_ordered_sharded`` over the run's
  ``GraphGroup``, each rank uploading only its rows;
* a rescale: ``elastic.rescale_exec.ElasticRescaler.rescale(data, k_new,
  recheck=True)`` on the sharded data, the ranges that change rank sent
  through ``launch.multihost.exchange``;
* the queries: ``graphs.engine.query_program`` over the group, each rank
  sweeping its own rows and an ``all_reduce`` combining them;
* ``view``: the whole pack, gathered from every rank
  (``graphs.engine.unshard_engine_data``, a collective);
* ``cache_counters``: this rank's; the harness reports rank 0's.

A run of one process is a group of one on its device.
"""
from __future__ import annotations

import torch

from perfbench import sut
from repro_torch.elastic import rescale_exec
from repro_torch.graphs import engine
from repro_torch.launch.mesh import GraphGroup, make_graph_group
from repro_torch.obs import metrics as program_metrics


class System(sut.System):
    """``sut.System`` with its pack, rescaler and queries over the run's ranks."""

    def __init__(self, *, num_vertices: int, device: torch.device, queries: dict, traced: bool = False,
                 world=None):
        if world is None or not world.ranked:
            self.group = make_graph_group(device)
        else:
            self.group = GraphGroup(size=world.size, rank=world.rank, device=device, backend=world.backend,
                                    processes=tuple(range(world.size)))
        super().__init__(num_vertices=num_vertices, device=device, queries=queries, traced=traced, world=world)
        self.registry = program_metrics.MetricsRegistry()
        self.rescaler = rescale_exec.ElasticRescaler(metrics_registry=self.registry)

    def pack(self, src, dst, k: int):
        return engine.pack_ordered_sharded(src, dst, self.num_vertices, k, self.group, device=self.device)

    def sent_bytes(self) -> int:
        """Bytes this rank's rescales have sent to other ranks (the harness
        asks a system for it in a run over ranks)."""
        return int(self.registry.counter("rescale.sent_bytes").value)

    @staticmethod
    def view(data):
        whole = engine.unshard_engine_data(data)
        return whole.edges, whole.mask, whole.k, whole.mirrors
