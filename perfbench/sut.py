"""The system under test: ``repro_torch`` on one card, the system of every
configuration that names none.

This module and the modules of ``systems/`` (each a system that a
configuration names with ``"system"``, ``spec.system``) are the only modules
of the benchmark that import the port. The benchmark drives the port through
its own entry points: the pack (``graphs.engine.pack_ordered``), the elastic
rescale (``elastic.rescale_exec.ElasticRescaler.rescale`` with the re-check
on) and the query programs (``graphs.engine.query_program``). From the port
it takes besides only its spans (``obs.trace``), the program cache's
counters and its kernels' names, which the device trace shows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.elastic import rescale_exec
from repro_torch.graphs import engine
from repro_torch.obs import trace as program_trace

# The port's hand-written kernels on the timed path, by the name their
# launches carry in the device trace.
KERNELS = {"rescale_migrate": "rescale_migrate_kernel", "segment_rf": "segment_rf_kernel"}


class System:
    """One process's instance of the port: a pack, its rescaler and its query
    programs."""

    group = None  # the queries' ``GraphGroup``: None is one card; a system over ranks sets its own first

    def __init__(self, *, num_vertices: int, device: torch.device, queries: dict, traced: bool = False,
                 world=None):
        if self.group is None and world is not None and world.size > 1:
            raise ValueError(f"sut.System runs on one card, not over {world.size} ranks: "
                             "a configuration over ranks names its system")
        if traced:
            # The rescaler's span ``rescale.migrate`` also enters a profiler
            # range, so the device trace shows it.
            program_trace.set_tracer(program_trace.Tracer(annotate=True))
        self.device = device
        self.num_vertices = int(num_vertices)
        self.rescaler = rescale_exec.ElasticRescaler()
        self.programs = {
            kind: engine.query_program(
                kind, num_vertices=self.num_vertices, group=self.group, iterations=queries["pagerank_iterations"],
                damping=queries["damping"], max_iters=queries["max_iters"],
            )
            for kind in engine.QUERY_KINDS
        }

    def pack(self, src: np.ndarray, dst: np.ndarray, k: int):
        return engine.pack_ordered(src, dst, self.num_vertices, k, device=self.device)

    def rescale(self, data, k_new: int):
        """``(new data, RescaleStats)``: the migration and the re-check of
        mirrors and RF, as an elastic controller calls it."""
        return self.rescaler.rescale(data, k_new, recheck=True)

    def query(self, kind: str, data, source: int):
        """``(answer, sweeps)``; PageRank runs a fixed count and gives ``None``."""
        program = self.programs[kind]
        if kind == "pagerank":
            return program(data.edges, data.mask, data.degrees), None
        if kind == "sssp":
            return program(data.edges, data.mask, source)
        return program(data.edges, data.mask)

    def cache_counters(self) -> dict:
        """The rescaler's program-cache counters of migrations, copied."""
        return dict(self.rescaler._programs.counters_snapshot().get("migrate", {}))

    @staticmethod
    def view(data):
        """What the benchmark judges of a pack: edges, mask, k and mirrors."""
        return data.edges, data.mask, data.k, data.mirrors

    def close(self) -> None:
        """Frees the rescaler and the programs; ``view`` still reads a pack."""
        program_trace.set_tracer(None)
        self.rescaler = self.programs = None
