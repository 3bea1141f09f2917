"""The ``graph`` axis as a group of torch.distributed ranks — the counterpart
of the reference's ``make_graph_mesh``.

A ``GraphGroup`` names what the partition layout needs of its ranks: how
many there are (g), which one this process is, the device its row block
lives on, the backend that carries its collectives, and the process (host)
behind each rank. Rank r belongs to process ``r // devs_per_proc``: the
reference's global device order is process-major, so the ranks of one host
are consecutive and ``cross_process_*`` stays "what crosses the NIC".

A world of one is ``GraphGroup()`` with no process group (``backend=None``):
the same layout and the same code path, whose collectives return their input.
"""
from __future__ import annotations

import dataclasses

import torch

from ..compat import resolve_device

__all__ = ["BACKENDS", "GraphGroup", "make_graph_group"]

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class GraphGroup:
    size: int = 1  # g, the graph-axis size
    rank: int = 0  # this process's position on the axis
    device: torch.device | None = None  # where this rank's rows live; None means "cuda"
    backend: str | None = None  # "nccl" or "gloo"; None: no process group (a world of one)
    processes: tuple = (0,)  # (g,) process index of each rank

    def __post_init__(self):
        if self.size < 1 or not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} is not in a group of {self.size}")
        if len(self.processes) != self.size:
            raise ValueError(f"{len(self.processes)} process indices for {self.size} ranks")
        if self.backend is None and self.size != 1:
            raise ValueError("a group of more than one rank needs a backend ('nccl' or 'gloo')")
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected one of {BACKENDS}")
        if self.device is not None:
            object.__setattr__(self, "device", torch.device(self.device))

    @property
    def distributed(self) -> bool:
        """True when a torch.distributed process group carries the collectives."""
        return self.backend is not None

    @property
    def torch_device(self) -> torch.device:
        """This rank's device; ``None`` resolves to ``"cuda"`` (raising without a card)."""
        return resolve_device(self.device)

    @property
    def process_count(self) -> int:
        return len(set(self.processes))

    def row_block(self, rows: int) -> tuple[int, int]:
        """[lo, hi) of this rank's rows in a leading axis of ``rows`` rows."""
        if rows % self.size:
            raise ValueError(f"{rows} rows do not split evenly over {self.size} ranks")
        m = rows // self.size
        return self.rank * m, (self.rank + 1) * m


def make_graph_group(device=None) -> GraphGroup:
    """A world of one on ``device`` (``None`` means ``"cuda"``). A group of
    several ranks comes from ``launch.multihost.initialize_distributed``."""
    return GraphGroup(device=resolve_device(device))
