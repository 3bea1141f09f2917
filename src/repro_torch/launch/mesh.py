"""Ranks as meshes: the ``graph`` axis as a group of torch.distributed ranks
(the counterpart of the reference's ``make_graph_mesh``), and the LM
harness's named grids (``make_production_mesh``, ``make_test_mesh``).

A ``GraphGroup`` names what the partition layout needs of its ranks: how
many there are (g), which one this process is, the device its row block
lives on, the backend that carries its collectives, and the process (host)
behind each rank. Rank r belongs to process ``r // devs_per_proc``: the
reference's global device order is process-major, so the ranks of one host
are consecutive and ``cross_process_*`` stays "what crosses the NIC".

A world of one is ``GraphGroup()`` with no process group (``backend=None``):
the same layout and the same code path, whose collectives return their input.

A ``RankGrid`` is the reference's named ``jax.make_mesh``: axis names and
sizes, ranks laid out row-major (the last axis fastest), as ``jax.make_mesh``
lays out its devices. Over a ``GraphGroup`` of the grid's size it holds one
torch.distributed sub-group for each line of each axis, and this rank's line
of an axis is a ``GraphGroup`` of its own (``line``), which the collectives of
``launch/multihost.py`` take. Without a group a grid is a shape only: the
production meshes are, on one card.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..compat import resolve_device

__all__ = ["BACKENDS", "GraphGroup", "MULTI_POD", "RankGrid", "SINGLE_POD", "make_graph_group", "make_production_mesh",
           "make_rank_grid", "make_test_mesh", "mesh_axis_sizes", "num_chips"]

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class GraphGroup:
    size: int = 1  # g, the graph-axis size
    rank: int = 0  # this process's position on the axis
    device: torch.device | None = None  # where this rank's rows live; None means "cuda"
    backend: str | None = None  # "nccl" or "gloo"; None: no process group (a world of one)
    processes: tuple = (0,)  # (g,) process index of each rank
    # The torch.distributed group of these ranks; None is the default (world)
    # group. A grid's line (``RankGrid.line``) is a sub-group.
    process_group: object = dataclasses.field(default=None, compare=False, repr=False)

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


# ------------------------------------------------------------- named grids
SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """Named axes over ranks. Rank r sits at ``coords`` = r in row-major
    order over ``shape``. ``lines`` maps each axis to this rank's line along
    it, a ``GraphGroup`` whose rank is this rank's coordinate on that axis;
    it is empty for a grid that is a shape only."""

    axis_names: tuple
    shape: tuple
    group: GraphGroup | None = None
    lines: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        if len(self.axis_names) != len(self.shape) or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axes {self.axis_names} do not name the {len(self.shape)} dimensions of {self.shape}")
        if self.group is not None and self.group.size != self.size:
            raise ValueError(f"a grid of {self.size} ranks over a group of {self.group.size}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else self.group.rank

    @property
    def coords(self) -> dict:
        """{axis: this rank's index on it}."""
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.shape))):
            out[name] = r % n
            r //= n
        return {name: out[name] for name in self.axis_names}

    def axis_size(self, axis: str, default: int = 1) -> int:
        return dict(zip(self.axis_names, self.shape)).get(axis, default)

    def line(self, axis: str) -> GraphGroup:
        """This rank's line along ``axis``: the ranks that differ from it on
        that axis only. An axis of size 1 is a world of one."""
        if axis not in self.axis_names:
            raise KeyError(f"the grid has no axis {axis!r}; its axes are {self.axis_names}")
        if self.axis_size(axis) == 1:
            return GraphGroup(device=None if self.group is None else self.group.device)
        if axis not in self.lines:
            raise ValueError(f"a grid without a group of ranks has no line along {axis!r}: it is a shape only")
        return self.lines[axis]


def _line_ranks(shape: tuple, axis: int) -> list:
    """Every line along ``axis``, in row-major order of the other axes; each
    line's ranks in order of their coordinate on ``axis``."""
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    others = [i for i in range(len(shape)) if i != axis]
    out = []
    for flat in range(math.prod(shape[i] for i in others)):
        base, rest = 0, flat
        for i in reversed(others):
            base += (rest % shape[i]) * strides[i]
            rest //= shape[i]
        out.append([base + c * strides[axis] for c in range(shape[axis])])
    return out


def make_rank_grid(shape, axis_names, group: GraphGroup | None = None) -> RankGrid:
    """A ``RankGrid`` of ``shape`` named ``axis_names``. Over a distributed
    ``group`` every rank calls this alike: it creates one sub-group for each
    line of each axis of size above 1, axis by axis and line by line, and
    keeps this rank's."""
    grid = RankGrid(tuple(axis_names), tuple(shape), group)
    if group is None or not group.distributed:
        return grid
    lines = {}
    for a, name in enumerate(grid.axis_names):
        if grid.shape[a] == 1:
            continue
        for ranks in _line_ranks(grid.shape, a):
            pg = dist.new_group(ranks)
            if group.rank in ranks:
                lines[name] = GraphGroup(
                    size=len(ranks), rank=ranks.index(group.rank), device=group.device, backend=group.backend,
                    processes=tuple(group.processes[r] for r in ranks), process_group=pg)
    return dataclasses.replace(grid, lines=lines)


def make_production_mesh(*, multi_pod: bool = False) -> RankGrid:
    """The production grid as a shape: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")``."""
    if multi_pod:
        return RankGrid(("pod", "data", "model"), MULTI_POD)
    return RankGrid(("data", "model"), SINGLE_POD)


def make_test_mesh(data: int = 1, model: int = 1, *, group: GraphGroup | None = None) -> RankGrid:
    """A (data, model) grid, over ``group``'s ranks when given."""
    return make_rank_grid((data, model), ("data", "model"), group)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def num_chips(mesh) -> int:
    return int(mesh.size)
