"""Partition placement math for the ``graph`` axis (DESIGN.md §6).

Partition p of a k-way pack lives on rank ``p % g`` of a world of g ranks, at
buffer row ``partition_row(p, k, g)``. A world of 1 is the degenerate case of
the same rules (row p = partition p). The ranks are a ``launch.mesh.GraphGroup``
(the reference's mesh); ``None`` stands for a world of one.
"""
from __future__ import annotations

import numpy as np

GRAPH_AXIS = "graph"  # the axis (torch.distributed ranks) owning graph partitions


def graph_axis_size(group=1) -> int:
    """Size of the ``graph`` axis: the number of ranks holding partitions.
    ``group`` is a ``GraphGroup``, a rank count, or ``None`` (a world of one)."""
    if group is None:
        return 1
    g = int(getattr(group, "size", group))
    if g < 1:
        raise ValueError(f"world_size must be >= 1, got {g}")
    return g


def padded_partition_count(k: int, g: int) -> int:
    """k rounded up to a multiple of the graph-axis size g. The extra
    partitions are empty (mask 0 everywhere) — k need not equal, divide, or
    exceed the rank count."""
    return ((k + g - 1) // g) * g


def partition_device(p: int, g: int) -> int:
    """Round-robin assignment: partition p lives on graph-axis position p % g."""
    return p % g


def partition_row(p: int, k: int, g: int) -> int:
    """Buffer row of partition p in the device-major packed layout.

    Rank d holds the contiguous row block [d·m, (d+1)·m) with m = k_pad/g;
    storing partition p at row (p % g)·m + p // g therefore realizes the
    round-robin assignment device(p) = p % g. With g = 1 this is the identity
    (row p = partition p), which is exactly the single-device pack_ordered
    layout.
    """
    m = padded_partition_count(k, g) // g
    return (p % g) * m + p // g


def row_partition(r: int, k: int, g: int) -> int:
    """Inverse of partition_row. May return p >= k: that row is a padding
    partition (empty, masked)."""
    m = padded_partition_count(k, g) // g
    return (r % m) * g + r // m


def device_process_map(group) -> np.ndarray:
    """(g,) process index of each ``graph``-axis rank. All zeros for a world
    of one (``group=None``) and for a single-process group, so one process is
    the degenerate case of the same per-process accounting."""
    if group is None:
        return np.zeros(1, dtype=np.int64)
    return np.asarray(group.processes, dtype=np.int64)


def partition_process(p: int, group) -> int:
    """Process owning partition p: the process of graph-axis rank p % g.
    Composes the round-robin partition→rank map with the group's
    rank→process map (multi-host runs: launch/multihost.py)."""
    return int(device_process_map(group)[p % graph_axis_size(group)])
