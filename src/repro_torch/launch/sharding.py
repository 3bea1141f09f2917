"""Partition placement math for the ``graph`` axis (DESIGN.md §6).

Partition p of a k-way pack lives on rank ``p % g`` of a world of g ranks, at
buffer row ``partition_row(p, k, g)``. A world of 1 is the degenerate case of
the same rules (row p = partition p), which is the layout this package runs.
"""
from __future__ import annotations

GRAPH_AXIS = "graph"  # the axis (torch.distributed ranks) owning graph partitions


def graph_axis_size(world_size: int = 1) -> int:
    """Size of the ``graph`` axis: the number of ranks holding partitions."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    return int(world_size)


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
