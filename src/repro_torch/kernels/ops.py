"""Public ops over the ``segment_rf`` kernel: distinct-vertex counts of packed
CEP chunks, measured on the device.

The rows are made on the data's device: masked-out slots become ``PAD_ID``
and each chunk's endpoint ids are sorted with ``torch.sort`` (a library call,
as the JAX package left the row sort to XLA). The kernel then counts the
distinct ids of every row.
"""
from __future__ import annotations

import numpy as np
import torch

from ..compat import PAD_ID
from . import segment_rf

__all__ = ["chunk_vertex_counts_packed", "packed_rows", "replication_factor_kernel"]


def packed_rows(edges: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The kernel's input for a pack: edges ``(k, E_max, 2)`` int32 and mask
    ``(k, E_max)`` f32 → ``(k, 2·E_max)`` int32 endpoint ids, each row sorted
    ascending with the masked-out slots as ``PAD_ID`` at its tail."""
    k, e_max, _ = edges.shape
    ids = torch.where(mask[..., None] > 0, edges, PAD_ID).reshape(k, 2 * e_max)
    return torch.sort(ids, dim=1).values


def chunk_vertex_counts_packed(edges: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """|V(E_p)| of every row of a pack → ``(k,)`` int64, on the pack's device."""
    return segment_rf.segment_distinct_counts(packed_rows(edges, mask)).to(torch.int64)


def replication_factor_kernel(
    src_ordered: np.ndarray, dst_ordered: np.ndarray, k: int, num_vertices: int, *, device=None
) -> float:
    """RF of the k CEP chunks of an ordered edge list, via the segment_rf kernel.

    Same signature and result as the JAX package's ``ops.replication_factor_kernel``:
    the chunks are packed on ``device`` and their rows counted by the kernel."""
    from ..graphs import engine  # engine imports this module for its own RF measure

    return engine.pack_ordered(src_ordered, dst_ordered, num_vertices, k, device=device).replication_factor
