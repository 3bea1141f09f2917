"""Elastic state resharding via CEP chunk arithmetic (paper → framework).

Every 1-D-flattenable state tensor (parameter, optimizer moment, KV block,
dataset sample space) is owned in CEP chunks over its flattened index space.
Rescaling k→k±x therefore needs only the O(k+k') boundary-overlay plan from
core/cep.py — never a pass over the data — and moves the Thm.-2-minimal number
of elements, vs ≈k/(k+x) of everything for hash-sharded state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..core import cep


@dataclasses.dataclass(frozen=True)
class TensorReshardPlan:
    name: str
    num_elements: int
    plan: cep.ScalePlan

    @property
    def moved_elements(self) -> int:
        return self.plan.migrated_edges

    def moved_bytes(self, itemsize: int) -> int:
        return self.moved_elements * itemsize


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    k_old: int
    k_new: int
    tensors: tuple

    @property
    def total_moved_bytes(self) -> int:
        return sum(t.moved_bytes(t_item) for t, t_item in self.tensors)

    def summary(self) -> dict:
        total = sum(t.num_elements * it for t, it in self.tensors)
        moved = self.total_moved_bytes
        return {
            "k_old": self.k_old,
            "k_new": self.k_new,
            "total_bytes": total,
            "moved_bytes": moved,
            "moved_frac": moved / max(total, 1),
            "random_frac": self.k_old / max(self.k_new, self.k_old),
        }


def plan_reshard(named_shapes: dict, k_old: int, k_new: int, itemsize_of: Callable = None) -> ReshardPlan:
    """named_shapes: {name: (shape, itemsize)}. O(1) per tensor."""
    tensors = []
    for name, (shape, itemsize) in named_shapes.items():
        n = int(np.prod(shape))
        tensors.append((TensorReshardPlan(name, n, cep.scale_plan(n, k_old, k_new)), itemsize))
    return ReshardPlan(k_old, k_new, tuple(tensors))


# ---------------------------------------------------------------- host shards
def shard_slices(num_elements: int, k: int, host: int) -> slice:
    b = cep.chunk_bounds(num_elements, k)
    return slice(int(b[host]), int(b[host + 1]))


def gather_host_shard(flat: np.ndarray, k: int, host: int) -> np.ndarray:
    return flat[shard_slices(flat.shape[0], k, host)]


def apply_reshard(old_shards: list, num_elements: int, k_old: int, k_new: int) -> list:
    """Rebuild the k_new host shards from k_old shards, touching ONLY the
    ranges in the scale plan (stay ranges are sliced in place). Returns
    (new_shards, moved_elements)."""
    plan = cep.scale_plan(num_elements, k_old, k_new)
    ob = cep.chunk_bounds(num_elements, k_old)
    nb = cep.chunk_bounds(num_elements, k_new)
    pieces: dict[int, list] = {p: [] for p in range(k_new)}
    moved = 0
    for lo, hi, src in plan.stay:
        seg = old_shards[src][lo - int(ob[src]) : hi - int(ob[src])]
        pieces[src].append((lo, seg))
    for lo, hi, src, dst in plan.moves:
        seg = old_shards[src][lo - int(ob[src]) : hi - int(ob[src])]
        pieces[dst].append((lo, seg))
        moved += hi - lo
    new_shards = []
    for p in range(k_new):
        segs = sorted(pieces[p], key=lambda t: t[0])
        if segs:
            new_shards.append(np.concatenate([s for _, s in segs]))
        else:
            new_shards.append(np.zeros(0, dtype=old_shards[0].dtype))
        assert new_shards[-1].shape[0] == int(nb[p + 1] - nb[p])
    return new_shards, moved
