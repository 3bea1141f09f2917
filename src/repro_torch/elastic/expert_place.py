"""GEO+CEP expert placement for elastic expert parallelism (beyond-paper use
of the paper's technique).

Experts are vertices; co-routing mass (how often two experts serve the same
token under top-k routing) are weighted edges. GEO orders the experts so
co-activated experts get adjacent ids; CEP chunks the order into EP groups.
EP-group resize k→k±x then moves the Thm.-2-minimal number of experts AND
keeps co-activated experts colocated (fewer cross-group all-to-all bytes).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import cep, ordering
from ..core.graph import Graph


def coactivation_graph(expert_ids: np.ndarray, num_experts: int) -> Graph:
    """expert_ids: (T, K) routed experts per token → weighted co-occurrence
    graph (weights folded in by edge multiplicity capping)."""
    t, k = expert_ids.shape
    pairs = []
    for i in range(k):
        for j in range(i + 1, k):
            pairs.append(np.stack([expert_ids[:, i], expert_ids[:, j]], axis=1))
    e = np.concatenate(pairs, axis=0)
    return Graph.from_edges(e, num_experts)


def order_experts(routing_stats: np.ndarray, window: int | None = None) -> np.ndarray:
    """routing_stats: (E, E) symmetric co-activation counts → expert order.

    Weighted greedy expansion — GEO's priority (Eq. 8: prefer the frontier
    vertex most attached to the recently ordered window) generalized to
    weighted edges, which the unweighted Graph container would collapse.
    O(E²·window); experts-per-model is ≤ a few hundred, so this is free.
    """
    stats = np.asarray(routing_stats, dtype=np.float64)
    e = stats.shape[0]
    if e == 0 or stats.max() <= 0:
        return np.arange(e, dtype=np.int64)
    window = window or max(1, e // 8)
    placed: list[int] = []
    rest = set(range(e))
    cur = int(np.argmax(stats.sum(1)))  # densest expert first
    while rest:
        placed.append(cur)
        rest.discard(cur)
        if not rest:
            break
        recent = placed[-window:]
        rest_list = sorted(rest)
        scores = stats[np.ix_(recent, rest_list)].sum(axis=0)
        if scores.max() > 0:
            cur = rest_list[int(np.argmax(scores))]
        else:  # disconnected: jump to the densest remaining expert
            rem_mass = stats[np.ix_(rest_list, rest_list)].sum(axis=1)
            cur = rest_list[int(np.argmax(rem_mass))]
    return np.asarray(placed, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class ExpertPlacement:
    order: np.ndarray  # expert ids in GEO order
    k_groups: int

    def group_of(self, expert: int) -> int:
        pos = int(np.flatnonzero(self.order == expert)[0])
        return int(cep.id2p(self.order.shape[0], self.k_groups, pos))

    def groups(self) -> list:
        e = self.order.shape[0]
        b = cep.chunk_bounds(e, self.k_groups)
        return [self.order[int(b[p]) : int(b[p + 1])].tolist() for p in range(self.k_groups)]

    def rescale(self, k_new: int) -> tuple["ExpertPlacement", int]:
        """O(1) regroup; returns (new placement, experts moved)."""
        moved = cep.migrated_edges_exact(self.order.shape[0], self.k_groups, k_new)
        return ExpertPlacement(self.order, k_new), moved


def cross_group_traffic(routing_stats: np.ndarray, placement: ExpertPlacement) -> float:
    """Σ co-activation mass between experts in different EP groups — the
    all-to-all proxy minimized by GEO ordering."""
    e = routing_stats.shape[0]
    pos = np.empty(e, dtype=np.int64)
    pos[placement.order] = np.arange(e)
    grp = np.asarray(cep.id2p(e, placement.k_groups, pos))
    iu = np.triu_indices(e, 1)
    cross = grp[iu[0]] != grp[iu[1]]
    return float(routing_stats[iu][cross].sum())
