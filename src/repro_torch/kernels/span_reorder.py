"""Span-local GEO repair — the device side of the partial re-order rung.

The streaming escalation ladder's middle rung (DESIGN.md §9) repairs only the
worst span of regions. This module holds the device program of that repair as
torch ops and its byte-exact numpy host mirror — the *differential oracle*
discipline: the device twin and the mirror implement the identical integer
algorithm, so the engine updates host bookkeeping from the mirror (no device
round-trip) while ``verify_bit_identity`` proves the two never diverge.

Algorithm (``span_order_*``): neighbor-expansion scoring over the span's live
edges, fully vectorized —

1. ``rounds`` iterations of min-label propagation over the span edges
   (scatter-min): every vertex adopts the smallest vertex id reachable within
   ``rounds`` hops inside the span.
2. Each vertex records the round its label last improved (``depth``).
3. Edges sort by (label, depth, lo endpoint, hi endpoint, slot). The slot key
   makes the composite unique, so any correct sort yields the same
   permutation: the host's ``np.lexsort`` and the device's successive stable
   ``torch.sort`` passes (least significant key first) agree bit for bit.

Candidate selection (``select_span_order_*``): the repair scores its expansion
order and a caller-supplied candidate permutation by the exact multi-k span
objective (distinct-vertex counts over CEP chunks at ``eval_ks``) and keeps
the candidate only on a strict win.

Objective evaluation is tombstone-aware (dead slots key to PAD and count
nothing). With ``use_pallas=True`` the distinct counting runs through
``kernels/segment_rf.py``'s ``segment_distinct_counts``: the CUDA kernel for a
tensor on the card, its plain version for one on the CPU — the per-(chunk, k)
key rows are exactly that kernel's sorted-row layout. ``use_pallas=False``
keeps the same boundary comparison inline (identical integers). The name is
the JAX package's, whose kernel there is a Pallas one.

The device twins take tensors on one device and run there; integer arithmetic
is int64 inside an op, and the chunk keys handed to the kernel are int32, as
it requires. ``_chunk_keys_device`` checks on the host that those keys fit
int32 and raises where they would not.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..compat import PAD_ID
from ..core import cep
from .segment_rf import segment_distinct_counts

__all__ = [
    "SPAN_ROUNDS",
    "eval_ks",
    "identity_candidate",
    "span_order_host",
    "span_objective_host",
    "select_span_order_host",
    "span_order_device",
    "span_objective_device",
    "select_span_order_device",
    "splice_targets_device",
]

# Label-propagation rounds: how far a neighborhood expands. Spans are one to
# three regions wide; 4 hops collapses any community that fits in one, and
# each round costs two scatter-mins — the rung's main cost knob.
SPAN_ROUNDS = 4

_PAD = int(PAD_ID)  # int32 max — tombstone/padding key for ids and chunk keys


def eval_ks(k_min: int, k_max: int) -> tuple:
    """The static k grid the span objective sums over: geometric steps of the
    GEO objective's [k_min, k_max] range (evaluating all ~125 k's per repair
    would cost more than the repair; three decades rank candidates the same
    way the full grid does on every span tested)."""
    ks = tuple(k for k in (4, 16, 64) if k_min <= k <= k_max)
    return ks if ks else (max(2, int(k_min)),)


def identity_candidate(valid: np.ndarray) -> np.ndarray:
    """The current span layout as a live-first permutation: occupied slots in
    slot order, tombstones appended — the production candidate (a repair must
    never score worse than what's already there)."""
    valid = np.asarray(valid, dtype=bool)
    return np.concatenate([np.flatnonzero(valid), np.flatnonzero(~valid)])


# ----------------------------------------------------------------- host mirror
def span_order_host(
    u: np.ndarray,
    v: np.ndarray,
    valid: np.ndarray,
    num_vertices: int,
    rounds: int = SPAN_ROUNDS,
) -> np.ndarray:
    """Numpy mirror of ``span_order_device`` — identical permutation, proven
    byte-for-byte by the differential tests and ``verify_bit_identity``."""
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    valid = np.asarray(valid, dtype=bool)
    cap = u.shape[0]
    uu, vv = u[valid], v[valid]
    lbl = np.arange(num_vertices, dtype=np.int64)
    depth = np.zeros(num_vertices, dtype=np.int64)
    for t in range(1, rounds + 1):
        le = np.minimum(lbl[uu], lbl[vv])
        new = lbl.copy()
        np.minimum.at(new, uu, le)
        np.minimum.at(new, vv, le)
        depth = np.where(new < lbl, t, depth)
        if np.array_equal(new, lbl):
            break  # converged — the device runs all rounds as no-ops
        lbl = new
    comp = np.where(valid, np.minimum(lbl[u], lbl[v]), _PAD)
    dep = np.where(valid, np.minimum(depth[u], depth[v]), 0)
    lo = np.where(valid, np.minimum(u, v), 0)
    hi = np.where(valid, np.maximum(u, v), 0)
    slot = np.arange(cap, dtype=np.int64)
    # Unique composite (slot breaks every tie) → sort-implementation agnostic.
    return np.lexsort((slot, hi, lo, dep, comp))


def span_objective_host(
    u: np.ndarray,
    v: np.ndarray,
    valid: np.ndarray,
    order: np.ndarray,
    ks: Sequence[int],
) -> int:
    """Exact span objective of a live-first permutation: Σ_{k∈ks} Σ_chunks
    |V(chunk)| over CEP chunks of the span's live edges. Integer, so the host
    and device comparisons agree exactly."""
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    valid = np.asarray(valid, dtype=bool)
    order = np.asarray(order, dtype=np.int64)
    n = int(valid.sum())
    if n == 0:
        return 0
    uo, vo = u[order[:n]], v[order[:n]]
    total = 0
    j = np.arange(n, dtype=np.int64)
    for k in ks:
        p = np.asarray(cep.id2p(n, int(k), j), dtype=np.int64)
        key = np.concatenate([p, p])
        ids = np.concatenate([uo, vo])
        total += np.unique(key * (np.int64(2) ** 32) + ids).shape[0]
    return int(total)


def select_span_order_host(
    u: np.ndarray,
    v: np.ndarray,
    valid: np.ndarray,
    num_vertices: int,
    candidate: np.ndarray,
    ks: Sequence[int],
    rounds: int = SPAN_ROUNDS,
) -> tuple[np.ndarray, bool]:
    """(chosen order, chose_candidate): expansion order vs candidate by exact
    objective, candidate only on a strict win — mirror of the device select."""
    vec = span_order_host(u, v, valid, num_vertices, rounds)
    obj_vec = span_objective_host(u, v, valid, vec, ks)
    obj_cand = span_objective_host(u, v, valid, candidate, ks)
    if obj_cand < obj_vec:
        return np.asarray(candidate, dtype=np.int64), True
    return vec, False


# ------------------------------------------------------------- device (torch)
def _lexsort_device(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting by ``keys`` (most significant first), ties by
    position: successive stable sorts, least significant key first. The
    position is the slot key of the JAX package's multi-key ``lax.sort``."""
    perm = torch.arange(keys[0].shape[0], dtype=torch.int64, device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def _id2p_device(n: torch.Tensor, k: int, j: torch.Tensor) -> torch.Tensor:
    """``cep.id2p`` with the edge count a 0-d device tensor (no host read)."""
    f = n // k
    b = k - n % k  # number of small chunks
    cut = b * f  # first edge id owned by a large chunk
    small = j // torch.clamp(f, min=1)  # f = 0 ⇒ no small chunk owns an edge
    large = b + (j - cut) // (f + 1)
    return torch.where(j < cut, small, large)


def _chunk_start_device(n: torch.Tensor, k: int, p: torch.Tensor) -> torch.Tensor:
    """``cep.chunk_start`` with the edge count a 0-d device tensor."""
    return p * (n // k) + torch.clamp(p - k + n % k, min=0)


def span_order_device(u, v, valid, num_vertices: int, rounds: int = SPAN_ROUNDS) -> torch.Tensor:
    """Device twin of ``span_order_host``. ``u``/``v`` int32 (cap,), ``valid``
    bool (cap,), on one device; returns the (cap,) int64 permutation, live
    slots first. Every round runs (a converged round changes nothing), so no
    value travels to the host."""
    dev = u.device
    ui = torch.where(valid, u, 0).long()
    vi = torch.where(valid, v, 0).long()
    lbl = torch.arange(num_vertices, dtype=torch.int32, device=dev)
    depth = torch.zeros(num_vertices, dtype=torch.int32, device=dev)
    for i in range(rounds):
        le = torch.where(valid, torch.minimum(lbl[ui], lbl[vi]), _PAD)
        # Scatter-min: every writer of a vertex reduces, none overwrites.
        new = lbl.scatter_reduce(0, ui, le, "amin").scatter_reduce_(0, vi, le, "amin")
        depth = torch.where(new < lbl, i + 1, depth)
        lbl = new
    comp = torch.where(valid, torch.minimum(lbl[ui], lbl[vi]), _PAD)
    dep = torch.where(valid, torch.minimum(depth[ui], depth[vi]), 0)
    lo = torch.where(valid, torch.minimum(u, v), 0)
    hi = torch.where(valid, torch.maximum(u, v), 0)
    return _lexsort_device((comp, dep, lo, hi))


def _check_key_range(ks: Sequence[int], cap: int) -> None:
    """The chunk keys p·(2·cap+2) + rank are int32 for the kernel; the
    largest is below max(ks)·(2·cap+2), which must fit. The host mirror
    counts in int64 and would not wrap, so a silent wrap here would break
    the bit-identity contract."""
    if max(int(k) for k in ks) * (2 * cap + 2) > _PAD:
        raise ValueError(
            f"span objective keys overflow int32: max(ks)={max(ks)} × (2·cap+2) with cap={cap} "
            f"exceeds {_PAD}"
        )


def _chunk_keys_device(u, v, valid, order, n, ks) -> torch.Tensor:
    """(len(ks), 2·cap) int32 rows of (chunk, vertex-rank) keys, PAD where
    dead — each row sorted is exactly the layout segment_rf counts over."""
    cap = u.shape[0]
    _check_key_range(ks, cap)
    ids_sorted = torch.sort(torch.cat([torch.where(valid, u, _PAD), torch.where(valid, v, _PAD)])).values
    stride = 2 * cap + 2
    order = order.long()
    ru = torch.searchsorted(ids_sorted, u[order].contiguous())
    rv = torch.searchsorted(ids_sorted, v[order].contiguous())
    j = torch.arange(cap, dtype=torch.int64, device=u.device)
    live = j < n
    rows = []
    for k in ks:
        p = _id2p_device(n, int(k), j)
        ku = torch.where(live, p * stride + ru, _PAD)
        kv = torch.where(live, p * stride + rv, _PAD)
        rows.append(torch.cat([ku, kv]))
    return torch.stack(rows).to(torch.int32)


def span_objective_device(u, v, valid, order, n, ks, *, use_pallas: bool) -> torch.Tensor:
    """Device twin of ``span_objective_host`` (identical integer result, a
    0-d int64 tensor). ``n`` is the live count, a 0-d tensor on the device.

    ``use_pallas=True`` counts the distinct keys through
    ``segment_distinct_counts`` (the CUDA ``segment_rf`` kernel on the card);
    ``False`` runs the same boundary comparison inline."""
    keys = torch.sort(_chunk_keys_device(u, v, valid, order, n, ks), dim=-1).values.contiguous()
    if use_pallas:
        return segment_distinct_counts(keys).sum(dtype=torch.int64)
    prev = torch.nn.functional.pad(keys[:, :-1], (1, 0), value=-1)
    return ((keys != prev) & (keys != _PAD)).sum(dtype=torch.int64)


def select_span_order_device(
    u, v, valid, num_vertices: int, candidate, ks, *, use_pallas: bool,
    rounds: int = SPAN_ROUNDS,
) -> torch.Tensor:
    """Device twin of ``select_span_order_host``: returns the chosen (cap,)
    permutation and never the objective — the host mirror recomputes the
    identical choice, so nothing travels back."""
    n = valid.sum()
    vec = span_order_device(u, v, valid, num_vertices, rounds)
    obj_vec = span_objective_device(u, v, valid, vec, n, ks, use_pallas=use_pallas)
    obj_cand = span_objective_device(u, v, valid, candidate, n, ks, use_pallas=use_pallas)
    return torch.where(obj_cand < obj_vec, candidate.long(), vec)


def splice_targets_device(n, span_regions: int, spr: int, cap: int) -> torch.Tensor:
    """Span-local slot target of each order position — the device twin of the
    host ``_rewrite_span`` splice: CEP chunks of the n live edges over the
    span's regions, each chunk spread evenly over its region's ``spr`` slots.
    Dead positions (j ≥ n) target the overflow slot ``cap``. ``n`` is a 0-d
    tensor on the device the targets are made on.

    The column (j − start)·spr is taken in int64: the JAX twin's int32 wraps
    once a region's live count times ``spr`` passes 2³¹ (spr above 46,340 at
    2/3 fill), while the host mirror computes in int64."""
    n = torch.as_tensor(n).long()
    j = torch.arange(cap, dtype=torch.int64, device=n.device)
    p = _id2p_device(n, span_regions, j)
    start = _chunk_start_device(n, span_regions, p)
    n_p = torch.clamp(_chunk_start_device(n, span_regions, p + 1) - start, min=1)
    col = ((j - start) * spr) // n_p
    return torch.where(j < n, p * spr + col, cap)
