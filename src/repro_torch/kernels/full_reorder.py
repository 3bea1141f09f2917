"""Whole-graph GEO re-ordering as a device program — the full-rebuild rung.

The escalation ladder's top rung (DESIGN.md §9/§11) re-orders every live slot,
not just a degraded span. This module generalizes the span repair of
``kernels/span_reorder.py`` to whole-graph scope with the same program shape —
an order kernel finished by one multi-key sort whose unique slot key makes the
composite a total order — and the same differential-oracle discipline:
``full_order_host`` is the byte-exact numpy mirror of ``full_order_device``,
so the engine advances host bookkeeping without a device round-trip.

The order kernel is a step-parallel form of GEO's greedy (core/ordering.py
Algorithm 4):

1. Per step, pick v_min by the exact GEO priority α·D[v] − β·M[v] over
   touched unselected vertices (random-permutation fallback otherwise).
2. Order all of v_min's remaining edges at once (keyed by the neighbor), then
   eagerly order the two-hop edges e_{u,w} whose w was touched within δ —
   GEO's Line-11 recency test, with M updated at step granularity.
3. Every ordered edge records (step, phase, key_a, key_b); the final 5-key
   sort (step, phase, key_a, key_b, slot) is the order. Dead slots key to
   int32 max and sort last, so the permutation is live-first.

The JAX twin runs the steps in a ``while_loop`` whose condition is data on
the device. Here a CUDA tensor takes the hand-written kernel
``csrc/full_reorder.cu``: the live incidence list is built with torch ops
(``incidence_device``), one launch runs every step on the card, evaluating
the twin's condition ``(t < nv) & (i < e_live)`` itself, and writes the
four keys and its step count (``greedy_keys``); the 5-key sort finishes on
the card. Nothing is read back. The kernel runs on one CTA for small
graphs and on a thread-block cluster of up to 16 CTAs above that, the
per-vertex state split over the cluster's shared memory (``greedy_plan``
says which). A CPU tensor takes the plain version
``full_order_device_torch``, the step loop as torch ops, which enqueues
exactly ``steps`` steps: the host mirror's step count (a step after every
live edge is ordered changes no key, since every degree is 0 then).
``launches`` counts the kernel's launches.

Candidate selection (``select_full_order_*``) scores the greedy order and a
caller-supplied candidate by the span objective at whole-graph scope; the
candidate wins only on a strict improvement.

int32 discipline: priorities are int32 on the device as in the JAX twin; the
mirror runs int64, and ``greedy_params`` rejects graphs whose priorities could
overflow int32, so the two never diverge by wraparound.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from ..compat import PAD_ID
from ..core import ordering
from . import _build
from .span_reorder import (
    _lexsort_device,
    eval_ks,
    identity_candidate,
    span_objective_device,
    span_objective_host,
)

__all__ = [
    "greedy_fits_int32",
    "greedy_params",
    "fallback_positions",
    "eval_ks_full",
    "full_order_host",
    "full_order_device",
    "full_order_device_torch",
    "greedy_keys",
    "greedy_plan",
    "incidence_device",
    "launches",
    "full_objective_host",
    "full_objective_device",
    "select_full_order_host",
    "select_full_order_device",
    "geo_full_candidate",
]

_PAD = int(PAD_ID)  # int32 max — dead-slot sort key
launches = 0  # launches of the greedy kernel since import (or a reset)
_greedy_fns = None  # (greedy, plan): the C entry points, their ctypes signatures set once


def greedy_fits_int32(num_edges: int, k_min: int, k_max: int, max_degree: int) -> bool:
    """Whether the step-parallel greedy's priorities α·D − β·M stay inside
    int32 for this graph — the precondition of ``greedy_params``. Callers on
    the rebuild path test this and fall back to a host ordering instead of
    aborting: a rebuild must degrade, not die."""
    ks = np.arange(k_min, k_max + 1, dtype=np.int64)
    alpha = int(np.sum(num_edges // ks))
    beta = int(k_max - k_min)
    return alpha * (int(max_degree) + 1) + beta * (num_edges + 1) < 2**31


def greedy_params(
    num_edges: int,
    k_min: int,
    k_max: int,
    max_degree: int,
) -> tuple[int, int, int]:
    """(alpha, beta, delta) of the step-parallel greedy — the same constants
    core/ordering.geo_order derives (Eq. 8 priorities, §4.1 δ), so the two
    rungs optimize one objective. Raises when a priority α·D − β·M could
    leave int32 range: the device computes int32, the mirror int64, and a
    silent wrap on only one side would break the byte-identity contract."""
    ks = np.arange(k_min, k_max + 1, dtype=np.int64)
    alpha = int(np.sum(num_edges // ks))
    beta = int(k_max - k_min)
    delta = max(1, num_edges // k_max)
    bound = alpha * (int(max_degree) + 1) + beta * (num_edges + 1)
    if bound >= 2**31:
        raise ValueError(
            f"greedy priorities may overflow int32 (bound {bound}): "
            "graph too large for the device full-reorder kernel"
        )
    return alpha, beta, delta


def fallback_positions(num_vertices: int, seed: int = 0) -> np.ndarray:
    """Random-vertex fallback ranks (paper: RandomVertex()): position of each
    vertex in a seeded permutation — the untouched-component tie-break, fixed
    per rebuild so host and device pick the identical fallback vertex."""
    rng = np.random.default_rng(seed)
    pos = np.empty(num_vertices, dtype=np.int64)
    pos[rng.permutation(num_vertices)] = np.arange(num_vertices)
    return pos


def eval_ks_full(k_min: int, k_max: int, regions: int) -> tuple:
    """Objective k grid for full-rebuild candidate selection: the span grid
    plus the current region count — a full rebuild must never regress the RF
    at the k the pack is actually partitioned into."""
    ks = set(eval_ks(k_min, k_max))
    if k_min <= regions <= k_max:
        ks.add(int(regions))
    return tuple(sorted(ks))


# ----------------------------------------------------------------- host mirror
def _incidence(ui: np.ndarray, vi: np.ndarray, valid: np.ndarray, num_vertices: int):
    """(ptr, slots): the live slots incident to vertex w are
    ``slots[ptr[w]:ptr[w+1]]``, ascending."""
    live = np.flatnonzero(valid)
    ends = np.concatenate([ui[live], vi[live]])
    by_vertex = np.argsort(ends, kind="stable")
    ptr = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(np.bincount(ends, minlength=num_vertices), out=ptr[1:])
    return ptr, np.concatenate([live, live])[by_vertex]


def _incident(ptr: np.ndarray, slots: np.ndarray, vs: np.ndarray) -> np.ndarray:
    """Concatenated incident slots of the vertices ``vs``."""
    starts, lens = ptr[vs], ptr[vs + 1] - ptr[vs]
    total = int(lens.sum())
    offsets = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    return slots[offsets + np.arange(total)]


def _full_order_host(u, v, valid, num_vertices, alpha, beta, delta, permpos) -> tuple[np.ndarray, int]:
    """``full_order_host`` and the number of greedy steps it ran — the step
    count the device twin is then given.

    The JAX package's mirror tests every slot at every step; this one visits
    only the slots incident to v_min and to its fresh frontier, through an
    incidence list — the same masks on the slots that can satisfy them, so
    the same keys (tests hold it byte-equal to the JAX package's mirror)."""
    cap = u.shape[0]
    ui = np.asarray(u, dtype=np.int64)
    vi = np.asarray(v, dtype=np.int64)
    valid = np.asarray(valid, dtype=bool)
    permpos = np.asarray(permpos, dtype=np.int64)
    ptr, inc = _incidence(ui, vi, valid, num_vertices)
    done = ~valid.copy()
    d = np.zeros(num_vertices, np.int64)
    np.add.at(d, ui[valid], 1)
    np.add.at(d, vi[valid], 1)
    m = np.zeros(num_vertices, np.int64)
    touched = np.zeros(num_vertices, bool)
    selected = np.zeros(num_vertices, bool)
    fr = np.zeros(num_vertices, bool)
    e_live = int(valid.sum())
    MAX = np.int64(_PAD)
    step = np.full(cap, MAX, np.int64)
    phase = np.full(cap, MAX, np.int64)
    ka = np.full(cap, MAX, np.int64)
    kb = np.full(cap, MAX, np.int64)
    i = 0
    steps = 0
    for t in range(num_vertices):
        if i >= e_live:
            break
        steps = t + 1
        cand = touched & ~selected & (d > 0)
        if cand.any():
            vmin = int(np.argmin(np.where(cand, alpha * d - beta * m, MAX)))
        else:
            vmin = int(np.argmin(np.where(~selected & (d > 0), permpos, MAX)))
        # --- one-hop: every remaining edge of v_min, keyed by the neighbor
        oh = inc[ptr[vmin] : ptr[vmin + 1]]
        oh = oh[~done[oh]]
        other = np.where(ui[oh] == vmin, vi[oh], ui[oh])
        n1 = oh.size
        i1 = i + n1
        step[oh] = t
        phase[oh] = 0
        ka[oh] = other
        kb[oh] = 0
        m[other] = i1
        np.subtract.at(d, other, 1)
        touched[other] = True
        touched[vmin] = True
        done[oh] = True
        d[vmin] = 0
        selected[vmin] = True
        i = i1
        # --- two-hop: e_{u,w} with u in the fresh frontier, w recent (≤ δ)
        if n1:
            fr[other] = True
            c = np.unique(_incident(ptr, inc, other))
            c = c[~done[c]]
            u_in = fr[ui[c]]
            v_in = fr[vi[c]]
            wother = np.where(u_in, vi[c], ui[c])
            rec = (
                touched[wother]
                & ~selected[wother]
                & (m[wother] > 0)
                & ((i1 - m[wother]) <= delta)
            )
            th_sel = rec & (wother != vmin)
            th = c[th_sel]
            fr[other] = False
            n2 = th.size
            if n2:
                tu = np.where(u_in[th_sel], ui[th], vi[th])
                tw = wother[th_sel]
                step[th] = t
                phase[th] = 1
                ka[th] = tu
                kb[th] = tw
                i2 = i1 + n2
                np.subtract.at(d, tu, 1)
                np.subtract.at(d, tw, 1)
                m[tu] = i2
                m[tw] = i2
                done[th] = True
                i = i2
    slot = np.arange(cap, dtype=np.int64)
    # Unique composite (slot breaks all ties) → sort-implementation agnostic.
    return np.lexsort((slot, kb, ka, phase, step)), steps


def full_order_host(
    u: np.ndarray,
    v: np.ndarray,
    valid: np.ndarray,
    num_vertices: int,
    alpha: int,
    beta: int,
    delta: int,
    permpos: np.ndarray,
) -> np.ndarray:
    """Numpy mirror of ``full_order_device`` — identical permutation byte for
    byte (int64 arithmetic over int32-range values; see ``greedy_params``)."""
    return _full_order_host(u, v, valid, num_vertices, alpha, beta, delta, permpos)[0]


# ------------------------------------------------------------- device (torch)
def full_order_device_torch(
    u, v, valid, num_vertices: int, alpha, beta, delta, permpos, *, steps: int
) -> torch.Tensor:
    """Plain version of ``full_order_device``: the step loop as torch ops,
    ``steps`` steps enqueued (the host mirror's count) and nothing read back.
    What a CPU tensor runs."""
    cap = u.shape[0]
    nv = int(num_vertices)
    dev = u.device
    i32 = torch.int32
    valid = valid.bool()
    ui = u.long()
    vi = v.long()
    # Per-vertex state carries one dump row at index nv: scatters from slots
    # that pick nothing land there, and no read of a real vertex sees it.
    d = torch.zeros(nv + 1, dtype=i32, device=dev)
    ones = torch.ones(cap, dtype=i32, device=dev)
    d.index_add_(0, torch.where(valid, ui, nv), ones).index_add_(0, torch.where(valid, vi, nv), ones)
    neg = -ones
    m = torch.zeros(nv + 1, dtype=i32, device=dev)
    touched = torch.zeros(nv + 1, dtype=torch.bool, device=dev)
    selected = torch.zeros(nv, dtype=torch.bool, device=dev)
    done = ~valid
    step = torch.full((cap,), _PAD, dtype=i32, device=dev)
    phase = torch.full((cap,), _PAD, dtype=i32, device=dev)
    ka = torch.full((cap,), _PAD, dtype=i32, device=dev)
    kb = torch.full((cap,), _PAD, dtype=i32, device=dev)
    i = torch.zeros((), dtype=torch.int64, device=dev)
    permpos = permpos.to(i32)
    true = torch.ones((), dtype=torch.bool, device=dev)

    def body(t: int):
        nonlocal d, m, touched, done, step, phase, ka, kb, i
        dv, mv = d[:nv], m[:nv]
        cand = touched[:nv] & ~selected & (dv > 0)
        vmin_c = torch.argmin(torch.where(cand, alpha * dv - beta * mv, _PAD))
        vmin_f = torch.argmin(torch.where(~selected & (dv > 0), permpos, _PAD))
        vmin = torch.where(cand.any(), vmin_c, vmin_f)  # argmin: first index on ties
        at_vmin = vmin.view(1)
        # one-hop
        oh = ~done & ((ui == vmin) | (vi == vmin))
        other = torch.where(ui == vmin, vi, ui)
        n1 = oh.sum()
        i1 = i + n1
        step = torch.where(oh, t, step)
        phase = torch.where(oh, 0, phase)
        ka = torch.where(oh, other.to(i32), ka)
        kb = torch.where(oh, 0, kb)
        oidx = torch.where(oh, other, nv)
        m.index_put_((oidx,), i1.to(i32))
        d.index_add_(0, oidx, neg)
        touched.index_put_((oidx,), true)
        touched.index_put_((at_vmin,), true)
        done = done | oh
        d.index_put_((at_vmin,), torch.zeros((), dtype=i32, device=dev))
        selected.index_put_((at_vmin,), true)
        # two-hop
        fr = torch.zeros(nv + 1, dtype=torch.bool, device=dev).index_put_((oidx,), true)
        u_in = fr[ui]
        v_in = fr[vi]
        wother = torch.where(u_in, vi, ui)
        mw = m[wother]
        rec = touched[wother] & ~selected[wother] & (mw > 0) & ((i1 - mw) <= delta)
        th = ~done & (u_in | v_in) & rec & (wother != vmin) & (n1 > 0)
        tu = torch.where(u_in, ui, vi)
        step = torch.where(th, t, step)
        phase = torch.where(th, 1, phase)
        ka = torch.where(th, tu.to(i32), ka)
        kb = torch.where(th, wother.to(i32), kb)
        i2 = (i1 + th.sum()).to(i32)
        tui = torch.where(th, tu, nv)
        twi = torch.where(th, wother, nv)
        d.index_add_(0, tui, neg).index_add_(0, twi, neg)
        m.index_put_((tui,), i2)
        m.index_put_((twi,), i2)
        done = done | th
        i = i2.long()

    for t in range(int(steps)):
        body(t)
    # The 5-key sort (step, phase, ka, kb, slot) — the whole-graph twin of the
    # span kernel's finish.
    return _lexsort_device((step, phase, ka, kb))


def incidence_device(u, v, valid, num_vertices: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``_incidence`` with torch ops and no host read: ``(ptr, slots)``, both
    int32, the live slots incident to vertex w at ``slots[ptr[w]:ptr[w+1]]``,
    ascending. ``slots`` keeps 2·cap entries: those past ``ptr[nv]`` are the
    dead slots' (keyed to vertex nv, so they sort last)."""
    nv = int(num_vertices)
    cap = u.shape[0]
    valid = valid.bool()
    ends = torch.cat([torch.where(valid, u.to(torch.int32), nv), torch.where(valid, v.to(torch.int32), nv)])
    by_vertex = torch.argsort(ends, stable=True)
    w = torch.arange(nv + 1, dtype=torch.int32, device=u.device)
    ptr = torch.searchsorted(ends[by_vertex], w, out_int32=True)
    return ptr, (by_vertex % cap).to(torch.int32)  # entry j of the concatenation is slot j mod cap


def _kernel():
    """``(greedy, plan)`` of the built library, with their ctypes
    signatures set where it is first loaded."""
    global _greedy_fns
    if _greedy_fns is None:
        lib = _build.load("full_reorder")
        greedy, plan = lib.full_reorder_greedy, lib.full_reorder_plan
        greedy.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        greedy.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        plan.restype = ctypes.c_int
        _greedy_fns = greedy, plan
    return _greedy_fns


def greedy_plan(num_vertices: int, device=None) -> tuple[int, int]:
    """The greedy kernel's launch for |V| vertices on a CUDA device (the
    current one by default): ``(cluster, global_bytes)``. ``cluster`` is the
    CTAs it runs on: 1, one CTA with the per-vertex state in its shared
    memory; 2–16, a thread-block cluster with the state split over the CTAs'
    shared memory, or, where ``global_bytes`` > 0, over that much global
    scratch. Raises with the CUDA error's string where the device cannot be
    asked."""
    nv = int(num_vertices)
    if not 0 < nv < 2**31 - 32:
        raise ValueError(f"greedy_plan takes 0 < |V| < 2**31 - 32, got {nv}")
    _, plan = _kernel()
    cluster, global_bytes = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = plan(nv, ctypes.byref(cluster), ctypes.byref(global_bytes))
    _build.check_launch("full_reorder", err)
    return cluster.value, global_bytes.value


def greedy_keys(u, v, valid, num_vertices: int, alpha: int, beta: int, delta: int, permpos):
    """The greedy kernel on CUDA tensors: ``(keys, steps, work)`` — keys
    ``(4, cap)`` int32, the rows (step, phase, key_a, key_b) of every slot
    (int32 max for a slot left unordered); ``steps`` ``(1,)`` int32, the steps
    the kernel ran (the twin's ``while_loop`` count); ``work`` ``(2,)`` int64,
    the incidence entries its walks read and its fallback steps. ``u``/``v``
    int32 and ``valid`` bool ``(cap,)``, ``permpos`` int32 ``(|V|,)``, all
    contiguous and on one CUDA device; ``alpha``, ``beta``, ``delta`` ints.
    One kernel launch, after the incidence list's torch ops, on the CTAs
    ``greedy_plan`` names; nothing is read back. A launch the card refuses
    (a cluster it cannot hold: no silent fallback) raises with the CUDA
    error's string."""
    global launches
    cap, nv = u.shape[0], int(num_vertices)
    for name, t, dtype, n in (("u", u, torch.int32, cap), ("v", v, torch.int32, cap),
                              ("valid", valid, torch.bool, cap), ("permpos", permpos, torch.int32, nv)):
        if t.dtype != dtype or t.dim() != 1 or t.shape[0] != n:
            raise TypeError(f"greedy_keys: {name} must be a ({n},) {dtype} tensor, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"greedy_keys: {name} must be contiguous")
        if t.device != u.device or t.device.type != "cuda":
            raise ValueError(f"greedy_keys: every input must lie on one CUDA device, got {name} on {t.device}")
    if not 0 < nv < 2**31 - 32 or not 0 < cap < 2**30:
        raise ValueError(f"greedy_keys takes 0 < |V| < 2**31 - 32 and 0 < cap < 2**30, got {nv} and {cap}")
    dev = u.device
    greedy, _ = _kernel()
    _, need = greedy_plan(nv, dev)
    with torch.cuda.device(dev):
        ptr, inc = incidence_device(u, v, valid, nv)
        done = (~valid).to(torch.uint8)
        keys = torch.full((4, cap), _PAD, dtype=torch.int32, device=dev)
        frontier = torch.empty(nv, dtype=torch.int32, device=dev)
        th = torch.empty((cap, 4), dtype=torch.int32, device=dev)
        state = torch.empty(max(1, need), dtype=torch.uint8, device=dev)
        steps = torch.empty(1, dtype=torch.int32, device=dev)
        work = torch.empty(2, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = greedy(u.data_ptr(), v.data_ptr(), done.data_ptr(), ptr.data_ptr(), inc.data_ptr(), permpos.data_ptr(),
                     keys.data_ptr(), frontier.data_ptr(), th.data_ptr(), state.data_ptr(), steps.data_ptr(),
                     work.data_ptr(), cap, nv, int(alpha), int(beta), int(delta), stream)
    _build.check_launch("full_reorder", err)
    launches += 1
    return keys, steps, work


def full_order_device(
    u, v, valid, num_vertices: int, alpha, beta, delta, permpos, *, steps: int
) -> torch.Tensor:
    """Device twin of ``full_order_host``. ``u``/``v`` int32 (cap,), ``valid``
    bool (cap,), ``permpos`` int32 (|V|,), all on one device; ``alpha``,
    ``beta``, ``delta`` Python ints (a 0-d tensor is read on the host).
    Returns the (cap,) int64 permutation, live slots first.

    On a CUDA device: the greedy kernel (``greedy_keys``: one launch, its own
    step count), then the 5-key sort (step, phase, ka, kb, slot) on the card.
    On the CPU: the plain version, which runs ``steps`` steps (the host
    mirror's count). Nothing is read back."""
    if u.device.type == "cpu":
        return full_order_device_torch(u, v, valid, num_vertices, alpha, beta, delta, permpos, steps=steps)
    if u.device.type != "cuda":
        raise ValueError(f"full_order_device runs on CUDA or CPU tensors, got {u.device}")
    keys, _, _ = greedy_keys(u, v, valid, num_vertices, int(alpha), int(beta), int(delta), permpos)
    return _lexsort_device(tuple(keys))


# ------------------------------------------------------- objective + selection
def full_objective_host(
    u: np.ndarray, v: np.ndarray, valid: np.ndarray, order: np.ndarray, ks: Sequence[int]
) -> int:
    """Exact whole-graph objective of a live-first permutation — the span
    objective evaluated at graph scope (the machinery is scope-free)."""
    return span_objective_host(u, v, valid, order, ks)


def full_objective_device(u, v, valid, order, n, ks, *, use_pallas: bool) -> torch.Tensor:
    """Device twin of ``full_objective_host`` (identical integers)."""
    return span_objective_device(u, v, valid, order, n, ks, use_pallas=use_pallas)


def _select_full_order_host(u, v, valid, num_vertices, candidate, ks, alpha, beta, delta, permpos):
    """``select_full_order_host`` and the greedy's step count."""
    greedy, steps = _full_order_host(u, v, valid, num_vertices, alpha, beta, delta, permpos)
    obj_g = full_objective_host(u, v, valid, greedy, ks)
    obj_c = full_objective_host(u, v, valid, candidate, ks)
    if obj_c < obj_g:
        return np.asarray(candidate, dtype=np.int64), True, steps
    return greedy, False, steps


def select_full_order_host(
    u: np.ndarray,
    v: np.ndarray,
    valid: np.ndarray,
    num_vertices: int,
    candidate: np.ndarray,
    ks: Sequence[int],
    alpha: int,
    beta: int,
    delta: int,
    permpos: np.ndarray,
) -> tuple[np.ndarray, bool]:
    """(chosen order, chose_candidate): the step-parallel greedy order vs the
    candidate permutation by the exact whole-graph objective; the candidate
    wins only on a strict improvement. With the incumbent layout as the
    candidate this is the never-worse guarantee; with host ``geo_order`` it is
    never-worse-than-GEO by construction."""
    return _select_full_order_host(u, v, valid, num_vertices, candidate, ks, alpha, beta, delta, permpos)[:2]


def select_full_order_device(
    u, v, valid, num_vertices: int, candidate, ks, alpha, beta, delta, permpos,
    *, use_pallas: bool, steps: int,
) -> torch.Tensor:
    """Device twin of ``select_full_order_host`` (returns only the chosen
    permutation — the mirror recomputes the identical decision host-side)."""
    n = valid.sum()
    greedy = full_order_device(u, v, valid, num_vertices, alpha, beta, delta, permpos, steps=steps)
    obj_g = full_objective_device(u, v, valid, greedy, n, ks, use_pallas=use_pallas)
    obj_c = full_objective_device(u, v, valid, candidate, n, ks, use_pallas=use_pallas)
    return torch.where(obj_c < obj_g, candidate.long(), greedy)


def geo_full_candidate(
    slot_src: np.ndarray,
    slot_dst: np.ndarray,
    slot_valid: np.ndarray,
    num_vertices: int,
    k_min: int = ordering.K_MIN_DEFAULT,
    k_max: int = ordering.K_MAX_DEFAULT,
    seed: int = 0,
) -> np.ndarray:
    """Host ``geo_order`` of the whole live slot array as a live-first slot
    permutation — the full-rebuild quality oracle, and the candidate of the
    async rung's ``geo`` and ``differential`` modes. The graph is rebuilt from
    the slots, ordered, and mapped back to slot ids (slots hold unique
    canonical u < v pairs, so the mapping is a bijection)."""
    from ..core.graph import Graph

    valid = np.asarray(slot_valid, dtype=bool)
    live = np.flatnonzero(valid)
    if live.size < 2:
        return identity_candidate(valid)
    u = np.asarray(slot_src, dtype=np.int64)
    v = np.asarray(slot_dst, dtype=np.int64)
    g = Graph.from_edges(np.stack([u[live], v[live]], axis=1), num_vertices)
    order = ordering.geo_order(g, k_min, k_max, seed=seed)
    # Slot lookup via scalar keys + searchsorted (the (u, v) pairs are unique
    # canonical edges, so u·V + v is a bijection — and V² fits int64 for any
    # graph this subsystem can hold).
    nv = np.int64(num_vertices)
    slot_keys = u[live] * nv + v[live]
    sorter = np.argsort(slot_keys, kind="stable")
    ordered_keys = g.src[order].astype(np.int64) * nv + g.dst[order].astype(np.int64)
    cand_live = live[sorter[np.searchsorted(slot_keys[sorter], ordered_keys)]]
    return np.concatenate([cand_live, np.flatnonzero(~valid)])
