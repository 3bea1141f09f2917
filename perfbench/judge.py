"""The comparison that decides ``correct``: every answer the window produced,
against the plain reference, once the window has closed.

* Each rescale's answer: the k it reports and its mirrors (its re-check of
  the replication factor) against the reference's at the k asked for
  (``rescale_answers_wrong``, exact).
* The packs: the one the window ended on and those of a few rescale events
  drawn from the seed, slot by slot against a from-scratch pack at the k
  asked for, edges, mask and zero padding (``pack_slots_wrong``, exact).
* Each PageRank answer's widest gap to the float64 reference, relative to
  the reference's value (``pagerank_max_rel_err``).
* Each SSSP and WCC answer and its sweep count (``sssp_wrong``,
  ``wcc_wrong``: vertices that differ plus sweep counts that differ, exact).

A number is held to the limit its configuration's file gives it.
"""
from __future__ import annotations

import math
from collections.abc import Iterable

import numpy as np
import torch

from . import reference


def _finite(x: float) -> float:
    return float(x) if math.isfinite(x) else 1e300  # a NaN or an overflow fails any limit and stays valid JSON


def judge(src_h: np.ndarray, dst_h: np.ndarray, num_vertices: int, events: list, packs: Iterable, queries: dict,
          limits: dict, device: torch.device) -> dict:
    """``{name: {"value", "limit"}}``. ``packs`` yields ``(edges, mask, k
    asked for)`` of the program's packs to compare slot by slot, one at a
    time: each pack and the reference's are dropped before the next comes."""
    src = torch.from_numpy(src_h).to(device)
    dst = torch.from_numpy(dst_h).to(device)
    v = int(num_vertices)
    ok = [e for e in events if e.get("ok")]
    values = {}

    rescales = [e for e in ok if e["kind"] == "rescale"]
    if rescales or packs:
        want = reference.mirrors(src, dst, [e["k_new"] for e in rescales])
        values["rescale_answers_wrong"] = sum(
            1 for e in rescales if e["k_out"] != e["k_new"] or e["mirrors"] != want[e["k_new"]]
        )
        wrong = 0
        for edges, mask, k in packs:
            want_edges, want_mask = reference.pack(src, dst, k)
            wrong += reference.slots_wrong(edges, mask, want_edges, want_mask)
            del edges, mask, want_edges, want_mask  # before the next pack is gathered
        values["pack_slots_wrong"] = wrong

    by_kind = {kind: [e for e in ok if e["kind"] == kind] for kind in ("pagerank", "sssp", "wcc")}
    if by_kind["pagerank"]:
        want = reference.pagerank(src, dst, v, queries["pagerank_iterations"], queries["damping"])
        gap = 0.0
        for e in by_kind["pagerank"]:
            rel = ((e["answer"].to(torch.float64) - want).abs() / want).max()
            gap = max(gap, _finite(float(rel)))
        values["pagerank_max_rel_err"] = gap
    if by_kind["sssp"]:
        wrong, cache = 0, {}
        for e in by_kind["sssp"]:
            if e["source"] not in cache:
                cache[e["source"]] = reference.sssp(src, dst, v, e["source"], queries["max_iters"])
            want, sweeps = cache[e["source"]]
            wrong += int((e["answer"].to(torch.float64) != want.to(torch.float64)).sum()) + int(e["sweeps"] != sweeps)
        values["sssp_wrong"] = wrong
    if by_kind["wcc"]:
        want, sweeps = reference.wcc(src, dst, v, queries["max_iters"])
        values["wcc_wrong"] = sum(
            int((e["answer"].to(torch.float64) != want.to(torch.float64)).sum()) + int(e["sweeps"] != sweeps)
            for e in by_kind["wcc"]
        )
    return {name: {"value": value, "limit": limits[name]} for name, value in values.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
