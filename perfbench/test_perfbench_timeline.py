"""The timeline driver: every seed gets the same work, and a wait for a due
time never ends before it."""
import time
import types

import numpy as np
import pytest
import torch

from perfbench import spec as specmod

timeline = specmod.load_module("drivers", "timeline")

MIX = {
    "schedule_seed": 20261018,
    "scale_events": {"every_s": 0.25, "small_share": 0.5, "small_max": 4, "factor": [0.5, 2.0]},
    "queries": {"rate_per_s": 60.0, "mix": {"pagerank": 2, "sssp": 5, "wcc": 3}},
}
CONFIG = {"k_range": [4, 128]}
PRESENT = np.arange(3, 3000, 7, dtype=np.int64)


class FakeSystem:
    """Answers at once: a query's answer is its source."""

    device = torch.device("cpu")

    def rescale(self, data, k_new):
        return types.SimpleNamespace(k=k_new, mirrors=0), types.SimpleNamespace(
            elapsed_s=0.0, recheck_s=0.0, cross_device_bytes=0)

    def query(self, kind, data, source):
        return source, 1


def sources_played(seed: int, seconds: float = 0.6) -> list:
    player = timeline.Player(FakeSystem(), MIX, CONFIG, seed=seed, present=PRESENT, annotate=False)
    player.k = 8
    _, events, _, _ = player.play(types.SimpleNamespace(k=8, mirrors=0), seconds)
    return [e["source"] for e in events if e["kind"] == "sssp"]


def test_every_seed_plays_the_schedules_sssp_sources_in_its_own_order():
    a, b = sources_played(7), sources_played(2**31 + 12)
    n = sum(1 for _, kind in timeline.query_schedule(MIX, 0.6) if kind == "sssp")
    assert len(a) == len(b) == n > 5
    assert sorted(a) == sorted(b) == sorted(int(v) for v in timeline.sssp_sources(MIX, PRESENT, n))
    assert a != b and set(a) <= set(PRESENT.tolist())
    assert sources_played(7) == a


@pytest.mark.parametrize("ahead_s", [-0.01, 0.0, 0.001, timeline.SPIN_S, 3 * timeline.SPIN_S])
def test_a_wait_never_ends_before_its_deadline(ahead_s):
    deadline = time.perf_counter() + ahead_s
    timeline.wait_until(deadline)
    assert time.perf_counter() >= deadline
