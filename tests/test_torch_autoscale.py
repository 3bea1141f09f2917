"""The port's autoscaler (``elastic/autoscale.py``) against the JAX package's:
the boundary tests of ``tests/test_autoscale.py`` — watermark strictness,
cooldown thresholds, clamps, the no-signal guard, no flapping under
oscillating load — each run on both policies, which must take the same
decisions (and hold for the same reasons) on the same registry signals; and a
policy-driven rescale of a port ``StreamingEngine(device="cpu")`` under both
controllers, bit-identical to ``pack_slots`` after every decision. Exact.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import re

import numpy as np
import pytest

from repro.elastic import autoscale as J_EA
from repro.elastic import controller as J_ec
from repro.obs import metrics as J_OM
from repro_torch.core import ordering
from repro_torch.core.graph import rmat_graph
from repro_torch.elastic import autoscale as EA
from repro_torch.elastic import controller as ec
from repro_torch.obs import metrics as OM
from repro_torch.stream import IncrementalOrderer, StreamingEngine, SyntheticStream

PORT, JAX = (EA, OM), (J_EA, J_OM)


def _registry(M, queue=0.0, rate=0.0, walls=()):
    r = M.MetricsRegistry()
    r.gauge("controller.queue_depth").set(queue)
    r.gauge("controller.events_per_s").set(rate)
    h = r.histogram("controller.batch_wall_s")
    for w in walls:
        h.observe(w)
    return r


def _cfg(A, **kw):
    """Unsmoothed (ema=1.0) so the tests hit the raw watermark arithmetic."""
    base = dict(k_min=1, k_max=8, step_out=2, step_in=1, queue_high_per_host=4.0, queue_low=0.5, ema=1.0,
                out_cooldown_s=10.0, in_cooldown_s=30.0)
    base.update(kw)
    return A.AutoscaleConfig(**base)


def both(scenario):
    """``scenario(A, M)`` on the port and on the reference; the two must
    agree on every decision and on every policy log entry. Returns the
    port's result."""
    got, want = scenario(*PORT), scenario(*JAX)
    assert got == want
    return got


def _held(pol):
    return [(s.decision, s.held_by, s.queue, s.rate, s.p99_s, s.wall_total) for s in pol.log]


# ------------------------------------------------------------ watermark edges
def test_high_watermark_is_strictly_greater():
    def run(A, M):
        pol = A.AutoscalePolicy(_cfg(A))
        at = pol.decide(k=2, now=0.0, registry=_registry(M, queue=8.0))  # exactly AT the watermark
        above = pol.decide(k=2, now=100.0, registry=_registry(M, queue=8.0 + 1e-9))
        return at, above, _held(pol)

    at, above, log = both(run)
    assert at is None and log[0][1] == "steady"
    assert above is not None and above[0] == 4 and "queue" in above[1]


def test_scale_in_requires_every_signal_calm():
    def run(A, M):
        walls = [0.01] * 5
        got = A.AutoscalePolicy(_cfg(A, rate_low=2.0)).decide(
            k=4, now=0.0, registry=_registry(M, queue=0.5, rate=1.0, walls=walls))
        pol2 = A.AutoscalePolicy(_cfg(A, rate_low=2.0))
        vetoed = pol2.decide(k=4, now=0.0, registry=_registry(M, queue=0.0, rate=2.0, walls=walls))
        return got, vetoed, _held(pol2)

    got, vetoed, log = both(run)
    assert got is not None and got[0] == 3
    assert vetoed is None and log[-1][1] == "steady"


def test_p99_signal_drives_both_directions():
    def run(A, M):
        cfg = dict(p99_high_s=0.1, p99_low_frac=0.5)
        out = A.AutoscalePolicy(_cfg(A, **cfg)).decide(k=2, now=0.0, registry=_registry(M, walls=[0.2] * 10))
        dead_band = A.AutoscalePolicy(_cfg(A, **cfg)).decide(k=2, now=0.0, registry=_registry(M, walls=[0.07] * 10))
        low = A.AutoscalePolicy(_cfg(A, **cfg)).decide(k=2, now=0.0, registry=_registry(M, walls=[0.01] * 10))
        return out, dead_band, low

    out, dead_band, low = both(run)
    assert out is not None and out[0] == 4 and "p99" in out[1]
    assert dead_band is None
    assert low is not None and low[0] == 1


# ------------------------------------------------------------------ cooldowns
def test_out_cooldown_boundary_is_inclusive():
    def run(A, M):
        pol = A.AutoscalePolicy(_cfg(A))
        hot = _registry(M, queue=100.0)
        return [pol.decide(k=2, now=0.0, registry=hot), pol.decide(k=4, now=10.0 - 1e-6, registry=hot),
                pol.decide(k=4, now=10.0, registry=hot)], _held(pol)

    (first, inside, expiry), log = both(run)
    assert first is not None and inside is None and log[1][1] == "cooldown" and expiry is not None


def test_scale_out_arms_the_in_window():
    def run(A, M):
        walls = [0.01] * 3
        pol = A.AutoscalePolicy(_cfg(A))
        calm = _registry(M, queue=0.0, walls=walls)
        return [pol.decide(k=2, now=0.0, registry=_registry(M, queue=100.0, walls=walls)),
                pol.decide(k=4, now=15.0, registry=calm), pol.decide(k=4, now=30.0, registry=calm)], _held(pol)

    (out, held, back_in), log = both(run)
    assert out is not None and held is None and log[1][1] == "cooldown" and back_in is not None


def test_scale_in_arms_the_out_window():
    def run(A, M):
        pol = A.AutoscalePolicy(_cfg(A))
        return [pol.decide(k=4, now=0.0, registry=_registry(M, queue=0.0, walls=[0.01] * 3)),
                pol.decide(k=3, now=5.0, registry=_registry(M, queue=100.0)),
                pol.decide(k=3, now=10.0, registry=_registry(M, queue=100.0))], _held(pol)

    (shrink, spike, later), log = both(run)
    assert shrink is not None and spike is None and log[1][1] == "cooldown" and later is not None


# --------------------------------------------------------------------- clamps
def test_k_max_and_k_min_clamp_decisions():
    def run(A, M):
        hot, calm = _registry(M, queue=1e6), _registry(M, queue=0.0, walls=[0.01])
        pol = A.AutoscalePolicy(_cfg(A, k_max=4))
        pol2 = A.AutoscalePolicy(_cfg(A, k_min=2))
        pol3 = A.AutoscalePolicy(_cfg(A, k_min=2, step_in=5))
        return ([pol.decide(k=4, now=0.0, registry=hot), pol.decide(k=3, now=0.0, registry=hot),
                 pol2.decide(k=2, now=0.0, registry=calm), pol3.decide(k=4, now=0.0, registry=calm)],
                [_held(p) for p in (pol, pol2, pol3)])

    (at_max, to_max, at_min, to_min), logs = both(run)
    assert at_max is None and logs[0][0][1] == "clamp" and to_max[0] == 4
    assert at_min is None and logs[1][0][1] == "clamp" and to_min[0] == 2
    for A in (EA, J_EA):
        with pytest.raises(ValueError):
            A.AutoscaleConfig(k_min=3, k_max=2)
        with pytest.raises(ValueError):
            A.AutoscaleConfig(ema=0.0)


# ------------------------------------------------------------- no-signal guard
def test_silent_registry_is_not_idleness():
    def run(A, M):
        out = []
        for reg in (_registry(M), M.NULL):
            pol = A.AutoscalePolicy(_cfg(A))
            out.append((pol.decide(k=4, now=0.0, registry=reg), _held(pol)))
        return out

    for decision, log in both(run):
        assert decision is None and log[-1][1] == "no_signal"


# --------------------------------------------------- oscillating load, no flap
def test_no_flapping_under_oscillating_load():
    def run(A, M):
        cfg = _cfg(A, ema=0.5, out_cooldown_s=5.0, in_cooldown_s=10.0, k_min=1, k_max=8)
        pol, k, decided = A.AutoscalePolicy(cfg), 4, []
        for t in range(200):
            got = pol.decide(k=k, now=float(t), registry=_registry(M, queue=200.0 if t % 2 == 0 else 0.0,
                                                                   walls=[0.01] * 3))
            if got is not None:
                decided.append((float(t), "out" if got[0] > k else "in"))
                k = got[0]
        return decided, k

    decided, k = both(run)
    assert decided
    for (ta, ka), (tb, kb) in zip(decided, decided[1:]):
        assert ka == kb or tb - ta >= 5.0, f"flap: {ka}@{ta} reversed by {kb}@{tb}"
    assert all(kind == "out" for _, kind in decided) and k == 8


def test_ema_smoothing_absorbs_single_burst():
    def run(A, M):
        pol = A.AutoscalePolicy(_cfg(A, ema=0.2))
        calm = [pol.decide(k=4, now=float(t), registry=_registry(M, queue=1.0)) for t in range(5)]
        burst = pol.decide(k=4, now=5.0, registry=_registry(M, queue=70.0))
        fired = None
        for t in range(6, 12):
            fired = pol.decide(k=4, now=float(t), registry=_registry(M, queue=70.0))
            if fired:
                break
        return calm, burst, fired, _held(pol)

    calm, burst, fired, log = both(run)
    assert calm == [None] * 5 and burst is None and fired is not None
    assert log[5][2] == pytest.approx(0.2 * 70.0 + 0.8 * log[4][2])


# --------------------------------------- policy-driven rescale, bit identity
def test_policy_rescale_executes_on_stream_with_bit_identity():
    g = rmat_graph(7, 8, seed=0)
    order = ordering.geo_order(g, seed=0)
    src, dst = g.src[order].astype(np.int64), g.dst[order].astype(np.int64)

    def run(C, A, M):
        engine = StreamingEngine(IncrementalOrderer(src, dst, g.num_vertices, regions=2), device="cpu")
        t = [0.0]
        ctl = C.ElasticController(2, clock=lambda: t[0], metrics_registry=M.MetricsRegistry())
        ctl.attach_stream(engine)
        ctl.attach_autoscaler(A.AutoscalePolicy(_cfg(A, out_cooldown_s=1.0, in_cooldown_s=2.0)))
        stream = SyntheticStream(g, batch_size=8, seed=1)
        assert ctl.autoscale() is None  # no signal yet: silence holds k
        ctl.ingest(stream.batch())
        ctl.note_backlog(100)
        ev_out = ctl.autoscale()
        assert ev_out.kind == "scale_out" and ev_out.executed and ctl.k == engine.k == 4
        assert engine.verify_bit_identity()
        t[0] = 10.0  # clear both cooldown windows
        ctl.note_backlog(0)
        ev_in = ctl.autoscale()
        assert ev_in.kind == "scale_in" and ev_in.executed and ctl.k == engine.k == 3
        assert engine.verify_bit_identity()
        assert "autoscale out" in ev_out.reason and "autoscale in" in ev_in.reason
        ctl.ingest(stream.batch())
        assert engine.verify_bit_identity()
        # A reason quotes the p99 of measured wall times: the one part of the
        # log two runs cannot share.
        return re.sub(r"p99 [0-9.]+ms", "p99 (measured)", ctl.events_jsonl(drop_timings=True)), \
            engine.orderer.slot_src.copy()

    (log, slots), (jlog, jslots) = run(ec, *PORT), run(J_ec, *JAX)
    assert log == jlog and np.array_equal(slots, jslots)


def test_attach_autoscaler_respects_controller_floor():
    for C, (A, _) in ((ec, PORT), (J_ec, JAX)):
        ctl = C.ElasticController(4, k_min=2)
        with pytest.raises(ValueError):
            ctl.attach_autoscaler(A.AutoscalePolicy(_cfg(A, k_min=1)))
        ctl.attach_autoscaler(A.AutoscalePolicy(_cfg(A, k_min=2)))
        assert ctl.autoscale() is None  # NULL registry: no signal, no decision


@pytest.mark.parametrize("seed", range(4))
def test_random_signal_sequences_decide_alike(seed):
    """Random queue / rate / wall readings on a random clock: the two
    policies take the same decision, and log the same smoothed signals, at
    every step."""
    def run(A, M):
        rng = np.random.default_rng(seed)
        pol = A.AutoscalePolicy(_cfg(A, ema=0.3, rate_high=50.0, rate_low=5.0, p99_high_s=0.05,
                                     out_cooldown_s=2.0, in_cooldown_s=4.0, k_max=16))
        k, now, out = 4, 0.0, []
        reg = M.MetricsRegistry()
        for _ in range(120):
            now += float(rng.exponential(1.0))
            reg.gauge("controller.queue_depth").set(float(rng.choice([0.0, 3.0, 40.0, 200.0])))
            reg.gauge("controller.events_per_s").set(float(rng.uniform(0, 80)))
            reg.histogram("controller.batch_wall_s").observe(float(rng.exponential(0.02)))
            got = pol.decide(k=k, now=now, registry=reg)
            out.append(got)
            k = got[0] if got else k
        return out, _held(pol)

    decisions, log = both(run)
    assert any(d is not None for d in decisions)
