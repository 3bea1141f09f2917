"""The check that decides ``correct``, shown to fail: whole runs on the CPU at a
small scale, past the harness's look for a card, with the controls in the
program's place and with the timed path broken underneath."""
import time

import pytest

from perfbench import control, harness, spec as specmod
from repro_torch.elastic import rescale_exec
from repro_torch.graphs import engine
from repro_torch.kernels import rescale_migrate

SPEC = specmod.Spec()


def _run(cell, seed=2**31 + 5, trace=False, **kw):
    w = SPEC.cell(cell)
    config, mix = SPEC.config(w["config"]), specmod.mix(w["traffic"])
    config["generator"]["scale"] = 9
    config["k_range"] = [4, 24]
    seconds = 0.3
    if mix["queries"]["rate_per_s"] > 0:
        mix["queries"]["rate_per_s"], mix["scale_events"]["every_s"], seconds = 60.0, 0.1, 0.5
    return harness.run(cell, seed, seconds, trace, "cpu", t_start=time.perf_counter(), spec=SPEC, config=config,
                       mix=mix, **kw)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["g500-s22.rescale", "g500-s22.query"])
def test_a_sound_run_is_correct(cell, trace):
    r = _run(cell, trace=trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 3, r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in SPEC.metrics_of(cell, trace)} - {
        "rescale_migrate_roofline", "segment_rf_roofline"}  # the CPU launches no kernel: nothing to read
    if trace:
        assert r["device"]["window_s"] > 0 and len(r["breakdown"]["idle_gaps"]) <= 10
    if cell.endswith("query"):
        assert set(r["checks"]) >= {"pagerank_max_rel_err", "sssp_wrong", "wcc_wrong", "rescale_answers_wrong"}


@pytest.mark.parametrize("cell, name, reads", [
    ("g500-s22.rescale", "recheck_off", "rescale_answers_wrong"),
    ("g500-s22.query", "bf16", "pagerank_max_rel_err"),
    ("g500-s22.query", "bf16", "wcc_wrong"),
])
def test_the_control_is_not_correct(cell, name, reads):
    r = _run(cell, system_cls=control.controls()[name])
    assert not r["correct"] and r["checks"][reads]["value"] > r["checks"][reads]["limit"]


def _rescale_unchanged(monkeypatch):
    real = rescale_exec.ElasticRescaler.execute

    def unchanged(self, data, plan, **kw):
        _, stats = real(self, data, plan, **kw)
        return data, stats
    monkeypatch.setattr(rescale_exec.ElasticRescaler, "execute", unchanged)


def _migrate_with(fault):
    real = rescale_migrate.migrate

    def broken(old_edges, table, out=None):
        edges, mask = real(old_edges, table, out)
        fault(edges, mask)
        return edges, mask
    return broken


def _half_rows(edges, mask):
    edges[edges.shape[0] // 2:] = 0
    mask[mask.shape[0] // 2:] = 0


def _one_id(edges, mask):
    edges[0, 0, 1] += 1


@pytest.mark.parametrize("fault", ["state unchanged", "half the rows left out", "an id altered"])
def test_a_broken_rescale_is_not_correct(monkeypatch, fault):
    if fault == "state unchanged":
        _rescale_unchanged(monkeypatch)
    else:
        monkeypatch.setattr(rescale_migrate, "migrate", _migrate_with(_half_rows if fault.startswith("half")
                                                                      else _one_id))
    r = _run("g500-s22.rescale")
    assert not r["correct"], (fault, r["checks"], r["failed"])


def _queries_with(fault):
    pagerank, propagate = engine._pagerank_operands, engine._min_propagate

    def pr(edges, mask, degrees, v, group, iterations, damping):
        if fault == "state unchanged":
            return pagerank(edges, mask, degrees, v, group, 0, damping)
        if fault == "half the rows left out":
            return pagerank(edges[: edges.shape[0] // 2], mask[: edges.shape[0] // 2], degrees, v, group,
                            iterations, damping)
        x = pagerank(edges, mask, degrees, v, group, iterations, damping)
        x[int(edges[0, 0, 0])] *= 1.1
        return x

    def mp(edges, mask, group, x0, step, max_iters):
        if fault == "state unchanged":
            return x0, 0
        if fault == "half the rows left out":
            return propagate(edges[: edges.shape[0] // 2], mask[: edges.shape[0] // 2], group, x0, step, max_iters)
        x, it = propagate(edges, mask, group, x0, step, max_iters)
        x[int(edges[-1, 0, 1])] += 1.0
        return x, it
    return pr, mp


@pytest.mark.parametrize("fault", ["state unchanged", "half the rows left out", "an answer altered"])
def test_a_broken_query_is_not_correct(monkeypatch, fault):
    pr, mp = _queries_with(fault)
    monkeypatch.setattr(engine, "_pagerank_operands", pr)
    monkeypatch.setattr(engine, "_min_propagate", mp)
    r = _run("g500-s22.query")
    wrong = [n for n, c in r["checks"].items() if c["value"] > c["limit"]]
    assert not r["correct"] and {"pagerank_max_rel_err", "sssp_wrong", "wcc_wrong"} <= set(wrong), (fault, wrong)


def test_a_run_holds_the_packs_it_checks_to_the_k_it_asked_for():
    # A rescale that answers with another k than asked is wrong even where
    # its pack and mirrors are those of the k it gives.
    real = rescale_exec.ElasticRescaler.rescale

    def off_by_one(self, data, k_new, **kw):
        return real(self, data, k_new + 1 if k_new < 24 else k_new - 1, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rescale_exec.ElasticRescaler, "rescale", off_by_one)
        r = _run("g500-s22.rescale")
    assert not r["correct"] and r["checks"]["rescale_answers_wrong"]["value"] > 0
