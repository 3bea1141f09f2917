"""A cell over several ranks, on the CPU: two gloo ranks started by
``launcher.launch`` through ``systems/sharded.py``, a rank that fails or stalls,
and the system under test found by name.

Each launch runs in a process of its own with a time limit, so that a hang
fails its test instead of holding the suite."""
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

from perfbench import harness, spec as specmod, sut

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPEC = specmod.Spec()
CELL = "g500-s22.rescale"
LIMIT_S = 120
SEED = 2**31 + 11


def _small(cell=CELL, **config_keys):
    """The cell's configuration and mix at scale 9, as the fault tests cut them."""
    w = SPEC.cell(cell)
    config, mix = SPEC.config(w["config"]), specmod.mix(w["traffic"])
    config["generator"]["scale"] = 9
    config["k_range"] = [4, 24]
    config.update(config_keys)
    return config, mix


LAUNCHER = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import launcher
kw = json.loads(open(sys.argv[1]).read())
launcher.BOUNDS.update(kw.pop("bounds") or {{}})
sys.exit(launcher.launch(t_start=time.perf_counter(), **kw))
"""

# A rank as ``run.py`` runs it, with the cell's configuration and mix cut to
# scale 9 (read from the file named first), and a fault planted where asked.
RANK = """
import functools, json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import harness, run
from repro_torch.elastic import rescale_exec
harness.run = functools.partial(harness.run, **json.loads(open(sys.argv[1]).read()))
real, calls = rescale_exec.ElasticRescaler.rescale, [0]
rank = int(sys.argv[sys.argv.index("--rank") + 1])

def rescale(self, data, k_new, **kw):
    calls[0] += 1
    if rank == 1 and calls[0] == 12:  # past the warm-up's three, inside the window
        if {fault!r} == "raises":
            raise RuntimeError("a fault planted on rank 1")
        time.sleep(3600)
    return real(self, data, k_new, **kw)

if {fault!r} is not None:
    rescale_exec.ElasticRescaler.rescale = rescale
sys.exit(run.main(sys.argv[2:]))
"""


def _launch(tmp_path, seconds, trace=False, fault=None, bounds=None):
    """Runs ``launcher.launch`` over two gloo ranks on the CPU in a process of
    its own; returns its exit code, standard output and error, and seconds."""
    paths = dict(root=str(ROOT), src=str(ROOT / "src"))
    config, mix = _small(system="sharded")
    (tmp_path / "overrides.json").write_text(json.dumps({"config": config, "mix": mix}))
    (tmp_path / "rank.py").write_text(RANK.format(fault=fault, **paths))
    kw = dict(workload=CELL, seed=SEED, seconds=seconds, trace=trace, devices=["cpu", "cpu"], bounds=bounds,
              child=[sys.executable, str(tmp_path / "rank.py"), str(tmp_path / "overrides.json")])
    (tmp_path / "launch.json").write_text(json.dumps(kw))
    (tmp_path / "launch.py").write_text(LAUNCHER.format(**paths))
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, str(tmp_path / "launch.py"), str(tmp_path / "launch.json")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        pytest.fail(f"the launch ran past its limit of {LIMIT_S} s")
    return proc.returncode, out, err, time.monotonic() - t0


def _rank_processes(err: str) -> list:
    return [int(line.split(" is process ")[1].split()[0]) for line in err.splitlines() if " is process " in line]


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.mark.parametrize("trace", [False, True])
def test_two_gloo_ranks_run_the_sharded_system_correctly(tmp_path, trace):
    rc, out, err, _ = _launch(tmp_path, seconds=1.0, trace=trace)
    assert rc == 0, err[-4000:]
    lines = [line for line in out.splitlines() if line.strip()]
    assert len(lines) == 1, out  # only rank 0 prints a result
    r = json.loads(lines[0])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 3, r["checks"]
    assert r["checks"]["rescale_answers_wrong"]["value"] == 0 and r["checks"]["pack_slots_wrong"]["value"] == 0
    assert r["device"]["count"] == 2
    assert err.rstrip().splitlines()[-len(r["checks"]):] == [
        f"check {n} {c['value']!r} limit {c['limit']!r}" for n, c in r["checks"].items()]
    assert "the window's rescales sent" in err and all(_gone(p) for p in _rank_processes(err))
    if trace:
        assert r["device"]["window_s"] > 0 and "breakdown" in r
        return
    config, mix = _small(system="sharded")
    one = harness.run(CELL, SEED, 0.5, False, "cpu", t_start=time.perf_counter(), spec=SPEC, config=config,
                      mix=mix)
    assert one["correct"] and one["device"]["count"] == 1 and one["checks"] == r["checks"]


@pytest.mark.parametrize("fault, code", [("raises", 4), ("stalls", 5)])
def test_a_rank_that_fails_ends_the_run_and_every_rank(tmp_path, fault, code):
    rc, out, err, took = _launch(tmp_path, seconds=4.0, fault=fault, bounds={"window": 3.0})
    assert rc == code and not out.strip(), (rc, out, err[-4000:])
    assert took < LIMIT_S / 2, took
    if fault == "raises":
        assert "rank 1 exited with code 1 in phase window" in err and "a fault planted on rank 1" in err
    else:
        assert "stayed in phase window" in err
    pids = _rank_processes(err)
    assert len(pids) == 2 and all(_gone(p) for p in pids)


@pytest.mark.parametrize("name, found", [(None, "sut"), ("sharded", "sharded"), ("no_such_system", None)])
def test_a_configuration_names_its_system(name, found):
    config = {} if name is None else {"system": name}
    if found is None:
        with pytest.raises(FileNotFoundError, match="no_such_system"):
            specmod.system(config)
        return
    cls = specmod.system(config)
    if found == "sut":
        assert cls is sut.System
    else:
        assert cls.__module__ == "perfbench.systems.sharded" and issubclass(cls, sut.System)


def test_the_launcher_imports_no_torch():
    # The launching process starts its ranks without paying for an import
    # that each rank makes again.
    code = "import sys; import perfbench.run, perfbench.launcher; print(' '.join(sorted(sys.modules)))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=LIMIT_S)
    assert out.returncode == 0 and "torch" not in out.stdout.split(), out.stderr
