"""``BENCHMARK.json`` against the benchmark's contract, discovery by name, and
the rule that a run loads nothing of JAX or of the JAX package."""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from perfbench import run as entry
from perfbench import spec as specmod

ROOT = pathlib.Path(__file__).resolve().parents[1]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in DOC["workloads"]]
METRICS = DOC["end_to_end"] + DOC["per_layer"]


def test_top_level_keys_command_and_paths():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["perfbench"] and len(DOC["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in DOC["command"])
    assert 1 <= DOC["run_seconds"] <= 51 and isinstance(DOC["run_seconds"], int)


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = [w["name"] for w in DOC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4), four


def test_a_full_check_with_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    names = [c["name"] for c in DOC["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m["name"]
    for entry_ in DOC["configs"] + DOC["workloads"]:
        assert 1 <= len(entry_["why"]) <= 200 and "\n" not in entry_["why"] and "\t" not in entry_["why"]
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["source"]) <= 200
        assert c["file"].startswith("perfbench/") and len(c["reduced"]) <= 16


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert set(e2e) == {"rescale_ms_p50", "rescale_ms_p95", "query_ms_p50", "query_ms_p95", "setup_s"}
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]


def test_per_layer_metrics_name_a_layer_and_a_metric_they_move():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and cell in e2e[m["moves"]].get("workloads", CELLS), (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    spec = specmod.Spec(ROOT / "BENCHMARK.json")
    e2e = [m["name"] for m in spec.metrics_of(cell, trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2 and spec.metrics_of(cell, trace=True)
    w = spec.cell(cell)
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    if w["chips"] > 1:  # sut.System is the port on one card: a cell over ranks names its system
        assert "system" in spec.config(w["config"]), cell


@pytest.mark.parametrize("cell", CELLS)
def test_discovery_by_name_finds_every_file_of_a_cell(cell):
    spec = specmod.Spec(ROOT / "BENCHMARK.json")
    w = spec.cell(cell)
    config, mix = spec.config(w["config"]), specmod.mix(w["traffic"])
    assert config["name"] == w["config"] and config["reduced"] == next(
        c["reduced"] for c in DOC["configs"] if c["name"] == w["config"])
    assert hasattr(specmod.load_module("drivers", mix["driver"]), "Player")
    assert hasattr(specmod.load_module("generators", config["generator"]["module"]), "generate")
    assert callable(specmod.system(config))
    for m in spec.metrics_of(cell, False) + spec.metrics_of(cell, True):
        assert callable(specmod.reader(m["name"]))


def test_foreign_modules_compare_top_level_names_whole():
    names = ["repro_torch", "repro_torch.graphs.engine", "reprox", "jaxtyping", "numpy"]
    assert entry.foreign_modules(names) == []
    assert entry.foreign_modules(names + ["repro", "repro.core.cep", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core.cep"]


def _imports_in_fresh_process(modules):
    code = (f"import sys, importlib\nfor m in {modules!r}: importlib.import_module(m)\n"
            "print(' '.join(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_a_run_loads_no_jax_and_the_yardstick_none_of_the_program():
    run_mods = _imports_in_fresh_process(["perfbench.run", "perfbench.harness", "perfbench.sut",
                                          "perfbench.control", "perfbench.sweep", "perfbench.ranks",
                                          "perfbench.launcher"])
    assert entry.foreign_modules(run_mods) == []
    assert "repro_torch.graphs.engine" in run_mods
    yardstick = _imports_in_fresh_process(["perfbench.reference", "perfbench.judge", "perfbench.cep",
                                           "perfbench.peaks", "perfbench.devtrace", "perfbench.stats"])
    assert not [m for m in yardstick if m.split(".")[0] in ("repro_torch", "repro", "jax", "jaxlib")]


def test_no_benchmark_file_reads_the_old_benchmarks():
    for path in ROOT.joinpath("perfbench").rglob("*.py"):
        if not path.name.startswith("test_"):
            text = path.read_text()
            assert "BENCH_" not in text and "benchmarks" not in text, path


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "{" not in out.stdout and "CUDA" in out.stderr
