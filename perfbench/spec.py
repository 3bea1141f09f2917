"""``BENCHMARK.json`` and the files it names, found by name.

A later change adds a configuration, a mix, a metric, a generator or a
system under test as new files and entries; nothing here names one of them.
``sut.py`` and the modules of ``systems/`` are the only modules of the
benchmark that import the port: ``system`` loads one of them when a run
asks for it, never at import.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


class Spec:
    """The benchmark's description, read from ``BENCHMARK.json``."""

    def __init__(self, path: pathlib.Path = ROOT / "BENCHMARK.json"):
        self.path = pathlib.Path(path)
        self.doc = json.loads(self.path.read_text())
        self.cells = {w["name"]: w for w in self.doc["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in {self.path.name}; have {sorted(self.cells)}")
        return self.cells[name]

    def config(self, name: str) -> dict:
        entry = next(c for c in self.doc["configs"] if c["name"] == name)
        return json.loads((ROOT / entry["file"]).read_text())

    def metrics_of(self, cell: str, trace: bool) -> list:
        """The cell's metrics: its end-to-end ones, or with ``trace`` its
        per-layer ones; a metric with ``workloads`` only in those cells."""
        group = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


def mix(name: str) -> dict:
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


def load_module(folder: str, name: str):
    """``perfbench/<folder>/<name>.py`` as a module (the name may hold dots)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system(config: dict):
    """The class of the system under test that ``config`` names with
    ``"system": "<name>"``: ``systems/<name>.py``'s ``System``; without the
    key, ``sut.System``, the port on one card."""
    name = config.get("system")
    if name is None:
        from . import sut

        return sut.System
    return load_module("systems", name).System


def reader(metric: str):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    return load_module("metrics", metric).read
