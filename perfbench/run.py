"""Run one cell of ``BENCHMARK.json`` on this machine's card.

    python3 -m perfbench.run --workload g500-s24.rescale --seed 7 --seconds 30 --trace 0

from the root of a checkout. Prints the cell's metrics as one JSON object on
the last line of standard output, and each number the check compared,
beside its limit, as the last lines of standard error. Exits 2, printing no
result, where no CUDA device is found or fewer than the cell asks for, and
3 where a module of JAX or of the JAX package was loaded in this process.
"""
from __future__ import annotations

import time

_T_TOP = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FOREIGN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def process_age() -> float:
    """Seconds since this process started, from ``/proc`` (to 10 ms)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_T_START = _T_TOP - process_age()


def foreign_modules(names) -> list:
    """The loaded modules whose top-level name is one of ``FOREIGN``, whole:
    ``repro_torch`` is not ``repro``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FOREIGN)


def cache_dirs(root: pathlib.Path) -> None:
    """Fixed build and kernel cache directories inside the checkout."""
    base = root / "build" / "perfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_dirs(ROOT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness, spec as specmod

    spec = specmod.Spec(ROOT / "BENCHMARK.json")
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s), found {found}", file=sys.stderr)
        return 2

    def log(line: str) -> None:
        print(f"perfbench: {line}", file=sys.stderr, flush=True)

    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start=_T_START,
                         spec=spec, log=log)
    foreign = foreign_modules(sys.modules)
    if foreign:
        print(f"perfbench: modules of JAX or of the JAX package were loaded: {foreign}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
