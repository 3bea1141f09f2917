"""Run one cell of ``BENCHMARK.json`` on this machine's cards.

    python3 -m perfbench.run --workload g500-s24.rescale --seed 7 --seconds 30 --trace 0

from the root of a checkout. Prints the cell's metrics as one JSON object on
the last line of standard output, and each number the check compared,
beside its limit, as the last lines of standard error.

A cell on one chip runs in this process. A cell whose ``chips`` is above 1
runs one process a rank, rank r on ``cuda:r``, over NCCL (``ranks.py``):
this process starts them without importing ``torch`` (``launcher.py``),
forwards their standard error line by line, tagged ``[r<rank>]``, and prints
rank 0's checks and result line once every rank has ended well. Each rank
checks its device. ``--rank`` and the options after it in the help are a
rank's own and are not given by hand.

Exit codes, with no result printed: 2 where no CUDA device is found or
fewer than the cell asks for; 3 where a module of JAX or of the JAX package
was loaded in this process, or in any rank; 4 where a rank raised, exited
without a result or was killed; 5 where a rank stayed in one phase (joining,
set-up, the window, the check) past its bound in ``launcher.BOUNDS``. In the
last two cases every rank is killed and reaped first, and that rank's last
lines close standard error.
"""
from __future__ import annotations

import time

_T_TOP = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import signal  # noqa: E402
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


def log(line: str) -> None:
    print(f"perfbench: {line}", file=sys.stderr, flush=True)


def finish(result) -> int:
    """After the run, in every process that ran a rank (or the one-card run):
    the check for foreign modules, then, where there is a result, its checks
    on standard error and the result line."""
    foreign = foreign_modules(sys.modules)
    if foreign:
        print(f"perfbench: modules of JAX or of the JAX package were loaded: {foreign}", file=sys.stderr)
        return 3
    if result is not None:
        for name, c in result["checks"].items():
            print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return 0


def cards_missing(needed: int) -> bool:
    """Whether this machine has fewer than ``needed`` CUDA devices, said on
    standard error."""
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < needed:
        print(f"perfbench: the cell needs {needed} CUDA device(s), found {found}", file=sys.stderr)
    return found < needed


def rank_main(args) -> int:
    """One rank of a run over several devices, as ``launcher.launch`` starts it."""
    from perfbench import ranks

    ranks.die_with_parent()
    if args.device.startswith("cuda") and cards_missing(args.world):
        return 2
    from perfbench import harness

    world = ranks.join(args.rank, args.world, args.init, args.device)
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), args.device,
                         t_start=args.t_start, world=world, log=log if world.rank == 0 else None)
    world.close()
    return finish(result)


def _ended_by_signal(signum, frame):
    raise SystemExit(128 + signum)  # unwinds through the launcher, which kills and reaps the ranks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, help="this process's rank in a run over several devices")
    ap.add_argument("--world", type=int, help="the number of ranks")
    ap.add_argument("--init", help="the process group's rendezvous (file://...)")
    ap.add_argument("--device", help="this rank's device")
    ap.add_argument("--t-start", type=float, help="the launching process's start, on the monotonic clock")
    args = ap.parse_args(argv)

    cache_dirs(ROOT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if args.rank is not None:
        return rank_main(args)
    from perfbench import spec as specmod

    spec = specmod.Spec(ROOT / "BENCHMARK.json")
    chips = int(spec.cell(args.workload)["chips"])
    if chips > 1:
        from perfbench import launcher

        signal.signal(signal.SIGTERM, _ended_by_signal)
        return launcher.launch(args.workload, args.seed, args.seconds, bool(args.trace),
                               devices=[f"cuda:{r}" for r in range(chips)], t_start=_T_START)
    if cards_missing(chips):
        return 2
    from perfbench import harness

    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start=_T_START,
                         spec=spec, log=log)
    return finish(result)


if __name__ == "__main__":
    sys.exit(main())
