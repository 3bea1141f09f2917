"""Starts the ranks of a run over several devices and watches them.

The contract the ranks keep is ``ranks.py``'s. The launcher bounds each
phase of each rank on its own (``BOUNDS``): a rank stalled in host code
enters no collective, and one collective timeout cannot be both the
set-up's, which in a fresh checkout builds the kernels, and the window's.
It ends a failed or stalled run by killing each rank's session, so what a
rank started goes too, and prints rank 0's checks and result line after
every rank has ended, so they stay the last lines of the run. It imports no
``torch``: each rank imports it and checks its own device.
"""
from __future__ import annotations

import collections
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
PHASE = "perfbench-phase "  # a rank's line on standard error that opens a phase; the launcher consumes it
# Seconds a rank may spend in a phase: starting and joining the process group,
# set-up (the graph, the pack, the warm-up and, in a fresh checkout, the
# kernels' builds), the window past its length (`timeline.GRACE_S`, 60 s,
# for items due in it, and one item more), and the check with the metrics.
BOUNDS = {"join": 180.0, "setup": 1000.0, "window": 150.0, "check": 300.0}
TAIL_LINES = 40  # of a failed rank's standard error, printed again at the end
FAILED, STALLED = 4, 5  # exit codes of the launcher


class _Rank:
    """A launched rank: its process, the phase it reported last, and its
    standard error, drained line by line as it comes."""

    def __init__(self, rank: int, proc: subprocess.Popen, emit):
        self.rank, self.proc, self.emit = rank, proc, emit
        self.phase, self.since = "join", time.monotonic()
        self.ended_at = None  # when its standard error closed, about when it exited
        self.tail = collections.deque(maxlen=TAIL_LINES)
        self.checks, self.stdout = [], []
        self.threads = [threading.Thread(target=self._drain_err, daemon=True),
                        threading.Thread(target=self._drain_out, daemon=True)]
        for t in self.threads:
            t.start()

    def _drain_err(self) -> None:
        for line in iter(self.proc.stderr.readline, ""):
            line = line.rstrip("\n")
            if line.startswith(PHASE):
                self.phase, self.since = line[len(PHASE):], time.monotonic()
            elif self.rank == 0 and line.startswith("check "):
                self.checks.append(line)  # printed last, after every rank has ended
            else:
                self.tail.append(line)
                self.emit(f"[r{self.rank}] {line}")
        self.ended_at = time.monotonic()

    def _drain_out(self) -> None:
        for line in iter(self.proc.stdout.readline, ""):
            self.stdout.append(line.rstrip("\n"))


def _kill(procs) -> None:
    """Kill every rank with whatever it started (its session), and reap it."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def launch(workload: str, seed: int, seconds: float, trace: bool, *, devices: list, t_start: float,
           child: list | None = None) -> int:
    """Run one cell over ``len(devices)`` ranks, rank r on ``devices[r]``,
    and print rank 0's checks and result line. Returns 0, or ``FAILED``
    where a rank failed, ``STALLED`` where one outstayed its phase, or a
    rank's own exit code 2 or 3 (no device, a foreign module).

    ``child`` is the command of a rank before its options (the default
    ``python3 -m perfbench.run``)."""
    bounds = dict(BOUNDS)
    bounds["window"] += float(seconds)
    lock = threading.Lock()

    def emit(line: str) -> None:
        with lock:
            print(line, file=sys.stderr, flush=True)

    rendezvous = tempfile.mkdtemp(prefix="perfbench_ranks_")
    procs, ranks = [], []
    try:
        options = ["--workload", workload, "--seed", str(seed), "--seconds", repr(float(seconds)),
                   "--trace", str(int(trace)), "--world", str(len(devices)),
                   "--init", f"file://{os.path.join(rendezvous, 'store')}", "--t-start", repr(float(t_start))]
        for r, device in enumerate(devices):
            argv = list(child or [sys.executable, "-m", "perfbench.run"]) + options + [
                "--rank", str(r), "--device", str(device)]
            procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                          cwd=ROOT, start_new_session=True))
        for r, p in enumerate(procs):
            emit(f"perfbench: rank {r} is process {p.pid} on {devices[r]}")
            ranks.append(_Rank(r, p, emit))

        failure = None
        while failure is None:
            codes = [p.poll() for p in procs]
            bad = [x for x, c in zip(ranks, codes) if c not in (None, 0)]
            if bad:
                first = min(bad, key=lambda x: (x.ended_at or float("inf"), x.rank))
                failure = (first, f"exited with code {first.proc.returncode} in phase {first.phase}",
                           first.proc.returncode if first.proc.returncode in (2, 3) else FAILED)
            elif all(c == 0 for c in codes):
                break
            else:
                now = time.monotonic()
                for x, c in zip(ranks, codes):
                    bound = bounds.get(x.phase, bounds["check"])
                    if c is None and now - x.since > bound:
                        failure = (x, f"stayed in phase {x.phase} for more than {bound:.0f} s", STALLED)
                        break
                time.sleep(0.05)
    finally:
        _kill(procs)
        for x in ranks:
            for t in x.threads:
                t.join(30.0)
        shutil.rmtree(rendezvous, ignore_errors=True)

    if failure is None and not ranks[0].stdout:
        failure = (ranks[0], "ended without a result line", FAILED)
    if failure is not None:
        rank, why, code = failure
        emit(f"perfbench: rank {rank.rank} {why}; the run is ended, every rank killed and reaped. "
             f"Its last lines:")
        for line in rank.tail:
            emit(f"[r{rank.rank}] {line}")
        return code
    for line in ranks[0].checks:
        emit(line)
    print(ranks[0].stdout[-1], flush=True)
    return 0
