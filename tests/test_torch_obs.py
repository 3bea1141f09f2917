"""The port's peak-RSS reader (``obs/metrics.py``): a process's own peak, in a
launched rank too.

The reference reads ``ru_maxrss``, which Linux carries across ``fork`` and
``exec``: a rank started by a launcher with a larger peak reports the
launcher's. The port reads ``VmHWM`` of ``/proc/self/status`` (the peak of
this process's own address space), or a running maximum of ``VmRSS`` where
the kernel reports no ``VmHWM``, and ``ru_maxrss`` only without ``/proc``.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.obs import metrics as OM

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
CHILD = "from repro_torch.obs import metrics as OM; f, mb = OM.read_peak_rss(); print(f, mb, OM.peak_rss_mb())"


def test_a_launched_process_reads_its_own_peak_not_its_launchers():
    big = np.ones(100_000_000, dtype=np.float32)  # 400 MB, every page written
    big[::4096] += 1.0
    _, parent_peak = OM.read_peak_rss()
    del big
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", CHILD], env=env, capture_output=True, text=True, check=True)
    field, child_peak, again = out.stdout.split()
    assert parent_peak > 400
    assert field in ("VmHWM", "VmRSS") and float(again) >= float(child_peak)
    # Well under the launcher's peak: the child never held the 400 MB.
    assert float(child_peak) < parent_peak - 350, (parent_peak, child_peak)


def test_without_vmhwm_the_running_vmrss_maximum(monkeypatch):
    monkeypatch.setattr(OM, "_vmrss_peak", (0, 0.0))

    def status(kb: int) -> str:
        return f"Name:\tpython\nVmPeak:\t99999 kB\nVmRSS:\t{kb} kB\nThreads:\t1\n"

    assert OM.read_peak_rss(status(2048)) == ("VmRSS", 2.0)
    assert OM.read_peak_rss(status(1024)) == ("VmRSS", 2.0)  # the largest read so far
    assert OM.read_peak_rss(status(4096)) == ("VmRSS", 4.0)
    monkeypatch.setattr(OM, "_vmrss_peak", (os.getpid() + 1, 99.0))  # another process's maximum
    assert OM.read_peak_rss(status(1024)) == ("VmRSS", 1.0)
    assert OM.read_peak_rss("VmHWM:\t5120 kB\nVmRSS:\t1024 kB\n") == ("VmHWM", 5.0)


def test_without_proc_status_ru_maxrss(monkeypatch, tmp_path):
    monkeypatch.setattr(OM, "_STATUS", str(tmp_path / "no-such-file"))
    field, mb = OM.read_peak_rss()
    assert field == "ru_maxrss" and mb > 0


@pytest.mark.parametrize("index,count", [(0, 1), (1, 3)])
def test_record_peak_rss_publishes_the_reader(index, count):
    reg = OM.MetricsRegistry()
    mb = OM.record_peak_rss(reg, process_index=index, process_count=count)
    snap = reg.snapshot()
    assert snap[f"process.peak_rss_mb.p{index}"] == pytest.approx(mb) and mb > 0
    assert OM.peak_rss_mb() >= mb
    assert all(snap[f"process.peak_rss_mb.p{i}"] == 0.0 for i in range(count) if i != index)
