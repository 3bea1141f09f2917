"""A cell over several devices: one process a rank, rank r on its own device.

``run.py`` calls ``launcher.launch`` for a cell whose ``chips`` is above 1:
rank r on ``cuda:r``, NCCL between the cards (the CPU tests use gloo between
CPU processes). Each rank is ``python3 -m perfbench.run`` with the rank's own
options, and the ranks meet through a file in a fresh temporary directory.
Each runs ``harness.run`` with its ``World``. The contract:

* Every rank makes the configuration's graph from its ``instance_seed``, and
  one collective over a checksum holds its ordered edge list equal to rank
  0's before the pack.
* Every rank plays the mix's schedule in the same order. An item ends in one
  collective that each rank enters after its own synchronize
  (``World.settle``); it also hands every rank rank 0's decision whether the
  window goes on, so rank 0's clock alone shapes the window. An item is
  timed on rank 0's host clock to the end of that collective, when every
  rank has its result.
* ``setup_s`` runs from the start of the launched process to the window's
  first item: starting the ranks and setting up NCCL count.
* Only rank 0 prints a result line. ``device.count`` is the number of ranks
  and ``memory_peak_bytes`` the largest peak over them. Rank 0 judges packs
  gathered whole from every rank, against the same reference.
* In a traced run every rank runs under the profiler. ``traces`` holds
  every rank's device work: the kernels' rooflines pool every rank's bytes
  and kernel time from it, and the other metrics read rank 0's trace as on
  one card.
* Rank 0 alone keeps the host copy of the ordered list past the pack, for
  the check.
* The check for modules of JAX or of the JAX package runs in every rank.

A rank that raises or exits ends the run, and so does one that stays in a
phase longer than ``launcher.BOUNDS`` allows: every process is killed and
reaped, and ``launch`` prints that rank's error and no result line, and
returns non-zero.
"""
from __future__ import annotations

import dataclasses
import datetime
import signal
import sys

import torch
import torch.distributed as dist

from perfbench.launcher import PHASE

COLLECTIVE_TIMEOUT_S = 1200.0  # longer than any phase: the launcher's bounds end a stalled run first


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the run's ranks. The default is a run of
    one process, where every collective is the identity."""

    size: int = 1
    rank: int = 0
    backend: str | None = None  # None: no process group
    device: torch.device | None = None

    @property
    def ranked(self) -> bool:
        return self.backend is not None

    @property
    def _wire(self) -> torch.device:
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def phase(self, name: str) -> None:
        """Tell the launcher that this rank entered phase ``name``."""
        if self.ranked:
            print(PHASE + name, file=sys.stderr, flush=True)

    def _all_reduce(self, values, op) -> list:
        t = torch.tensor(values, dtype=torch.int64, device=self._wire)
        dist.all_reduce(t, op=op)
        return t.tolist()

    def barrier(self) -> None:
        if self.ranked:
            self._all_reduce([0], dist.ReduceOp.SUM)

    def settle(self, flag: bool) -> bool:
        """The collective that ends an item: returns rank 0's ``flag`` on
        every rank, once every rank has entered it."""
        if not self.ranked:
            return flag
        return bool(self._all_reduce([int(flag) if self.rank == 0 else 0], dist.ReduceOp.MAX)[0])

    def max_int(self, value: int) -> int:
        return int(self._all_reduce([int(value)], dist.ReduceOp.MAX)[0]) if self.ranked else int(value)

    def sum_int(self, value: int) -> int:
        return int(self._all_reduce([int(value)], dist.ReduceOp.SUM)[0]) if self.ranked else int(value)

    def gather(self, obj) -> list | None:
        """Every rank's ``obj`` on rank 0, in rank order; ``None`` elsewhere."""
        if not self.ranked:
            return [obj]
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0)
        return out

    def same_graph(self, src: torch.Tensor, dst: torch.Tensor, num_vertices: int) -> None:
        """Raise on every rank unless every rank holds rank 0's ordered edge
        list: its length, its label space and two position-weighted sums of
        its endpoints (int64, wrapping), in one collective."""
        if not self.ranked:
            return
        sums = [0, 0]
        block = 1 << 26
        for lo in range(0, src.numel(), block):
            s, d = src[lo:lo + block].long(), dst[lo:lo + block].long()
            at = torch.arange(lo, lo + s.numel(), dtype=torch.int64, device=s.device) * 2 + 1
            sums[0] += int(((s * 1_000_003 + d) * at).sum())
            sums[1] += int(((d * 998_244_353 + s) * (at * at)).sum())
        mine = torch.tensor([src.numel(), int(num_vertices)] + [x % 2**63 for x in sums], dtype=torch.int64)
        parts = [torch.empty_like(mine, device=self._wire) for _ in range(self.size)]
        dist.all_gather(parts, mine.to(self._wire))
        differ = [r for r, p in enumerate(parts) if not torch.equal(p.cpu(), parts[0].cpu())]
        if differ:
            raise RuntimeError(f"the ordered edge lists of ranks {differ} differ from rank 0's: "
                               f"{[p.tolist() for p in parts]} (edges, ids, two checksums)")

    def close(self) -> None:
        if self.ranked:
            dist.destroy_process_group()


def join(rank: int, size: int, init: str, device: str) -> World:
    """Join the run's process group as ``rank`` on ``device`` and set up its
    communicator with a first collective: NCCL between cards, gloo between
    CPU processes."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    world = World(size=size, rank=rank, backend=backend, device=dev)
    world.barrier()
    world.phase("setup")
    return world


def die_with_parent() -> None:
    """Have the kernel kill this rank when the launcher's process ends, so
    no rank outlives a launcher that was killed itself."""
    try:
        import ctypes

        ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
