"""The ``graph`` axis over torch.distributed: process groups, row blocks,
collectives, rank-to-rank transport and localhost test clusters.

Each rank is one OS process that holds the contiguous row block
``[r·m, (r+1)·m)`` of every ``(k_pad, …)`` graph buffer on its own device
(``launch/sharding.py``), while vertex state is replicated. This module owns
everything that becomes rank-aware at that point:

* **Process bootstrap.** ``initialize_distributed`` / ``initialize_from_env``
  call ``init_process_group`` with an explicit backend, device and timeout,
  and return the ``GraphGroup`` (``launch/mesh.py``). Environment variables
  (``REPRO_MH_*``) carry the cluster spec, so a worker script needs no
  argument plumbing. Rank ``process_id · devs_per_proc + local_rank`` belongs
  to process (host) ``process_id``.
* **Row blocks.** ``put_global`` moves a rank's block of a host array that
  every rank holds to its device; ``put_global_local`` moves a block the rank
  built alone. A world of one is the degenerate case of the same calls.
* **Collectives and transport.** ``all_reduce``, ``all_gather_rows`` and
  ``exchange`` (point-to-point) pick their buffers by ``group.backend``:
  NCCL works on the rank's card; gloo works on host tensors, so every byte is
  staged through host memory explicitly, as gloo's point-to-point requires.
  Nothing catches an error to switch between them. ``psum_host`` and
  ``host_read`` are the host-facing forms.
* **Localhost clusters.** ``launch_local_cluster`` starts one process per
  rank, rendezvousing through a file in a fresh temporary directory (no port
  to race for when several clusters start at once), and captures each
  process's output line by line.

What crosses the NIC: partition p lives on rank p % g, and ranks map to
processes by ``GraphGroup.processes``, so exactly the ScalePlan move ranges
whose two ranks belong to different processes are network traffic
(``RescaleStats.cross_process_*``). On one card, NCCL refuses two ranks of
one communicator, so a group of several ranks on one card uses gloo.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..obs import trace as OT
from .mesh import GraphGroup

__all__ = [
    "ClusterSpec",
    "DEFAULT_TIMEOUT_S",
    "LeaseBoard",
    "LocalCluster",
    "LocalClusterResult",
    "ProcResult",
    "initialize_distributed",
    "initialize_from_env",
    "free_port",
    "put_global",
    "put_global_local",
    "addressable_row_block",
    "all_reduce",
    "all_gather_rows",
    "exchange",
    "psum_host",
    "host_read",
    "local_shard_rows",
    "launch_local_cluster",
    "spawn_local_cluster",
]

# Environment contract between launch_local_cluster and worker processes.
ENV_COORD = "REPRO_MH_COORDINATOR"
ENV_NPROCS = "REPRO_MH_NUM_PROCESSES"
ENV_PID = "REPRO_MH_PROCESS_ID"
ENV_DEVS = "REPRO_MH_DEVS_PER_PROC"
ENV_LOCAL = "REPRO_MH_LOCAL_RANK"
ENV_BACKEND = "REPRO_MH_BACKEND"
ENV_DEVICE = "REPRO_MH_DEVICE"  # the rank's device, e.g. "cuda:0" or "cpu"

DEFAULT_TIMEOUT_S = 300.0  # of every collective; a stranded rank fails instead of waiting forever


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    coordinator: str  # "host:port" of rank 0's TCP store, or a "file://" rendezvous
    num_processes: int
    process_id: int
    devs_per_proc: int = 1  # ranks per process (host)
    local_rank: int = 0
    backend: str = "gloo"
    device: str = "cpu"

    @property
    def world_size(self) -> int:
        return self.num_processes * self.devs_per_proc

    @property
    def rank(self) -> int:
        return self.process_id * self.devs_per_proc + self.local_rank


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port for a ``host:port`` coordinator (the
    usual bind(0) race applies; local clusters rendezvous through a file)."""
    s = socket.socket()
    try:
        s.bind((host, 0))
        return int(s.getsockname()[1])
    finally:
        s.close()


def initialize_distributed(
    coordinator: str,
    num_processes: int,
    process_id: int,
    *,
    devs_per_proc: int = 1,
    local_rank: int = 0,
    backend: str,
    device,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> GraphGroup:
    """Join this process to the group as rank ``process_id · devs_per_proc +
    local_rank`` and return its ``GraphGroup``. ``backend`` and ``device`` are
    the caller's choice: NCCL needs a CUDA device of its own for each rank;
    gloo takes any device and stages through host memory."""
    spec = ClusterSpec(coordinator, num_processes, process_id, devs_per_proc, local_rank, backend, str(device))
    dev = torch.device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=init, world_size=spec.world_size, rank=spec.rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return GraphGroup(
        size=spec.world_size, rank=spec.rank, device=dev, backend=backend,
        processes=tuple(r // devs_per_proc for r in range(spec.world_size)),
    )


def initialize_from_env(environ=None, *, timeout_s: float = DEFAULT_TIMEOUT_S) -> GraphGroup | None:
    """Initialize from the ``REPRO_MH_*`` variables ``launch_local_cluster``
    sets; returns the group, or None outside a launched cluster."""
    env = os.environ if environ is None else environ
    if ENV_COORD not in env:
        return None
    return initialize_distributed(
        env[ENV_COORD], int(env[ENV_NPROCS]), int(env[ENV_PID]),
        devs_per_proc=int(env.get(ENV_DEVS, 1)), local_rank=int(env.get(ENV_LOCAL, 0)),
        backend=env[ENV_BACKEND], device=env[ENV_DEVICE], timeout_s=timeout_s,
    )


# ---------------------------------------------------------------- liveness
class LeaseBoard:
    """File-based liveness leases for a process group (DESIGN.md §15).

    Worker process ``i`` stamps ``lease_p{i}.json`` with its batch step and
    the lease clock after every unit of progress; anyone holding the shared
    directory (the drill parent, a sibling process) classifies the group
    without any collective — which is the point: a process that died inside
    a gloo collective strands its peers, so detection must not itself ride
    on the collective plane. Stamps are written via tmp+rename, so a reader
    never sees a torn lease; a SIGKILL mid-stamp leaves the previous stamp.

    The clock follows the runtime's injected-clock convention
    (``ElasticController(clock=...)``): default ``time.monotonic``, which is
    CLOCK_MONOTONIC on Linux — one system-wide timeline every local process
    shares, so cross-process lease ages are directly comparable. Tests
    inject a fake clock and drive expiry deterministically.

    A process that never stamped is aged from the board's construction time
    (a worker that died before its first stamp must still expire).
    """

    def __init__(self, directory, *, lease_s: float = 2.0, clock=time.monotonic):
        self.dir = os.fspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.lease_s = float(lease_s)
        self.clock = clock
        self._t0 = clock()

    def _path(self, process_id: int) -> str:
        return os.path.join(self.dir, f"lease_p{int(process_id)}.json")

    def stamp(self, process_id: int, step: int) -> None:
        """Renew process ``process_id``'s lease at progress ``step``."""
        path = self._path(process_id)
        tmp = f"{path}.tmp{int(process_id)}"
        with open(tmp, "w") as f:
            f.write(json.dumps({"step": int(step), "t": float(self.clock())}))
        os.replace(tmp, path)  # atomic: readers see whole stamps or nothing

    def read(self, process_id: int) -> dict | None:
        """The last stamp of ``process_id`` — {"step", "t"} — or None."""
        try:
            with open(self._path(process_id)) as f:
                return json.loads(f.read())
        except (OSError, ValueError):
            return None

    def age(self, process_id: int, *, now: float | None = None) -> float:
        """Seconds since the last stamp (since board construction when the
        process never stamped)."""
        now = self.clock() if now is None else now
        stamp = self.read(process_id)
        return now - (self._t0 if stamp is None else stamp["t"])

    def step(self, process_id: int) -> int:
        """Last stamped progress step (-1 before the first stamp)."""
        stamp = self.read(process_id)
        return -1 if stamp is None else int(stamp["step"])

    def dead(self, num_processes: int, *, now: float | None = None) -> list[int]:
        """Process ids whose lease age exceeds ``lease_s`` — the failure
        detector's verdict at ``now``. A frozen stamp (the victim's last
        write before SIGKILL) ages past the lease like silence does."""
        now = self.clock() if now is None else now
        return [
            pid for pid in range(int(num_processes))
            if self.age(pid, now=now) > self.lease_s
        ]

    def survivors(self, num_processes: int, *, now: float | None = None) -> list[int]:
        gone = set(self.dead(num_processes, now=now))
        return [pid for pid in range(int(num_processes)) if pid not in gone]

    def surviving_devices(
        self, num_processes: int, devs_per_proc: int, *, now: float | None = None
    ) -> list[int]:
        """Global rank indices still backed by a live process. Ranks are
        process-major (process i owns [i·d, (i+1)·d)), so the surviving list
        is exactly what a recovery group re-plans k over."""
        d = int(devs_per_proc)
        return [
            dev
            for pid in self.survivors(num_processes, now=now)
            for dev in range(pid * d, (pid + 1) * d)
        ]

    def wait_for_step(
        self, process_id: int, step: int, *, timeout: float = 60.0, poll_s: float = 0.01
    ) -> int:
        """Block (real time) until ``process_id``'s lease reaches ``step``.
        The drill parent uses this to align its SIGKILL with a chosen batch
        index. Returns the observed step; raises TimeoutError."""
        deadline = time.monotonic() + timeout
        while True:
            s = self.step(process_id)
            if s >= int(step):
                return s
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"process {process_id} never reached step {step} "
                    f"(last stamped {s}) within {timeout}s"
                )
            time.sleep(poll_s)


# ------------------------------------------------------- collectives, transport
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def _wire(group: GraphGroup) -> torch.device:
    """Where a collective's buffers live: the rank's card for NCCL, host
    memory for gloo (staged explicitly, never left to the backend)."""
    return group.torch_device if group.backend == "nccl" else torch.device("cpu")


def all_reduce(t: torch.Tensor, group: GraphGroup, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum", "min" or "max") of ``t`` over every rank of ``group``
    (the world, or a grid's line), as a new tensor on ``t``'s device; ``t``
    itself is untouched. A world of one returns ``t``."""
    if not group.distributed:
        return t
    buf = t.to(_wire(group), copy=True)
    with OT.span("transfer.all_reduce"):
        dist.all_reduce(buf, op=_REDUCE_OPS[op], group=group.process_group)
    return buf.to(t.device)


def all_gather_rows(t: torch.Tensor, group: GraphGroup) -> torch.Tensor:
    """Every rank's equal-shaped block of ``t``, concatenated in rank order
    along the leading axis, on ``t``'s device. A world of one returns ``t``."""
    if not group.distributed:
        return t
    buf = t.to(_wire(group)).contiguous()
    parts = [torch.empty_like(buf) for _ in range(group.size)]
    with OT.span("transfer.all_gather"):
        dist.all_gather(parts, buf, group=group.process_group)
    return torch.cat(parts).to(t.device)


def exchange(group: GraphGroup, sends: list, recvs: list) -> tuple[int, int]:
    """Point-to-point transfers between ranks: ``sends`` are
    ``(peer, tensor, tag)``, ``recvs`` are ``(peer, out, tag)`` with ``out`` a
    contiguous tensor (a view is written in place). Every rank lists its
    transfers in one agreed order, so the k-th send from a to b meets the
    k-th receive at b from a. Returns this rank's (bytes sent, bytes received).

    NCCL sends and receives on the rank's card in one batch; gloo takes host
    tensors, so the sends are copied to host memory and the receives land in
    host buffers that are then copied into ``out``. The caller makes sure some
    collective ran on the group before the first call (NCCL sets up its
    communicator in one)."""
    if any(not out.is_contiguous() for _, out, _ in recvs):
        raise ValueError("exchange receives into contiguous tensors only")
    sent = sum(t.numel() * t.element_size() for _, t, _ in sends)
    received = sum(out.numel() * out.element_size() for _, out, _ in recvs)
    if not sends and not recvs:
        return 0, 0
    wire = _wire(group)
    landing = [out if out.device == wire else torch.empty(out.shape, dtype=out.dtype, device=wire)
               for _, out, _ in recvs]
    ops = [dist.P2POp(dist.isend, t.to(wire).contiguous(), peer, tag=tag) for peer, t, tag in sends]
    ops += [dist.P2POp(dist.irecv, buf, peer, tag=tag) for (peer, _, tag), buf in zip(recvs, landing)]
    with OT.span("transfer.exchange"):
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for (_, out, _), buf in zip(recvs, landing):
            if buf is not out:
                out.copy_(buf)
    return sent, received


# ------------------------------------------------------------- row blocks
def addressable_row_block(global_shape, group: GraphGroup) -> tuple[int, int]:
    """[lo, hi) leading-axis rows this rank holds of a ``global_shape`` buffer."""
    return group.row_block(int(global_shape[0]))


def put_global(host_arr, group: GraphGroup) -> torch.Tensor:
    """This rank's row block of a host array that every rank holds, copied
    to the rank's device. With one rank the block is the whole array."""
    with OT.span("transfer.put_global"):
        host_arr = np.asarray(host_arr)
        lo, hi = addressable_row_block(host_arr.shape, group)
        return torch.from_numpy(np.ascontiguousarray(host_arr[lo:hi])).to(group.torch_device, copy=True)


def put_global_local(local_block, global_shape, group: GraphGroup) -> torch.Tensor:
    """This rank's block of a ``global_shape`` buffer from ONLY the rows it
    holds (``addressable_row_block`` says which), copied to its device: no
    rank stages the global buffer."""
    with OT.span("transfer.put_global"):
        local_block = np.asarray(local_block)
        lo, hi = addressable_row_block(global_shape, group)
        if local_block.shape[0] != hi - lo or local_block.shape[1:] != tuple(global_shape[1:]):
            raise ValueError(
                f"local block shape {local_block.shape} does not cover rows "
                f"[{lo}, {hi}) of global shape {tuple(global_shape)}"
            )
        return torch.from_numpy(np.ascontiguousarray(local_block)).to(group.torch_device, copy=True)


def psum_host(local, group: GraphGroup) -> np.ndarray:
    """Sum a host array over every rank (collective; one ``all_reduce``).
    A world of one returns a copy of the input."""
    with OT.span("transfer.psum_host"):
        local = np.asarray(local)
        if not group.distributed:
            return local.copy()
        return all_reduce(torch.from_numpy(np.array(local)), group, "sum").numpy()


def host_read(t: torch.Tensor, group: GraphGroup) -> np.ndarray:
    """The global buffer whose row blocks the ranks hold, on the host of every
    rank (collective: one ``all_gather`` of the equal-shaped blocks)."""
    with OT.span("transfer.host_read"):
        return all_gather_rows(t, group).cpu().numpy()


def local_shard_rows(t: torch.Tensor, group: GraphGroup) -> list[tuple[int, int, np.ndarray]]:
    """This rank's block ``t`` of a row-sharded buffer as ``[(row_lo, row_hi,
    data)]`` — what a worker persists so a parent can reassemble the global
    buffer without any collective."""
    m = int(t.shape[0])
    return [(group.rank * m, (group.rank + 1) * m, t.cpu().numpy())]


# --------------------------------------------------------- localhost clusters
@dataclasses.dataclass(frozen=True)
class ProcResult:
    process_id: int
    rank: int
    returncode: int
    stdout: str
    stderr: str


@dataclasses.dataclass(frozen=True)
class LocalClusterResult:
    spec_coordinator: str
    procs: tuple[ProcResult, ...]

    @property
    def ok(self) -> bool:
        return all(p.returncode == 0 for p in self.procs)

    def format_logs(self, tail: int = 4000) -> str:
        """Per-rank logs, for test/CI failure diagnosis."""
        out = []
        for p in self.procs:
            out.append(f"--- process {p.process_id} rank {p.rank} (rc={p.returncode}) ---")
            if p.stdout:
                out.append(f"[stdout]\n{p.stdout[-tail:]}")
            if p.stderr:
                out.append(f"[stderr]\n{p.stderr[-tail:]}")
        return "\n".join(out)


class LocalCluster:
    """A RUNNING localhost cluster: the handle ``launch_local_cluster``
    returns. ``spawn_local_cluster`` is the blocking wrapper (launch +
    ``wait``); a fault drill holds the handle instead, so it can SIGKILL a
    chosen rank mid-run (``kill``) and still collect every rank's partial
    log afterwards. Whatever happens — clean exits, a timeout, an injected
    kill, an exception in the caller — ``wait`` reaps every child (kill + OS
    ``wait()``) and removes the rendezvous directory."""

    def __init__(self, coord: str, procs: list, ranks: list, captured: dict, threads: list, rendezvous: str):
        self.coordinator = coord
        self._procs = procs
        self._ranks = ranks  # (process_id, rank) of each child
        self._captured = captured
        self._threads = threads
        self._rendezvous = rendezvous
        self._notes: dict[int, list] = {i: [] for i in range(len(procs))}

    @property
    def n_ranks(self) -> int:
        return len(self._procs)

    def poll(self, rank: int):
        """Exit code of rank ``rank``'s process, or None while it runs."""
        return self._procs[rank].poll()

    def kill(self, rank: int, *, reason: str = "fault injection") -> None:
        """SIGKILL rank ``rank``'s process and reap it immediately; its
        partial log stays captured and gets an attributable kill note."""
        p = self._procs[rank]
        if p.poll() is None:
            p.kill()
            p.wait()
        self._notes[rank].append(f"[r{rank}] [local_cluster] SIGKILL injected mid-run ({reason})\n")

    def wait(self, timeout: float = 600.0) -> LocalClusterResult:
        """Block until every rank exits (killing the whole group at the
        deadline), reap everything, and return all logs."""
        deadline = time.monotonic() + timeout
        timed_out = []
        try:
            for i, p in enumerate(self._procs):
                try:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    timed_out.append(i)
        finally:
            for q in self._procs:
                if q.poll() is None:
                    q.kill()
            for q in self._procs:
                try:
                    q.wait(timeout=30.0)  # REAP: a killed child must not linger
                except subprocess.TimeoutExpired:  # pragma: no cover — SIGKILL
                    pass  # cannot be refused; defensive only
            shutil.rmtree(self._rendezvous, ignore_errors=True)
        for t in self._threads:  # readers end at EOF once every child exited
            t.join(30.0)
        results = []
        for i, p in enumerate(self._procs):
            err = "".join(self._captured[(i, 1)]) + "".join(self._notes[i])
            if i in timed_out:
                err += f"\n[r{i}] [local_cluster] killed after {timeout}s timeout"
            rc = p.returncode if p.returncode is not None else -1
            pid, rank = self._ranks[i]
            results.append(ProcResult(pid, rank, rc, "".join(self._captured[(i, 0)]), err))
        return LocalClusterResult(self.coordinator, tuple(results))


def launch_local_cluster(
    n_procs: int,
    devs_per_proc: int,
    argv: list[str],
    *,
    backend: str,
    devices: list,
    env_extra: dict | None = None,
    cwd: str | None = None,
) -> LocalCluster:
    """Start ``python <argv>`` once per rank of an ``n_procs`` ×
    ``devs_per_proc`` localhost cluster and return the RUNNING handle (see
    ``LocalCluster``); the caller must ``wait()`` it. Rank r = process ·
    devs_per_proc + local rank runs on ``devices[r]`` over ``backend``; the
    worker calls ``initialize_from_env()``. Every captured log line is
    prefixed ``[p{process}r{rank}] `` as it is emitted."""
    if n_procs < 1 or devs_per_proc < 1:
        raise ValueError("n_procs and devs_per_proc must be >= 1")
    world = n_procs * devs_per_proc
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    rendezvous = tempfile.mkdtemp(prefix="repro_mh_")
    coord = f"file://{os.path.join(rendezvous, 'store')}"
    procs, ranks = [], []
    for pid in range(n_procs):
        for local in range(devs_per_proc):
            rank = pid * devs_per_proc + local
            env = dict(os.environ)
            env.update({
                ENV_COORD: coord, ENV_NPROCS: str(n_procs), ENV_PID: str(pid), ENV_DEVS: str(devs_per_proc),
                ENV_LOCAL: str(local), ENV_BACKEND: backend, ENV_DEVICE: str(devices[rank]),
            })
            if env_extra:
                env.update({k: str(v) for k, v in env_extra.items()})
            procs.append(subprocess.Popen(
                [sys.executable] + list(argv), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env, cwd=cwd,
            ))
            ranks.append((pid, rank))
    # Drain every child's pipes CONCURRENTLY and LINE-WISE: the ranks form one
    # collective group, so a single child blocked writing to a full pipe
    # would stall every other child at its next collective. Each line is
    # tagged with its rank as it is read, and a killed rank's partial log is
    # already captured the moment it dies.
    captured: dict[tuple, list] = {(i, s): [] for i in range(world) for s in (0, 1)}

    def drain(i: int, stream, which: int) -> None:
        pid, rank = ranks[i]
        prefix = f"[p{pid}r{rank}] "
        sink = captured[(i, which)]
        for line in iter(stream.readline, ""):
            sink.append(prefix + line)
        stream.close()

    threads = [
        threading.Thread(target=drain, args=(i, s, which), daemon=True)
        for i, p in enumerate(procs)
        for which, s in ((0, p.stdout), (1, p.stderr))
    ]
    for t in threads:
        t.start()
    return LocalCluster(coord, procs, ranks, captured, threads, rendezvous)


def spawn_local_cluster(
    n_procs: int,
    devs_per_proc: int,
    argv: list[str],
    *,
    backend: str,
    devices: list,
    timeout: float = 600.0,
    env_extra: dict | None = None,
    cwd: str | None = None,
) -> LocalClusterResult:
    """``launch_local_cluster`` + ``wait``: run the cluster to its end (or
    kill it at ``timeout``), reap every child and return all logs; the
    caller decides what a failure means (tests print ``format_logs()``)."""
    return launch_local_cluster(
        n_procs, devs_per_proc, argv, backend=backend, devices=devices, env_extra=env_extra, cwd=cwd
    ).wait(timeout)
