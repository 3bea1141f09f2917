"""Chunked checkpointing with CEP-resharded restore + the incremental
slot-state checkpoint the failure-recovery path restores from (DESIGN.md §15).

Two layers share this module:

**Tree store** (``save`` / ``restore``) — the PR-7 contract: a pytree is
flattened to named tensors, each chunked by the CEP bounds at ``k_shards``,
so a replacement host pulls only the old shards overlapping its new chunk
(Thm.-2 restore cost, not a full reshuffle). Error paths raise typed
``CheckpointError`` subclasses — never silently corrupt arrays.

**Incremental slot checkpoint** (``SlotCheckpoint``) — the durable state of
the streaming runtime. Layout on disk::

  <dir>/chunk_r<region>_s<step>.npz   one region's slot range (src/dst/valid)
  <dir>/manifest_<step>.json          geometry + per-region chunk_step map +
                                      monitor control state; written via
                                      tmp+rename, so a partial snapshot is
                                      INVISIBLE (crash mid-commit falls back
                                      to the previous manifest)
  <dir>/wal.jsonl                     write-behind log: one record per ingest
                                      batch (coalesced slot writes from
                                      ``drain_recovery_ops`` — including
                                      emit_ops=False device span repairs —
                                      plus the raw batch and the monitor's
                                      baseline/cooldown after it) and one
                                      barrier record per executed rescale

A snapshot writes only the regions the orderer dirtied since the last one
(``drain_dirty_regions``) and carries clean regions forward by reference in
``chunk_step`` — snapshot cost is proportional to touched chunks. Layout
changes (grow, full-rebuild commit, resync) dirty every region AND invalidate
slot-addressed ops, so ``note_batch`` forces a full snapshot instead of a WAL
record; executed rescales write a ``scale`` barrier record the replay handles
with ``relayout`` (a pure function of slot state). Restore = latest manifest's
chunks + the WAL tail replayed as raw slot writes — bit-exact by construction,
no placement or repair logic re-runs. ``restore(partitions=...)`` reads only
the lost regions' chunks and replays only their slots' ops: recovery cost
scales with lost partitions, not graph size.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Optional

import numpy as np

from ..core import cep

__all__ = [
    "CheckpointError",
    "MissingStepError",
    "TemplateMismatchError",
    "CorruptShardError",
    "SlotCheckpoint",
    "save",
    "restore",
]


class CheckpointError(Exception):
    """Base class of every typed checkpoint failure."""


class MissingStepError(CheckpointError):
    """The requested step directory / manifest does not exist."""


class TemplateMismatchError(CheckpointError):
    """The restore ``template``'s named leaves do not match the manifest."""


class CorruptShardError(CheckpointError):
    """A shard/chunk file is missing, truncated, or inconsistent with its
    manifest — restoring it would return silently corrupt arrays."""


# --------------------------------------------------------------- tree store
def _tree_leaves(tree, path: tuple = ()) -> list:
    """``[(path, leaf)]`` in the JAX package's pytree order: a dict's
    children by sorted key, a list's or tuple's by position, a namedtuple's by
    field (named ``.field``); ``None`` holds no leaf; anything else (an array,
    a ``torch.Tensor``, a scalar) is a leaf. Each path entry is the key,
    index or ``.field`` the leaf's name joins with ``/``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _tree_leaves(tree[key], path + (key,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in _tree_leaves(getattr(tree, f), path + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [x for i, child in enumerate(tree) for x in _tree_leaves(child, path + (i,))]
    return [(path, tree)]


def _tree_rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken, in ``_tree_leaves``
    order, from the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _tree_rebuild(tree[key], leaves) for key in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_rebuild(getattr(tree, f), leaves) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_rebuild(child, leaves) for child in tree)
    return next(leaves)


def _leaf_name(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _host_array(leaf) -> np.ndarray:
    """A leaf's values on the host: a ``torch.Tensor`` through
    ``.cpu().numpy()`` (torch is imported only when one is given)."""
    if type(leaf).__module__.startswith("torch"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, leaf):
    """``arr`` as the template leaf's type: a tensor of its dtype on its
    device for a ``torch.Tensor``, else an array of its dtype."""
    if type(leaf).__module__.startswith("torch"):
        import torch

        return torch.from_numpy(np.ascontiguousarray(arr)).to(dtype=leaf.dtype, device=leaf.device)
    return arr.astype(leaf.dtype)


def _flatten_named(tree) -> list:
    return [(_leaf_name(path), _host_array(leaf)) for path, leaf in _tree_leaves(tree)]


def save(tree, directory, step: int, k_shards: int) -> pathlib.Path:
    d = pathlib.Path(directory) / f"step_{step}"
    d.mkdir(parents=True, exist_ok=True)
    named = _flatten_named(tree)
    manifest = {
        "step": step,
        "k_shards": k_shards,
        "tensors": [
            {"name": n, "shape": list(a.shape), "dtype": str(a.dtype)} for n, a in named
        ],
    }
    (d / "manifest.json").write_text(json.dumps(manifest))
    for h in range(k_shards):
        shard = {}
        for n, a in named:
            flat = a.reshape(-1)
            b = cep.chunk_bounds(flat.shape[0], k_shards)
            shard[n] = flat[int(b[h]) : int(b[h + 1])]
        np.savez(d / f"shard_{h}.npz", **shard)
    return d


def restore(directory, step: int, k_new: int, template=None) -> tuple:
    """Returns (tree_or_named_dict, bytes_touched).

    Each new host h' reads only old shards overlapping its new chunk; we
    account bytes read per host to demonstrate Thm.-2 restore cost. Raises
    ``MissingStepError`` when the step was never saved,
    ``CorruptShardError`` on unreadable/truncated shard files, and
    ``TemplateMismatchError`` when ``template``'s leaves don't name the
    saved tensors.
    """
    d = pathlib.Path(directory) / f"step_{step}"
    try:
        manifest = json.loads((d / "manifest.json").read_text())
    except FileNotFoundError as e:
        raise MissingStepError(f"no checkpoint at step {step} under {directory}") from e
    except (OSError, json.JSONDecodeError) as e:
        raise CorruptShardError(f"unreadable manifest for step {step}: {e}") from e
    k_old = manifest["k_shards"]
    shards = []
    for h in range(k_old):
        try:
            shards.append(np.load(d / f"shard_{h}.npz"))
        except FileNotFoundError as e:
            raise CorruptShardError(f"step {step}: shard_{h}.npz missing") from e
        except Exception as e:  # zipfile/np.load raise a zoo of types on truncation
            raise CorruptShardError(f"step {step}: shard_{h}.npz unreadable: {e}") from e
    arrays = {}
    bytes_touched = 0
    for t in manifest["tensors"]:
        n, shape, dtype = t["name"], tuple(t["shape"]), t["dtype"]
        total = int(np.prod(shape)) if shape else 1
        ob = cep.chunk_bounds(max(total, 1), k_old)
        flat = np.empty(total, dtype=dtype)
        for h in range(k_old):
            lo, hi = int(ob[h]), int(ob[h + 1])
            if hi <= lo:
                continue
            try:
                chunk = shards[h][n]
            except Exception as e:
                raise CorruptShardError(
                    f"step {step}: shard_{h}.npz lacks tensor {n!r}: {e}"
                ) from e
            if chunk.shape != (hi - lo,):
                raise CorruptShardError(
                    f"step {step}: shard_{h}.npz tensor {n!r} holds {chunk.shape}, "
                    f"manifest chunk is ({hi - lo},)"
                )
            flat[lo:hi] = chunk
        arrays[n] = flat.reshape(shape)
        if k_new != k_old:
            bytes_touched += cep.migrated_edges_exact(max(total, 1), k_old, k_new) * flat.itemsize
    if template is not None:
        leaves_with_path = _tree_leaves(template)
        want = [_leaf_name(path) for path, _ in leaves_with_path]
        if sorted(want) != sorted(arrays):
            missing = sorted(set(want) - set(arrays))
            extra = sorted(set(arrays) - set(want))
            raise TemplateMismatchError(
                f"template treedef does not match step {step}: "
                f"template-only leaves {missing}, checkpoint-only tensors {extra}"
            )
        ordered = [
            _like(arrays[name], leaf)
            for name, (_, leaf) in zip(want, leaves_with_path)
        ]
        return _tree_rebuild(template, iter(ordered)), bytes_touched
    return arrays, bytes_touched


# ------------------------------------------------- incremental slot snapshot
_OP_BYTES = 25  # slot + u + v (int64) + valid (bool): the WAL replay bill


def _atomic_write_text(path: pathlib.Path, text: str) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)  # atomic on POSIX: the manifest appears whole or not at all


class SlotCheckpoint:
    """Incremental per-CEP-chunk checkpoint of an ``IncrementalOrderer``.

    Region r's slot range ``[r·spr, (r+1)·spr)`` IS its CEP chunk at
    k = regions (the slot array's capacity divides evenly), so chunk files
    are addressable per partition — exactly what a partition-scoped restore
    needs. See the module docstring for the disk layout and replay contract.
    """

    def __init__(
        self,
        directory,
        *,
        interval: int = 4,
        tracer=None,
        metrics_registry=None,
    ):
        from ..obs import metrics as obs_metrics
        from ..obs import trace as obs_trace

        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.interval = int(interval)
        self._tracer = tracer if tracer is not None else obs_trace.get_tracer()
        reg = metrics_registry if metrics_registry is not None else obs_metrics.NULL
        self._c_snapshots = reg.counter("checkpoint.snapshots")
        self._c_snapshot_bytes = reg.counter("checkpoint.snapshot_bytes")
        self._c_wal_records = reg.counter("checkpoint.wal_records")
        self._c_wal_bytes = reg.counter("checkpoint.wal_bytes")
        self._c_restore_bytes = reg.counter("checkpoint.restore_bytes")
        m = self.latest_manifest()
        self._wal_seq = self._scan_wal_seq(m["wal_seq"] if m else -1)
        self._last_snap_step = m["step"] if m else None
        # The orderer's layout epoch as of the last snapshot / scale barrier;
        # a mismatch in note_batch means the batch re-laid-out the slot array
        # (grow / rebuild commit) and slot-addressed ops can't replay across
        # it — force a full snapshot instead. None = never synced (epoch
        # counters are per-process, so a fresh process always snapshots).
        self._epoch_seen: Optional[int] = None

    # ------------------------------------------------------------- manifests
    def latest_manifest(self) -> Optional[dict]:
        """The highest-step parseable manifest, or None. Unparseable files
        (a crash can't produce one — writes are atomic — but be defensive)
        are skipped, not fatal: recovery falls back to the previous one."""
        best = None
        for p in self.dir.glob("manifest_*.json"):
            try:
                m = json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                continue
            if best is None or m["step"] > best["step"]:
                best = m
        return best

    def _scan_wal_seq(self, floor: int) -> int:
        seq = floor
        for rec in self._wal_records_raw():
            seq = max(seq, rec["seq"])
        return seq

    def _wal_path(self) -> pathlib.Path:
        return self.dir / "wal.jsonl"

    def _wal_records_raw(self) -> list[dict]:
        """Every parseable WAL record, stopping at the first torn line (a
        SIGKILL mid-append truncates the tail; everything after the tear is
        untrusted)."""
        path = self._wal_path()
        if not path.exists():
            return []
        out = []
        for line in path.read_text().splitlines():
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                break
        return out

    def wal_tail(self, after_seq: int) -> list[dict]:
        return [r for r in self._wal_records_raw() if r["seq"] > after_seq]

    def _append_wal(self, rec: dict) -> None:
        line = json.dumps(rec) + "\n"
        with open(self._wal_path(), "a") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        self._c_wal_records.inc()
        self._c_wal_bytes.inc(len(line))

    # ------------------------------------------------------------ write path
    def note_batch(self, orderer, batch, step: int) -> Optional[dict]:
        """Make batch ``step``'s effects durable: a WAL record of the
        coalesced slot writes it (and any span repair between batches)
        produced, or — when the batch changed the slot-array layout, or the
        snapshot interval elapsed — a snapshot. Returns the snapshot info
        dict when one was taken, else None."""
        if self._epoch_seen is None or orderer.layout_epoch != self._epoch_seen:
            # Re-layout inside the batch window (grow / rebuild commit /
            # resync): slot ops can't replay across it, and every region is
            # dirty anyway — the snapshot IS this batch's durability record.
            return self.snapshot(orderer, step)
        ops = orderer.drain_recovery_ops()
        self._append_wal(
            {
                "kind": "batch",
                "seq": self._next_seq(),
                "step": int(step),
                "insert": np.asarray(batch.insert).tolist(),
                "delete": np.asarray(batch.delete).tolist(),
                "ops": [[int(s), int(u), int(v), int(valid)] for s, u, v, valid in ops],
                "baseline_kappa": float(orderer._baseline_kappa),
                "cooldown": int(orderer._cooldown),
            }
        )
        if self._last_snap_step is None or step - self._last_snap_step >= self.interval:
            return self.snapshot(orderer, step)
        return None

    def note_scale(self, orderer, k_new: int, step: int) -> None:
        """WAL barrier for an EXECUTED rescale (``relayout`` already ran).
        Replay reconstructs the orderer at the barrier and re-runs
        ``relayout(k_new)`` — a pure function of slot state — instead of
        replaying slot ops across the geometry change."""
        orderer.drain_recovery_ops()  # invalidated by the re-layout
        self._append_wal(
            {
                "kind": "scale",
                "seq": self._next_seq(),
                "step": int(step),
                "k_new": int(k_new),
                "baseline_kappa": float(orderer._baseline_kappa),
                "cooldown": int(orderer._cooldown),
            }
        )
        self._epoch_seen = orderer.layout_epoch

    def _next_seq(self) -> int:
        self._wal_seq += 1
        return self._wal_seq

    def snapshot(self, orderer, step: int) -> dict:
        """Write the regions dirtied since the last snapshot (all of them on
        the first, or after a re-layout), carry clean regions forward by
        reference, and commit the manifest atomically. Obsolete WAL records
        are pruned after the commit. Returns
        {step, dirty_regions, bytes_written}."""
        with self._tracer.span("checkpoint.snapshot"):
            prev = self.latest_manifest()
            dirty = orderer.drain_dirty_regions()
            orderer.drain_recovery_ops()  # baked into the chunks below
            regions, spr = orderer.regions, orderer.slots_per_region
            full = (
                prev is None
                or prev["regions"] != regions
                or prev["spr"] != spr
                or self._epoch_seen is None
                or orderer.layout_epoch != self._epoch_seen
            )
            if full:
                dirty = list(range(regions))
            chunk_step = (
                {} if full else {int(r): s for r, s in prev["chunk_step"].items()}
            )
            bytes_written = 0
            for r in dirty:
                lo = r * spr
                path = self.dir / f"chunk_r{r}_s{step}.npz"
                np.savez(
                    path,
                    src=orderer.slot_src[lo : lo + spr],
                    dst=orderer.slot_dst[lo : lo + spr],
                    valid=orderer.slot_valid[lo : lo + spr],
                )
                chunk_step[r] = int(step)
                bytes_written += path.stat().st_size
            manifest = {
                "step": int(step),
                "regions": int(regions),
                "spr": int(spr),
                "num_vertices": int(orderer.num_vertices),
                "wal_seq": int(self._wal_seq),
                "chunk_step": {str(r): int(s) for r, s in chunk_step.items()},
                "baseline_kappa": float(orderer._baseline_kappa),
                "cooldown": int(orderer._cooldown),
            }
            # The atomic rename is the COMMIT POINT: every chunk file above is
            # already durable, and until this rename lands the previous
            # manifest still names a complete, older snapshot.
            _atomic_write_text(self.dir / f"manifest_{step}.json", json.dumps(manifest))
            self._last_snap_step = int(step)
            self._epoch_seen = orderer.layout_epoch
            self._prune(manifest)
            self._c_snapshots.inc()
            self._c_snapshot_bytes.inc(bytes_written)
            return {
                "step": int(step),
                "dirty_regions": dirty,
                "bytes_written": bytes_written,
            }

    def _prune(self, manifest: dict) -> None:
        """Drop WAL records the new manifest covers and chunk files / old
        manifests nothing references anymore. Best-effort: a leftover file is
        garbage, never corruption (restore goes through the manifest)."""
        keep = self.wal_tail(manifest["wal_seq"])
        text = "".join(json.dumps(r) + "\n" for r in keep)
        _atomic_write_text(self._wal_path(), text)
        live = {f"chunk_r{r}_s{s}.npz" for r, s in manifest["chunk_step"].items()}
        live.add(f"manifest_{manifest['step']}.json")
        for p in list(self.dir.glob("chunk_r*.npz")) + list(self.dir.glob("manifest_*.json")):
            if p.name not in live:
                try:
                    p.unlink()
                except OSError:
                    pass

    # ----------------------------------------------------------- read path
    def _read_chunk(self, region: int, step: int, spr: int) -> tuple:
        path = self.dir / f"chunk_r{region}_s{step}.npz"
        try:
            with np.load(path) as z:
                src, dst, valid = z["src"], z["dst"], z["valid"]
        except FileNotFoundError as e:
            raise CorruptShardError(f"chunk file {path.name} missing") from e
        except Exception as e:
            raise CorruptShardError(f"chunk file {path.name} unreadable: {e}") from e
        if src.shape != (spr,) or dst.shape != (spr,) or valid.shape != (spr,):
            raise CorruptShardError(
                f"chunk file {path.name} holds {src.shape}, manifest spr is {spr}"
            )
        return src, dst, valid, path.stat().st_size

    @staticmethod
    def _apply_ops(slot_src, slot_dst, slot_valid, ops, only=None) -> int:
        """Replay coalesced slot writes; ``only`` filters to a region set.
        A tombstone zeroes the slot — matching what ``_delete`` wrote live,
        so replay is bit-exact, not just logically equal."""
        n = 0
        for s, u, v, valid in ops:
            if only is not None and s not in only:
                continue
            if valid:
                slot_src[s], slot_dst[s], slot_valid[s] = u, v, True
            else:
                slot_src[s], slot_dst[s], slot_valid[s] = 0, 0, False
            n += 1
        return n

    def restore(self, *, config=None):
        """Full cold restore: latest manifest's chunks + the WAL tail.

        Returns ``(orderer, info)`` where info carries the recovery point
        (``step`` = last durable batch), ``bytes_read``, ``replayed`` WAL
        records, and ``wal_steps`` (the replay-tail batch indices — what the
        staleness boundary tests pin). The orderer is reconstructed via
        ``IncrementalOrderer.from_slots`` with the WAL's final
        baseline/cooldown, so post-restore monitor decisions replay the
        pre-failure timeline exactly."""
        from ..stream.incremental import IncrementalOrderer, StreamConfig

        config = config if config is not None else StreamConfig()
        with self._tracer.span("checkpoint.restore"):
            m = self.latest_manifest()
            if m is None:
                raise MissingStepError(f"no manifest under {self.dir}")
            regions, spr = m["regions"], m["spr"]
            src = np.zeros(regions * spr, dtype=np.int64)
            dst = np.zeros(regions * spr, dtype=np.int64)
            valid = np.zeros(regions * spr, dtype=bool)
            bytes_read = 0
            for r in range(regions):
                cs = m["chunk_step"].get(str(r))
                if cs is None:
                    raise CorruptShardError(f"manifest step {m['step']} lacks region {r}")
                csrc, cdst, cvalid, nbytes = self._read_chunk(r, cs, spr)
                lo = r * spr
                src[lo : lo + spr] = csrc
                dst[lo : lo + spr] = cdst
                valid[lo : lo + spr] = cvalid
                bytes_read += nbytes
            kappa, cooldown = m["baseline_kappa"], m["cooldown"]
            tail = self.wal_tail(m["wal_seq"])
            step = m["step"]
            wal_steps = []
            for rec in tail:
                if rec["kind"] == "scale":
                    o = IncrementalOrderer.from_slots(
                        src, dst, valid, m["num_vertices"],
                        regions=regions, config=config,
                        baseline_kappa=kappa, cooldown=cooldown,
                    )
                    o.relayout(rec["k_new"])
                    regions, spr = o.regions, o.slots_per_region
                    src, dst, valid = o.slot_src, o.slot_dst, o.slot_valid
                else:
                    bytes_read += _OP_BYTES * len(rec["ops"])
                    self._apply_ops(src, dst, valid, rec["ops"])
                    wal_steps.append(rec["step"])
                kappa, cooldown = rec["baseline_kappa"], rec["cooldown"]
                step = rec["step"]
            orderer = IncrementalOrderer.from_slots(
                src, dst, valid, m["num_vertices"],
                regions=regions, config=config,
                baseline_kappa=kappa, cooldown=cooldown,
            )
            self._c_restore_bytes.inc(bytes_read)
            return orderer, {
                "step": int(step),
                "manifest_step": int(m["step"]),
                "regions": int(regions),
                "num_vertices": int(m["num_vertices"]),
                "bytes_read": int(bytes_read),
                "replayed": len(tail),
                "wal_steps": wal_steps,
            }

    def restore_partitions(self, partitions) -> tuple[dict, dict]:
        """Partition-scoped warm restore: read ONLY the lost regions' chunks
        and replay only their slots' WAL ops (valid because recovery ops are
        materialized placement decisions — no global state feeds the replay).
        Survivors keep their live state untouched. Refuses to cross a scale
        barrier (the chunk geometry changed; callers degrade to a full
        ``restore``). Returns ``({region: (src, dst, valid)}, info)``."""
        with self._tracer.span("checkpoint.restore"):
            m = self.latest_manifest()
            if m is None:
                raise MissingStepError(f"no manifest under {self.dir}")
            tail = self.wal_tail(m["wal_seq"])
            if any(r["kind"] != "batch" for r in tail):
                raise CheckpointError(
                    "partition-scoped restore cannot replay across a scale "
                    "barrier — use restore() (full)"
                )
            spr = m["spr"]
            lost = sorted({int(r) for r in partitions})
            for r in lost:
                if not 0 <= r < m["regions"]:
                    raise CheckpointError(f"region {r} out of range (k={m['regions']})")
            out = {}
            bytes_read = 0
            for r in lost:
                csrc, cdst, cvalid, nbytes = self._read_chunk(
                    r, m["chunk_step"][str(r)], spr
                )
                out[r] = (csrc.copy(), cdst.copy(), cvalid.copy())
                bytes_read += nbytes
            replayed = 0
            for rec in tail:
                for s, u, v, valid_ in rec["ops"]:
                    r = s // spr
                    if r not in out:
                        continue
                    csrc, cdst, cvalid = out[r]
                    rel = s - r * spr
                    if valid_:
                        csrc[rel], cdst[rel], cvalid[rel] = u, v, True
                    else:
                        csrc[rel], cdst[rel], cvalid[rel] = 0, 0, False
                    replayed += 1
                    bytes_read += _OP_BYTES
            self._c_restore_bytes.inc(bytes_read)
            return out, {
                "manifest_step": int(m["step"]),
                "bytes_read": int(bytes_read),
                "replayed_ops": replayed,
                "lost_bytes": int(
                    len(lost) * spr * (8 + 8 + 1)  # the lost slot state itself
                ),
            }
