"""Elasticity under failure in the port (DESIGN.md §15), against the JAX
package: the tests of ``tests/test_faults.py`` on the port's ``LeaseBoard``,
``ElasticController.report_failure``, ``SlotCheckpoint`` and
``StreamingEngine(device="cpu")``.

* **Units** — lease liveness on an injected clock; ``report_failure`` (the
  k_min floor, the FailureEvent sequenced before the shrink, both autoscaler
  cooldowns armed), its event byte-equal to the reference controller's.
* **Staleness boundaries** — a kill right after a snapshot, on a snapshot,
  mid-rebuild-flight (the flight is not survived; the ladder fires again),
  after a rebuild commit, and during a rescale barrier (a torn barrier falls
  back to the pre-scale state); the WAL tails (``wal_steps``) are pinned, and
  the reference's ``SlotCheckpoint`` restores the same directory to the same
  slots.
* **Partition-scoped restore** — the lost regions' chunks bit-equal to the
  live ones, for fewer bytes.
* **Property** — hypothesis races ingest / rescale / async rebuild / kill;
  every run ends bit-identical to a no-failure mirror that took the same
  decisions, each controller generation's seq strictly increasing. A fixed
  interleaving covers the same executor without hypothesis.
* **The drill** — ``tests/torch_faults_harness.py`` on a 2 × 2 gloo cluster
  of CPU ranks: process 1's ranks SIGKILLed after batch 5, the lease board's
  detection, the survivors abandoned, then a recovery group of 2 ranks
  restoring from disk, re-planning 8 → 4 across its ranks and finishing the
  stream: restore point, final slots and final pack byte-equal to a
  no-failure oracle replayed through the JAX package.

Exact everywhere.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import os
import sys

import numpy as np
import pytest

import faults_harness as J_FH
import torch_faults_harness as FH
from conftest import hypothesis_or_stub
from repro.checkpoint import SlotCheckpoint as J_SlotCheckpoint
from repro.elastic import controller as J_ec
from repro.graphs import engine as J_E
from repro.obs import log as J_OL
from repro.stream import IncrementalOrderer as J_IncrementalOrderer
from repro.stream import SyntheticStream as J_SyntheticStream
from repro_torch.checkpoint import CheckpointError, SlotCheckpoint
from repro_torch.elastic import controller as ec
from repro_torch.elastic.autoscale import AutoscaleConfig, AutoscalePolicy
from repro_torch.launch import multihost as MH
from repro_torch.obs import log as OL
from repro_torch.stream import IncrementalOrderer, StreamingEngine, SyntheticStream

given, settings, st = hypothesis_or_stub()


# --------------------------------------------------------------- LeaseBoard
class TestLeaseBoard:
    def test_stamp_age_dead(self, tmp_path):
        clk = [0.0]
        board = MH.LeaseBoard(tmp_path, lease_s=1.0, clock=lambda: clk[0])
        board.stamp(0, 5)
        clk[0] = 0.5
        assert board.dead(2) == []  # p1 never stamped but is younger than t0+1s
        assert board.step(0) == 5 and board.step(1) == -1
        clk[0] = 1.5
        assert board.dead(2) == [0, 1]  # a frozen stamp ages like silence
        board.stamp(0, 6)
        assert board.dead(2) == [1] and board.survivors(2) == [0]

    def test_surviving_devices_process_major(self, tmp_path):
        clk = [10.0]
        board = MH.LeaseBoard(tmp_path, lease_s=1.0, clock=lambda: clk[0])
        board.stamp(0, 0)
        board.stamp(1, 0)
        clk[0] = 10.5
        board.stamp(0, 1)  # p1's lease now freezes
        clk[0] = 11.2
        assert board.survivors(2) == [0]
        assert board.surviving_devices(2, 4) == [0, 1, 2, 3]

    def test_torn_lease_reads_as_never_stamped(self, tmp_path):
        clk = [0.0]
        board = MH.LeaseBoard(tmp_path, lease_s=1.0, clock=lambda: clk[0])
        (tmp_path / "lease_p0.json").write_text('{"step": 3, "t"')  # torn
        assert board.read(0) is None and board.step(0) == -1
        clk[0] = 2.0
        assert 0 in board.dead(1)  # aged from board construction

    def test_wait_for_step(self, tmp_path):
        board = MH.LeaseBoard(tmp_path, lease_s=1.0)
        board.stamp(0, 3)
        assert board.wait_for_step(0, 2, timeout=1.0) == 3
        with pytest.raises(TimeoutError):
            board.wait_for_step(1, 0, timeout=0.05, poll_s=0.01)


# ------------------------------------------------------------ report_failure
class TestReportFailure:
    def _controller(self, n, C=ec, **kw):
        clk = [100.0]
        return C.ElasticController(n, clock=lambda: clk[0], **kw), clk

    def test_failure_sequenced_before_shrink(self):
        ctl, _ = self._controller(8)
        fev, sev = ctl.report_failure([4, 5, 6, 7], detect_s=0.25)
        assert fev.kind == "failure" and fev.k_old == 8 and fev.k_new == 4 and fev.detect_s == 0.25
        assert sev is not None and sev.kind == "scale_in" and sev.k_new == 4
        assert fev.seq < sev.seq and ctl.events == [fev, sev] and ctl.k == 4

    def test_k_min_floor_retains_hosts(self):
        ctl, _ = self._controller(2, k_min=2)
        fev, sev = ctl.report_failure([0, 1])
        assert fev.lost_hosts == () and fev.k_new == 2 and sev is None and ctl.k == 2

    def test_k_min_partial_clamp(self):
        ctl, _ = self._controller(3, k_min=2)
        fev, sev = ctl.report_failure([1, 2])
        assert fev.k_new == 2 and len(fev.lost_hosts) == 1
        assert "clamped at k_min=2" in fev.reason and sev is not None and sev.k_new == 2

    def test_dead_hosts_not_re_evicted(self):
        ctl, _ = self._controller(4)
        ctl.report_failure([3])
        fev, _ = ctl.report_failure([3, 2])  # 3 already dead
        assert fev.lost_hosts == (2,) and ctl.k == 2

    def test_failure_arms_both_autoscaler_cooldowns(self):
        ctl, _ = self._controller(4)
        pol = AutoscalePolicy(AutoscaleConfig(out_cooldown_s=10.0, in_cooldown_s=30.0))
        ctl.attach_autoscaler(pol)
        ctl.report_failure([3])
        assert pol._next_out_t == 110.0 and pol._next_in_t == 130.0

    def test_note_external_scale_never_shortens(self):
        pol = AutoscalePolicy(AutoscaleConfig(out_cooldown_s=10.0, in_cooldown_s=30.0))
        pol._next_in_t = 500.0  # already armed further out
        pol.note_external_scale(100.0)
        assert pol._next_in_t == 500.0 and pol._next_out_t == 110.0

    def test_failure_event_roundtrips_jsonl_and_equals_reference(self):
        ctl, _ = self._controller(4)
        jctl, _ = self._controller(4, C=J_ec)
        for c in (ctl, jctl):
            c.report_failure([3], detect_s=0.5, restored_bytes=123, replayed_records=2)
        assert OL.events_from_jsonl(ctl.events_jsonl()) == ctl.events
        assert ctl.events_jsonl() == jctl.events_jsonl()
        assert J_OL.events_from_jsonl(ctl.events_jsonl()) == jctl.events


# ------------------------------------------------------------ shared helpers
def _make_pipeline(src, dst, num_vertices, regions, cfg, **eng_kw):
    o = IncrementalOrderer(src, dst, num_vertices, regions=regions, config=cfg)
    eng = StreamingEngine(o, device="cpu", span_repair="host", **eng_kw)
    ctl = ec.ElasticController(regions)
    ctl.attach_stream(eng)
    return o, eng, ctl


def _slots(o):
    return o.slot_src.copy(), o.slot_dst.copy(), o.slot_valid.copy()


def _assert_slots_equal(a, b, msg=""):
    for name, x, y in zip(("slot_src", "slot_dst", "slot_valid"), a, b):
        assert np.array_equal(x, y), f"{name} diverged {msg}"


def _restore_both(tmp_path, interval):
    """The port's restore of the directory, held against the reference's."""
    o2, info = SlotCheckpoint(tmp_path, interval=interval).restore(config=FH.drill_config())
    jo2, jinfo = J_SlotCheckpoint(tmp_path, interval=interval).restore(config=J_FH.drill_config())
    assert info == jinfo
    _assert_slots_equal(_slots(o2), _slots(jo2), "(port restore vs reference restore)")
    return o2, info


# ------------------------------------------------------- staleness boundaries
class TestStalenessBoundaries:
    def _stream(self, g, n):
        s = SyntheticStream(g, batch_size=32, delete_frac=0.3, seed=9)
        return [s.batch() for _ in range(n)]

    def test_kill_at_batch_after_snapshot(self, tmp_path):
        g, src, dst = FH.build_ordered()
        o, eng, ctl = _make_pipeline(src, dst, g.num_vertices, 4, FH.drill_config())
        ctl.attach_checkpoint(SlotCheckpoint(tmp_path, interval=4))
        for b in self._stream(g, 6):  # snapshots at steps 0 and 4; batch 5 is WAL-only
            ctl.ingest(b)
        o2, info = _restore_both(tmp_path, 4)
        assert info["manifest_step"] == 4 and info["wal_steps"] == [5] and info["replayed"] == 1
        _assert_slots_equal(_slots(o2), _slots(o), "(kill after snapshot)")

    def test_kill_right_on_snapshot_has_empty_tail(self, tmp_path):
        g, src, dst = FH.build_ordered()
        o, eng, ctl = _make_pipeline(src, dst, g.num_vertices, 4, FH.drill_config())
        ctl.attach_checkpoint(SlotCheckpoint(tmp_path, interval=4))
        for b in self._stream(g, 5):  # the last batch (step 4) snapshots
            ctl.ingest(b)
        o2, info = _restore_both(tmp_path, 4)
        assert info["wal_steps"] == [] and info["replayed"] == 0
        _assert_slots_equal(_slots(o2), _slots(o), "(kill on snapshot)")

    def test_kill_mid_rebuild_flight_aborts_and_ladder_refires(self, tmp_path):
        g, src, dst = FH.build_ordered()
        cfg = FH.drill_config()
        o, eng, ctl = _make_pipeline(src, dst, g.num_vertices, 4, cfg, full_rebuild="geo", rebuild_flight=3)
        ctl.attach_checkpoint(SlotCheckpoint(tmp_path, interval=100))
        batches = self._stream(g, 8)
        ctl.ingest(batches[0])  # the first batch forces the initial full snapshot
        ctl.ingest(batches[1])
        o.drift = lambda: 1e6
        ctl.ingest(batches[2])  # dispatch
        del o.drift
        assert eng.rebuild_state == "dispatch" and eng.rebuilds_in_flight == 1
        ctl.ingest(batches[3])  # in flight — and this is where we "die"
        assert eng.rebuilds_in_flight == 1
        want = _slots(o)  # the flight never touched the slot arrays
        o2, info = _restore_both(tmp_path, 100)
        assert info["wal_steps"] == [1, 2, 3]  # the dispatch batch is a plain record
        _assert_slots_equal(_slots(o2), want, "(kill mid-flight)")
        eng2 = StreamingEngine.from_restored(o2, device="cpu", span_repair="host", full_rebuild="geo",
                                             rebuild_flight=3)
        assert eng2.rebuilds_in_flight == 0  # the flight is NOT survived
        eng2.verify_bit_identity()
        ctl2 = ec.ElasticController(4)
        ctl2.attach_stream(eng2)
        o2.drift = lambda: 1e6  # drift is still past the rung threshold …
        ctl2.ingest(batches[4])
        del o2.drift
        assert eng2.rebuild_state == "dispatch"  # … so the ladder fires again

    def test_commit_after_flight_forces_full_snapshot(self, tmp_path):
        g, src, dst = FH.build_ordered()
        o, eng, ctl = _make_pipeline(src, dst, g.num_vertices, 4, FH.drill_config(), full_rebuild="geo",
                                     rebuild_flight=1)
        ctl.attach_checkpoint(SlotCheckpoint(tmp_path, interval=100))
        batches = self._stream(g, 5)
        ctl.ingest(batches[0])
        o.drift = lambda: 1e6
        ctl.ingest(batches[1])  # dispatch
        del o.drift
        ctl.ingest(batches[2])  # commit: re-layout ⇒ epoch bump
        assert eng.rebuild_state == "commit"
        o2, info = _restore_both(tmp_path, 100)
        assert info["manifest_step"] == 2 and info["wal_steps"] == []
        _assert_slots_equal(_slots(o2), _slots(o), "(rebuild commit)")

    def test_kill_during_rescale_commit(self, tmp_path):
        g, src, dst = FH.build_ordered()
        o, eng, ctl = _make_pipeline(src, dst, g.num_vertices, 4, FH.drill_config())
        ctl.attach_checkpoint(SlotCheckpoint(tmp_path, interval=100))
        batches = self._stream(g, 4)
        for b in batches[:3]:
            ctl.ingest(b)
        pre_scale = _slots(o)
        ctl._emit("scale_in", 4, 2, (2, 3), "drill shrink")  # writes the barrier
        post_scale = _slots(o)
        o2, info = _restore_both(tmp_path, 100)  # committed barrier: the re-plan stands
        assert o2.regions == 2 and info["wal_steps"] == [1, 2]
        _assert_slots_equal(_slots(o2), post_scale, "(committed barrier)")
        # A torn barrier (SIGKILL mid-append) truncates the WAL tail: recovery
        # falls back to the PRE-scale state.
        wal = tmp_path / "wal.jsonl"
        lines = wal.read_text().splitlines(keepends=True)
        wal.write_text("".join(lines[:-1]) + lines[-1][: len(lines[-1]) // 2])
        o3, info3 = _restore_both(tmp_path, 100)
        assert o3.regions == 4 and info3["wal_steps"] == [1, 2]
        _assert_slots_equal(_slots(o3), pre_scale, "(torn barrier)")


# ------------------------------------------------------- partition-scoped restore
class TestPartitionRestore:
    def test_lost_partitions_bit_equal_and_cheaper(self, tmp_path):
        g, src, dst = FH.build_ordered()
        o, eng, ctl = _make_pipeline(src, dst, g.num_vertices, 8, FH.drill_config())
        ck = SlotCheckpoint(tmp_path, interval=3)
        ctl.attach_checkpoint(ck)
        s = SyntheticStream(g, batch_size=32, delete_frac=0.3, seed=9)
        for _ in range(5):  # snapshots at 0, 3; the WAL tail covers 4
            ctl.ingest(s.batch())
        spr = o.slots_per_region
        chunks, info = ck.restore_partitions([1, 5])
        for r in (1, 5):
            for got, live in zip(chunks[r], (o.slot_src, o.slot_dst, o.slot_valid)):
                assert np.array_equal(got, live[r * spr:(r + 1) * spr])
        _, full_info = SlotCheckpoint(tmp_path, interval=3).restore(config=FH.drill_config())
        assert info["bytes_read"] < full_info["bytes_read"]
        _, one_info = ck.restore_partitions([1])
        assert one_info["bytes_read"] < info["bytes_read"]
        assert J_SlotCheckpoint(tmp_path).restore_partitions([1, 5])[1] == info

    def test_refuses_across_scale_barrier(self, tmp_path):
        g, src, dst = FH.build_ordered()
        o, eng, ctl = _make_pipeline(src, dst, g.num_vertices, 8, FH.drill_config())
        ck = SlotCheckpoint(tmp_path, interval=100)
        ctl.attach_checkpoint(ck)
        ctl.ingest(SyntheticStream(g, batch_size=32, seed=9).batch())
        ctl._emit("scale_in", 8, 4, (4, 5, 6, 7), "shrink")
        with pytest.raises(CheckpointError, match="scale"):
            ck.restore_partitions([1])

    def test_out_of_range_partition(self, tmp_path):
        g, src, dst = FH.build_ordered()
        o, eng, ctl = _make_pipeline(src, dst, g.num_vertices, 4, FH.drill_config())
        ck = SlotCheckpoint(tmp_path)
        ctl.attach_checkpoint(ck)
        ctl.ingest(SyntheticStream(g, batch_size=32, seed=9).batch())
        with pytest.raises(CheckpointError, match="out of range"):
            ck.restore_partitions([7])


# ----------------------------------------------------------- property (race)
def _run_race(actions, tmp_path):
    """Execute an action interleaving twice — subject (with kills: crash +
    cold restore + failure shrink) and mirror (same decisions, never loses
    state) — and return both controllers plus the subject's generations."""
    g, src, dst = FH.build_ordered()
    cfg = FH.drill_config()
    stream = SyntheticStream(g, batch_size=32, delete_frac=0.3, seed=11)
    batches = [stream.batch() for _ in range(len(actions) + 1)]
    eng_kw = dict(full_rebuild="geo", rebuild_flight=2)
    o, eng, ctl = _make_pipeline(src, dst, g.num_vertices, 4, cfg, **eng_kw)
    ck = SlotCheckpoint(tmp_path, interval=2)
    ctl.attach_checkpoint(ck)
    bi, durable, mirror_ops, generations = 0, False, [], [ctl]

    def scale_in(c):
        k_old = c.k
        hid = max(h.host_id for h in c.hosts.values() if h.alive)
        c.hosts[hid].alive = False
        c._emit("scale_in", k_old, c.k, (hid,), "race scale_in")

    for act in actions:
        if act in ("ingest", "rebuild") and bi < len(batches):
            if act == "rebuild":
                ctl.stream.orderer.drift = lambda: 1e6
            ctl.ingest(batches[bi])
            if act == "rebuild":
                del ctl.stream.orderer.drift
            mirror_ops.append((act, bi))
            bi += 1
            durable = True
        elif act == "scale_in" and ctl.k > 2:
            scale_in(ctl)
            mirror_ops.append(("scale_in", None))
        elif act == "scale_out":
            ctl.add_hosts(1)
            mirror_ops.append(("scale_out", None))
        elif act == "kill" and durable and ctl.k >= 2:
            ck = SlotCheckpoint(tmp_path, interval=2)  # crash: cold-restore, re-home, failure shrink
            o, info = ck.restore(config=cfg)
            eng = StreamingEngine.from_restored(o, device="cpu", span_repair="host", **eng_kw)
            k_cur = o.regions
            ctl = ec.ElasticController(k_cur)
            ctl.attach_stream(eng)
            ctl.attach_checkpoint(ck)
            ctl._batch_step = info["step"]
            _, sev = ctl.report_failure([k_cur - 1], reason="race kill")
            generations.append(ctl)
            mirror_ops.append(("failure_shrink", sev.k_new if sev else None))

    mo, meng, mctl = _make_pipeline(src, dst, g.num_vertices, 4, cfg, **eng_kw)
    for op, arg in mirror_ops:
        if op in ("ingest", "rebuild"):
            if op == "rebuild":
                mo.drift = lambda: 1e6
            mctl.ingest(batches[arg])
            if op == "rebuild":
                del mo.drift
        elif op == "scale_in":
            scale_in(mctl)
        elif op == "scale_out":
            mctl.add_hosts(1)
        elif op == "failure_shrink" and arg is not None:
            k_old = mctl.k
            lost = sorted(h.host_id for h in mctl.hosts.values() if h.alive)[arg - k_old:]
            for hid in lost:
                mctl.hosts[hid].alive = False
            mctl._emit("scale_in", k_old, arg, tuple(lost), "mirror failure shrink")
    return ctl, mctl, generations


def _assert_race_invariants(ctl, mctl, generations):
    subject, mirror = ctl.stream.orderer, mctl.stream.orderer
    assert subject.regions == mirror.regions
    _assert_slots_equal(_slots(subject), _slots(mirror), "(race vs mirror)")
    ctl.stream.verify_bit_identity()
    mctl.stream.verify_bit_identity()
    for gen_i, c in enumerate(generations):
        seqs = [ev.seq for ev in c.events]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs), f"generation {gen_i}: {seqs}"
        if gen_i > 0:  # every recovery generation leads with its FailureEvent
            assert c.events and c.events[0].kind == "failure"


@given(actions=st.lists(st.sampled_from(["ingest", "scale_in", "scale_out", "rebuild", "kill"]),
                        min_size=3, max_size=7))
@settings(max_examples=6, deadline=None)
def test_race_recovery_matches_no_failure_mirror(actions, tmp_path_factory):
    _assert_race_invariants(*_run_race(actions, tmp_path_factory.mktemp("race")))


def test_race_fixed_interleaving(tmp_path):
    actions = ["ingest", "scale_out", "ingest", "rebuild", "kill", "ingest", "scale_in", "ingest", "kill", "ingest"]
    ctl, mctl, generations = _run_race(actions, tmp_path)
    _assert_race_invariants(ctl, mctl, generations)
    assert len(generations) == 3


# ------------------------------------------------------------------ the drill
@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The drill once: 2 × 2 gloo CPU ranks live, process 1 SIGKILLed after
    batch ``FH.KILL_STEP``, a recovery group of 2 ranks."""
    shared, out = tmp_path_factory.mktemp("drill_shared"), tmp_path_factory.mktemp("drill_out")
    return FH.run_drill(shared, out, device="cpu", backend="gloo", live_devices=["cpu"] * 4,
                        recover_devices=["cpu"] * 2)


def _jax_oracle(last_durable: int):
    """The no-failure replay through the JAX package: its drill graph, its
    orderer and stream, the same re-plan 8 → 4 after the last durable batch."""
    g, src, dst = J_FH.build_ordered()
    o = J_IncrementalOrderer(src, dst, g.num_vertices, regions=J_FH.REGIONS, config=J_FH.drill_config())
    stream = J_SyntheticStream(g, batch_size=J_FH.STREAM_BATCH, seed=J_FH.STREAM_SEED)
    snap = None
    for b in range(FH.BATCHES):
        o.apply(stream.batch())
        o.needs_resync = False
        o.drain_ops()
        if b == last_durable:
            snap = _slots(o)
            o.relayout(FH.K_RECOVER)
            o.drain_gather_map()
            o.needs_resync = False
    return o, snap


class TestDrill:
    def test_group_reaped_with_partial_logs(self, drill):
        procs = drill["live"].procs
        assert [p.returncode for p in procs[2:]] == [-9, -9]  # the victims: SIGKILLed and reaped
        # The survivors were reaped too: killed where they were stranded, or
        # ended by their collective's error once the peer's socket closed.
        assert all(p.returncode not in (None, 0) for p in procs[:2])
        for p in procs[2:]:  # the victims' PARTIAL logs survived, attributably prefixed
            assert any("live: batch" in line and line.startswith(f"[p1r{p.rank}] ") for line in p.stdout.splitlines())
            assert "SIGKILL injected mid-run (drill preemption)" in p.stderr
        assert all("stranded survivor" in p.stderr for p in procs[:2])

    def test_detection_latency_bounded(self, drill):
        assert 0.0 < drill["detect_s"] <= FH.LEASE_S + 2.0
        for rec in drill["records"]:
            assert rec["failure_event"]["detect_s"] == pytest.approx(drill["detect_s"], abs=1e-6)

    def test_failure_event_and_replan(self, drill):
        for rec in drill["records"]:
            fe = rec["failure_event"]
            assert fe["k_old"] == 8 and fe["k_new"] == 4 and fe["lost_hosts"] == [4, 5, 6, 7]
            assert fe["restored_bytes"] > 0 and rec["k_final"] == 4
            assert rec["event_kinds"][:2] == ["failure", "scale_in"]
            assert rec["event_seqs"] == list(range(len(rec["event_seqs"])))
            assert rec["scale_event"]["executed"] and rec["jax_loaded"] is False
        a, b = drill["records"]
        assert a["events_jsonl"] == b["events_jsonl"]  # both recovery ranks logged the same
        moved = [r["scale_event"] for r in drill["records"]]
        assert sum(m["sent_bytes"] for m in moved) == sum(m["received_bytes"] for m in moved) == \
            moved[0]["cross_device_bytes"] > 0
        assert a["checkpoint"]["restore_bytes"] == a["restore"]["bytes_read"]

    def test_recovery_bit_identical_to_oracle(self, drill):
        last_durable = drill["records"][0]["restore"]["step"]
        assert FH.KILL_STEP <= last_durable < FH.BATCHES - 1  # a tail was left to finish
        oracle, restore_point = _jax_oracle(last_durable)
        for arrays in drill["arrays"]:
            _assert_slots_equal((arrays["restore_src"], arrays["restore_dst"], arrays["restore_valid"]),
                                restore_point, "(drill restore point)")
            _assert_slots_equal((arrays["final_src"], arrays["final_dst"], arrays["final_valid"]),
                                _slots(oracle), "(drill final)")
        port_oracle, port_point = FH.drill_oracle(last_durable)  # the smoke's oracle agrees
        _assert_slots_equal(port_point, restore_point, "(port oracle)")
        _assert_slots_equal(_slots(port_oracle), _slots(oracle), "(port oracle)")

    def test_recovered_pack_matches_oracle_pack(self, drill):
        oracle, _ = _jax_oracle(drill["records"][0]["restore"]["step"])
        pack = J_E.pack_slots(oracle.slot_src, oracle.slot_dst, oracle.slot_valid, 4, oracle.num_vertices)
        edges, mask = FH.reassemble(drill["records"], drill["arrays"])
        assert edges.tobytes() == np.asarray(pack.edges).tobytes()
        assert mask.tobytes() == np.asarray(pack.mask).tobytes()


def test_harness_imports_no_jax():
    import subprocess

    probe = ("import sys; sys.argv = ['x']; import torch_faults_harness; "
             "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules))")
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, check=True, cwd=here,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join([here, os.path.join(here, "..", "src")])})
    assert out.stdout.strip() == "False"
