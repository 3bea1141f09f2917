"""The port's multi-rank ``graph`` axis over torch.distributed, on the CPU.

One module-scoped cluster of 2 processes × 2 ranks over gloo, started through
the port's ``launch_local_cluster``, runs this file as its worker
(``python tests/test_torch_multihost.py worker <dir>``): the worker imports no
JAX, drives the sharded packs, executed rescales, GAS apps, shard-streamed
slot pack, host collectives and the global metrics snapshot, and writes what
each rank holds. The parent holds those against the JAX package's
single-process oracles (``pack_ordered``, ``pack_slots``, the replicated GAS
apps, ``cross_process_plan_edges``) and plan arithmetic. Every group and every
wait has its own timeout, so a fault fails within about two minutes instead
of hanging the suite.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import dataclasses
import json
import os
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":  # the worker: make the port importable without pytest's path setup
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import cep  # noqa: E402
from repro_torch.elastic.rescale_exec import EDGE_BYTES, ElasticRescaler, plan_segments  # noqa: E402
from repro_torch.graphs import engine as E  # noqa: E402
from repro_torch.kernels import rescale_migrate, segment_rf  # noqa: E402
from repro_torch.launch import multihost as MH  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import GraphGroup, make_graph_group  # noqa: E402
from repro_torch.obs import metrics as OM  # noqa: E402

N_PROCS, DEVS_PER_PROC = 2, 2
G = N_PROCS * DEVS_PER_PROC
GROUP_TIMEOUT_S = 45.0  # every collective of the worker's group
CLUSTER_TIMEOUT_S = 150.0  # the whole cluster, start-up included
ROW_KS = (3, 4, 6)  # below, equal to and above the rank count
CHAIN = ((8, 12), (12, 8))
PAIRS = ((5, 9), (12, 20), (3, 7), (20, 16), (7, 8))  # as tests/test_rescale_sharded.py
APP_KS = (5, 8)
SLOT_K, SLOT_SPR = 6, 40


# ------------------------------------------------------------------ worker
def _stats_dict(stats) -> dict:
    return dataclasses.asdict(stats)


def worker(out_dir: pathlib.Path) -> None:
    """One rank's share of every scenario; writes ``rank{r}.npz`` and
    ``rank{r}.json``. Runs on whatever device and backend the launcher gave
    the rank (the card tests in ``tests/test_torch_cuda.py`` run it on the
    H100)."""
    import torch.distributed as dist

    group = MH.initialize_from_env(timeout_s=GROUP_TIMEOUT_S)
    r = group.rank
    inp = np.load(out_dir / "inputs.npz")
    src, dst, v, source = inp["src"], inp["dst"], int(inp["num_vertices"]), int(inp["source"])
    arrays, meta = {}, {"rank": r, "group": [group.size, group.rank, group.backend, list(group.processes)]}
    reg = OM.MetricsRegistry()
    rx = ElasticRescaler(metrics_registry=reg)

    def keep(name, sdata):
        arrays[f"{name}_edges"], arrays[f"{name}_mask"] = sdata.edges.cpu().numpy(), sdata.mask.cpu().numpy()
        meta[name] = dict(parts=sdata.local_partitions(), k_pad=sdata.k_pad, rows=sdata.rows_per_device,
                          block=list(MH.addressable_row_block((sdata.k_pad,), group)),
                          mirrors=sdata.mirrors, rf=sdata.replication_factor, num_edges=sdata.num_edges)

    for k in ROW_KS:
        keep(f"pack{k}", E.pack_ordered_sharded(src, dst, v, k, group))

    d8 = E.pack_ordered_sharded(src, dst, v, 8, group)
    d12, s_out = rx.rescale(d8, 12, verify=True)
    back, s_in = rx.rescale(d12, 8, verify=True)
    keep("chain12", d12)
    keep("chain8", back)
    meta["chain_stats"] = [_stats_dict(s_out), _stats_dict(s_in)]
    olds = {(8, 12): d8, (12, 8): d12}
    for k_old, k_new in PAIRS:
        olds[(k_old, k_new)] = E.pack_ordered_sharded(src, dst, v, k_old, group)
        new, st = rx.rescale(olds[(k_old, k_new)], k_new, verify=True)
        keep(f"pair{k_old}_{k_new}", new)
        meta[f"pair{k_old}_{k_new}_stats"] = _stats_dict(st)
    meta["rescale_migrate_launches"] = rescale_migrate.launches  # one a rescale on a card, none on the CPU

    # Each rescale's table, and its migration again into a block that holds
    # a sentinel: the receive ranges must still hold it, every other slot
    # the executed result.
    meta["tables"], meta["recv_left"] = {}, {}
    for (k_old, k_new), old in olds.items():
        prog = rx._programs._programs[("migrate", src.shape[0], k_old, k_new, group, old.edges.device)]
        t = prog.table
        meta["tables"][f"{k_old}_{k_new}"] = dict(pieces=t.pieces.tolist(), sends=list(prog.sends),
                                                  recvs=list(prog.recvs), rows=t.rows, width=t.width)
        out = (torch.full((t.rows, t.width, 2), -7, dtype=torch.int32, device=old.edges.device),
               torch.full((t.rows, t.width), -7.0, device=old.edges.device))
        edges = rescale_migrate.migrate(old.edges, t, out=out)[0].cpu().numpy()
        name = {(8, 12): "chain12", (12, 8): "chain8"}.get((k_old, k_new), f"pair{k_old}_{k_new}")
        left = np.zeros(edges.shape[:2], dtype=bool)
        for _, r_, a, b, _ in prog.recvs:
            left[r_, a:b] = True
        meta["recv_left"][name] = bool((edges[left] == -7).all() and (edges[~left] == arrays[f"{name}_edges"][~left]).all()
                                       and (out[1].cpu().numpy() == arrays[f"{name}_mask"]).all())

    for k in APP_KS:
        d = E.pack_ordered_sharded(src, dst, v, k, group)
        arrays[f"pagerank{k}"] = E.pagerank(d, iterations=20).cpu().numpy()
        (ss, meta[f"sssp{k}_it"]), (wc, meta[f"wcc{k}_it"]) = E.sssp(d, source=source), E.wcc(d)
        arrays[f"sssp{k}"], arrays[f"wcc{k}"] = ss.cpu().numpy(), wc.cpu().numpy()

    slots = np.load(out_dir / "slots.npz")

    def part_fn(p):
        sl = slice(p * SLOT_SPR, (p + 1) * SLOT_SPR)
        meta.setdefault("slot_parts_called", []).append(int(p))
        return slots["src"][sl], slots["dst"][sl], slots["valid"][sl]

    ps = E.pack_slots_sharded_stream(part_fn, SLOT_K, v, group, SLOT_SPR)
    keep("slots", ps)
    arrays["slots_degrees"] = ps.degrees.cpu().numpy()
    meta["local_slot_partitions"] = E.local_slot_partitions(SLOT_K, group)

    arrays["psum"] = MH.psum_host(np.arange(5, dtype=np.float64) * (r + 1), group)
    pack6 = E.pack_ordered_sharded(src, dst, v, 6, group)
    arrays["host_read6"] = MH.host_read(pack6.edges, group)
    meta["local_shard_rows6"] = [[lo, hi, list(a.shape)] for lo, hi, a in MH.local_shard_rows(pack6.edges, group)]

    reg.counter("test.rank_plus_one").inc(r + 1)
    reg.histogram("test.latency_s").observe(1e-4 * (r + 1))
    OM.record_peak_rss(reg, process_index=r, process_count=group.size)
    meta["snapshot_local"] = {k: np.atleast_1d(x).tolist() for k, x in reg.snapshot().items()}
    meta["snapshot_global"] = {k: np.atleast_1d(x).tolist() for k, x in reg.snapshot_global(group).items()}

    # A pack whose rows are not CEP chunks on ONE rank: every rank must raise.
    bad_mask = d8.mask.clone()
    if r == 1:
        bad_mask[0, 0] = 0.0
    try:
        rx.rescale(dataclasses.replace(d8, mask=bad_mask), 12)
        meta["layout_error"] = None
    except ValueError as e:
        meta["layout_error"] = str(e)
    meta["after_error_sum"] = float(MH.all_reduce(torch.ones(1), group, "sum")[0])  # the group still works

    meta["segment_rf_launches"] = segment_rf.launches
    meta["jax_loaded"] = any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules)
    dist.destroy_process_group()
    np.savez(out_dir / f"rank{r}.npz", **arrays)
    (out_dir / f"rank{r}.json").write_text(json.dumps(meta))


# ------------------------------------------------------------------ parent
def _reference():
    """The JAX package's modules, imported in the parent only."""
    from repro.core import cep as J_cep
    from repro.core import ordering as J_ordering
    from repro.core.graph import rmat_graph as J_rmat
    from repro.elastic import rescale_exec as J_RX
    from repro.graphs import engine as J_E
    from repro.launch import mesh as J_MM
    from repro.launch import multihost as J_MH
    from repro.launch import sharding as J_SH

    return types.SimpleNamespace(cep=J_cep, ordering=J_ordering, rmat=J_rmat, RX=J_RX, E=J_E, MM=J_MM,
                                 MH=J_MH, SH=J_SH)


def _stand_in_mesh(processes):
    """What the reference's ``device_process_map`` and ``graph_axis_size``
    read of a mesh: a ``graph`` axis of devices carrying ``process_index``."""
    devs = np.empty(len(processes), dtype=object)
    devs[:] = [types.SimpleNamespace(process_index=int(p)) for p in processes]
    return types.SimpleNamespace(shape={"graph": len(processes)}, devices=devs)


@pytest.fixture(scope="module")
def J():
    return _reference()


@pytest.fixture(scope="module")
def cluster(J, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_multihost")
    jg = J.rmat(8, 6, seed=0)
    order = J.ordering.geo_order(jg, seed=0)
    src, dst = jg.src[order].astype(np.int32), jg.dst[order].astype(np.int32)
    deg = np.bincount(np.concatenate([src, dst]), minlength=jg.num_vertices)
    np.savez(out / "inputs.npz", src=src, dst=dst, num_vertices=jg.num_vertices, source=int(np.argmax(deg)))
    rng = np.random.default_rng(0)
    n_slots = SLOT_K * SLOT_SPR
    np.savez(out / "slots.npz", src=rng.integers(0, jg.num_vertices, n_slots).astype(np.int64),
             dst=rng.integers(0, jg.num_vertices, n_slots).astype(np.int64), valid=rng.random(n_slots) < 0.7)
    res = MH.spawn_local_cluster(
        N_PROCS, DEVS_PER_PROC, [str(pathlib.Path(__file__).resolve()), "worker", str(out)],
        backend="gloo", devices=["cpu"] * G, timeout=CLUSTER_TIMEOUT_S,
        env_extra={"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"},
    )
    assert res.ok, res.format_logs()
    ranks = [(dict(np.load(out / f"rank{r}.npz")), json.loads((out / f"rank{r}.json").read_text()))
             for r in range(G)]
    return types.SimpleNamespace(jg=jg, src=src, dst=dst, source=int(np.argmax(deg)), ranks=ranks,
                                 slots=dict(np.load(out / "slots.npz")), result=res)


def _reassembled(cluster, name: str, k: int):
    """The global buffers from every rank's block, in rank order, and the
    partition-major pack (rows un-permuted) with the padding rows apart."""
    edges = np.concatenate([a[f"{name}_edges"] for a, _ in cluster.ranks])
    mask = np.concatenate([a[f"{name}_mask"] for a, _ in cluster.ranks])
    rows = [SH.partition_row(p, k, G) for p in range(k)]
    pad = np.setdiff1d(np.arange(edges.shape[0]), rows)
    return edges[rows], mask[rows], edges[pad], mask[pad]


def _assert_equals_jax_pack(cluster, J, name: str, k: int):
    edges, mask, pad_e, pad_m = _reassembled(cluster, name, k)
    want = J.E.pack_ordered(cluster.src, cluster.dst, cluster.jg.num_vertices, k)
    assert edges.dtype == np.int32 and mask.dtype == np.float32
    assert edges.tobytes() == np.asarray(want.edges).tobytes()
    assert mask.tobytes() == np.asarray(want.mask).tobytes()
    assert not pad_e.any() and not pad_m.any()
    return want


def test_workers_ran_as_a_gloo_group_without_jax(cluster):
    for r, (_, meta) in enumerate(cluster.ranks):
        assert meta["group"] == [G, r, "gloo", [0, 0, 1, 1]]
        assert meta["jax_loaded"] is False
    assert [(p.process_id, p.rank) for p in cluster.result.procs] == [(r // 2, r) for r in range(G)]


@pytest.mark.parametrize("k", ROW_KS)
def test_rows_per_rank_follow_round_robin(cluster, J, k):
    m = SH.padded_partition_count(k, G) // G
    for d, (_, meta) in enumerate(cluster.ranks):
        info = meta[f"pack{k}"]
        assert info["block"] == [d * m, (d + 1) * m] and info["rows"] == m and info["k_pad"] == m * G
        assert info["parts"] == [SH.row_partition(r, k, G) for r in range(d * m, (d + 1) * m)]
        assert all(SH.partition_device(p, G) == d for p in info["parts"] if p < k)
    want = _assert_equals_jax_pack(cluster, J, f"pack{k}", k)
    assert {(meta[f"pack{k}"]["mirrors"], meta[f"pack{k}"]["rf"]) for _, meta in cluster.ranks} == {
        (want.mirrors, want.replication_factor)}


def test_rescale_8_12_8_byte_equal_to_jax_pack_ordered(cluster, J):
    _assert_equals_jax_pack(cluster, J, "chain12", 12)
    want8 = _assert_equals_jax_pack(cluster, J, "chain8", 8)
    n = cluster.jg.num_edges
    for _, meta in cluster.ranks:
        for st, (k_old, k_new) in zip(meta["chain_stats"], CHAIN):
            plan = J.cep.scale_plan(n, k_old, k_new)
            assert st["oracle_checked"] and st["devices"] == G and st["processes"] == N_PROCS
            assert st["migrated_bytes"] == plan.migrated_bytes(EDGE_BYTES)
            assert st["cross_device_edges"] + st["on_device_edges"] == st["migrated_edges"]
        assert meta["chain8"]["mirrors"] == want8.mirrors


@pytest.mark.parametrize("k_old,k_new", PAIRS)
def test_awkward_pairs_byte_equal_with_cross_rank_and_process_accounting(cluster, J, k_old, k_new):
    want = _assert_equals_jax_pack(cluster, J, f"pair{k_old}_{k_new}", k_new)
    plan = J.cep.scale_plan(cluster.jg.num_edges, k_old, k_new)
    cross = sum(hi - lo for lo, hi, s, d in plan.moves if s % G != d % G)
    xproc = J.RX.cross_process_plan_edges(plan, _stand_in_mesh([r // DEVS_PER_PROC for r in range(G)]))
    stats = [meta[f"pair{k_old}_{k_new}_stats"] for _, meta in cluster.ranks]
    assert all(st == {**stats[0], "elapsed_s": st["elapsed_s"], "recheck_s": st["recheck_s"]} for st in stats)
    st = stats[0]
    assert st["oracle_checked"] and (st["devices"], st["processes"]) == (G, N_PROCS)
    assert (st["cross_device_edges"], st["cross_device_bytes"]) == (cross, cross * EDGE_BYTES)
    assert (st["cross_process_edges"], st["cross_process_bytes"]) == (xproc, xproc * EDGE_BYTES)
    assert st["on_device_edges"] == plan.migrated_edges - cross
    assert {meta[f"pair{k_old}_{k_new}"]["mirrors"] for _, meta in cluster.ranks} == {want.mirrors}


@pytest.mark.parametrize("rescale", [f"{a}_{b}" for a, b in CHAIN + PAIRS])
def test_segment_tables_leave_the_receive_ranges_to_the_peers_sends(cluster, rescale):
    """Each rank's migration table covers its block once; its receive ranges
    are the ranges that the other ranks send it (one send a receive, equal
    lengths, by tag), and the copies and receives over all ranks are the
    plan's segments. Re-run into a block holding a sentinel, the migration
    leaves exactly the receive ranges unwritten, and no rank launched the
    kernel on the CPU."""
    k_old, k_new = map(int, rescale.split("_"))
    plan = cep.scale_plan(cluster.jg.num_edges, k_old, k_new)
    tables = [meta["tables"][rescale] for _, meta in cluster.ranks]
    for me, t in enumerate(tables):
        covered = np.zeros((t["rows"], t["width"]), dtype=np.int64)
        for row, a, b, *_ in t["pieces"]:
            covered[row, a:b] += 1
        assert (covered == 1).all()
        recvs = [(row, a, b) for row, a, b, kind, *_ in t["pieces"] if kind == rescale_migrate.RECV]
        assert sorted(recvs) == sorted((r, a, b) for _, r, a, b, _ in t["recvs"])
        for owner, r, a, b, tag in t["recvs"]:
            (send,) = [s for s in tables[owner]["sends"] if (s[0], s[4]) == (me, tag)]
            assert owner != me and send[3] - send[2] == b - a
    copies = sum(sum(1 for p in t["pieces"] if p[3] >= 0) + len(t["recvs"]) for t in tables)
    assert copies == len(plan_segments(plan))
    assert sum(len(t["sends"]) for t in tables) == sum(len(t["recvs"]) for t in tables)
    name = {"8_12": "chain12", "12_8": "chain8"}.get(rescale, f"pair{rescale}")
    assert all(meta["recv_left"][name] for _, meta in cluster.ranks)
    assert all(meta["rescale_migrate_launches"] == 0 for _, meta in cluster.ranks)


def test_cross_process_plan_edges_equals_reference(J):
    from repro_torch.elastic.rescale_exec import cross_process_plan_edges

    for procs in ([0, 0, 1, 1], [0, 1, 0, 1], [0, 0, 0, 0], [0, 1, 2, 3], [0, 0, 0, 1, 1, 1]):
        group = GraphGroup(size=len(procs), rank=0, device="cpu", backend="gloo", processes=tuple(procs))
        for k_old, k_new in PAIRS + CHAIN:
            plan = cep.scale_plan(5000, k_old, k_new)
            want = J.RX.cross_process_plan_edges(J.cep.scale_plan(5000, k_old, k_new), _stand_in_mesh(procs))
            assert cross_process_plan_edges(plan, group) == want
    assert cross_process_plan_edges(cep.scale_plan(5000, 3, 7), None) == 0


def test_rescale_traffic_is_what_the_plan_sends_across_ranks(cluster):
    """Each rank's sent and received bytes (metrics) sum over the ranks to the
    plan's cross-rank bytes: nothing else crosses, nothing is lost."""
    glob = cluster.ranks[0][1]["snapshot_global"]
    stats = [*cluster.ranks[0][1]["chain_stats"], *(cluster.ranks[0][1][f"pair{a}_{b}_stats"] for a, b in PAIRS)]
    cross = sum(st["cross_device_bytes"] for st in stats)
    assert glob["rescale.sent_bytes"] == glob["rescale.received_bytes"] == [cross]
    assert glob["rescale.cross_device_bytes"] == [G * cross]  # every rank counts the plan's bill


@pytest.mark.parametrize("k", APP_KS)
def test_gas_apps_match_jax_replicated_engine(cluster, J, k):
    jdata = J.E.pack_ordered(cluster.src, cluster.dst, cluster.jg.num_vertices, k)
    mesh = J.MM.make_test_mesh(data=1, model=1)
    pr = np.asarray(J.E.pagerank(jdata, mesh, iterations=20))
    ss, ss_it = J.E.sssp(jdata, mesh, source=cluster.source)
    wc, wc_it = J.E.wcc(jdata, mesh)
    for arrays, meta in cluster.ranks:
        np.testing.assert_allclose(arrays[f"pagerank{k}"], pr, rtol=1e-5, atol=1e-7)
        assert np.array_equal(arrays[f"sssp{k}"], np.asarray(ss)) and meta[f"sssp{k}_it"] == ss_it
        assert np.array_equal(arrays[f"wcc{k}"], np.asarray(wc)) and meta[f"wcc{k}_it"] == wc_it
    # The combine leaves every rank with the same vertex state, bit for bit.
    assert all(np.array_equal(a[f"pagerank{k}"], cluster.ranks[0][0][f"pagerank{k}"]) for a, _ in cluster.ranks)


def test_pack_slots_sharded_stream_equals_jax_pack_slots(cluster, J):
    s = cluster.slots
    want = J.E.pack_slots(s["src"], s["dst"], s["valid"], SLOT_K, cluster.jg.num_vertices)
    edges, mask, pad_e, pad_m = _reassembled(cluster, "slots", SLOT_K)
    assert edges.tobytes() == np.asarray(want.edges).tobytes()
    assert mask.tobytes() == np.asarray(want.mask).tobytes()
    assert not pad_e.any() and not pad_m.any()
    for d, (arrays, meta) in enumerate(cluster.ranks):
        assert arrays["slots_degrees"].tobytes() == np.asarray(want.degrees).tobytes()
        assert meta["slots"]["num_edges"] == want.num_edges
        assert meta["local_slot_partitions"] == [p for p in range(SLOT_K) if p % G == d]
        assert meta["slot_parts_called"] == meta["local_slot_partitions"]  # only its own partitions


def test_psum_host_host_read_and_local_shard_rows(cluster, J):
    want6 = np.concatenate([a["pack6_edges"] for a, _ in cluster.ranks])
    for d, (arrays, meta) in enumerate(cluster.ranks):
        np.testing.assert_array_equal(arrays["psum"], np.arange(5, dtype=np.float64) * sum(range(1, G + 1)))
        assert arrays["host_read6"].tobytes() == want6.tobytes()
        m = want6.shape[0] // G
        assert meta["local_shard_rows6"] == [[d * m, (d + 1) * m, [m, *want6.shape[1:]]]]


def test_snapshot_global_equals_sum_of_locals(cluster):
    locals_ = [meta["snapshot_local"] for _, meta in cluster.ranks]
    glob = cluster.ranks[0][1]["snapshot_global"]
    assert sorted(glob) == sorted(locals_[0])
    for name, value in glob.items():
        # Float sums may round in another order than np.sum's; counts are exact.
        np.testing.assert_allclose(value, np.sum([loc[name] for loc in locals_], axis=0), rtol=1e-12, atol=0)
    assert all(meta["snapshot_global"] == glob for _, meta in cluster.ranks)
    assert glob["test.rank_plus_one"] == [sum(range(1, G + 1))]
    # One peak-RSS gauge per rank, each carrying only its own process's value.
    for r, loc in enumerate(locals_):
        assert glob[f"process.peak_rss_mb.p{r}"] == loc[f"process.peak_rss_mb.p{r}"] and loc[
            f"process.peak_rss_mb.p{r}"][0] > 0


def test_layout_error_raises_on_every_rank(cluster):
    errors = [meta["layout_error"] for _, meta in cluster.ranks]
    assert all(e is not None and "not CEP-chunked" in e for e in errors)
    assert "per-row edge counts" in errors[1]
    assert all("another rank" in e for i, e in enumerate(errors) if i != 1)
    assert {meta["after_error_sum"] for _, meta in cluster.ranks} == {float(G)}


# ---------------------------------------------------- without a cluster
def test_device_process_map_and_partition_process_equal_reference(J):
    assert SH.device_process_map(None).tolist() == J.SH.device_process_map(None).tolist() == [0]
    assert SH.partition_process(5, None) == J.SH.partition_process(5, None) == 0
    for procs in ([0, 0, 1, 1], [0, 1, 2], [0, 0, 0, 0, 1, 1, 1, 1]):
        group = GraphGroup(size=len(procs), rank=0, device="cpu", backend="gloo", processes=tuple(procs))
        mesh = _stand_in_mesh(procs)
        assert SH.device_process_map(group).tolist() == J.SH.device_process_map(mesh).tolist()
        assert SH.graph_axis_size(group) == J.SH.graph_axis_size(mesh)
        assert [SH.partition_process(p, group) for p in range(20)] == [
            J.SH.partition_process(p, mesh) for p in range(20)]


def test_lease_board_equals_reference_on_a_fake_clock(J, tmp_path):
    clk = [100.0]
    boards = [MH.LeaseBoard(tmp_path / "port", lease_s=1.5, clock=lambda: clk[0]),
              J.MH.LeaseBoard(tmp_path / "ref", lease_s=1.5, clock=lambda: clk[0])]
    script = [(0.0, 0, 1), (0.5, 1, 1), (1.0, 0, 2), (1.2, None, None), (0.4, 2, 5), (2.0, None, None)]
    for dt, pid, step in script:
        clk[0] += dt
        for b in boards:
            if pid is not None:
                b.stamp(pid, step)
        reads = [(b.dead(4), b.survivors(4), b.surviving_devices(4, 2), [b.step(p) for p in range(4)],
                  [round(b.age(p), 9) for p in range(4)]) for b in boards]
        assert reads[0] == reads[1]
    assert boards[0].wait_for_step(2, 5, timeout=1.0) == boards[1].wait_for_step(2, 5, timeout=1.0) == 5
    with pytest.raises(TimeoutError):
        boards[0].wait_for_step(3, 1, timeout=0.05)


def test_graph_group_and_cluster_spec():
    one = make_graph_group("cpu")
    assert (one.size, one.rank, one.distributed, one.process_count, one.row_block(6)) == (1, 0, False, 1, (0, 6))
    g = GraphGroup(size=4, rank=2, device="cpu", backend="gloo", processes=(0, 0, 1, 1))
    assert (g.distributed, g.process_count, g.row_block(8), g.torch_device) == (True, 2, (4, 6), torch.device("cpu"))
    for bad in (dict(size=2), dict(size=2, rank=2, backend="gloo", processes=(0, 0)),
                dict(size=2, backend="mpi", processes=(0, 0)), dict(size=2, backend="gloo", processes=(0,))):
        with pytest.raises(ValueError):
            GraphGroup(**bad)
    with pytest.raises(ValueError, match="evenly"):
        g.row_block(6)
    spec = MH.ClusterSpec("127.0.0.1:1234", num_processes=2, process_id=1, devs_per_proc=2, local_rank=1)
    assert (spec.world_size, spec.rank) == (4, 3)
    assert MH.initialize_from_env({}) is None
    assert 0 < MH.free_port() < 65536
    with pytest.raises(ValueError, match="NCCL"):
        MH.initialize_distributed("127.0.0.1:1", 1, 0, backend="nccl", device="cpu")


def test_world_of_one_helpers_need_no_process_group():
    one = make_graph_group("cpu")
    x = np.arange(6, dtype=np.float64).reshape(3, 2)
    assert np.array_equal(MH.psum_host(x, one), x) and MH.psum_host(x, one) is not x
    t = torch.arange(12).reshape(6, 2)
    assert MH.all_reduce(t, one) is t and MH.all_gather_rows(t, one) is t
    assert np.array_equal(MH.host_read(t, one), t.numpy())
    assert torch.equal(MH.put_global(t.numpy(), one), t)
    assert MH.local_shard_rows(t, one)[0][:2] == (0, 6)
    assert MH.exchange(one, [], []) == (0, 0)
    with pytest.raises(ValueError, match="does not cover"):
        MH.put_global_local(np.zeros((2, 2)), (4, 2), one)
    reg = OM.MetricsRegistry()
    reg.counter("a").inc(3)
    assert reg.snapshot_global(one) == reg.snapshot() == {"a": 3.0}
    assert OM.NULL.snapshot_global(one) == {}


def test_shard_engine_data_at_one_rank_returns_the_pack_uncopied(J):
    jg = J.rmat(6, 4, seed=0)
    data = E.pack_ordered(jg.src, jg.dst, jg.num_vertices, 4, device="cpu")
    s = E.shard_engine_data(data)
    assert all(getattr(s, n).data_ptr() == getattr(data, n).data_ptr() for n in ("edges", "mask", "degrees"))
    back = E.unshard_engine_data(s)  # the oracle layout is a copy, also at one rank
    assert all(getattr(back, n).data_ptr() != getattr(data, n).data_ptr() for n in ("edges", "mask", "degrees"))
    assert all(torch.equal(getattr(back, n), getattr(data, n)) for n in ("edges", "mask", "degrees"))


def test_pack_ordered_sharded_at_one_rank_equals_pack_ordered(J):
    jg = J.rmat(7, 6, seed=0)
    order = J.ordering.geo_order(jg, seed=0)
    src, dst = jg.src[order], jg.dst[order]
    for k in (1, 4, 17):
        want = E.pack_ordered(src, dst, jg.num_vertices, k, device="cpu")
        got = E.pack_ordered_sharded(src, dst, jg.num_vertices, k, device="cpu")
        assert all(torch.equal(getattr(got, n), getattr(want, n)) for n in ("edges", "mask", "degrees"))
        assert (got.mirrors, got.replication_factor, got.num_edges) == (want.mirrors, want.replication_factor,
                                                                       want.num_edges)
        new, st = ElasticRescaler().rescale(got, k + 3, verify=True)
        assert st.oracle_checked and (st.devices, st.processes, st.cross_device_edges) == (1, 1, 0)
        assert torch.equal(new.edges, E.pack_ordered(src, dst, jg.num_vertices, k + 3, device="cpu").edges)


if __name__ == "__main__":
    if sys.argv[1:2] != ["worker"]:
        sys.exit(f"usage: {sys.argv[0]} worker <dir>")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    worker(pathlib.Path(sys.argv[2]))
