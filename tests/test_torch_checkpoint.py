"""The port's checkpoint store (``checkpoint/store.py``) against the JAX
package's, on the same inputs.

* The tests of ``tests/test_checkpoint.py`` on the port: the on-disk CEP
  chunk layout, the streaming pack and slot state round-tripped through a
  resharded restore, the Thm.-2 bytes-touched bill, the typed errors.
* The port flattens a tree without ``jax.tree_util``: its leaf names and
  order equal the reference's (dicts by sorted key, lists, tuples,
  namedtuples, ``None``), and ``torch.Tensor`` leaves are saved through
  ``.cpu().numpy()``.
* A tree saved by either package restores in the other, with the same
  manifest JSON and byte-equal arrays.
* A ``SlotCheckpoint`` fed by the reference's orderer and one fed by the
  port's, on one stream with a rescale barrier, write the same manifests and
  WAL byte for byte and chunk files with byte-equal members (a zip entry
  also stamps the time it was written, so the archives themselves are
  compared by their members), and each package restores the other's
  directory to the same slots.

Exact everywhere.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import json
import zipfile
from collections import namedtuple

import numpy as np
import pytest
import torch

from repro.checkpoint import store as J_store
from repro.stream import IncrementalOrderer as J_IncrementalOrderer
from repro.stream import SyntheticStream as J_SyntheticStream
from repro.stream.incremental import StreamConfig as J_StreamConfig
from repro_torch.checkpoint import store
from repro_torch.core import cep, ordering
from repro_torch.core.graph import rmat_graph
from repro_torch.graphs import engine as GE
from repro_torch.stream import IncrementalOrderer, SyntheticStream
from repro_torch.stream.incremental import StreamConfig


@pytest.fixture(scope="module")
def slots():
    """Drifted slot arrays: stream a few batches so the slot array has real
    gaps/tombstones — the layout a checkpoint must preserve exactly."""
    g = rmat_graph(7, 6, seed=0)
    order = ordering.geo_order(g, seed=0)
    o = IncrementalOrderer(g.src[order].astype(np.int64), g.dst[order].astype(np.int64), g.num_vertices, regions=4)
    stream = SyntheticStream(g, batch_size=48, delete_frac=0.3, seed=5)
    for _ in range(6):
        o.apply(stream.batch())
    o.needs_resync = False
    o.drain_ops()
    return g, o


def orderer_tree(g, o):
    """The checkpointable orderer state: the slot triple IS the stream's
    durable state (dicts/devices rebuild from it)."""
    return {
        "slot": {"src": o.slot_src.copy(), "dst": o.slot_dst.copy(), "valid": o.slot_valid.copy()},
        "meta": np.asarray([g.num_vertices, o.regions], dtype=np.int64),
    }


# ------------------------------------------------------------ layout contract
def test_shard_files_hold_exact_cep_chunks(tmp_path, slots):
    g, o = slots
    tree = orderer_tree(g, o)
    k = 5
    d = store.save(tree, tmp_path, step=2, k_shards=k)
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["step"] == 2 and manifest["k_shards"] == k
    named = {t["name"]: t for t in manifest["tensors"]}
    assert set(named) == {"slot/src", "slot/dst", "slot/valid", "meta"}
    for h in range(k):
        with np.load(d / f"shard_{h}.npz") as z:
            for name in named:
                flat = np.asarray(tree["slot"][name.split("/")[1]] if "/" in name else tree[name]).reshape(-1)
                b = cep.chunk_bounds(flat.shape[0], k)
                np.testing.assert_array_equal(z[name], flat[int(b[h]):int(b[h + 1])])


def test_chunks_partition_each_tensor(tmp_path, slots):
    g, o = slots
    k = 3
    d = store.save(orderer_tree(g, o), tmp_path, step=0, k_shards=k)
    chunks = []
    for h in range(k):
        with np.load(d / f"shard_{h}.npz") as z:
            chunks.append(z["slot/src"])
    np.testing.assert_array_equal(np.concatenate(chunks), o.slot_src)


# ----------------------------------------------- pack_slots layout round-trip
@pytest.mark.parametrize("k_new", [4, 6, 2])
def test_pack_slots_layout_roundtrip_resharded(tmp_path, slots, k_new):
    """The streaming pack (torch tensors, saved as they are) plus the slot
    state round-trips byte-exactly through save at k=4 and restore at any k'."""
    g, o = slots
    pack = GE.pack_slots(o.slot_src, o.slot_dst, o.slot_valid, o.regions, g.num_vertices, device="cpu")
    tree = dict(orderer_tree(g, o), pack={"edges": pack.edges, "mask": pack.mask, "degrees": pack.degrees})
    store.save(tree, tmp_path, step=7, k_shards=4)
    restored, bytes_touched = store.restore(tmp_path, 7, k_new=k_new, template=tree)
    for name in ("src", "dst", "valid"):
        np.testing.assert_array_equal(restored["slot"][name], tree["slot"][name])
        assert restored["slot"][name].dtype == tree["slot"][name].dtype
    for name in ("edges", "mask", "degrees"):
        assert isinstance(restored["pack"][name], torch.Tensor)  # the template's leaf type
        assert torch.equal(restored["pack"][name], tree["pack"][name])
    repack = GE.pack_slots(restored["slot"]["src"], restored["slot"]["dst"], restored["slot"]["valid"],
                           o.regions, g.num_vertices, device="cpu")
    assert torch.equal(repack.edges, restored["pack"]["edges"])
    assert torch.equal(repack.mask, restored["pack"]["mask"])
    assert (bytes_touched == 0) == (k_new == 4)


def test_bytes_touched_matches_cep_model(tmp_path, slots):
    g, o = slots
    k_old, k_new = 4, 7
    store.save(orderer_tree(g, o), tmp_path, step=1, k_shards=k_old)
    _, bytes_touched = store.restore(tmp_path, 1, k_new=k_new)
    expect = sum(cep.migrated_edges_exact(np.asarray(a).size, k_old, k_new) * np.asarray(a).itemsize
                 for a in (o.slot_src, o.slot_dst, o.slot_valid, np.zeros(2, np.int64)))
    assert bytes_touched == expect
    total_bytes = sum(np.asarray(a).nbytes for a in (o.slot_src, o.slot_dst, o.slot_valid)) + 16
    assert bytes_touched < total_bytes


def test_restore_without_template_returns_named_dict(tmp_path, slots):
    g, o = slots
    store.save(orderer_tree(g, o), tmp_path, step=4, k_shards=3)
    arrays, bytes_touched = store.restore(tmp_path, 4, k_new=3)
    assert set(arrays) == {"slot/src", "slot/dst", "slot/valid", "meta"}
    np.testing.assert_array_equal(arrays["slot/valid"], o.slot_valid)
    assert bytes_touched == 0


def test_tiny_tensor_survives_more_shards_than_elements(tmp_path):
    tree = {"tiny": np.arange(3, dtype=np.int32), "scalar": np.float32(2.5)}
    store.save(tree, tmp_path, step=0, k_shards=6)
    arrays, _ = store.restore(tmp_path, 0, k_new=2)
    np.testing.assert_array_equal(arrays["tiny"], tree["tiny"])
    assert arrays["scalar"].shape == () and float(arrays["scalar"]) == 2.5


# -------------------------------------------------------------- error paths
def test_restore_missing_step_is_typed(tmp_path, slots):
    g, o = slots
    store.save(orderer_tree(g, o), tmp_path, step=3, k_shards=2)
    with pytest.raises(store.MissingStepError, match="step 9"):
        store.restore(tmp_path, 9, k_new=2)
    assert issubclass(store.MissingStepError, store.CheckpointError)


def test_restore_mismatched_template_treedef(tmp_path, slots):
    g, o = slots
    store.save(orderer_tree(g, o), tmp_path, step=0, k_shards=2)
    bad = {"slot": {"src": o.slot_src, "dst": o.slot_dst}, "extra": np.zeros(3)}
    with pytest.raises(store.TemplateMismatchError) as ei:
        store.restore(tmp_path, 0, k_new=2, template=bad)
    assert "extra" in str(ei.value) and "slot/valid" in str(ei.value)


def test_restore_missing_shard_file(tmp_path, slots):
    g, o = slots
    d = store.save(orderer_tree(g, o), tmp_path, step=1, k_shards=3)
    (d / "shard_1.npz").unlink()
    with pytest.raises(store.CorruptShardError, match="shard_1.npz missing"):
        store.restore(tmp_path, 1, k_new=3)


def test_restore_truncated_shard_file(tmp_path, slots):
    g, o = slots
    d = store.save(orderer_tree(g, o), tmp_path, step=1, k_shards=3)
    blob = (d / "shard_2.npz").read_bytes()
    (d / "shard_2.npz").write_bytes(blob[: len(blob) // 2])
    with pytest.raises(store.CorruptShardError, match="shard_2.npz"):
        store.restore(tmp_path, 1, k_new=3)


def test_restore_wrong_chunk_shape(tmp_path, slots):
    g, o = slots
    d = store.save(orderer_tree(g, o), tmp_path, step=2, k_shards=2)
    with np.load(d / "shard_0.npz") as z:
        tensors = {n: z[n] for n in z.files}
    tensors["slot/src"] = tensors["slot/src"][:-1]
    np.savez(d / "shard_0.npz", **tensors)
    with pytest.raises(store.CorruptShardError, match="manifest chunk"):
        store.restore(tmp_path, 2, k_new=2)


def test_slot_checkpoint_restore_without_manifest(tmp_path):
    with pytest.raises(store.MissingStepError, match="no manifest"):
        store.SlotCheckpoint(tmp_path).restore()


def _fresh_ck_pipeline(tmp_path, slots, interval=2):
    g, o_seed = slots
    o = IncrementalOrderer(o_seed.slot_src[o_seed.slot_valid].copy(), o_seed.slot_dst[o_seed.slot_valid].copy(),
                           g.num_vertices, regions=4)
    ck = store.SlotCheckpoint(tmp_path, interval=interval)
    stream = SyntheticStream(g, batch_size=32, delete_frac=0.3, seed=7)
    for step in range(4):
        b = stream.batch()
        o.apply(b)
        o.needs_resync = False
        o.drain_ops()
        ck.note_batch(o, b, step)
    return o, ck


def test_slot_checkpoint_missing_chunk_file(tmp_path, slots):
    _fresh_ck_pipeline(tmp_path, slots)
    next(tmp_path.glob("chunk_r2_s*.npz")).unlink()
    with pytest.raises(store.CorruptShardError, match="chunk_r2"):
        store.SlotCheckpoint(tmp_path).restore()


def test_slot_checkpoint_truncated_chunk_file(tmp_path, slots):
    _fresh_ck_pipeline(tmp_path, slots)
    victim = next(tmp_path.glob("chunk_r1_s*.npz"))
    blob = victim.read_bytes()
    victim.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(store.CorruptShardError, match="unreadable"):
        store.SlotCheckpoint(tmp_path).restore()


def test_slot_checkpoint_manifest_missing_region(tmp_path, slots):
    _fresh_ck_pipeline(tmp_path, slots)
    m = max(tmp_path.glob("manifest_*.json"), key=lambda p: int(p.stem.split("_")[1]))
    doc = json.loads(m.read_text())
    del doc["chunk_step"]["3"]
    m.write_text(json.dumps(doc))
    with pytest.raises(store.CorruptShardError, match="lacks region 3"):
        store.SlotCheckpoint(tmp_path).restore()


# ---------------------------------------------- the local flatten vs tree_util
Pair = namedtuple("Pair", ["left", "right"])
TREES = {
    "nested-dict": lambda: {"b": {"y": np.arange(3), "x": np.ones((2, 2))}, "a": np.float32(1.5)},
    "lists-tuples": lambda: [np.arange(4), (np.zeros(2), [np.ones(1), np.int64(7)])],
    "none-leaves": lambda: {"keep": np.arange(2), "gone": None, "list": [None, np.ones(3)]},
    "namedtuple": lambda: {"p": Pair(np.arange(2), Pair(np.ones(1), np.zeros(3)))},
    "int-keys": lambda: {3: np.arange(2), 1: {12: np.ones(2), 0: np.zeros(1)}},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_leaf_names_and_order_equal_jax_tree_util(name):
    tree = TREES[name]()
    got, want = store._flatten_named(tree), J_store._flatten_named(tree)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(TREES))
def test_template_restore_rebuilds_the_tree_as_the_reference(tmp_path, name):
    tree = TREES[name]()
    store.save(tree, tmp_path, step=0, k_shards=2)
    got, _ = store.restore(tmp_path, 0, k_new=3, template=tree)
    want, _ = J_store.restore(tmp_path, 0, k_new=3, template=tree)
    got_l, want_l = store._flatten_named(got), J_store._flatten_named(want)
    assert [n for n, _ in got_l] == [n for n, _ in want_l]
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for (_, a), (_, b) in zip(got_l, want_l))
    assert type(got) is type(want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tree_saved_by_one_package_restores_in_the_other(tmp_path, slots, writer):
    g, o = slots
    tree = orderer_tree(g, o)
    save, load = (store.save, J_store.restore) if writer == "port" else (J_store.save, store.restore)
    other_save = J_store.save if writer == "port" else store.save
    d = save(tree, tmp_path / "a", step=5, k_shards=3)
    other = other_save(tree, tmp_path / "b", step=5, k_shards=3)
    assert (d / "manifest.json").read_text() == (other / "manifest.json").read_text()
    for h in range(3):
        with np.load(d / f"shard_{h}.npz") as z, np.load(other / f"shard_{h}.npz") as w:
            assert z.files == w.files and all(z[n].tobytes() == w[n].tobytes() for n in z.files)
    arrays, touched = load(tmp_path / "a", 5, k_new=4)
    arrays_again, touched_again = (store.restore if writer == "port" else J_store.restore)(tmp_path / "a", 5, k_new=4)
    assert touched == touched_again and set(arrays) == set(arrays_again)
    for n in arrays:
        assert arrays[n].dtype == arrays_again[n].dtype and arrays[n].tobytes() == arrays_again[n].tobytes()


def test_torch_tensor_leaves_save_as_their_numpy_values(tmp_path, slots):
    g, o = slots
    tree = {"src": torch.from_numpy(o.slot_src.copy()), "valid": torch.from_numpy(o.slot_valid.copy()),
            "w": torch.arange(10, dtype=torch.float32)}
    store.save(tree, tmp_path, step=0, k_shards=3)
    arrays, _ = J_store.restore(tmp_path, 0, k_new=3)  # the reference reads it as numpy
    np.testing.assert_array_equal(arrays["src"], o.slot_src)
    assert arrays["valid"].dtype == np.bool_ and arrays["w"].dtype == np.float32
    back, _ = store.restore(tmp_path, 0, k_new=2, template=tree)
    assert all(isinstance(back[n], torch.Tensor) and torch.equal(back[n], tree[n]) for n in tree)


# -------------------------------------------- slot checkpoints, both orderers
def _drive(orderer_cls, ck_cls, cfg, g, src, dst, directory, interval=3):
    """One stream with a rescale barrier through an orderer and a
    ``SlotCheckpoint`` of one package. Returns the orderer."""
    o = orderer_cls(src, dst, g.num_vertices, regions=4, config=cfg)
    ck = ck_cls(directory, interval=interval)
    stream = (SyntheticStream if orderer_cls is IncrementalOrderer else J_SyntheticStream)(
        g, batch_size=32, delete_frac=0.3, seed=9)
    for step in range(6):  # snapshots at 0 and 3; the WAL tail: batch 4, the barrier, batch 5
        b = stream.batch()
        o.apply(b)
        o.needs_resync = False
        o.drain_ops()
        ck.note_batch(o, b, step)
        if step == 4:
            o.relayout(6)
            o.drain_gather_map()
            o.needs_resync = False
            ck.note_scale(o, 6, step)
    return o


def _zip_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.fixture(scope="module")
def both_dirs(tmp_path_factory, slots):
    g, _ = slots
    order = ordering.geo_order(g, seed=0)
    src, dst = g.src[order].astype(np.int64), g.dst[order].astype(np.int64)
    d = tmp_path_factory.mktemp("slotck")
    cfg, jcfg = (c(partial_drift=99.0, full_drift=999.0) for c in (StreamConfig, J_StreamConfig))
    o = _drive(IncrementalOrderer, store.SlotCheckpoint, cfg, g, src, dst, d / "port")
    jo = _drive(J_IncrementalOrderer, J_store.SlotCheckpoint, jcfg, g, src, dst, d / "jax")
    return d / "port", d / "jax", o, jo


def test_slot_checkpoints_of_both_orderers_write_the_same_directory(both_dirs):
    port, jax_dir, o, jo = both_dirs
    np.testing.assert_array_equal(o.slot_src, jo.slot_src)
    names = sorted(p.name for p in port.iterdir())
    assert names == sorted(p.name for p in jax_dir.iterdir())
    assert any(n.startswith("manifest_") for n in names) and "wal.jsonl" in names
    for n in names:
        if n.endswith(".npz"):
            assert _zip_members(port / n) == _zip_members(jax_dir / n), n
        else:
            assert (port / n).read_bytes() == (jax_dir / n).read_bytes(), n
    wal = [json.loads(line) for line in (port / "wal.jsonl").read_text().splitlines()]
    assert {r["kind"] for r in wal} == {"batch", "scale"}  # the tail crosses the rescale barrier


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_package_restores_the_others_slot_checkpoint(both_dirs, reader):
    port, jax_dir, o, jo = both_dirs
    if reader == "port":
        got, info = store.SlotCheckpoint(jax_dir).restore(config=StreamConfig(partial_drift=99.0, full_drift=999.0))
        want, winfo = store.SlotCheckpoint(port).restore(config=StreamConfig(partial_drift=99.0, full_drift=999.0))
    else:
        got, info = J_store.SlotCheckpoint(port).restore(config=J_StreamConfig(partial_drift=99.0, full_drift=999.0))
        want, winfo = J_store.SlotCheckpoint(jax_dir).restore(
            config=J_StreamConfig(partial_drift=99.0, full_drift=999.0))
    assert info == winfo and info["replayed"] > 0 and got.regions == 6
    for a, b, live in ((got.slot_src, want.slot_src, o.slot_src), (got.slot_dst, want.slot_dst, o.slot_dst),
                       (got.slot_valid, want.slot_valid, o.slot_valid)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, live)  # the restore IS the live state at the last batch
    assert got._baseline_kappa == jo._baseline_kappa and got._cooldown == jo._cooldown


def test_restore_partitions_equal_reference(tmp_path, slots):
    g, _ = slots
    order = ordering.geo_order(g, seed=0)
    src, dst = g.src[order].astype(np.int64), g.dst[order].astype(np.int64)
    o = IncrementalOrderer(src, dst, g.num_vertices, regions=4)
    ck = store.SlotCheckpoint(tmp_path, interval=3)
    stream = SyntheticStream(g, batch_size=32, delete_frac=0.3, seed=9)
    for step in range(5):  # snapshots at 0, 3; the WAL tail covers 4
        b = stream.batch()
        o.apply(b)
        o.needs_resync = False
        o.drain_ops()
        ck.note_batch(o, b, step)
    got, info = ck.restore_partitions([1, 3])
    want, winfo = J_store.SlotCheckpoint(tmp_path).restore_partitions([1, 3])
    assert info == winfo and info["replayed_ops"] > 0
    spr = o.slots_per_region
    for r in (1, 3):
        for a, b, live in zip(got[r], want[r], (o.slot_src, o.slot_dst, o.slot_valid)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, live[r * spr:(r + 1) * spr])
