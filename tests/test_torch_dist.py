"""The port's LM over ranks (``repro_torch.models.dist``, the SP branch of
``models/layers.py attention_block``, the rank's share of ``init_cache``)
against the JAX package's, on gloo ranks on the CPU.

Two local clusters started through the port's ``launch_local_cluster`` run
this file as their worker (``python tests/test_torch_dist.py worker <mode>
<dir>``, no JAX there), one process a rank at one thread:

* ``attention``: 8 ranks as the reference test's 2 × 4 ``("data", "model")``
  grid. ``sp_decode_attention`` on each rank's rows and cache slice, with and
  without window and softcap, is held within 2e-5 of the reference's
  ``sp_decode_attention`` on 8 forced host devices (a child process, as
  ``tests/test_multidevice.py:16 run_with_devices``) and of its
  ``mea_attention`` oracle. ``sp_cache_update`` at positions 0, 7, 8 and 31:
  the owner's slice holds the token, every other slice stays zero, byte-equal
  to the reference's.
* ``decode``: 4 ranks as a 2 × 2 grid. The smoke configs of qwen3-8b,
  gemma3-4b, deepseek-moe-16b and hymba-1.5b (the harness's random weights):
  a prefill of 40 tokens leaving each rank its cache slice, then 3 SP decode
  steps, held within rtol / atol 5e-4 of the reference's plain
  ``forward_prefill`` and ``forward_decode`` on the whole batch (the
  reference's SP forward raises on its sharding hints in jax 0.9.0). The two
  ranks of a data row give the same logits bit for bit.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":  # the worker: make the port importable without pytest's path setup
    sys.path.insert(0, str(ROOT / "src"))

import torch_lm_harness as H  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as MM  # noqa: E402
from repro_torch.launch import multihost as MH  # noqa: E402
from repro_torch.models import dist as D  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

GROUP_TIMEOUT_S = 60.0
CLUSTER_TIMEOUT_S = 240.0
ATTN_GRID, DECODE_GRID = (2, 4), (2, 2)
ATTN = dict(b=4, hq=8, hkv=2, hd=16, s=64, pos=40)  # tests/test_multidevice.py:44
ATTN_VARIANTS = {"plain": dict(window=None, softcap=None), "window_softcap": dict(window=16, softcap=20.0)}
CACHE = dict(b=2, hkv=2, s=32, hd=8)
CACHE_POSITIONS = (0, 7, 8, 31)
ATTN_TOL = 2e-5
DECODE_ARCHS = ("qwen3-8b", "gemma3-4b", "deepseek-moe-16b", "hymba-1.5b")
DECODE = dict(batch=4, seq=40, max_len=48, steps=3)  # past the smoke window of 32; the prefill spans both slices
DECODE_TOL = 5e-4


def attention_inputs() -> dict:
    rng = np.random.default_rng(0)
    a = ATTN
    return {"q": rng.standard_normal((a["b"], a["hq"], 1, a["hd"])).astype(np.float32),
            "ck": rng.standard_normal((a["b"], a["hkv"], a["s"], a["hd"])).astype(np.float32),
            "cv": rng.standard_normal((a["b"], a["hkv"], a["s"], a["hd"])).astype(np.float32)}


def decode_inputs(cfg) -> dict:
    rng = np.random.default_rng([1, cfg.vocab_size])
    return {"tokens": rng.integers(0, cfg.vocab_size, (DECODE["batch"], DECODE["seq"])).astype(np.int64),
            "next": rng.integers(0, cfg.vocab_size, (DECODE["steps"], DECODE["batch"], 1)).astype(np.int64)}


# ------------------------------------------------------------------ worker
def worker(mode: str, out_dir: pathlib.Path) -> None:
    group = MH.initialize_from_env(timeout_s=GROUP_TIMEOUT_S)
    out: dict = {}
    if mode == "attention":
        dist = D.Distribution(mesh=MM.make_test_mesh(*ATTN_GRID, group=group))
        inp = attention_inputs()
        lo, hi = dist.batch_rows(ATTN["b"])
        slo, shi = dist.seq_slice(ATTN["s"])
        q = torch.from_numpy(inp["q"][lo:hi])
        ck, cv = (torch.from_numpy(np.ascontiguousarray(inp[n][lo:hi, :, slo:shi])) for n in ("ck", "cv"))
        for name, kw in ATTN_VARIANTS.items():
            out[f"attn_{name}"] = D.sp_decode_attention(dist, q, ck, cv, ATTN["pos"], scale=ATTN["hd"] ** -0.5,
                                                        **kw).numpy()
        clo, chi = dist.batch_rows(CACHE["b"])
        cs_lo, cs_hi = dist.seq_slice(CACHE["s"])
        for pos in CACHE_POSITIONS:
            cache = torch.zeros(chi - clo, CACHE["hkv"], cs_hi - cs_lo, CACHE["hd"])
            got = D.sp_cache_update(dist, cache, torch.ones(chi - clo, CACHE["hkv"], 1, CACHE["hd"]), pos)
            assert got is cache
            out[f"cache_{pos}"] = cache.numpy()
    else:
        dist = D.Distribution(mesh=MM.make_test_mesh(*DECODE_GRID, group=group))
        lo, hi = dist.batch_rows(DECODE["batch"])
        for arch in DECODE_ARCHS:
            cfg = configs.get_smoke(arch)
            model = M.params_from_numpy(cfg, H.numpy_params(M.param_shapes(cfg)), device="cpu")
            inp = decode_inputs(cfg)
            with torch.inference_mode(), D.use_distribution(dist):
                cache = M.init_cache(cfg, DECODE["batch"], DECODE["max_len"], device="cpu")
                out[f"{arch}|cache_shape"] = np.asarray(cache["k"].shape)
                logits, _ = M.forward_prefill(model, cfg, {"tokens": torch.from_numpy(inp["tokens"][lo:hi])}, cache)
                out[f"{arch}|prefill"] = logits.numpy()
                for i in range(DECODE["steps"]):
                    logits, _ = M.forward_decode(model, cfg, torch.from_numpy(inp["next"][i][lo:hi]), cache)
                    out[f"{arch}|decode{i}"] = logits.numpy()
                out[f"{arch}|pos"] = np.asarray(cache["pos"])
    np.savez(out_dir / f"rank{group.rank}.npz", **out)
    (out_dir / f"rank{group.rank}.json").write_text(json.dumps({"jax_loaded": "jax" in sys.modules}))


# ------------------------------------------------------------ the reference
REFERENCE_CHILD = """
import sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import test_torch_dist as T
from repro.launch import mesh as MM
from repro.models import dist as D
from repro.models import layers as L

mesh = MM.make_test_mesh(data=2, model=4)
dist = D.Distribution(mesh=mesh, batch_axes=("data",), seq_axes=("model",))
inp = {{k: jnp.asarray(v) for k, v in T.attention_inputs().items()}}
a = T.ATTN
pos = jnp.asarray(a["pos"], jnp.int32)
out = {{}}
for name, kw in T.ATTN_VARIANTS.items():
    w = None if kw["window"] is None else jnp.asarray(kw["window"])
    with mesh:
        out["attn_" + name] = jax.jit(lambda q, k, v: D.sp_decode_attention(
            dist, q, k, v, pos, window=w, softcap=kw["softcap"], scale=a["hd"] ** -0.5))(inp["q"], inp["ck"], inp["cv"])
    out["mea_" + name] = L.mea_attention(inp["q"], inp["ck"], inp["cv"], causal=True, q_offset=pos, window=w,
                                         softcap=kw["softcap"], kv_len=jnp.full((a["b"],), pos + 1, jnp.int32))
c = T.CACHE
cache = jnp.zeros((c["b"], c["hkv"], c["s"], c["hd"]))
newk = jnp.ones((c["b"], c["hkv"], 1, c["hd"]))
for p in T.CACHE_POSITIONS:
    with mesh:
        out["cache_%d" % p] = jax.jit(lambda cc, n: D.sp_cache_update(dist, cc, n, jnp.asarray(p)))(cache, newk)
np.savez({out!r}, **{{k: np.asarray(v) for k, v in out.items()}})
"""


def _reference_child(out: pathlib.Path) -> subprocess.Popen:
    from repro.launch.multihost import force_host_device_flags

    env = dict(os.environ)
    env["XLA_FLAGS"] = force_host_device_flags(8, env.get("XLA_FLAGS", ""))
    env["PYTHONPATH"] = str(ROOT / "src")
    code = REFERENCE_CHILD.format(tests=str(ROOT / "tests"), out=str(out))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], env=env, cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _reference_decode(arch: str) -> dict:
    """The reference's plain prefill and decode steps on the whole batch."""
    import jax
    import jax.numpy as jnp
    from repro import configs as J_configs
    from repro.models import model as JM

    cfg = J_configs.get_smoke(arch)
    params = jax.tree.map(jnp.asarray, H.numpy_params(M.param_shapes(configs.get_smoke(arch))))
    inp = decode_inputs(cfg)
    cache = JM.init_cache(cfg, DECODE["batch"], DECODE["max_len"])
    logits, cache = jax.jit(lambda p, b, c: JM.forward_prefill(p, cfg, b, c))(
        params, {"tokens": jnp.asarray(inp["tokens"], jnp.int32)}, cache)
    out = {"prefill": np.asarray(logits)}
    step = jax.jit(lambda p, t, c: JM.forward_decode(p, cfg, t, c))
    for i in range(DECODE["steps"]):
        logits, cache = step(params, jnp.asarray(inp["next"][i], jnp.int32), cache)
        out[f"decode{i}"] = np.asarray(logits)
    out["pos"] = int(cache["pos"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both clusters and the reference child run at once; the parent
    computes the reference's plain decodes meanwhile."""
    out = tmp_path_factory.mktemp("torch_dist")
    me = str(pathlib.Path(__file__).resolve())
    env = {"PYTHONPATH": str(ROOT / "src"), **torch_threads.RANK_ENV}
    clusters = {}
    for mode, grid in (("attention", ATTN_GRID), ("decode", DECODE_GRID)):
        (out / mode).mkdir()
        n = grid[0] * grid[1]
        clusters[mode] = MH.launch_local_cluster(n, 1, [me, "worker", mode, str(out / mode)], backend="gloo",
                                                 devices=["cpu"] * n, env_extra=env, cwd=str(ROOT))
    child = _reference_child(out / "reference.npz")
    ref_decode = {arch: _reference_decode(arch) for arch in DECODE_ARCHS}
    stdout, stderr = child.communicate(timeout=CLUSTER_TIMEOUT_S)
    assert child.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
    ranks = {}
    for mode, cluster in clusters.items():
        res = cluster.wait(CLUSTER_TIMEOUT_S)
        assert res.ok, res.format_logs()
        ranks[mode] = [(dict(np.load(out / mode / f"rank{r}.npz")),
                        json.loads((out / mode / f"rank{r}.json").read_text())) for r in range(cluster.n_ranks)]
    return types.SimpleNamespace(ranks=ranks, reference=dict(np.load(out / "reference.npz")), ref_decode=ref_decode)


def _coords(grid, r):
    return divmod(r, grid[1])  # (data, model): row-major, as jax.make_mesh lays devices out


def test_workers_ran_without_jax(runs):
    assert all(meta["jax_loaded"] is False for mode in runs.ranks.values() for _, meta in mode)
    assert [len(v) for v in runs.ranks.values()] == [8, 4]


@pytest.mark.parametrize("variant", list(ATTN_VARIANTS))
def test_sp_decode_attention_matches_reference_and_oracle(runs, variant):
    rows = {}
    for r, (arrs, _) in enumerate(runs.ranks["attention"]):
        d, m = _coords(ATTN_GRID, r)
        got = arrs[f"attn_{variant}"]
        if d in rows:  # every rank of a data row merges the same partials
            assert got.tobytes() == rows[d].tobytes(), (r, d, m)
        rows[d] = got
    got = np.concatenate([rows[d] for d in sorted(rows)])
    np.testing.assert_allclose(got, runs.reference[f"attn_{variant}"], rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(got, runs.reference[f"mea_{variant}"], rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("pos", CACHE_POSITIONS)
def test_sp_cache_update_writes_owner_slice_only(runs, pos):
    want = runs.reference[f"cache_{pos}"]
    s_loc = CACHE["s"] // ATTN_GRID[1]
    b_loc = CACHE["b"] // ATTN_GRID[0]
    for r, (arrs, _) in enumerate(runs.ranks["attention"]):
        d, m = _coords(ATTN_GRID, r)
        got = arrs[f"cache_{pos}"]
        assert got.tobytes() == want[d * b_loc : (d + 1) * b_loc, :, m * s_loc : (m + 1) * s_loc].tobytes(), r
        assert bool(got.any()) == (m == pos // s_loc), r


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sp_decode_over_2x2_ranks_matches_reference_plain_decode(runs, arch):
    ref = runs.ref_decode[arch]
    rows: dict = {}
    for r, (arrs, _) in enumerate(runs.ranks["decode"]):
        d, m = _coords(DECODE_GRID, r)
        assert tuple(arrs[f"{arch}|cache_shape"][[1, 3]]) == (DECODE["batch"] // 2, DECODE["max_len"] // 2)
        assert int(arrs[f"{arch}|pos"]) == ref["pos"] == DECODE["seq"] + DECODE["steps"]
        names = ["prefill"] + [f"decode{i}" for i in range(DECODE["steps"])]
        got = {n: arrs[f"{arch}|{n}"] for n in names}
        if d in rows:
            assert all(got[n].tobytes() == rows[d][n].tobytes() for n in names), (arch, r)
        rows[d] = got
    for name in rows[0]:
        np.testing.assert_allclose(np.concatenate([rows[0][name], rows[1][name]]), ref[name],
                                   rtol=DECODE_TOL, atol=DECODE_TOL, err_msg=f"{arch} {name}")


if __name__ == "__main__":
    if sys.argv[1:2] != ["worker"]:
        sys.exit(f"usage: {sys.argv[0]} worker <attention|decode> <dir>")
    worker(sys.argv[2], pathlib.Path(sys.argv[3]))
