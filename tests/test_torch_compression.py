"""The port's int8 error-feedback gradient compression
(``repro_torch.train.compression``) against the JAX package's.

* ``quantize`` and ``dequantize`` equal to the reference's on the same
  arrays, ``q`` byte for byte.
* ``compressed_allreduce`` over 8 data ranks (a local gloo cluster running
  this file as its worker, one process a rank at one thread, no JAX there)
  against the reference's under ``shard_map`` on 8 forced host devices (a
  child process, as ``tests/test_multidevice.py:16 run_with_devices``): the
  reduced gradients and every rank's new error within 1 ulp, the reduced
  gradients byte-equal across ranks.
* ``tests/test_multidevice.py:125``'s linear model mirrored: the compressed
  data-parallel gradient over 8 ranks within 0.05 (relative, max-norm) of the
  plain gradient of the whole batch, the loss the ranks' mean.
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

from repro_torch.launch import mesh as MM  # noqa: E402
from repro_torch.launch import multihost as MH  # noqa: E402
from repro_torch.train import compression as C  # noqa: E402

RANKS = 8
GROUP_TIMEOUT_S = 60.0
CLUSTER_TIMEOUT_S = 240.0
SHAPES = {"w": (16, 4), "b": (4,), "layer/k": (3, 5, 7)}
REL_BOUND = 0.05  # tests/test_multidevice.py:146


def grads_and_errors() -> dict:
    """Per-rank gradients and carried errors, stacked on a leading rank axis."""
    rng = np.random.default_rng(0)
    out = {}
    for name, shape in SHAPES.items():
        out[f"g/{name}"] = rng.standard_normal((RANKS, *shape)).astype(np.float32)
        out[f"e/{name}"] = (0.01 * rng.standard_normal((RANKS, *shape))).astype(np.float32)
    return out


def linear_problem() -> dict:
    return {"w": np.random.default_rng(0).standard_normal((16, 4)).astype(np.float32),
            "x": np.random.default_rng(1).standard_normal((32, 16)).astype(np.float32),
            "y": np.random.default_rng(2).standard_normal((32, 4)).astype(np.float32)}


def _tree(flat: dict, prefix: str, rank: int) -> dict:
    """{"w": ..., "b": ..., "layer": {"k": ...}} of one rank."""
    out: dict = {}
    for name in SHAPES:
        node = out
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(flat[f"{prefix}/{name}"][rank])
    return out


def _flat(tree: dict, prefix: str) -> dict:
    out = {}
    for name in SHAPES:
        node = tree
        for p in name.split("/"):
            node = node[p]
        out[f"{prefix}/{name}"] = node.numpy()
    return out


# ------------------------------------------------------------------ worker
def worker(out_dir: pathlib.Path) -> None:
    group = MH.initialize_from_env(timeout_s=GROUP_TIMEOUT_S)
    grid = MM.make_test_mesh(data=RANKS, model=1, group=group)
    r = grid.coords["data"]
    inp = grads_and_errors()
    reduced, new_e = C.compressed_allreduce(_tree(inp, "g", r), _tree(inp, "e", r), grid.line("data"))
    out = {**_flat(reduced, "reduced"), **_flat(new_e, "new_error")}

    lin = linear_problem()
    shard = slice(r * 4, (r + 1) * 4)
    batch = {"x": torch.from_numpy(lin["x"][shard]), "y": torch.from_numpy(lin["y"][shard])}

    def loss_fn(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    fn = C.make_compressed_dp_grad_fn(loss_fn, grid, axis="data")
    loss, grads, err2 = fn({"w": torch.from_numpy(lin["w"])}, batch, {"w": torch.zeros(16, 4)})
    out.update({"lin_loss": loss.numpy(), "lin_grad": grads["w"].numpy(), "lin_error": err2["w"].numpy()})
    np.savez(out_dir / f"rank{group.rank}.npz", **out)
    (out_dir / f"rank{group.rank}.json").write_text(json.dumps({"jax_loaded": "jax" in sys.modules, "data": r}))


# ------------------------------------------------------------ the reference
REFERENCE_CHILD = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_compression as T
from repro.compat import shard_map
from repro.launch import mesh as MM
from repro.train import compression as C

mesh = MM.make_test_mesh(data=T.RANKS, model=1)
inp = {{k: jnp.asarray(v) for k, v in T.grads_and_errors().items()}}
g = {{n: inp["g/" + n] for n in T.SHAPES}}
e = {{n: inp["e/" + n] for n in T.SHAPES}}

def local(g, e):
    g = {{k: v[0] for k, v in g.items()}}
    e = {{k: v[0] for k, v in e.items()}}
    red, ne = C.compressed_allreduce(g, e, "data")
    return {{k: v[None] for k, v in red.items()}}, {{k: v[None] for k, v in ne.items()}}

spec = {{n: P("data") for n in T.SHAPES}}
with mesh:
    red, ne = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
                                check_vma=False))(g, e)
out = {{}}
for n in T.SHAPES:
    out["reduced/" + n] = np.asarray(red[n])
    out["new_error/" + n] = np.asarray(ne[n])
lin = {{k: jnp.asarray(v) for k, v in T.linear_problem().items()}}
loss_fn = lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)
fn = C.make_compressed_dp_grad_fn(loss_fn, mesh, axis="data")
with mesh:
    loss, grads, err = jax.jit(fn)({{"w": lin["w"]}}, {{"x": lin["x"], "y": lin["y"]}}, {{"w": jnp.zeros((16, 4))}})
out["lin_loss"] = np.asarray(loss)
out["lin_grad"] = np.asarray(grads["w"])
np.savez({out!r}, **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.launch.multihost import force_host_device_flags

    out = tmp_path_factory.mktemp("torch_compression")
    cluster = MH.launch_local_cluster(
        RANKS, 1, [str(pathlib.Path(__file__).resolve()), "worker", str(out)], backend="gloo",
        devices=["cpu"] * RANKS, env_extra={"PYTHONPATH": str(ROOT / "src"), **torch_threads.RANK_ENV},
        cwd=str(ROOT))
    env = dict(os.environ)
    env["XLA_FLAGS"] = force_host_device_flags(RANKS, env.get("XLA_FLAGS", ""))
    env["PYTHONPATH"] = str(ROOT / "src")
    code = REFERENCE_CHILD.format(tests=str(ROOT / "tests"), out=str(out / "reference.npz"))
    child = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env, cwd=str(ROOT),
                           capture_output=True, text=True, timeout=CLUSTER_TIMEOUT_S)
    assert child.returncode == 0, f"STDOUT:\n{child.stdout}\nSTDERR:\n{child.stderr}"
    res = cluster.wait(CLUSTER_TIMEOUT_S)
    assert res.ok, res.format_logs()
    ranks = [(dict(np.load(out / f"rank{r}.npz")), json.loads((out / f"rank{r}.json").read_text()))
             for r in range(RANKS)]
    return types.SimpleNamespace(ranks=ranks, reference=dict(np.load(out / "reference.npz")))


@pytest.mark.parametrize("shape", [(16, 4), (1000,), (3, 5, 7), (1,)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_equals_reference(shape, bits):
    import jax.numpy as jnp
    from repro.train import compression as JC

    g = np.random.default_rng([bits, len(shape)]).standard_normal(shape).astype(np.float32) * 3.0
    q, scale = C.quantize(torch.from_numpy(g), bits=bits)
    jq, jscale = JC.quantize(jnp.asarray(g), bits=bits)
    assert q.dtype == torch.int8 and q.numpy().tobytes() == np.asarray(jq).tobytes()
    assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()
    assert C.dequantize(q, scale).numpy().tobytes() == np.asarray(JC.dequantize(jq, jscale)).tobytes()


def test_workers_ran_without_jax(runs):
    assert [meta for _, meta in runs.ranks] == [{"jax_loaded": False, "data": r} for r in range(RANKS)]


@pytest.mark.parametrize("name", list(SHAPES))
def test_compressed_allreduce_over_8_ranks_equals_reference(runs, name):
    ref = runs.reference
    for r, (arrs, _) in enumerate(runs.ranks):
        got = arrs[f"reduced/{name}"]
        assert got.tobytes() == runs.ranks[0][0][f"reduced/{name}"].tobytes(), r
        np.testing.assert_array_max_ulp(got, ref[f"reduced/{name}"][r], maxulp=1)
        np.testing.assert_array_max_ulp(arrs[f"new_error/{name}"], ref[f"new_error/{name}"][r], maxulp=1)


def test_compressed_dp_grads_of_a_linear_model(runs):
    lin = linear_problem()
    w = torch.from_numpy(lin["w"]).requires_grad_(True)
    loss = torch.mean((torch.from_numpy(lin["x"]) @ w - torch.from_numpy(lin["y"])) ** 2)
    (g_true,) = torch.autograd.grad(loss, [w])
    g_true = g_true.numpy()
    for arrs, _ in runs.ranks:
        rel = np.abs(arrs["lin_grad"] - g_true).max() / (np.abs(g_true).max() + 1e-9)
        assert rel < REL_BOUND, rel
        assert float(arrs["lin_loss"]) > 0
        np.testing.assert_allclose(arrs["lin_loss"], runs.reference["lin_loss"], rtol=1e-6)
        assert arrs["lin_grad"].tobytes() == runs.ranks[0][0]["lin_grad"].tobytes()
    ref_rel = np.abs(runs.reference["lin_grad"] - g_true).max() / (np.abs(g_true).max() + 1e-9)
    assert ref_rel < REL_BOUND


if __name__ == "__main__":
    if sys.argv[1:2] != ["worker"]:
        sys.exit(f"usage: {sys.argv[0]} worker <dir>")
    worker(pathlib.Path(sys.argv[2]))
