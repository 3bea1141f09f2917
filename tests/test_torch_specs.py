"""The port's sharding rules (``repro_torch.launch.sharding``), input specs
(``launch/specs.py``) and grids (``launch/mesh.py``) against the JAX
package's.

* Every rule (``param_spec``, ``opt_state_spec``, ``batch_spec``,
  ``cache_spec``, ``cache_seq_axes`` and the ``*_shardings`` helpers) equal to
  the reference's for every leaf of every full config on the 16×16, 2×16×16,
  2×4 and 8×1 grids. The reference's rules read only ``axis_names`` and
  ``devices.shape``, so they run here on a stand-in of that shape.
* Every leaf of every ``specs`` function (shape, dtype, spec and the block
  one rank holds) equal to the reference's ``ShapeDtypeStruct`` and its
  ``NamedSharding.shard_shape``, in a child forced to 512 host devices (the
  production meshes need them).
* ``RankGrid``: row-major coordinates and lines as ``jax.make_mesh`` lays
  devices out, and the production shapes.
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

from repro.launch import sharding as J_SH
from repro_torch import configs
from repro_torch.launch import mesh as MM
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES, cell_is_runnable

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRIDS = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
         "2x4": ((2, 4), ("data", "model")), "8x1": ((8, 1), ("data", "model"))}
CHILD_TIMEOUT_S = 400.0


def _standin(grid: str):
    shape, names = GRIDS[grid]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=object))


def _port_grid(grid: str):
    shape, names = GRIDS[grid]
    return MM.RankGrid(names, shape)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _norm(spec) -> list:
    """A spec as JSON holds it: entries None, a name, or a list of names."""
    return json.loads(json.dumps([list(e) if isinstance(e, tuple) else e for e in tuple(spec)]))


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_and_opt_state_specs_equal_reference(arch, grid):
    cfg = configs.get_config(arch)
    ref_mesh, mesh = _standin(grid), _port_grid(grid)
    shapes = M.param_shapes(cfg)
    tree = dict(_leaves(SH.params_shardings(mesh, shapes)))
    assert list(tree) == [path for path, _ in _leaves(shapes)]
    for path, (shape, _) in _leaves(shapes):
        want = _norm(J_SH.param_spec(ref_mesh, path, shape))
        assert _norm(SH.param_spec(mesh, path, shape)) == want == _norm(tree[path]), path
        assert _norm(SH.opt_state_spec(mesh, path, shape)) == _norm(J_SH.opt_state_spec(ref_mesh, path, shape)), path


@pytest.mark.parametrize("grid", list(GRIDS))
def test_batch_cache_and_seq_specs_equal_reference(grid):
    ref_mesh, mesh = _standin(grid), _port_grid(grid)
    assert SH.batch_axes(mesh) == J_SH.batch_axes(ref_mesh)
    for b in (1, 2, 3, 8, 16, 32, 128, 256, 512, 24):
        assert _norm(SH.batch_spec(mesh, b)) == _norm(J_SH.batch_spec(ref_mesh, b)), b
        assert SH.cache_seq_axes(mesh, b) == J_SH.cache_seq_axes(ref_mesh, b), b
    for arch in configs.ARCH_NAMES:
        cfg = configs.get_config(arch)
        for sname, shape in SHAPES.items():
            cache = M.cache_shapes(cfg, shape.global_batch, shape.seq_len)
            for seq_shard in (True, False):
                specs = SH.cache_shardings(mesh, cache, seq_shard=seq_shard)
                for key, (cshape, _) in cache.items():
                    want = _norm(J_SH.cache_spec(ref_mesh, key, cshape, seq_shard=seq_shard))
                    assert _norm(SH.cache_spec(mesh, key, cshape, seq_shard=seq_shard)) == want, (arch, sname, key)
                    assert _norm(specs[key]) == want
            bs = SH.batch_shardings(mesh, {"tokens": ((shape.global_batch, shape.seq_len), torch.int32)})
            assert _norm(bs["tokens"]) == _norm(J_SH.batch_spec(ref_mesh, shape.global_batch)) + [None]


def test_graph_engine_specs_equal_reference():
    assert [_norm(s) for s in SH.engine_shardings()] == [
        _norm(J_SH.edges_spec()), _norm(J_SH.mask_spec()), _norm(J_SH.vertex_spec())]


def test_rank_grid_lays_ranks_out_row_major():
    grid = MM.RankGrid(("pod", "data", "model"), (2, 3, 4))
    assert grid.size == 24 and MM.num_chips(grid) == 24
    assert MM.mesh_axis_sizes(grid) == {"pod": 2, "data": 3, "model": 4}
    ids = np.arange(24).reshape(2, 3, 4)  # jax.make_mesh's device order
    for a, name in enumerate(grid.axis_names):
        lines = MM._line_ranks(grid.shape, a)
        want = np.moveaxis(ids, a, -1).reshape(-1, grid.shape[a]).tolist()
        assert lines == want, name
    for r in range(24):
        g = MM.GraphGroup(size=24, rank=r, backend="gloo", processes=tuple(range(24)))
        coords = MM.RankGrid(grid.axis_names, grid.shape, g).coords
        assert [coords[n] for n in grid.axis_names] == [int(x[0]) for x in np.nonzero(ids == r)]


def test_production_and_test_grids():
    m1, m2 = MM.make_production_mesh(), MM.make_production_mesh(multi_pod=True)
    assert (m1.shape, m1.axis_names) == ((16, 16), ("data", "model"))
    assert (m2.shape, m2.axis_names) == ((2, 16, 16), ("pod", "data", "model"))
    assert MM.num_chips(m2) == 512 and MM.num_chips(m1) == 256
    t = MM.make_test_mesh(2, 4)
    assert (t.shape, t.axis_names, t.group) == ((2, 4), ("data", "model"), None)
    with pytest.raises(ValueError):
        t.line("model")  # a shape only: no ranks to talk to
    assert MM.make_test_mesh(2, 1).line("model").distributed is False
    with pytest.raises(ValueError):
        MM.RankGrid(("data",), (4,), MM.GraphGroup(size=2, rank=0, backend="gloo", processes=(0, 1)))


# -------------------------------------------------- specs.py on 512 devices
REFERENCE_CHILD = """
import json, sys
import numpy as np
import jax
sys.path.insert(0, {tests!r})
import test_torch_specs as T
from repro import configs
from repro.launch import mesh as MM
from repro.launch import specs as SP
from repro.models.config import SHAPES, cell_is_runnable

meshes = {{"16x16": MM.make_production_mesh(), "2x16x16": MM.make_production_mesh(multi_pod=True),
          "2x4": MM.make_test_mesh(2, 4), "8x1": MM.make_test_mesh(8, 1)}}

def rec(tree):
    out = {{}}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        out[name] = [list(leaf.shape), str(leaf.dtype), T._norm(leaf.sharding.spec),
                     list(leaf.sharding.shard_shape(leaf.shape))]
    return out

out = {{}}
for arch in configs.ARCH_NAMES:
    cfg = configs.get_config(arch)
    for g, mesh in meshes.items():
        out[f"{{arch}}|{{g}}|params"] = rec(SP.param_specs(cfg, mesh))
        out[f"{{arch}}|{{g}}|opt_state"] = rec(SP.opt_state_specs(cfg, mesh))
        for sname, shape in SHAPES.items():
            if not cell_is_runnable(arch, sname):
                continue
            out[f"{{arch}}|{{g}}|{{sname}}|batch"] = rec(SP.batch_specs(cfg, shape, mesh))
            out[f"{{arch}}|{{g}}|{{sname}}|token"] = rec({{"token": SP.token_specs(cfg, shape, mesh)}})
            if shape.kind != "train":
                out[f"{{arch}}|{{g}}|{{sname}}|cache"] = rec(SP.cache_specs(cfg, shape, mesh, seq_shard=True))
with open({out!r}, "w") as f:
    json.dump(out, f)
"""


def _port_rec(tree) -> dict:
    return {"/".join(path): [list(x.shape), str(x.dtype).replace("torch.", ""), _norm(x.spec), list(x.shard_shape)]
            for path, x in _leaves(tree if isinstance(tree, dict) else {"token": tree})}


@pytest.fixture(scope="module")
def reference_specs(tmp_path_factory):
    from repro.launch.multihost import force_host_device_flags

    out = tmp_path_factory.mktemp("torch_specs") / "reference.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = force_host_device_flags(512, env.get("XLA_FLAGS", ""))
    env["PYTHONPATH"] = str(ROOT / "src")
    code = REFERENCE_CHILD.format(tests=str(ROOT / "tests"), out=str(out))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env, cwd=str(ROOT), capture_output=True,
                       text=True, timeout=CHILD_TIMEOUT_S)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_input_specs_and_shard_shapes_equal_reference(reference_specs, arch):
    cfg = configs.get_config(arch)
    for g in GRIDS:
        mesh = _port_grid(g)
        assert _port_rec(SP.param_specs(cfg, mesh)) == reference_specs[f"{arch}|{g}|params"], g
        assert _port_rec(SP.opt_state_specs(cfg, mesh)) == reference_specs[f"{arch}|{g}|opt_state"], g
        for sname, shape in SHAPES.items():
            if not cell_is_runnable(arch, sname):
                continue
            key = f"{arch}|{g}|{sname}"
            assert _port_rec(SP.batch_specs(cfg, shape, mesh)) == reference_specs[f"{key}|batch"], key
            assert _port_rec(SP.token_specs(cfg, shape, mesh)) == reference_specs[f"{key}|token"], key
            inputs = SP.input_specs(cfg, shape, mesh)
            if shape.kind != "train":
                cache = _port_rec(SP.cache_specs(cfg, shape, mesh, seq_shard=True))
                assert cache == reference_specs[f"{key}|cache"], key
                assert _port_rec(inputs["cache"]) == cache
            per_dev = SP.per_device_bytes(inputs)
            want = sum(int(np.prod(s)) * x.dtype.itemsize for s, x in
                       ((x.shard_shape, x) for x in SP.leaves(inputs)))
            assert per_dev == want > 0
