"""The port's train step (``repro_torch.train.steps``) against the JAX
package's, on the 10 smoke configs, and the committed fixture of the JAX
package's steps (``tests/torch_train_fixture.npz``), which ``chip_smoke.py``
path 11 (c) holds the port on the card against.

Weights and batches come from ``tests/torch_lm_harness.py`` (random in every
leaf; ``TRAIN_OPT``: the first step's learning rate is the peak). Each
config takes one plain step and one 2-microbatch step from the same weights,
in float32 on the CPU, then a second step on the same batch. Tolerances:
loss, grad norm and the second step's loss to rtol 1e-5; each leaf's
gradient (recovered from the first moment) to a relative L2 of 1e-4; each
leaf's updated value to a relative L2 of 1e-5, where Adam's first step moves
an element by lr · sign(g): an element whose two gradients differ in sign is
noise around zero (asserted: below 1e-4 of the leaf's largest gradient, and
at most one element in a thousand), and is held to that sign step instead.

After a change to the harness's training set-up or to the reference's
steps, rewrite the fixture with
``PYTHONPATH=src JAX_PLATFORMS=cpu python tools/train_fixture.py``.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import importlib.util
import pathlib

import numpy as np
import pytest

import torch_lm_harness as H
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.train import optimizer as O

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = H.TRAIN_RTOL
GRAD_RTOL = H.TRAIN_GRAD_RTOL


def _load_tool():
    spec = importlib.util.spec_from_file_location("train_fixture", ROOT / "tools" / "train_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TF = _load_tool()
CASES = [(arch, mb) for arch in configs.ARCH_NAMES for mb in H.TRAIN_MODES]


@pytest.fixture(scope="module", params=CASES, ids=[f"{a}-mb{m}" for a, m in CASES])
def case(request):
    """((arch, microbatches), the JAX package's outputs, the port's)."""
    arch, mb = request.param
    cfg = configs.get_smoke(arch)
    got = H.port_train_outputs(cfg, H.numpy_params(M.param_shapes(cfg)), H.train_inputs(cfg), "cpu", mb)
    return request.param, TF.jax_train_outputs(arch, mb), got


def _rel(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / max(np.linalg.norm(want), 1e-30))


def test_train_step_equals_jax(case):
    (arch, mb), ref, got = case
    assert sorted(got) == sorted(ref), (arch, mb)
    for k in ("loss", "grad_norm", "lr", "next_loss"):
        assert got[k] == pytest.approx(ref[k], rel=LOSS_RTOL), (arch, mb, k)
    assert np.isfinite([got["loss"], got["next_loss"]]).all() and got["next_loss"] < got["loss"], (arch, mb)
    for k in ref:
        if k.startswith("grad/"):
            assert got[k].shape == ref[k].shape, (arch, mb, k)
            assert _rel(got[k], ref[k]) < GRAD_RTOL, (arch, mb, k, _rel(got[k], ref[k]))
        elif k.startswith("params/"):
            leaf = k.split("/", 1)[1]
            H.assert_updates_close(got[k], ref[k], got[f"grad/{leaf}"], ref[f"grad/{leaf}"], ref["lr"],
                                   O.OptConfig().weight_decay, (arch, mb, leaf))


def test_train_fixture_is_current(case):
    """The JAX package recomputes the committed scalars (to float rounding:
    another host's XLA may sum in another order)."""
    (arch, mb), ref, _ = case
    committed = H.read_train_fixture()[(arch, mb)]
    fresh = H.train_fixture_subset(ref)
    assert sorted(fresh) == sorted(committed)
    for k, want in committed.items():
        assert float(fresh[k]) == pytest.approx(want, rel=1e-5, abs=1e-9), (arch, mb, k)


def test_train_fixture_holds_every_config():
    committed = H.read_train_fixture()
    assert sorted(committed) == sorted(CASES)
    for (arch, _), d in committed.items():
        leaves = ["/".join(p) for p, _ in M._leaves(M.param_shapes(configs.get_smoke(arch)))]
        for kind in ("grad_l2", "grad_proj", "proj_norm"):
            assert sorted(k.split("/", 1)[1] for k in d if k.startswith(kind + "/")) == sorted(leaves), (arch, kind)
        assert {"loss", "grad_norm", "lr", "next_loss"} <= set(d)


def test_port_on_the_cpu_equals_the_train_fixture(case):
    """The check path 11 (c) makes on the card, here on the CPU."""
    (arch, mb), _, got = case
    ratios = H.train_fixture_ratios(got, H.read_train_fixture()[(arch, mb)])
    assert max(ratios.values()) <= 1.0, max(ratios, key=ratios.get)
