"""The committed fixture of the JAX package's LM outputs
(``tests/torch_lm_fixture.npz``), which ``chip_smoke.py`` path 10 (c) holds
the port on the card against: it is current (recomputed here from the JAX
package, it equals the file), and the port on the CPU equals it to the
parity tests' tolerance.

After a change to the harness's set-up or to the reference's outputs,
rewrite it with ``PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_fixture.py``.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import importlib.util
import pathlib

import numpy as np
import pytest

import torch_lm_harness as H
from repro_torch import configs
from repro_torch.models import model as M

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def committed():
    return H.read_fixture()


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("lm_fixture", ROOT / "tools" / "lm_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_holds_every_architecture(committed):
    assert sorted(committed) == sorted(configs.ARCH_NAMES)
    for arch, d in committed.items():
        cfg = configs.get_smoke(arch)
        leaves = {k for k in M.init_cache(cfg, 1, 1, device="cpu") if k != "pos"}
        assert {k.split("/", 1)[1] for k in d if k.startswith("prefill_cache/")} == leaves, arch
        assert {"loss", "ce_loss", "aux_loss", "prefill_logits", "decode_logits"} <= set(d), arch


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_fixture_is_current(committed, tool, arch):
    """The JAX package recomputes the committed outputs (to float rounding:
    another host's XLA may sum in another order)."""
    fresh = H.fixture_subset(tool.jax_outputs(arch, H.FIXTURE_SETUP))
    assert sorted(fresh) == sorted(committed[arch])
    for k, want in committed[arch].items():
        assert fresh[k].shape == want.shape and fresh[k].dtype == want.dtype, (arch, k)
        np.testing.assert_allclose(fresh[k], want, rtol=1e-5, atol=1e-6, err_msg=f"{arch} {k}")


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_port_on_the_cpu_equals_the_fixture(committed, arch):
    cfg = configs.get_smoke(arch)
    s = H.FIXTURE_SETUP
    got = H.port_outputs(cfg, H.numpy_params(M.param_shapes(cfg)), H.numpy_inputs(cfg, s["batch"], s["seq"]),
                         s["max_len"], "cpu")
    for k, want in committed[arch].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-5, err_msg=f"{arch} {k}")
