#!/usr/bin/env python3
"""Write ``tests/torch_train_fixture.npz``: the JAX package's train steps on
each of the 10 smoke configs, for ``chip_smoke.py`` path 11 (c) to hold the
port on the card against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/train_fixture.py

Weights, batch and optimizer come from ``tests/torch_lm_harness.py``
(``numpy_params``, ``train_inputs``, ``TRAIN_OPT``). For one plain step and
one 2-microbatch step of each config, in float32 on the CPU: the loss, the
grad norm and the learning rate, each leaf's gradient L2 and its projection
on a seeded Gaussian vector, and the loss of a second step on the same
batch. ``tests/test_torch_train_steps.py`` recomputes them and holds the
committed file to them. Needs the JAX package; about a minute.
"""
from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_lm_harness as H  # noqa: E402
from repro import configs  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.train import optimizer as O  # noqa: E402
from repro.train import steps as S  # noqa: E402


def jax_shapes(cfg, dtype=jnp.float32) -> dict:
    """The reference's parameter tree as ``(shape, dtype name)`` leaves."""
    tree = jax.eval_shape(lambda k: M.init_params(cfg, k, dtype), jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), tree)


def jax_train_outputs(arch: str, microbatches: int) -> dict:
    """The JAX package's two train steps, named as
    ``torch_lm_harness.port_train_outputs`` names the port's."""
    cfg = configs.get_smoke(arch)
    params = jax.tree.map(jnp.asarray, H.numpy_params(jax_shapes(cfg)))
    batch = {k: jnp.asarray(v) for k, v in H.train_inputs(cfg).items()}
    opt = O.OptConfig(**H.TRAIN_OPT)
    step = jax.jit(S.make_train_step(cfg, opt, microbatches=microbatches))
    p1, s1, m1 = step(params, O.init_opt_state(params), batch)
    out = {k: np.float64(m1[k]) for k in ("loss", "grad_norm", "lr")}
    out.update(H.grad_readings(jax.tree.map(np.asarray, s1["m"]), float(m1["grad_norm"]), opt.b1, opt.clip_norm))
    out.update({f"params/{'/'.join(p)}": np.asarray(a) for p, a in H._leaves(jax.tree.map(np.asarray, p1))})
    _, s2, m2 = step(p1, s1, batch)
    out["next_loss"] = np.float64(m2["loss"])
    return out


def main() -> int:
    outputs = {(arch, mb): jax_train_outputs(arch, mb) for arch in configs.ARCH_NAMES for mb in H.TRAIN_MODES}
    H.write_train_fixture(outputs)
    print(f"wrote {H.TRAIN_FIXTURE} ({H.TRAIN_FIXTURE.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
