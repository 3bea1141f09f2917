#!/usr/bin/env python3
"""Write ``tests/torch_lm_fixture.npz``: the JAX package's LM outputs on each
of the 10 smoke configs, for ``chip_smoke.py`` path 10 (c) to hold the port
on the card against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_fixture.py

Weights and inputs come from ``tests/torch_lm_harness.py`` (numpy, from a
seed; ``FIXTURE_SETUP``): ``forward_train``'s losses, ``forward_prefill``'s
logits and every cache leaf, and one ``forward_decode``'s logits, in
float32 on the CPU. ``tests/test_torch_lm_fixture.py`` recomputes them and
holds the committed file to them. Needs the JAX package; about 30 s.
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


def jax_shapes(cfg, dtype=jnp.float32) -> dict:
    """The reference's parameter tree as ``(shape, dtype name)`` leaves."""
    tree = jax.eval_shape(lambda k: M.init_params(cfg, k, dtype), jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), tree)


def jax_outputs(arch: str, setup: dict) -> dict:
    """The JAX package's outputs on the harness's weights and inputs, named
    as ``torch_lm_harness.port_outputs`` names the port's."""
    cfg = configs.get_smoke(arch)
    params = jax.tree.map(jnp.asarray, H.numpy_params(jax_shapes(cfg)))
    inputs = H.numpy_inputs(cfg, setup["batch"], setup["seq"])
    batch = {k: jnp.asarray(v) for k, v in inputs.items() if k != "next"}
    out: dict = {}
    loss, metrics = jax.jit(lambda p, b: M.forward_train(p, cfg, b))(params, batch)
    out["loss"], out["ce_loss"], out["aux_loss"] = loss, metrics["ce_loss"], metrics["aux_loss"]
    cache = M.init_cache(cfg, setup["batch"], setup["max_len"])
    logits, cache = jax.jit(lambda p, b, c: M.forward_prefill(p, cfg, b, c))(params, batch, cache)
    out["prefill_logits"] = logits
    out.update({f"prefill_cache/{k}": v for k, v in cache.items() if k != "pos"})
    logits, cache2 = jax.jit(lambda p, t, c: M.forward_decode(p, cfg, t, c))(params, jnp.asarray(inputs["next"]), cache)
    out["decode_logits"] = logits
    out.update({f"decode_cache/{k}": v for k, v in cache2.items() if k != "pos"})
    out["prefill_pos"], out["decode_pos"] = cache["pos"], cache2["pos"]
    return {k: np.asarray(v) for k, v in out.items()}


def main() -> int:
    outputs = {arch: jax_outputs(arch, H.FIXTURE_SETUP) for arch in configs.ARCH_NAMES}
    H.write_fixture(outputs)
    print(f"wrote {H.FIXTURE} ({H.FIXTURE.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
