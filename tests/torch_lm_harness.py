"""The LM harness's shared set-up: weights and inputs drawn by numpy from a
seed, the port's outputs on them, and the committed fixture of the JAX
package's outputs (``tests/torch_lm_fixture.npz``, written by
``tools/lm_fixture.py``).

It imports no JAX, so ``chip_smoke.py`` (path 10 (c)) uses it where only
PyTorch is installed; the CPU tests and the fixture writer use it beside the
JAX package. A parameter tree is nested dicts of numpy arrays with the
reference's names and layer-stacked shapes; a shape tree has ``(shape,
dtype)`` leaves (``repro_torch.models.model.param_shapes``, or
``jax.eval_shape`` of the reference's ``init_params``).
"""
from __future__ import annotations

import pathlib
import zlib

import numpy as np

FIXTURE = pathlib.Path(__file__).with_name("torch_lm_fixture.npz")
SEED = 0
FIXTURE_SETUP = dict(batch=2, seq=10, max_len=12)  # small: the fixture holds every cache leaf
PARITY_SETUP = dict(batch=2, seq=40, max_len=48)  # past the smoke configs' window of 32

# Every leaf is random, so a norm's (1 + w), a bias, a_log, dt_bias and
# d_skip each change the outputs.
_NORMS = {"ln1", "ln2", "ln_cross", "final_norm", "enc_final_norm", "q_norm", "k_norm", "out_norm",
          "fuse_attn", "fuse_ssm", "bq", "bk", "bv"}


def _leaves(tree: dict, prefix=()):
    for name in sorted(tree):
        sub = tree[name]
        if isinstance(sub, dict):
            yield from _leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def numpy_params(shapes: dict, seed: int = SEED) -> dict:
    """Float32 weights for the shape tree ``shapes``: each leaf from its own
    generator, seeded by ``seed`` and the leaf's path."""
    out: dict = {}
    for path, (shape, _) in _leaves(shapes):
        rng = np.random.default_rng([seed, zlib.crc32("/".join(path).encode())])
        z = rng.standard_normal(tuple(shape))
        name = path[-1]
        if name in _NORMS:
            a = 0.3 * z
        elif name == "d_skip":
            a = 1.0 + 0.3 * z
        elif name in ("a_log", "dt_bias", "router"):
            a = 0.5 * z
        elif name == "conv_w":
            a = 0.2 * z
        else:
            a = 0.05 * z
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[name] = a.astype(np.float32)
    return out


def numpy_inputs(cfg, batch: int, seq: int, seed: int = SEED) -> dict:
    """tokens and targets (B, S) int32, the decode step's ``next`` (B, 1),
    and the vlm's ``patch_embeds`` or encdec's ``frames`` (float32)."""
    rng = np.random.default_rng([seed, 1])
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
        "next": rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32),
    }
    if cfg.family == "vlm":
        out["patch_embeds"] = (0.5 * rng.standard_normal((batch, cfg.num_patches, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (0.5 * rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return out


def port_outputs(cfg, params: dict, inputs: dict, max_len: int, device) -> dict:
    """The port's outputs on numpy weights and inputs, as numpy: ``loss``,
    ``ce_loss``, ``aux_loss`` of ``forward_train``; ``prefill_logits`` and
    ``prefill_cache/<leaf>`` of ``forward_prefill``; ``decode_logits`` and
    ``decode_cache/<leaf>`` of one ``forward_decode`` on ``next``."""
    import torch

    from repro_torch.models import model as M

    model = M.params_from_numpy(cfg, params, device=device)
    t = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    batch = {k: v for k, v in t.items() if k != "next"}
    out: dict = {}
    with torch.inference_mode():
        loss, metrics = M.forward_train(model, cfg, batch)
        out["loss"], out["ce_loss"], out["aux_loss"] = loss, metrics["ce_loss"], metrics["aux_loss"]
        cache = M.init_cache(cfg, inputs["tokens"].shape[0], max_len, device=device)
        logits, cache = M.forward_prefill(model, cfg, batch, cache)
        out["prefill_logits"] = logits
        out.update({f"prefill_cache/{k}": v.clone() for k, v in cache.items() if k != "pos"})
        logits, cache = M.forward_decode(model, cfg, t["next"], cache)
        out["decode_logits"] = logits
        out.update({f"decode_cache/{k}": v for k, v in cache.items() if k != "pos"})
    return {k: v.float().cpu().numpy() for k, v in out.items()}


FIXTURE_KEYS = ("loss", "ce_loss", "aux_loss", "prefill_logits", "prefill_cache/", "decode_logits")


def fixture_subset(outputs: dict) -> dict:
    """What the fixture keeps of a run's outputs: the losses, the prefill's
    logits and every cache leaf, and the decode's logits."""
    return {k: v for k, v in outputs.items() if k.startswith(FIXTURE_KEYS)}


def read_fixture(path: pathlib.Path = FIXTURE) -> dict:
    """{arch: {name: array}} from the committed fixture."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            arch, name = key.split("|", 1)
            out.setdefault(arch, {})[name] = z[key]
    return out


def write_fixture(outputs: dict, path: pathlib.Path = FIXTURE) -> None:
    """``outputs``: {arch: {name: array}}; each array stored as ``arch|name``."""
    flat = {f"{arch}|{name}": np.asarray(v) for arch, d in outputs.items() for name, v in fixture_subset(d).items()}
    np.savez_compressed(path, **flat)
