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
        a = rng.standard_normal(tuple(shape))
        name = path[-1]
        # Scaled in place (the same float64 products), so a full-width
        # embedding holds one float64 copy at a time.
        if name in _NORMS:
            a *= 0.3
        elif name == "d_skip":
            a *= 0.3
            a += 1.0
        elif name in ("a_log", "dt_bias", "router"):
            a *= 0.5
        elif name == "conv_w":
            a *= 0.2
        else:
            a *= 0.05
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


# ------------------------------------------------------------------ training
TRAIN_FIXTURE = pathlib.Path(__file__).with_name("torch_train_fixture.npz")
# The optimizer of the training parity checks: the first step's learning rate
# is the peak, so one update moves every leaf visibly.
TRAIN_OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_SETUP = dict(batch=2, seq=40)  # past the smoke configs' window of 32; batch 2 splits into 2 microbatches
# The SSD families train on 24 tokens: from 32 on, these weights overflow the
# exp of the chunk's masked upper triangle, and the reference's own gradient
# is NaN (0 · inf in the where's backward); the port's is too.
SSD_TRAIN_SEQ = 24
TRAIN_MODES = (1, 2)  # microbatches


def train_inputs(cfg) -> dict:
    """The training batch: ``numpy_inputs`` at ``TRAIN_SETUP``'s (or the SSD
    families') length, without the decode token."""
    seq = SSD_TRAIN_SEQ if cfg.family in ("ssm", "hybrid") else TRAIN_SETUP["seq"]
    return {k: v for k, v in numpy_inputs(cfg, TRAIN_SETUP["batch"], seq).items() if k != "next"}


def grad_readings(m_tree: dict, grad_norm: float, b1: float, clip_norm: float) -> dict:
    """Each leaf's gradient, recovered from the first AdamW step's moment
    (m = (1 - b1) · scale · g, scale the clip's), as ``grad/<leaf>``, its L2
    as ``grad_l2/<leaf>`` and its projection on a Gaussian vector seeded by
    the leaf's path as ``grad_proj/<leaf>`` (``proj_norm/<leaf>``: that
    vector's L2)."""
    scale = min(1.0, clip_norm / max(grad_norm, 1e-9))
    out: dict = {}
    for path, m in _leaves(m_tree):
        name = "/".join(path)
        g = np.asarray(m, np.float64) / ((1 - b1) * scale)
        r = np.random.default_rng([SEED, 7, zlib.crc32(name.encode())]).standard_normal(g.shape)
        out[f"grad/{name}"] = g.astype(np.float32)
        out[f"grad_l2/{name}"] = np.float64(np.linalg.norm(g))
        out[f"grad_proj/{name}"] = np.float64(np.sum(g * r))
        out[f"proj_norm/{name}"] = np.float64(np.linalg.norm(r))
    return out


def port_train_outputs(cfg, params: dict, inputs: dict, device, microbatches: int) -> dict:
    """The port's two train steps from ``params`` on ``inputs`` (the same
    batch twice), as numpy: the first step's ``loss``, ``grad_norm`` and
    ``lr``, ``grad_readings`` of its gradients, the parameters after it as
    ``params/<leaf>``, and the second step's loss as ``next_loss``."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import steps as S

    opt = O.OptConfig(**TRAIN_OPT)
    model = M.params_from_numpy(cfg, params, device=device)
    state = O.init_opt_state(model)
    step = S.make_train_step(cfg, opt, microbatches=microbatches)
    batch = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    model, state, m1 = step(model, state, batch)
    out = {k: np.float64(m1[k].item()) for k in ("loss", "grad_norm", "lr")}
    out.update(grad_readings(_map_tensors(state["m"]), float(m1["grad_norm"]), opt.b1, opt.clip_norm))
    out.update({f"params/{'/'.join(p)}": a for p, a in _leaves(M.params_to_numpy(model))})
    _, _, m2 = step(model, state, batch)
    out["next_loss"] = np.float64(m2["loss"].item())
    return out


def _map_tensors(tree: dict) -> dict:
    return {k: _map_tensors(v) if isinstance(v, dict) else v.detach().float().cpu().numpy() for k, v in tree.items()}


def train_fixture_subset(outputs: dict) -> dict:
    """What the training fixture keeps of a run's outputs: the scalars."""
    return {k: v for k, v in outputs.items() if not k.startswith(("grad/", "params/"))}


def read_train_fixture(path: pathlib.Path = TRAIN_FIXTURE) -> dict:
    """{(arch, microbatches): {name: value}} from the committed fixture."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            arch, mb, name = key.split("|", 2)
            out.setdefault((arch, int(mb)), {})[name] = float(z[key])
    return out


def write_train_fixture(outputs: dict, path: pathlib.Path = TRAIN_FIXTURE) -> None:
    """``outputs``: {(arch, microbatches): {name: value}}; each scalar stored
    as ``arch|microbatches|name``."""
    flat = {f"{arch}|{mb}|{name}": np.float64(v) for (arch, mb), d in outputs.items()
            for name, v in train_fixture_subset(d).items()}
    np.savez_compressed(path, **flat)


TRAIN_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4  # the CPU parity tests': the step's scalars; a leaf's gradient


def train_fixture_ratios(got: dict, want: dict) -> dict:
    """Each committed reading's distance from ``got`` as a share of its
    tolerance (1.0 at the limit): the step's scalars at ``TRAIN_RTOL``, a
    leaf's gradient L2 at ``TRAIN_GRAD_RTOL``, its projection at
    ``TRAIN_GRAD_RTOL`` times the gradient's and the vector's L2 (what a
    gradient within ``TRAIN_GRAD_RTOL`` can move it)."""
    out = {}
    for k, w in want.items():
        kind, _, leaf = k.partition("/")
        if kind == "grad_l2":
            tol = TRAIN_GRAD_RTOL * abs(w) + 1e-9
        elif kind == "grad_proj":
            tol = TRAIN_GRAD_RTOL * want[f"grad_l2/{leaf}"] * want[f"proj_norm/{leaf}"] + 1e-9
        else:
            tol = TRAIN_RTOL * abs(w) + 1e-12
        out[k] = abs(float(got[k]) - w) / tol
    return out


UPDATE_RTOL = 1e-5  # a leaf's updated value, relative L2
FLIP_SHARE = 1e-3  # elements of a leaf whose two gradients may differ in sign
FLIP_SIZE = 1e-4  # such an element's gradient, against the leaf's largest


def assert_updates_close(got_p, want_p, got_g, want_g, lr: float, weight_decay: float, what) -> None:
    """A leaf's updated values to a relative L2 of ``UPDATE_RTOL``. Adam's
    first step moves an element by lr · g / (|g| + eps): where the two runs'
    gradients differ in sign they are noise around zero (at most
    ``FLIP_SHARE`` of the leaf, each below ``FLIP_SIZE`` of its largest), and
    such an element is held to the sign step, 2 · lr · (1 + wd · |p|)."""
    flip = np.sign(got_g) != np.sign(want_g)
    assert flip.sum() <= max(1, FLIP_SHARE * flip.size), (what, int(flip.sum()))
    assert (np.abs(want_g[flip]) <= FLIP_SIZE * np.abs(want_g).max()).all(), what
    step = np.abs(got_p - want_p)[flip]
    assert (step <= 2 * lr * (1 + weight_decay * np.abs(want_p[flip])) * (1 + 1e-3)).all(), what
    rest_g, rest_w = np.asarray(got_p[~flip], np.float64), np.asarray(want_p[~flip], np.float64)
    rel = np.linalg.norm(rest_g - rest_w) / max(np.linalg.norm(rest_w), 1e-30)
    assert rel < UPDATE_RTOL, (what, rel)
