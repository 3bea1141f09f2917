#!/usr/bin/env python3
"""The bf16 forward of the port against the JAX package's, on the same
weights and tokens: are the port's bf16 distances the reference's own?

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_bf16_parity.py            # gemma3-4b's widths
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_bf16_parity.py --smoke    # its smoke widths

gemma3-4b at its published widths (``configs/gemma3_4b.py``: d 2,560, 8
heads over 4 KV heads of 256, window 1,024, vocabulary 262,144), its depth
cut to one cycle of the layer pattern (5 local layers, 1 global). Float32
weights from ``tests/torch_lm_harness.py numpy_params`` (a seed), cast to
bf16 in each package as its ``init_params`` types each leaf. Tokens are
drawn by numpy and fed to both packages (decode is teacher-forced). In each
package, in bf16: a prefill of ``--batch`` x ``--seq`` tokens, ``--steps``
decode steps, and a fresh prefill over seq + 1 tokens; in float32 the same
fresh prefill. Three relative L2 distances a package, as ``chip_smoke.py``
path 10 (a) reads them on the card:

  decode_vs_fresh   the first decode step against the fresh bf16 prefill;
  prefill_vs_f32    the fresh bf16 prefill against the float32 one;
  decode_vs_f32     the first decode step against the float32 prefill.

Also the two packages' bf16 logits against each other. The full width holds
1.24 G parameters in both packages, one package at a time: about 15 GB of
host memory and a few minutes on the CPU. The last line is a JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import resource
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_lm_harness as H  # noqa: E402
from repro import configs as J_configs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ARCH = "gemma3-4b"
DISTANCES = ("decode_vs_fresh", "prefill_vs_f32", "decode_vs_f32")
RATIO = 1.25  # the port's distance may be at most this many times the reference's


def one_cycle(cfg):
    """``cfg`` with its depth cut to one cycle of its layer pattern."""
    return dataclasses.replace(cfg, num_layers=len(cfg.layer_pattern))


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def tokens(cfg, batch: int, seq: int, steps: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq + steps)).astype(np.int32)


def jax_run(cfg, params: dict, toks: np.ndarray, seq: int, steps: int) -> dict:
    """The JAX package's logits: ``decode`` (each step, bf16), ``fresh``
    (bf16) and ``fresh32`` (float32), the fresh prefills over seq + 1."""
    b, max_len = toks.shape[0], toks.shape[1]
    prefill = jax.jit(lambda p, bt, c: JM.forward_prefill(p, cfg, bt, c))
    decode = jax.jit(lambda p, t, c: JM.forward_decode(p, cfg, t, c))
    out = {}
    shapes = jax.eval_shape(lambda k: JM.init_params(cfg, k, jnp.bfloat16), jax.random.PRNGKey(0))
    p32 = jax.tree.map(jnp.asarray, params)
    full = {"tokens": jnp.asarray(toks[:, : seq + 1])}
    out["fresh32"] = np.asarray(prefill(p32, full, JM.init_cache(cfg, b, max_len))[0])
    del p32
    gc.collect()
    p16 = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), params, shapes)
    logits, cache = prefill(p16, {"tokens": jnp.asarray(toks[:, :seq])}, JM.init_cache(cfg, b, max_len, jnp.bfloat16))
    out["prefill"] = np.asarray(logits)
    out["decode"] = []
    for i in range(steps):
        logits, cache = decode(p16, jnp.asarray(toks[:, seq + i : seq + i + 1]), cache)
        out["decode"].append(np.asarray(logits))
    del cache
    out["fresh"] = np.asarray(prefill(p16, full, JM.init_cache(cfg, b, max_len, jnp.bfloat16))[0])
    return out


def port_run(cfg, params: dict, toks: np.ndarray, seq: int, steps: int) -> dict:
    """The port's logits, named as ``jax_run`` names them."""
    b, max_len = toks.shape[0], toks.shape[1]
    t = torch.from_numpy(toks)
    full = {"tokens": t[:, : seq + 1]}
    out = {}
    with torch.inference_mode():
        model = M.params_from_numpy(cfg, params, device="cpu")
        out["fresh32"] = M.forward_prefill(model, cfg, full, M.init_cache(cfg, b, max_len, device="cpu"))[0].numpy()
        del model
        gc.collect()
        model = M.params_from_numpy(cfg, params, dtype=torch.bfloat16, device="cpu")
        cache = M.init_cache(cfg, b, max_len, dtype=torch.bfloat16, device="cpu")
        logits, cache = M.forward_prefill(model, cfg, {"tokens": t[:, :seq]}, cache)
        out["prefill"] = logits.numpy()
        out["decode"] = []
        for i in range(steps):
            logits, cache = M.forward_decode(model, cfg, t[:, seq + i : seq + i + 1], cache)
            out["decode"].append(logits.numpy())
        del cache
        cache = M.init_cache(cfg, b, max_len, dtype=torch.bfloat16, device="cpu")
        out["fresh"] = M.forward_prefill(model, cfg, full, cache)[0].numpy()
    return out


def ratio(port: float, ref: float) -> float:
    """The port's distance over the reference's; 1 where both are 0 (on the
    CPU a decode step and a fresh prefill may give the same bits)."""
    if ref == 0.0:
        return 1.0 if port == 0.0 else float("inf")
    return port / ref


def distances(run: dict) -> dict:
    """The three readings of one package's run."""
    dec = run["decode"][0]
    return {"decode_vs_fresh": rel_l2(dec, run["fresh"]), "prefill_vs_f32": rel_l2(run["fresh"], run["fresh32"]),
            "decode_vs_f32": rel_l2(dec, run["fresh32"])}


def compare(smoke: bool, batch: int, seq: int, steps: int) -> dict:
    """Both packages on one set of weights and tokens: each package's three
    distances, the port's over the reference's, and the packages' bf16
    logits against each other."""
    cfg = one_cycle((configs.get_smoke if smoke else configs.get_config)(ARCH))
    jcfg = one_cycle((J_configs.get_smoke if smoke else J_configs.get_config)(ARCH))
    params = H.numpy_params(M.param_shapes(cfg))
    toks = tokens(cfg, batch, seq, steps)
    t0 = time.perf_counter()
    ref = jax_run(jcfg, params, toks, seq, steps)
    jax_s = time.perf_counter() - t0
    gc.collect()
    t0 = time.perf_counter()
    got = port_run(cfg, params, toks, seq, steps)
    port_s = time.perf_counter() - t0
    finite = all(np.isfinite(r[k]).all() for r in (ref, got) for k in ("prefill", "fresh", "fresh32"))
    finite = finite and all(np.isfinite(x).all() for r in (ref, got) for x in r["decode"])
    dj, dp = distances(ref), distances(got)
    return {
        "arch": cfg.name, "widths": "smoke" if smoke else "published", "layers": cfg.num_layers,
        "d_model": cfg.d_model, "vocab": cfg.vocab_size, "batch": batch, "seq": seq, "steps": steps,
        "finite": bool(finite), "jax": dj, "port": dp, "port_over_jax": {k: ratio(dp[k], dj[k]) for k in DISTANCES},
        "port_vs_jax_bf16": {"prefill": rel_l2(got["prefill"], ref["prefill"]),
                             "decode": [rel_l2(a, b) for a, b in zip(got["decode"], ref["decode"])],
                             "fresh": rel_l2(got["fresh"], ref["fresh"])},
        "port_vs_jax_f32": rel_l2(got["fresh32"], ref["fresh32"]),
        "jax_s": jax_s, "port_s": port_s,
        "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="gemma3-4b's smoke widths instead of its published ones")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    out = compare(args.smoke, args.batch, args.seq, args.steps)
    for k in DISTANCES:
        print(f"{k:16s} jax {out['jax'][k]:.4e}  port {out['port'][k]:.4e}  port/jax {out['port_over_jax'][k]:.3f}")
    print(json.dumps(out))
    return 0 if out["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
