#!/usr/bin/env python3
"""Show that chip_smoke.py's full-size flash_attention check fails a faulty kernel.

    python3 tools/flash_planted_fault.py

Needs a CUDA device and ``nvcc``. Builds, in a temporary directory, copies
of ``src/repro_torch/kernels/csrc/flash_attention.cu`` with one planted
fault each in the consumer loop of its tensor-core (bf16) kernel, where a
consumer warpgroup decides whether to compute a key tile:

- ``skip-last-tile``: every 64-row query tile skips the last key tile it
  would compute (under the causal mask, the tile that holds the diagonal);
- ``skip-last-tile-late``: only the query tiles in the second half of the
  sequence skip it, where a row attends over thousands of keys and its
  output is small.

A skipped tile is still waited for and released, so the producer and the
consumers stay in step and a faulty copy finishes.

It runs the kernel and each faulty copy at the smoke's two full-size
prefill shapes (qwen3-8b and gemma2-9b local layer, bf16, inputs made by
the smoke's ``prefill_inputs`` from seed 0) and holds each against the
plain version. For each it prints the max abs difference and the worst
ratio of ``|got - want|`` to the smoke's limit, ``1e-4 + 2^-7·|want|``, and to the JAX tests' bf16 tolerance,
``2e-2 + 2e-2·|want|`` (``tests/test_kernels.py``); a ratio above 1 fails.
The last line is one JSON object with every reading. Exits nonzero if the
kernel fails the smoke's limit or a faulty copy passes it.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
LOOP = "      const bool skip = t < t_lo || t > t_hi;"
FAULTS = {
    "skip-last-tile": "      const bool skip = t < t_lo || t >= t_hi;",
    "skip-last-tile-late": "      const bool skip = t < t_lo || t > t_hi - (2 * q0 >= s_len ? 1 : 0);",
}
JAX_TESTS_BF16_TOL = 2e-2


def build_faulty(tmp: pathlib.Path, nvcc: str, flags) -> dict:
    """One library per planted fault, all built at once."""
    source = (CSRC / "flash_attention.cu").read_text()
    if source.count(LOOP) != 1:
        raise RuntimeError("the key-tile test of flash_attention.cu is not where this script plants its faults")

    def build(name: str) -> pathlib.Path:
        cu, so = tmp / f"{name}.cu", tmp / f"{name}.so"
        cu.write_text(source.replace(LOOP, FAULTS[name]))
        subprocess.run([nvcc, *flags, "-I", str(CSRC), "-o", str(so), str(cu)], check=True, capture_output=True,
                       text=True)
        return so

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(FAULTS)) as pool:
        paths = dict(zip(FAULTS, pool.map(build, FAULTS)))
    return {name: ctypes.CDLL(str(p)) for name, p in paths.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_planted_fault: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = smoke.card_line()
    smoke.log(f"card: {card}")
    readings, ok = [], True
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"kernel": _build.load("flash_attention"), **build_faulty(pathlib.Path(tmp), _build.find_nvcc(),
                                                                          _build.NVCC_FLAGS)}
        gen = torch.Generator(device=dev).manual_seed(0)
        for what, (qkv, kw) in zip(("qwen3-8b", "gemma2-9b local"), smoke.prefill_inputs(gen, dev)):
            want = smoke.flash_plain(fa.flash_attention_torch, qkv, kw)
            scale = qkv[0].shape[-1] ** -0.5
            for name, lib in libs.items():
                got = torch.empty_like(qkv[0])
                fa._launch(lib, *qkv, got, scale, kw["causal"], kw.get("window"), kw.get("softcap"),
                           torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                r = dict(call=what, kernel=name, max_abs_err=float((got.float() - want.float()).abs().max()),
                         smoke_ratio=smoke.tol_ratio(got, want, smoke.BF16_RTOL, smoke.BF16_ATOL),
                         jax_tests_ratio=smoke.tol_ratio(got, want, JAX_TESTS_BF16_TOL, JAX_TESTS_BF16_TOL))
                r["smoke_check"] = "passes" if r["smoke_ratio"] <= 1 else "fails"
                r["jax_tests_check"] = "passes" if r["jax_tests_ratio"] <= 1 else "fails"
                ok &= (r["smoke_check"] == "passes") == (name == "kernel")
                readings.append(r)
                smoke.log(f"{what} {name}: max abs err {r['max_abs_err']:.3e}; smoke limit ratio "
                          f"{r['smoke_ratio']:.3f} ({r['smoke_check']}); JAX tests' tolerance ratio "
                          f"{r['jax_tests_ratio']:.3f} ({r['jax_tests_check']})")
            del want
    smoke.log(json.dumps({"card": card, "readings": readings, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
