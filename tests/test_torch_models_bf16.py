"""The port's bf16 forward against the JAX package's, past one layer: the
check of ``tools/lm_bf16_parity.py`` at narrow width.

gemma3-4b's smoke config, one cycle of its layer pattern (5 local layers, 1
global), bf16 weights cast from the same float32 numpy weights in each
package, the same tokens: a prefill, 4 decode steps and a fresh prefill over
seq + 1 in bf16, the fresh prefill in float32. Each of the port's three
distances (decode against the fresh prefill; the bf16 prefill and the first
decode step against the float32 prefill) is at most ``RATIO`` (1.25) times
the reference's own. The tool prints the same at gemma3-4b's published
widths.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def parity():
    spec = importlib.util.spec_from_file_location("lm_bf16_parity", ROOT / "tools" / "lm_bf16_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reading(parity):
    return parity.compare(smoke=True, batch=2, seq=40, steps=4)


def test_bf16_run_is_finite_and_one_cycle_deep(reading):
    assert reading["finite"] and reading["layers"] == 6 and reading["widths"] == "smoke"
    assert reading["port_vs_jax_f32"] < 1e-4  # the float32 forwards agree, as the parity tests hold them


@pytest.mark.parametrize("distance", ["decode_vs_fresh", "prefill_vs_f32", "decode_vs_f32"])
def test_port_bf16_distance_is_the_references_own(parity, reading, distance):
    port, ref = reading["port"][distance], reading["jax"][distance]
    assert reading["port_over_jax"][distance] <= parity.RATIO, (distance, port, ref)
    if ref > 0:  # the packages' bf16 rounding moves the logits alike
        assert port > 0
