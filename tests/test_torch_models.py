"""The port's LM (``repro_torch.models`` and ``repro_torch.configs``) against
the JAX package's on the same weights and inputs.

For each of the 10 smoke configs the weights are random in every leaf
(``tests/torch_lm_harness.py numpy_params``: norms, biases, ``a_log``,
``dt_bias`` and ``d_skip`` away from their zero/one inits), carried into the
port by ``params_from_numpy``, and ``forward_train``, ``forward_prefill``
(logits and every cache leaf) and one ``forward_decode`` are held to the JAX
package's at rtol 1e-4, atol 1e-5, in float32 on the CPU. The JAX side runs
once per architecture (a module-scoped fixture).
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

import torch_lm_harness as H
from repro import configs as J_configs
from repro.models import model as JM
from repro_torch import configs
from repro_torch.models import model as M

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5


def _load_fixture_tool():
    spec = importlib.util.spec_from_file_location("lm_fixture", ROOT / "tools" / "lm_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LF = _load_fixture_tool()


@pytest.fixture(scope="module", params=configs.ARCH_NAMES)
def arch_ref(request):
    """(arch, the JAX package's outputs at ``PARITY_SETUP``)."""
    return request.param, LF.jax_outputs(request.param, H.PARITY_SETUP)


def _port(arch, setup, device="cpu"):
    cfg = configs.get_smoke(arch)
    params = H.numpy_params(M.param_shapes(cfg))
    inputs = H.numpy_inputs(cfg, setup["batch"], setup["seq"])
    return H.port_outputs(cfg, params, inputs, setup["max_len"], device)


def test_forward_train_prefill_decode_equal_jax(arch_ref):
    arch, ref = arch_ref
    got = _port(arch, H.PARITY_SETUP)
    assert int(ref["prefill_pos"]) == H.PARITY_SETUP["seq"] and int(ref["decode_pos"]) == H.PARITY_SETUP["seq"] + 1
    names = [k for k in ref if not k.endswith("_pos")]
    assert sorted(names) == sorted(got), arch
    for k in names:
        assert got[k].shape == ref[k].shape, (arch, k)
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL, err_msg=f"{arch} {k}")
    if configs.get_smoke(arch).family == "moe":
        assert got["aux_loss"] > 0


def test_cache_pos_is_an_int_and_the_cache_is_updated_in_place():
    cfg = configs.get_smoke("hymba-1.5b")
    model = M.params_from_numpy(cfg, H.numpy_params(M.param_shapes(cfg)), device="cpu")
    inputs = H.numpy_inputs(cfg, 2, 12)
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    leaves = {k: v for k, v in cache.items() if k != "pos"}
    with torch.inference_mode():
        _, out = M.forward_prefill(model, cfg, {"tokens": torch.from_numpy(inputs["tokens"])}, cache)
        assert out is cache and cache["pos"] == 12 and type(cache["pos"]) is int
        _, out = M.forward_decode(model, cfg, torch.from_numpy(inputs["next"]), cache)
    assert out is cache and cache["pos"] == 13
    assert all(cache[k] is v for k, v in leaves.items())
    assert cache["k"][:, :, :, 12].abs().sum() > 0 and cache["k"][:, :, :, 13:].abs().sum() == 0


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_prefill_then_decode_matches_full_forward(arch):
    """The port's own cache paths (KV, SSM state, conv, cross): prefill over
    t_0..t_{n-1} then a decode of t_n gives the logits of a fresh prefill
    over t_0..t_n."""
    cfg = configs.get_smoke(arch)
    model = M.params_from_numpy(cfg, H.numpy_params(M.param_shapes(cfg), seed=2), device="cpu")
    b, s, max_len = 2, 16, 32
    inputs = H.numpy_inputs(cfg, b, s, seed=3)
    batch = {k: torch.from_numpy(v) for k, v in inputs.items() if k not in ("next", "targets")}
    nxt = torch.from_numpy(inputs["next"])
    with torch.inference_mode():
        _, cache = M.forward_prefill(model, cfg, batch, M.init_cache(cfg, b, max_len, device="cpu"))
        logits_dec, cache = M.forward_decode(model, cfg, nxt, cache)
        full = dict(batch, tokens=torch.cat([batch["tokens"], nxt], dim=1))
        logits_full, _ = M.forward_prefill(model, cfg, full, M.init_cache(cfg, b, max_len, device="cpu"))
    assert logits_dec.shape == (b, cfg.vocab_size) and cache["pos"] == s + 1
    np.testing.assert_allclose(logits_dec.numpy(), logits_full.numpy(), rtol=RTOL, atol=ATOL, err_msg=arch)


def test_bf16_prefill_then_decode_is_consistent():
    """The serving check of the smoke's path 10 (a), on gemma3's smoke config
    in bfloat16: decode logits against a fresh prefill, relative L2 < 2e-2."""
    cfg = configs.get_smoke("gemma3-4b")
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")
    b, s = 2, 40
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        cache = M.init_cache(cfg, b, 64, dtype=torch.bfloat16, device="cpu")
        _, cache = M.forward_prefill(model, cfg, {"tokens": tokens[:, :s]}, cache)
        dec, _ = M.forward_decode(model, cfg, tokens[:, s:], cache)
        full, _ = M.forward_prefill(model, cfg, {"tokens": tokens}, M.init_cache(cfg, b, 64, dtype=torch.bfloat16,
                                                                                   device="cpu"))
    assert dec.dtype == torch.float32 and torch.isfinite(dec).all()
    assert float(torch.linalg.norm(dec - full) / torch.linalg.norm(full)) < 2e-2


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_param_shapes_equal_jax_eval_shape(arch, size):
    cfg = (configs.get_config if size == "full" else configs.get_smoke)(arch)
    jcfg = (J_configs.get_config if size == "full" else J_configs.get_smoke)(arch)
    for jdt, tdt in ((jax.numpy.float32, torch.float32), (jax.numpy.bfloat16, torch.bfloat16)):
        want = LF.jax_shapes(jcfg, jdt)
        got = jax.tree.map(lambda leaf: (tuple(leaf[0]), str(leaf[1]).replace("torch.", "")), M.param_shapes(cfg, tdt),
                           is_leaf=lambda x: isinstance(x, tuple))
        assert got == want, (arch, size, tdt)
    if size == "smoke":  # the built model holds those shapes, less the layer axis
        model = M.CausalLM(cfg, device="cpu")
        for path, (shape, dt) in M._leaves(M.param_shapes(cfg)):
            t = M._param(model[path[0]][0], path[1:]) if path[0] in ("layers", "encoder") else M._param(model, path)
            assert tuple(t.shape) == (tuple(shape[1:]) if path[0] in ("layers", "encoder") else tuple(shape))


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_params_round_trip_through_numpy(arch):
    cfg = configs.get_smoke(arch)
    tree = H.numpy_params(M.param_shapes(cfg), seed=5)
    back = M.params_to_numpy(M.params_from_numpy(cfg, tree, device="cpu"))
    flat, back_flat = dict(M._leaves(tree)), dict(M._leaves(back))
    assert flat.keys() == back_flat.keys()
    for k, a in flat.items():
        assert back_flat[k].dtype == a.dtype and np.array_equal(back_flat[k], a), k


def test_params_from_numpy_rejects_a_wrong_tree():
    cfg = configs.get_smoke("qwen2-1.5b")
    tree = H.numpy_params(M.param_shapes(cfg))
    del tree["layers"]["bq"]
    with pytest.raises(ValueError, match="missing"):
        M.params_from_numpy(cfg, tree, device="cpu")
    tree = H.numpy_params(M.param_shapes(cfg))
    tree["embed"] = tree["embed"][:-1]
    with pytest.raises(ValueError, match="shape"):
        M.params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-moe-16b", "whisper-small", "qwen3-8b"])
def test_init_params_follows_the_reference_init(arch):
    """Zeros and ones where the reference's ``init_params`` puts them, and
    each drawn leaf's spread near the reference's (the draws themselves come
    from another generator)."""
    cfg = configs.get_smoke(arch)
    want = dict(M._leaves(jax.tree.map(np.asarray, JM.init_params(J_configs.get_smoke(arch), jax.random.PRNGKey(0)))))
    got = dict(M._leaves(M.params_to_numpy(M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                                         device="cpu"))))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if np.all(w == 0) or np.all(w == 1):
            assert np.array_equal(g, w), k
        else:
            assert 0.75 < g.std() / w.std() < 1.33, (k, g.std(), w.std())


def test_init_params_on_bf16_keeps_the_float32_leaves():
    cfg = configs.get_smoke("hymba-1.5b")
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")
    dts = {name.rsplit(".", 1)[-1]: p.dtype for name, p in model.named_parameters()}
    assert dts["a_log"] == dts["dt_bias"] == torch.float32 and dts["wq"] == torch.bfloat16


def test_moe_router_stays_float32_in_bf16():
    cfg = configs.get_smoke("granite-moe-3b-a800m")
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")
    assert model.layers[0].router.dtype == torch.float32 and model.layers[0].w1.dtype == torch.bfloat16


def test_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.params_from_numpy(cfg, H.numpy_params(M.param_shapes(cfg)))


def test_configs_and_config_module_are_byte_equal_copies():
    port, ref = ROOT / "src" / "repro_torch", ROOT / "src" / "repro"
    files = ["models/config.py", "models/__init__.py"]
    files += [f"configs/{p.name}" for p in sorted((ref / "configs").glob("*.py"))]
    assert len(files) == 13
    for f in files:
        assert (port / f).read_bytes() == (ref / f).read_bytes(), f
    assert configs.ARCH_NAMES == J_configs.ARCH_NAMES
    for arch in configs.ARCH_NAMES:
        assert dataclasses.asdict(configs.get_config(arch)) == dataclasses.asdict(J_configs.get_config(arch))
        assert configs.get_config(arch).param_count() == J_configs.get_config(arch).param_count()
