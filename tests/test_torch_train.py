"""The port's training (``repro_torch.train``, ``repro_torch.launch.train``)
against the JAX package's on the CPU, and its remat sites.

* ``optimizer``: ``adamw_update`` over three steps on a tree mixing float32
  and bf16 leaves, with clipping and bias correction at steps 1-3: float32
  parameters, ``m`` and ``v`` to a relative L2 of 1e-6 a leaf, bf16 leaves
  to one bf16 ulp an element;
  ``lr_schedule`` at steps 0-120 and ``global_norm`` to rtol 1e-6. The
  reference's tests of the quadratic and the schedule's shape, on the port.
* ``tests/test_system.py``'s three training behaviours on the port: it learns
  the synthetic chain, a 4-microbatch step agrees with the plain one (loss
  rel 2e-3, update cosine above 0.99), and a checkpoint saved at k = 4 and
  restored at k = 3 gives the same next-step loss (rel 1e-6).
* Checkpoints across packages: a training checkpoint written by either
  package and restored by the other gives the writer's next-step loss to
  rel 1e-5.
* ``launch.train.main`` on the CPU, and asking it for the card without one.
* Remat: ``forward_train`` with ``remat`` on and off gives the same loss and
  gradients (rel 1e-6); the bytes autograd saves outside the checkpoints
  (counted by ``saved_tensors_hooks``) stay below one logits chunk in the
  loss and shrink with ``remat`` in the layer stack; under
  ``torch.inference_mode()`` no checkpoint runs.
"""
import torch_threads  # noqa: F401  (first: the thread count of this process)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_harness as H
from repro import configs as J_configs
from repro.checkpoint import store as J_store
from repro.data import pipeline as J_dp
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train import steps as JS
from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.data import pipeline as dp
from repro_torch.launch import train as LT
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import optimizer as O
from repro_torch.train import steps as S

F32_RTOL = 1e-6  # the optimizer's float32 arithmetic, op for op
REMAT_RTOL = 1e-6


# ------------------------------------------------------------------ optimizer
def _mixed_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": rng.standard_normal(7).astype(np.float32),
            "nested": {"c": rng.standard_normal(5).astype(np.float32),
                       "d": rng.standard_normal((2, 3)).astype(np.float32)}}


BF16_LEAVES = {("b",), ("nested", "d")}


def _as_jax(tree, path=()):
    if isinstance(tree, dict):
        return {k: _as_jax(v, path + (k,)) for k, v in tree.items()}
    return jnp.asarray(tree, jnp.bfloat16 if path in BF16_LEAVES else jnp.float32)


def _as_torch(tree, path=()):
    if isinstance(tree, dict):
        return {k: _as_torch(v, path + (k,)) for k, v in tree.items()}
    return torch.from_numpy(tree).to(torch.bfloat16 if path in BF16_LEAVES else torch.float32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_tree_close(got, want, what, path=()):
    if isinstance(want, dict):
        for k in want:
            _assert_tree_close(got[k], want[k], what, path + (k,))
        return
    g, w = _np(got), _np(want)
    if path in BF16_LEAVES and path[0] not in ("m", "v"):
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (np.abs(g - w) <= ulp).all(), (what, path)
    else:  # the leaf's relative L2: an element where two terms cancel keeps only their ulps
        rel = np.linalg.norm(g.astype(np.float64) - w) / np.linalg.norm(w.astype(np.float64))
        assert rel < F32_RTOL, (what, path, rel)


def test_adamw_update_equals_jax_on_mixed_tree():
    """Three steps, grads drawn anew each step (the second large enough to
    clip): parameters, moments, step, grad norm and learning rate."""
    opt = O.OptConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    jopt = JO.OptConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    assert dataclasses.asdict(opt) == dataclasses.asdict(jopt)
    start = _mixed_tree(0)
    jp, tp = _as_jax(start), _as_torch(start)
    js, ts = JO.init_opt_state(jp), O.init_opt_state(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    assert all(leaf.dtype == torch.float32 for leaf in jax.tree.leaves(ts["m"]))
    for i, gain in enumerate((0.1, 5.0, 0.3)):
        g = jax.tree.map(lambda a: gain * a, _mixed_tree(10 + i))
        jp, js, jm = JO.adamw_update(jp, _as_jax(g), js, jopt)
        tp2, ts2, tm = O.adamw_update(tp, _as_torch(g), ts, opt)
        assert tp2 is tp and ts2 is ts  # in place
        assert int(ts["step"]) == int(js["step"]) == i + 1
        _assert_tree_close(tp, jp, f"params after step {i + 1}")
        _assert_tree_close({"m": ts["m"], "v": ts["v"]}, {"m": js["m"], "v": js["v"]}, f"moments after step {i + 1}")
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=F32_RTOL), (i, k)
    assert float(jm["grad_norm"]) > 0 and float(O.global_norm(_as_torch(_mixed_tree(11)))) * 5.0 > opt.clip_norm


def test_lr_schedule_equals_jax():
    for kw in ({}, dict(peak_lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)):
        opt, jopt = O.OptConfig(**kw), JO.OptConfig(**kw)
        for step in range(121):
            got = O.lr_schedule(opt, step)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(JO.lr_schedule(jopt, step)), rel=F32_RTOL), (kw, step)


def test_global_norm_equals_jax():
    tree = _mixed_tree(3)
    assert float(O.global_norm(_as_torch(tree))) == pytest.approx(float(JO.global_norm(_as_jax(tree))), rel=F32_RTOL)


def test_adamw_reduces_quadratic_loss():
    params = {"w": torch.tensor([2.0, -3.0, 1.5])}
    opt = O.OptConfig(peak_lr=0.1, warmup_steps=5, total_steps=200, weight_decay=0.0)
    state = O.init_opt_state(params)
    for _ in range(150):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w**2), [w])
        params, state, _ = O.adamw_update(params, {"w": g}, state, opt)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


def test_lr_schedule_shape():
    opt = O.OptConfig(peak_lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(O.lr_schedule(opt, 0)) < 0.2
    assert float(O.lr_schedule(opt, 10)) == pytest.approx(1.0, rel=0.05)
    assert float(O.lr_schedule(opt, 99)) == pytest.approx(0.1, rel=0.15)


def test_opt_state_holds_the_reference_tree():
    """m and v take the reference's stacked shapes, float32 at any parameter
    dtype; a layer's update writes its slice of them."""
    cfg = configs.get_smoke("deepseek-moe-16b")
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")
    state = O.init_opt_state(model)
    want = {"/".join(p): s for p, (s, _) in M._leaves(M.param_shapes(cfg))}
    for key in ("m", "v"):
        got = {"/".join(p): leaf for p, leaf in M._leaves(state[key])}
        assert sorted(got) == sorted(want)
        assert all(tuple(got[k].shape) == tuple(want[k]) and got[k].dtype == torch.float32 for k in want)
    grads = {n: torch.ones_like(p) if n == "layers.1.shared.w2" else None for n, p in model.named_parameters()}
    O.adamw_update(model, grads, state, O.OptConfig())
    assert state["m"]["layers"]["shared"]["w2"][1].abs().min() > 0
    assert state["m"]["layers"]["shared"]["w2"][0].abs().max() == 0 and state["m"]["embed"].abs().max() == 0


def test_prefill_and_decode_steps_wrap_the_forwards():
    cfg = configs.get_smoke("hymba-1.5b")
    model = M.params_from_numpy(cfg, H.numpy_params(M.param_shapes(cfg)), device="cpu")
    inputs = H.numpy_inputs(cfg, 2, 12)
    batch, nxt = {"tokens": torch.from_numpy(inputs["tokens"])}, torch.from_numpy(inputs["next"])
    got, cache = S.make_prefill_step(cfg)(model, batch, M.init_cache(cfg, 2, 16, device="cpu"))
    got_dec, cache = S.make_decode_step(cfg)(model, nxt, cache)
    with torch.inference_mode():
        want, ref_cache = M.forward_prefill(model, cfg, batch, M.init_cache(cfg, 2, 16, device="cpu"))
        want_dec, _ = M.forward_decode(model, cfg, nxt, ref_cache)
    assert torch.equal(got, want) and torch.equal(got_dec, want_dec) and cache["pos"] == 13


# ------------------------------------------------- tests/test_system.py on the port
def _torch_batch(gb: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in gb.items()}


def test_training_learns_the_synthetic_chain():
    """A few dozen steps on the Markov-chain data must beat the noise floor."""
    cfg = configs.get_smoke("qwen2-1.5b")
    dc = dp.DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=16)
    opt = O.OptConfig(peak_lr=2e-3, warmup_steps=10, total_steps=80)
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state = O.init_opt_state(model)
    step_fn = S.make_train_step(cfg, opt)
    losses = []
    for step in range(80):
        model, state, m = step_fn(model, state, _torch_batch(dp.global_batch(dc, step)))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    # ln(V) ≈ 6.24 noise floor; the chain is 7/8 predictable once learned.
    assert np.mean(losses[-10:]) < np.mean(losses[:5]) - 1.0, losses[::10]


def test_microbatched_step_matches_plain_grads_direction():
    cfg = configs.get_smoke("gemma3-4b")
    dc = dp.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    opt = O.OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    gb = _torch_batch(dp.global_batch(dc, 0))
    runs = []
    for mb in (1, 4):
        model = M.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
        before = model["embed"].detach().clone()
        model, _, m = S.make_train_step(cfg, opt, microbatches=mb)(model, O.init_opt_state(model), gb)
        runs.append((float(m["loss"]), (model["embed"].detach() - before).numpy(), m))
    (l1, d1, m1), (l2, d2, m2) = runs
    assert l2 == pytest.approx(l1, rel=2e-3)
    cos = (d1 * d2).sum() / (np.linalg.norm(d1) * np.linalg.norm(d2) + 1e-12)
    assert cos > 0.99
    assert set(m2) == {"loss", "grad_norm", "lr"} and {"ce_loss", "aux_loss"} <= set(m1)  # as the reference


def _next_loss(cfg, opt, model, state, gb) -> float:
    return float(S.make_train_step(cfg, opt)(model, state, _torch_batch(gb))[2]["loss"])


def test_elastic_rescale_preserves_training_state(tmp_path):
    """save @k=4 → restore @k=3 must reproduce the exact same next-step loss."""
    cfg = configs.get_smoke("qwen2-1.5b")
    dc = dp.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    opt = O.OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    model = M.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    state = O.init_opt_state(model)
    step_fn = S.make_train_step(cfg, opt)
    for step in range(3):
        model, state, _ = step_fn(model, state, _torch_batch(dp.global_batch(dc, step)))
    store.save(LT.checkpoint_tree(model, state), tmp_path, step=3, k_shards=4)
    template = LT.checkpoint_tree(model, O.init_opt_state(model))
    tree, _ = store.restore(tmp_path, 3, k_new=3, template=template)
    assert int(tree["opt"]["step"]) == 3 and isinstance(tree["opt"]["m"]["embed"], torch.Tensor)
    restored = M.params_from_numpy(cfg, tree["params"], device="cpu")
    want = _next_loss(cfg, opt, model, state, dp.global_batch(dc, 3))
    got = _next_loss(cfg, opt, restored, tree["opt"], dp.global_batch(dc, 3))
    assert got == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------ checkpoints across packages
CKPT_ARCH = "gemma2-9b"  # softcaps, qk-free dense with local and global layers


def _ckpt_setup():
    cfg, jcfg = configs.get_smoke(CKPT_ARCH), J_configs.get_smoke(CKPT_ARCH)
    dc = dp.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    return cfg, jcfg, dc, O.OptConfig(**kw), JO.OptConfig(**kw), H.numpy_params(M.param_shapes(cfg))


def _jax_steps(jcfg, jopt, params, dc, steps):
    step_fn = jax.jit(JS.make_train_step(jcfg, jopt))
    params = jax.tree.map(jnp.asarray, params)
    state = JO.init_opt_state(params)
    for step in steps:
        params, state, m = step_fn(params, state, {k: jnp.asarray(v) for k, v in J_dp.global_batch(dc, step).items()})
    return params, state, m


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    cfg, jcfg, dc, opt, jopt, params = _ckpt_setup()
    jp, js, _ = _jax_steps(jcfg, jopt, params, dc, range(2))
    J_store.save({"params": jp, "opt": js}, tmp_path, step=2, k_shards=4)
    _, _, m_writer = _jax_steps(jcfg, jopt, params, dc, range(3))
    model = M.params_from_numpy(cfg, params, device="cpu")
    tree, _ = store.restore(tmp_path, 2, k_new=3, template=LT.checkpoint_tree(model, O.init_opt_state(model)))
    restored = M.params_from_numpy(cfg, tree["params"], device="cpu")
    assert int(tree["opt"]["step"]) == 2
    got = _next_loss(cfg, opt, restored, tree["opt"], dp.global_batch(dc, 2))
    assert got == pytest.approx(float(m_writer["loss"]), rel=1e-5)


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    cfg, jcfg, dc, opt, jopt, params = _ckpt_setup()
    model = M.params_from_numpy(cfg, params, device="cpu")
    state = O.init_opt_state(model)
    step_fn = S.make_train_step(cfg, opt)
    for step in range(2):
        model, state, _ = step_fn(model, state, _torch_batch(dp.global_batch(dc, step)))
    store.save(LT.checkpoint_tree(model, state), tmp_path, step=2, k_shards=4)
    want = _next_loss(cfg, opt, model, state, dp.global_batch(dc, 2))
    jp = jax.tree.map(jnp.asarray, params)
    tree, _ = J_store.restore(tmp_path, 2, k_new=5, template={"params": jp, "opt": JO.init_opt_state(jp)})
    assert int(tree["opt"]["step"]) == 2
    gb = {k: jnp.asarray(v) for k, v in J_dp.global_batch(dc, 2).items()}
    _, _, m = jax.jit(JS.make_train_step(jcfg, jopt))(tree["params"], tree["opt"], gb)
    assert float(m["loss"]) == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------- the launcher
def test_launch_train_on_the_cpu_writes_its_checkpoint(tmp_path, capsys):
    read = LT.main(["--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16", "--hosts", "2",
                    "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    assert len(read["losses"]) == 3 and np.isfinite(read["losses"]).all() and read["checkpoints"] == [2]
    assert "device=cpu" in capsys.readouterr().out
    tree, _ = store.restore(tmp_path, 2, k_new=3)
    assert "params/embed" in tree and int(tree["opt/step"]) == 3
    assert tree["params/embed"].shape == (configs.get_smoke("qwen2-1.5b").vocab_size,
                                          configs.get_smoke("qwen2-1.5b").d_model)


def test_launch_train_asked_for_the_card_without_one_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LT.main(argv + ["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


# --------------------------------------------------------------------- remat
def _train_batch(cfg) -> dict:
    return {k: torch.from_numpy(v) for k, v in H.train_inputs(cfg).items()}


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_forward_train_remat_on_and_off_agree(arch):
    cfg = configs.get_smoke(arch)
    params = H.numpy_params(M.param_shapes(cfg))
    runs = []
    for remat in (True, False):
        model = M.params_from_numpy(cfg, params, device="cpu")
        loss, metrics = M.forward_train(model, cfg, _train_batch(cfg), remat=remat)
        loss.backward()
        runs.append((loss.item(), metrics["aux_loss"].item(), {n: p.grad for n, p in model.named_parameters()}))
    (l1, a1, g1), (l2, a2, g2) = runs
    assert l1 == pytest.approx(l2, rel=REMAT_RTOL) and a1 == pytest.approx(a2, rel=REMAT_RTOL, abs=1e-12)
    for n in g2:
        assert torch.isfinite(g1[n]).all(), (arch, n)
        torch.testing.assert_close(g1[n], g2[n], rtol=REMAT_RTOL, atol=1e-9, msg=f"{arch} {n}")


class SavedBytes:
    """Bytes autograd packs for backward while the context is open (outside
    any checkpoint: a checkpoint's own hooks take what is saved inside it),
    each storage counted once."""

    def __init__(self):
        self.storages = {}

    def pack(self, t):
        self.storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    def __enter__(self):
        self._ctx = torch.autograd.graph.saved_tensors_hooks(self.pack, lambda t: t)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)

    @property
    def total(self) -> int:
        return sum(self.storages.values())


def test_chunked_ce_loss_saves_less_than_one_chunk(monkeypatch):
    """With each chunk a remat site, no chunk's (B, c, V) float32 logits are
    kept for backward; without the site, every chunk's are."""
    b, s, d, v, c = 2, 64, 16, 1000, 16
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((b, s, d), generator=gen, requires_grad=True)
    embed = torch.randn((v, d), generator=gen, requires_grad=True)
    targets = torch.randint(0, v, (b, s), generator=gen)
    one_chunk = b * c * v * 4
    with SavedBytes() as saved:
        loss = M.chunked_ce_loss(x, embed, targets, chunk=c, softcap=30.0)
    loss.backward()
    assert saved.total < one_chunk, (saved.total, one_chunk)
    monkeypatch.setattr(L, "remat", lambda fn, *args: fn(*args))
    with SavedBytes() as kept:
        loss_kept = M.chunked_ce_loss(x, embed, targets, chunk=c, softcap=30.0)
    assert kept.total >= (s // c) * one_chunk and float(loss_kept) == pytest.approx(float(loss), rel=REMAT_RTOL)


@pytest.mark.parametrize("arch", ["gemma3-4b", "hymba-1.5b"])
def test_remat_shrinks_what_the_layer_stack_saves(arch):
    cfg = dataclasses.replace(configs.get_smoke(arch), num_layers=6)
    model = M.params_from_numpy(cfg, H.numpy_params(M.param_shapes(cfg)), device="cpu")
    totals = {}
    for remat in (True, False):
        with SavedBytes() as saved:
            loss, _ = M.forward_train(model, cfg, _train_batch(cfg), remat=remat)
        loss.backward()
        totals[remat] = saved.total
    assert totals[True] * 3 < totals[False], totals


def test_no_checkpoint_runs_under_inference_mode(monkeypatch):
    """Under autograd every one of the reference's five sites is a checkpoint
    (layer body, encoder body, loss chunk, attention query slice, SSD chunk
    step); serving under ``torch.inference_mode()`` calls each directly."""
    seen = []
    real = L._ckpt.checkpoint

    def counting(fn, *args, **kw):
        seen.append(fn.__qualname__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(L._ckpt, "checkpoint", counting)
    for arch in ("whisper-small", "hymba-1.5b"):
        cfg = configs.get_smoke(arch)
        model = M.params_from_numpy(cfg, H.numpy_params(M.param_shapes(cfg)), device="cpu")
        batch = _train_batch(cfg)
        with torch.inference_mode():
            M.forward_train(model, cfg, batch)
            cache = M.init_cache(cfg, 2, batch["tokens"].shape[1] + 1, device="cpu")
            M.forward_prefill(model, cfg, batch, cache)
            M.forward_decode(model, cfg, batch["tokens"][:, :1], cache)
        assert seen == [], arch
        with torch.no_grad():
            M.forward_train(model, cfg, batch)
        assert seen == [], arch
    for arch in ("whisper-small", "hymba-1.5b"):
        cfg = configs.get_smoke(arch)
        model = M.params_from_numpy(cfg, H.numpy_params(M.param_shapes(cfg)), device="cpu")
        M.forward_train(model, cfg, _train_batch(cfg))[0].backward()
    sites = {q.split(".<locals>.")[0] + "." + q.rsplit(".", 1)[-1] for q in seen}
    assert sites == {"_run_layers.body", "_encode.body", "chunked_ce_loss.step", "mea_attention.rows",
                     "_ssd_chunked.step"}, sites
