"""AdamW + cosine schedule + global-norm clipping, in PyTorch.

The counterpart of ``repro.train.optimizer``. Moments are kept in float32
whatever the parameter's dtype (mixed-precision master update). The state
has the reference's tree: ``{"m": ..., "v": ..., "step": int32 0-d}``, where
``m`` and ``v`` hold a ``CausalLM``'s leaves stacked over the layer axis
under the reference's names (``models.model.param_shapes``), so
``checkpoint.store`` writes the same leaf names in both packages. Updates are
made in place, with the reference's arithmetic in float32: the learning rate
read at the old step, bias correction at the new one, weight decay on every
leaf.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..models import model as M


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(opt: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int, or a tensor whose device the
    result takes), a float32 0-d tensor computed in float32 as the
    reference's ``jnp`` computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = opt.peak_lr * (step + 1) / max(opt.warmup_steps, 1)
    t = torch.clip((step - opt.warmup_steps) / max(opt.total_steps - opt.warmup_steps, 1), 0.0, 1.0)
    cos = opt.peak_lr * (opt.min_lr_frac + (1 - opt.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < opt.warmup_steps, warm, cos)


def _tree_leaves(tree: dict, prefix=()):
    for name in sorted(tree):
        sub = tree[name]
        if isinstance(sub, dict):
            yield from _tree_leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def _at(tree: dict, path: tuple):
    for name in path:
        tree = tree[name]
    return tree


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _model_path(name: str) -> tuple:
    """A ``CausalLM`` parameter's name as (the reference's leaf path, the
    layer index or None): ``layers.3.shared.w1`` -> (("layers", "shared",
    "w1"), 3)."""
    parts = name.split(".")
    if parts[0] in M._STACKED:
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def init_opt_state(params) -> dict:
    """Float32 zeros for ``m`` and ``v`` and a 0-d int32 ``step``. ``params``
    is a ``CausalLM`` (the moments take its stacked shapes) or a tree of
    tensors (nested dicts)."""
    if isinstance(params, nn.Module):
        dev = next(params.parameters()).device
        shapes = M.param_shapes(params.cfg)

        def zeros():
            return _map(shapes, lambda leaf: torch.zeros(leaf[0], dtype=torch.float32, device=dev))
    else:
        dev = next(leaf for _, leaf in _tree_leaves(params)).device

        def zeros():
            return _map(params, lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device))
    return {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _leaf_slots(params, grads, state) -> list:
    """[(parameter, gradient, m, v)] for every leaf: for a ``CausalLM`` by
    ``named_parameters()`` (``grads`` keyed by those names; ``m`` and ``v``
    the layer's views of the stacked moments), for a tree by its leaves
    (``grads`` a tree of the same shape). A gradient may be None (a leaf the
    loss does not reach): it counts as zeros."""
    if isinstance(params, nn.Module):
        out = []
        for name, p in params.named_parameters():
            path, i = _model_path(name)
            m, v = _at(state["m"], path), _at(state["v"], path)
            out.append((p, grads[name], m if i is None else m[i], v if i is None else v[i]))
        return out
    return [(p, _at(grads, path), _at(state["m"], path), _at(state["v"], path)) for path, p in _tree_leaves(params)]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32. ``tree``: nested
    dicts, or a list, of tensors (None counts as zeros)."""
    leaves = [leaf for _, leaf in _tree_leaves(tree)] if isinstance(tree, dict) else list(tree)
    sums = [torch.sum(torch.square(leaf.float())) for leaf in leaves if leaf is not None]
    return torch.sqrt(torch.stack(sums).sum())


def adamw_update(params, grads, state: dict, opt: OptConfig):
    """One AdamW step, in place: the parameters, ``state["m"]`` and
    ``state["v"]`` are updated and ``state["step"]`` advanced. ``params``: a
    ``CausalLM`` (``grads`` keyed by its parameter names) or a tree of
    tensors (``grads`` a tree alike). Returns (params, state, {"grad_norm",
    "lr"}), as the reference does."""
    slots = _leaf_slots(params, grads, state)
    step = state["step"] + 1
    lr = lr_schedule(opt, state["step"])
    gnorm = global_norm([g for _, g, _, _ in slots])
    scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=stepf.device)
    bc1 = 1 - torch.pow(torch.tensor(opt.b1, **f32), stepf)
    bc2 = 1 - torch.pow(torch.tensor(opt.b2, **f32), stepf)
    with torch.no_grad():
        for p, g, m, v in slots:
            g = torch.zeros_like(p, dtype=torch.float32) if g is None else g.to(torch.float32, copy=True)
            g.mul_(scale)
            m.mul_(opt.b1).add_(g * (1 - opt.b1))
            v.mul_(opt.b2).add_((g * (1 - opt.b2)).mul_(g))
            del g
            delta = torch.div(m, bc1)
            denom = torch.div(v, bc2).sqrt_().add_(opt.eps)
            delta.div_(denom)
            del denom
            p32 = p if p.dtype == torch.float32 else p.float()
            delta.add_(p32 * opt.weight_decay)
            if p32 is p:
                p.sub_(delta.mul_(lr))
            else:
                p.copy_(p32.sub_(delta.mul_(lr)))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
