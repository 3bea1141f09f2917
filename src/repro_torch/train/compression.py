"""Error-feedback int8 gradient compression over the data ranks.

The counterpart of ``repro.train.compression``. Each rank's gradients are
quantized to int8 values with a scale shared by the ranks (the largest of
their per-tensor scales), summed in int32 over the data axis, dequantized
and divided by the rank count; what the quantization lost is fed back into
the next step's gradients. The reference's ``shard_map`` over the data axis
is one OS process a rank here, and its ``psum`` / ``pmax`` / ``pmean`` are
``launch.multihost.all_reduce`` over the rank's line of a
``launch.mesh.RankGrid``.

Gradients and errors are a tensor, a dict of them (nested dicts too), or,
for a module, a dict keyed by ``named_parameters()`` names.
"""
from __future__ import annotations

import torch

from ..launch import multihost as MH


def _div(x, d):
    """x / d correctly rounded on every device. PyTorch's CUDA division by a
    Python number multiplies by its reciprocal, which can miss the quotient
    by an ulp; a 0-d tensor divisor on the same device is divided by."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def quantize(g, *, bits: int = 8):
    maxv = g.abs().max() + 1e-12
    scale = _div(maxv, 2 ** (bits - 1) - 1)
    q = torch.clamp(torch.round(g / scale), -(2 ** (bits - 1) - 1), 2 ** (bits - 1) - 1)
    return q.to(torch.int8), scale


def dequantize(q, scale):
    return q.float() * scale


def _map2(fn, a, b):
    """``fn`` over the leaves of two trees of one structure; two trees of
    the results."""
    if isinstance(a, dict):
        pairs = {k: _map2(fn, a[k], b[k]) for k in a}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    return fn(a, b)


def compressed_allreduce(grads, error, group):
    """quantize(g + e) → int32 sum over ``group`` (the data ranks: a
    ``GraphGroup``, as ``RankGrid.line("data")`` gives) → dequantize / n.
    Returns (reduced_grads, new_error), each of the structure of ``grads``."""
    n = group.size

    def one(g, e):
        g = g.float() + e
        # Shared scale = max of the local scales, so Σ_i q_i·scale is the
        # exact sum of the locally quantized values (no scale mixing error).
        local_scale = _div(g.abs().max() + 1e-12, 127.0)
        scale = MH.all_reduce(local_scale, group, "max")
        q = torch.clamp(torch.round(g / scale), -127, 127)
        # Error feedback against what was sent: g − q·scale rounded once, as
        # the reference's fused multiply-add gives it (q·scale is exact in
        # float64, and so is the difference of two nearby values).
        new_e = (g.double() - q.double() * scale.double()).float()
        summed = MH.all_reduce(q.to(torch.int32), group, "sum").float()
        return _div(summed * scale, n), new_e

    return _map2(one, grads, error)


def make_compressed_dp_grad_fn(loss_fn, mesh, axis: str = "data"):
    """Data-parallel gradients with the compressed all-reduce: each rank
    holds its shard of the batch and every parameter. Returns fn(params,
    batch, error) -> (loss, grads, new_error): ``loss`` the mean over the
    ranks of ``loss_fn(params, batch)``, ``grads`` the compressed mean of
    the ranks' gradients. ``params`` is a module (gradients keyed by
    ``named_parameters()``) or a dict of tensors (gradients of its
    structure); ``error`` has the gradients' structure."""
    line = mesh.line(axis)

    def fn(params, batch, error):
        if isinstance(params, torch.nn.Module):
            named = dict(params.named_parameters())
            loss = loss_fn(params, batch)
            grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        else:
            leaves = []

            def track(t):
                t = t.detach().requires_grad_(True)
                leaves.append(t)
                return t

            def tree(x, f):
                return {k: tree(v, f) for k, v in x.items()} if isinstance(x, dict) else f(x)

            tracked = tree(params, track)
            loss = loss_fn(tracked, batch)
            it = iter(torch.autograd.grad(loss, leaves))
            grads = tree(params, lambda _: next(it))
        grads, new_error = compressed_allreduce(grads, error, line)
        loss = MH.all_reduce(loss.detach(), line, "sum") / line.size
        return loss, grads, new_error

    return fn
