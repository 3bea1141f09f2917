"""Train / serve steps: the functions a launcher calls a step.

The counterpart of ``repro.train.steps``. The reference's
``jax.value_and_grad`` is autograd: with one microbatch ``loss.backward()``
leaves the gradients in the parameters' dtype; with several, each
microbatch's gradients (``torch.autograd.grad``) are added into float32 sums,
as the reference's ``lax.scan`` adds them, and divided by their count. The
model and the optimizer state are updated in place and returned.
"""
from __future__ import annotations

import torch

from ..models import model as M
from . import optimizer as O


def make_train_step(cfg, opt: O.OptConfig, *, microbatches: int = 1, remat: bool = True):
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics): ``{"loss", "grad_norm", "lr"}`` and, with one microbatch, the
    forward's ``ce_loss`` and ``aux_loss`` (0-d tensors on the model's
    device; reading one waits for the step)."""

    def train_step(model, opt_state, batch):
        named = list(model.named_parameters())
        if microbatches == 1:
            model.zero_grad(set_to_none=True)
            loss, metrics = M.forward_train(model, cfg, batch, remat=remat)
            loss.backward()
            grads = {n: p.grad for n, p in named}
        else:
            def split(x):
                b = x.shape[0]
                return x.reshape(microbatches, b // microbatches, *x.shape[1:])

            mbs = {k: split(v) for k, v in batch.items()}
            params = [p for _, p in named]
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
            lsum = torch.zeros((), dtype=torch.float32, device=params[0].device)
            for j in range(microbatches):
                l, _ = M.forward_train(model, cfg, {k: v[j] for k, v in mbs.items()}, remat=remat)
                for s, g in zip(gsum, torch.autograd.grad(l, params, allow_unused=True)):
                    if g is not None:
                        s.add_(g)
                lsum = lsum + l.detach()
            grads = {n: s.div_(microbatches) for (n, _), s in zip(named, gsum)}
            loss, metrics = lsum / microbatches, {}
        model, opt_state, opt_metrics = O.adamw_update(model, grads, opt_state, opt)
        del grads
        model.zero_grad(set_to_none=True)
        out = {"loss": loss.detach(), **opt_metrics}
        out.update({k: v.detach() for k, v in metrics.items()})
        return model, opt_state, out

    return train_step


def make_prefill_step(cfg):
    def prefill_step(model, batch, cache):
        with torch.inference_mode():
            return M.forward_prefill(model, cfg, batch, cache)

    return prefill_step


def make_decode_step(cfg):
    def decode_step(model, token, cache):
        with torch.inference_mode():
            return M.forward_decode(model, cfg, token, cache)

    return decode_step
