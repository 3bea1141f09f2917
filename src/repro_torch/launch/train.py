"""Training launcher: LM training on one card.

  python -m repro_torch.launch.train --arch qwen2-1.5b --steps 100               # on the card
  python -m repro_torch.launch.train --arch qwen2-1.5b --steps 3 --device cpu    # on the CPU

The counterpart of ``repro.launch.train``, with its flags and ``--device``.
Uses the reduced (smoke) config by default; ``--full`` takes the published
one. Each step's global batch is
the ``--hosts`` CEP shards of ``data.pipeline`` put together. The training
state (the reference's stacked parameter tree and the optimizer state) is
CEP-checkpointed through ``checkpoint.store`` every ``--ckpt-every`` steps,
into ``--hosts`` shards a later run can restore at any host count. Runs on
the card unless ``--device cpu``; asking for the card without one raises
``RuntimeError`` before any work.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..checkpoint import store
from ..compat import resolve_device
from ..data import pipeline as dp
from ..models import model as M
from ..train import optimizer as O
from ..train import steps as S


def checkpoint_tree(model, state: dict) -> dict:
    """What a checkpoint holds, under the reference's leaf names:
    ``{"params": the stacked parameter tree (numpy), "opt": state}``."""
    return {"params": M.params_to_numpy(model), "opt": state}


def main(argv=None) -> dict:
    """Run the loop; returns ``{"losses", "lr", "grad_norm"}`` (a float a
    step), ``"checkpoints"`` (the steps saved), ``"seconds"``, and the final
    ``"model"`` and ``"state"``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=configs.ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--full", action="store_true", help="use the full (non-smoke) config")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.get_config(args.arch) if args.full else configs.get_smoke(args.arch)
    dc = dp.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)
    opt = O.OptConfig(total_steps=args.steps)
    model = M.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0), device=device)
    state = O.init_opt_state(model)
    step_fn = S.make_train_step(cfg, opt, microbatches=args.microbatches)
    n = cfg.param_count()
    print(f"arch={cfg.name} params={n/1e6:.1f}M hosts={args.hosts} device={device}")
    read = {"losses": [], "lr": [], "grad_norm": [], "checkpoints": []}
    t0 = time.time()
    for step in range(args.steps):
        shards = [dp.host_batch(dc, step, args.hosts, h) for h in range(args.hosts)]
        batch = {k: torch.from_numpy(np.concatenate([s[k] for s in shards])).to(device) for k in ("tokens", "targets")}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros((args.batch, cfg.num_patches, cfg.d_model), device=device)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((args.batch, cfg.encoder_seq, cfg.d_model), device=device)
        model, state, m = step_fn(model, state, batch)
        for key, name in (("losses", "loss"), ("lr", "lr"), ("grad_norm", "grad_norm")):
            read[key].append(m[name])
        if step % 10 == 0:
            print(f"step {step:5d} loss={float(m['loss']):.4f} lr={float(m['lr']):.2e} "
                  f"gnorm={float(m['grad_norm']):.2f} ({(time.time()-t0):.1f}s)")
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            store.save(checkpoint_tree(model, state), args.ckpt_dir, step, k_shards=args.hosts)
            read["checkpoints"].append(step)
            print(f"  checkpointed @{step} into {args.hosts} CEP shards")
    for key in ("losses", "lr", "grad_norm"):
        read[key] = torch.stack(read[key]).cpu().tolist()
    read["seconds"] = time.time() - t0
    print(f"done: final loss {read['losses'][-1]:.4f} in {read['seconds']:.1f}s")
    read["model"], read["state"] = model, state
    return read


if __name__ == "__main__":
    main()
