#!/usr/bin/env python3
"""Run path 10 of ``chip_smoke.py`` alone: the LM harness's forward pass on
the card, with every gate of the smoke.

    python3 tools/lm_path.py              # path 10
    python3 tools/lm_path.py --profile    # then the decode step's device busy share
    python3 tools/lm_path.py --exact-bf16-reduction   # cuBLAS's reduced-precision bf16 reduction off

(a) gemma3-4b at full width in bf16 through examples/serve_decode.py's loop
(8 prompts of 2,048 tokens, a prefill, 64 greedy decode steps); (b) five
families at full width and depth 2 in float32; (c) the 10 smoke configs
against the committed JAX fixture. ``--profile`` then traces 8 decode steps
of (a)'s model with ``torch.profiler`` and prints the device's busy time
(the sum of its kernels, which run one at a time on one stream) against the
steps' wall time, and the kernels that take the most.
``--exact-bf16-reduction`` runs the path with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` off, to
see how much of (a)'s bf16 distances the GEMMs' split-K reductions make. Needs a CUDA device,
no kernel build; about a minute. Prints the card, the path's lines and last
its readings as one ``{"lm": ...}`` JSON line.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def profile_decode(CS, dev, steps: int = 8) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.models import model as M

    cfg = configs.get_config(CS.LM_ARCH)
    model = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (CS.LM_BATCH, CS.LM_PROMPT),
                            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    with torch.inference_mode():
        cache = M.init_cache(cfg, CS.LM_BATCH, CS.LM_MAX_LEN, dtype=torch.bfloat16, device=dev)
        logits, cache = M.forward_prefill(model, cfg, {"tokens": prompts}, cache)
        tok = logits.argmax(-1)[:, None]
        for _ in range(2):  # warm
            logits, cache = M.forward_decode(model, cfg, tok, cache)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = M.forward_decode(model, cfg, tok, cache)
                tok = logits.argmax(-1)[:, None]
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels only: an aten op's row repeats the device time of the kernels it launched.
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    n_kernels = sum(r[2] for r in rows)
    read = {"steps": steps, "wall_ms_per_step": wall_ms / steps, "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "device_kernels_per_step": n_kernels / steps,
            "top": [{"name": k[:80], "ms_per_step": t / steps, "calls_per_step": c / steps} for k, t, c in rows[:12]]}
    print(f"decode profile: {read['wall_ms_per_step']:.3f} ms a step on the host's clock (profiler on), device busy "
          f"{read['device_busy_ms_per_step']:.3f} ms a step, idle share {read['device_idle_share']:.3f}, "
          f"{read['device_kernels_per_step']:.0f} kernels a step", flush=True)
    return read


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true", help="then trace 8 decode steps of (a)'s model")
    ap.add_argument("--exact-bf16-reduction", action="store_true",
                    help="turn cuBLAS's reduced-precision bf16 reduction off")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    import torch

    if not torch.cuda.is_available():
        print("lm_path: needs a CUDA device", file=sys.stderr)
        return 1
    print(CS.card_line(), flush=True)
    dev = torch.device("cuda")
    if args.exact_bf16_reduction:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    read = CS.lm_path(dev)
    read["bf16_reduced_precision_reduction"] = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    if args.profile:
        read["profile"] = profile_decode(CS, dev)
    print(json.dumps({"lm": read}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
