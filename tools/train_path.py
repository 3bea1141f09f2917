#!/usr/bin/env python3
"""Run path 11 of ``chip_smoke.py`` alone: LM training on the card, with
every gate of the smoke.

    python3 tools/train_path.py              # path 11
    python3 tools/train_path.py --profile    # then one full-width step under torch.profiler

(a) gemma3-4b at full width in bf16, 3 AdamW steps with remat on 2 x 2,048
tokens; (b) ``launch/train.py``'s ``main`` at its defaults with the
reference test's schedule, and its step-50 checkpoint restored at k = 3 and
4; (c) the 10 smoke configs' train steps against the committed JAX fixture.
``--profile`` then traces one step of (a)'s model (after one untraced step)
and prints the device's busy time (the sum of its kernels, which run one at
a time on one stream) against the step's wall time, the kernels a step, and
the kernels that take the most. Needs a CUDA device, no kernel build; about
a minute. Prints the card, the path's lines and last its readings as one
``{"train": ...}`` JSON line.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def profile_step(CS, dev) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.data import pipeline as dp
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import steps as S

    cfg = configs.get_config(CS.LM_ARCH)
    model = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16, device=dev)
    state = O.init_opt_state(model)
    step_fn = S.make_train_step(cfg, O.OptConfig(**CS.TRAIN_OPT))
    dc = dp.DataConfig(vocab_size=cfg.vocab_size, seq_len=CS.TRAIN_SEQ, global_batch=CS.TRAIN_BATCH)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in dp.global_batch(dc, 0).items()}
    model, state, _ = step_fn(model, state, batch)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, state, _ = step_fn(model, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels only: an aten op's row repeats the device time of the kernels it launched.
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    read = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_kernels": sum(r[2] for r in rows),
            "top": [{"name": k[:80], "ms": t, "calls": c} for k, t, c in rows[:15]]}
    print(f"train step profile: {wall_ms:.3f} ms on the host's clock (profiler on), device busy {busy_ms:.3f} ms, "
          f"idle share {read['device_idle_share']:.3f}, {read['device_kernels']} kernels", flush=True)
    del model, state
    return read


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true", help="then trace one full-width step of (a)'s model")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    import torch

    if not torch.cuda.is_available():
        print("train_path: needs a CUDA device", file=sys.stderr)
        return 1
    print(CS.card_line(), flush=True)
    dev = torch.device("cuda")
    read = CS.train_path(dev)
    if args.profile:
        torch.cuda.empty_cache()
        read["profile"] = profile_step(CS, dev)
    print(json.dumps({"train": read}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
