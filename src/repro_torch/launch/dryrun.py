"""Dry run: every (arch × shape × mesh) cell's plan, and the cells one card
holds run on it.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell's step on 512 placeholder devices and reads XLA's memory, cost and
collective analyses. One card compiles no 512-device program, so this has
two modes:

* **Plan** (the CPU, nothing allocated): for every arch × shape × mesh
  (``single`` 16×16, ``multi`` 2×16×16) the reference's record without
  XLA's fields, with the bytes one rank holds of each input (``specs``) and
  the analytic roofline on the H100's constants (``roofline``; its
  collective term is 0: there is no HLO to read collectives from). Also the
  plan at one card: those input bytes plus an activation estimate, against
  the card's memory.
* **Run** (``--run``; the card unless ``--device cpu``): each cell whose
  plan at one card fits runs one step at its real global shapes, on random
  weights at the config's widths. It records ``max_memory_allocated``
  against the plan's bytes and the step's time against the roofline's bound.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --run
  PYTHONPATH=src python -m repro_torch.launch.dryrun --run --device cpu --smoke --arch mamba2-1.3b --shape decode_32k

Records land in ``artifacts/dryrun_torch/<mesh>/<arch>--<shape>.json`` and
``artifacts/dryrun_torch/run/<arch>--<shape>.json``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from .. import configs
from ..compat import resolve_device
from ..models import model as M
from ..models.config import SHAPES, ShapeSpec, cell_is_runnable
from ..train import optimizer as O
from ..train import steps as S
from . import mesh as MM
from . import roofline as R
from . import sharding as SH
from . import specs as SP

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
CARD_BYTES = 80e9  # the plan's card: H100 80GB HBM3 (NVIDIA data sheet, H100 SXM)
FIT_SHARE = 0.9  # of the card's memory the plan may fill (the allocator's and the context's slack)
MESHES = ("single", "multi")


def distribution_of(mesh, shape: ShapeSpec) -> dict:
    """The reference's ``Distribution`` for the cell, as the record holds it."""
    ba = SH.batch_axes(mesh)
    batch_ok = shape.global_batch % SH._axes_size(mesh, ba) == 0
    return {"batch_axes": list(ba) if batch_ok else [], "seq_axes": list(SH.cache_seq_axes(mesh, shape.global_batch)),
            "sp_decode": shape.kind == "decode"}


def activation_bytes(cfg, shape: ShapeSpec, data_shards: int) -> float:
    """The plan's estimate of what a step holds beside its inputs, per rank.
    Train and prefill: the reference's activation coefficients of
    ``roofline.analytic_costs`` (6 and 4 bf16 tensors of (tokens, d_model) a
    layer). Decode: the float32 logits twice, and one float32 key and value
    block of the attention (1,024 keys) twice over."""
    tokens = shape.global_batch * shape.seq_len / data_shards
    if shape.kind == "train":
        return tokens * cfg.d_model * 2 * cfg.num_layers * 6
    if shape.kind == "prefill":
        return tokens * cfg.d_model * 2 * cfg.num_layers * 4
    b = shape.global_batch / data_shards
    kv_block = 2 * b * cfg.num_kv_heads * min(shape.seq_len, 1024) * cfg.head_dim * 4 if cfg.family != "ssm" else 0
    ssm = 3 * b * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4 if cfg.ssm_state else 0
    return 2 * b * cfg.vocab_size * 4 + 2 * kv_block + ssm


def plan_cell(arch: str, shape_name: str, mesh, *, cfg=None) -> dict:
    """The plan of one cell on ``mesh`` (a ``RankGrid``); ``cfg`` overrides
    the published config (a smoke config, for a run on the CPU)."""
    cfg = configs.get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name]
    specs = SP.input_specs(cfg, shape, mesh)
    chips = MM.num_chips(mesh)
    sizes = MM.mesh_axis_sizes(mesh)
    mb = SP.TRAIN_MICROBATCHES.get(arch, 1)
    analytic = R.analytic_costs(cfg, shape, chips, microbatches=mb, model_shards=sizes.get("model", 1))
    rf = R.Roofline(
        flops_per_chip=analytic["flops_per_chip"],
        hbm_bytes_per_chip=analytic["hbm_bytes_per_chip"],
        collective_bytes_per_chip=0.0,
        chips=chips,
        model_flops_global=R.model_flops(cfg, shape),
    )
    inputs = {name: SP.per_device_bytes(tree) for name, tree in specs.items()}
    inputs["total"] = sum(inputs.values())
    data_shards = max(chips // sizes.get("model", 1), 1)
    act = activation_bytes(cfg, shape, data_shards)
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "chips": chips,
        "distribution": distribution_of(mesh, shape),
        "microbatches": mb if shape.kind == "train" else 1,
        "input_bytes_per_device": inputs,
        "activation_bytes_estimate": act,
        "plan_bytes_per_device": inputs["total"] + act,
        "roofline": rf.to_dict(),
    }


def fits_one_card(arch: str, shape_name: str, *, cfg=None, card_bytes: float = CARD_BYTES) -> dict:
    """The plan at one card, and whether its bytes fit ``FIT_SHARE`` of
    ``card_bytes``."""
    if not cell_is_runnable(arch, shape_name):
        return {"fits": False, "reason": "full-attention arch at 500k context"}
    plan = plan_cell(arch, shape_name, MM.make_test_mesh(1, 1), cfg=cfg)
    plan["fits"] = plan["plan_bytes_per_device"] <= FIT_SHARE * card_bytes
    plan["card_bytes"] = card_bytes
    return plan


def plan_record(arch: str, shape_name: str, mesh_kind: str) -> dict:
    if not cell_is_runnable(arch, shape_name):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "skipped": True,
                "reason": "full-attention arch at 500k context (see DESIGN.md §5)"}
    rec = plan_cell(arch, shape_name, MM.make_production_mesh(multi_pod=(mesh_kind == "multi")))
    rec["one_card"] = {k: v for k, v in fits_one_card(arch, shape_name).items()
                       if k in ("fits", "plan_bytes_per_device", "input_bytes_per_device", "card_bytes")}
    rec["ok"] = True
    return rec


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cfg, shape: ShapeSpec, *, device=None, steps: int = 2, microbatches: int = 1) -> dict:
    """``steps`` steps of the cell at its real global shapes on ``device``
    (after one untimed step), on random bf16 weights (the dry run's parameter
    dtype, ``specs.PARAM_DTYPE``). Returns each step's ms (CUDA events on a
    card, the host clock on the CPU), peak memory on a card, and what the
    last step returned."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = M.init_params(cfg, generator=gen, dtype=SP.PARAM_DTYPE, device=dev)
    b, s = shape.global_batch, shape.seq_len
    out: dict = {"device": torch.cuda.get_device_name(dev) if on_card else "cpu", "steps": steps}
    if shape.kind == "decode":
        step = S.make_decode_step(cfg)
        cache = M.init_cache(cfg, b, s, dtype=SP.CACHE_DTYPE, device=dev)
        token = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device=dev)

        def one():
            cache["pos"] = s - 1  # the last position: attention over the whole cache
            return step(model, token, cache)[0]
    elif shape.kind == "prefill":
        step = S.make_prefill_step(cfg)
        cache = M.init_cache(cfg, b, s, dtype=SP.CACHE_DTYPE, device=dev)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)}

        def one():
            cache["pos"] = 0
            return step(model, batch, cache)[0]
    else:
        step = S.make_train_step(cfg, O.OptConfig(), microbatches=microbatches)
        opt_state = O.init_opt_state(model)
        batch = {k: torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev) for k in ("tokens", "targets")}

        def one():
            return step(model, opt_state, batch)[2]["loss"]

    res = one()
    _sync(dev)
    times = []
    for _ in range(steps):
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            res = one()
            ev[1].record()
            torch.cuda.synchronize(dev)
            times.append(ev[0].elapsed_time(ev[1]))
        else:
            t0 = time.perf_counter()
            res = one()
            times.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = times
    out["finite"] = bool(torch.isfinite(res).all())
    out["result_shape"] = list(res.shape)
    if on_card:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return out


def run_record(arch: str, shape_name: str, *, device=None, smoke: bool = False, card_bytes: float = CARD_BYTES) -> dict:
    """The run of one cell that fits one card, held against its plan."""
    cfg = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    plan = fits_one_card(arch, shape_name, cfg=cfg, card_bytes=card_bytes)
    if not plan["fits"]:
        raise ValueError(f"{arch} × {shape_name} does not fit one card: {plan}")
    run = run_cell(cfg, SHAPES[shape_name], device=device, microbatches=SP.TRAIN_MICROBATCHES.get(arch, 1))
    compute_ms, memory_ms = plan["roofline"]["t_compute_s"] * 1e3, plan["roofline"]["t_memory_s"] * 1e3
    rec = {"arch": arch, "shape": shape_name, "config": "smoke" if smoke else "published", "plan": plan, **run,
           "bound_ms": max(compute_ms, memory_ms), "bound_by": "operations" if compute_ms >= memory_ms else "bytes"}
    rec["step_over_bound"] = min(run["step_ms"]) / rec["bound_ms"]
    if "max_memory_allocated" in run:
        rec["memory_over_plan"] = run["max_memory_allocated"] / plan["plan_bytes_per_device"]
    if not run["finite"]:
        raise RuntimeError(f"{arch} × {shape_name}: the step returned non-finite values")
    return rec


def _write(path: pathlib.Path, rec: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--run", action="store_true", help="run the cells whose plan fits one card")
    ap.add_argument("--device", default=None, help="--run's device (default: the card)")
    ap.add_argument("--smoke", action="store_true", help="--run the smoke configs (for the CPU)")
    ap.add_argument("--out", type=pathlib.Path, default=ART)
    args = ap.parse_args(argv)

    archs = configs.ARCH_NAMES if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    records = []
    if args.run:
        dev = resolve_device(args.device)
        card_bytes = torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else CARD_BYTES
        for arch in archs:
            for shape in shapes:
                cfg = configs.get_smoke(arch) if args.smoke else None
                plan = fits_one_card(arch, shape, cfg=cfg, card_bytes=card_bytes)
                if not plan["fits"]:
                    continue
                t0 = time.time()
                rec = run_record(arch, shape, device=dev, smoke=args.smoke, card_bytes=card_bytes)
                _write(args.out / "run" / f"{arch}--{shape}.json", rec)
                records.append(rec)
                mem = rec.get("max_memory_allocated")
                print(f"[run] {arch} × {shape}: step {min(rec['step_ms']):.3f} ms (bound {rec['bound_ms']:.3f} ms, "
                      f"{rec['bound_by']}); plan {rec['plan']['plan_bytes_per_device'] / 1e9:.3f} GB"
                      + (f", peak {mem / 1e9:.3f} GB" if mem is not None else "")
                      + f" on {rec['device']} ({time.time() - t0:.0f}s)", flush=True)
        return records
    meshes = list(MESHES) if args.mesh == "both" else [args.mesh]
    for mk in meshes:
        for arch in archs:
            for shape in shapes:
                rec = plan_record(arch, shape, mk)
                _write(args.out / mk / f"{arch}--{shape}.json", rec)
                records.append(rec)
                if rec.get("skipped"):
                    print(f"[{mk}] {arch} × {shape}: SKIP", flush=True)
                    continue
                r = rec["roofline"]
                print(f"[{mk}] {arch} × {shape}: OK in/dev={rec['input_bytes_per_device']['total'] / 2**30:.2f}GiB "
                      f"bottleneck={r['bottleneck']} t=({r['t_compute_s']:.2e},{r['t_memory_s']:.2e})s "
                      f"one card: {'fits' if rec['one_card']['fits'] else 'no'}", flush=True)
    return records


if __name__ == "__main__":
    main()
