#!/usr/bin/env python3
"""Run path 9 (b) of ``chip_smoke.py`` alone: the reference's serving scenario
on the card, with every gate of the smoke, after building the two kernels it
launches (``segment_rf`` and ``full_reorder``).

    python3 tools/serve_path.py             # (b): one rank on the card
    python3 tools/serve_path.py --cards 4   # (c): (b) on one rank, then 4 NCCL ranks, a card each

Needs a CUDA device (four for ``--cards 4``) and ``nvcc``; about a minute.
Path 9 (a) needs path 3's engine at RMAT-20 and runs only in the smoke.
Prints the card, the path's lines and last its readings as one
``{"serve": ...}`` JSON line.
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    import torch

    from repro_torch.kernels import _build, segment_rf

    if not torch.cuda.is_available() or torch.cuda.device_count() < args.cards:
        print(f"serve_path: needs {args.cards} CUDA device(s)", file=sys.stderr)
        return 1
    print(CS.card_line(), flush=True)
    _build.build_all(("segment_rf", "full_reorder"))
    phases: dict = {}
    if args.cards == 1:
        read = {"b": CS.serve_scenario(torch.device("cuda"), phases, segment_rf)}
        read["b"].pop("segment_rf_max_abs_err")
        del read["b"]["answers"]
    else:
        read = CS.serve_over_cards([f"cuda:{i}" for i in range(4)], phases, segment_rf)
    print(json.dumps({"serve": read, "phases": phases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
