#!/usr/bin/env python3
"""Run path 7 of ``chip_smoke.py`` alone: the out-of-core pipeline over 4
ranks (2 processes x 2), with every gate of the smoke, after building the
two kernels it launches (``segment_rf`` and ``full_reorder``).

    python3 tools/outofcore_path.py             # (a): 4 gloo ranks on cuda:0
    python3 tools/outofcore_path.py --cards 4   # (c): 4 NCCL ranks, a card each

Needs a CUDA device (four for ``--cards 4``) and ``nvcc``; about a minute
and a half. Prints the card, each rank's lines and the path's summary, and
last the path's readings as one ``{"outofcore": ...}`` JSON line.
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

    from repro_torch.kernels import _build

    if not torch.cuda.is_available() or torch.cuda.device_count() < args.cards:
        print(f"outofcore_path: needs {args.cards} CUDA device(s)", file=sys.stderr)
        return 1
    print(CS.card_line(), flush=True)
    _build.build_all(("segment_rf", "full_reorder"))
    if args.cards == 1:
        read = CS.outofcore_path("a_g4_gloo_1card", "gloo", ["cuda:0"] * 4)
    else:
        read = CS.outofcore_path("c_g4_nccl_4cards", "nccl", [f"cuda:{i}" for i in range(4)])
    print(json.dumps({"outofcore": read}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
