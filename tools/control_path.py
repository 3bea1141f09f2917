#!/usr/bin/env python3
"""Run path 8 of ``chip_smoke.py`` alone: the control plane on the card, with
every gate of the smoke, after building the two kernels it launches
(``segment_rf`` and ``full_reorder``).

    python3 tools/control_path.py             # (a) one rank, (b) the drill on 4 gloo ranks on cuda:0
    python3 tools/control_path.py --cards 4   # (c): the drill over NCCL, 4 live ranks and 2 recovering, a card each

Needs a CUDA device (four for ``--cards 4``) and ``nvcc``; under a minute.
Prints the card, the path's lines and last its readings as one
``{"control": ...}`` JSON line.
"""
import argparse
import json
import pathlib
import sys
import time

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
        print(f"control_path: needs {args.cards} CUDA device(s)", file=sys.stderr)
        return 1
    print(CS.card_line(), flush=True)
    _build.build_all(("segment_rf", "full_reorder"))
    t0 = time.perf_counter()
    graph = CS.rungs_graph()
    print(f"path 4's graph and GEO order: {time.perf_counter() - t0:.3f} s", flush=True)
    if args.cards == 1:
        read = {"a": CS.control_path(torch.device("cuda"), graph, segment_rf)}
        read["b"] = CS.control_drill("b_g4_gloo_1card", "gloo", ["cuda:0"] * 4, ["cuda:0"] * 2, graph)
    else:
        cards = [f"cuda:{i}" for i in range(4)]
        read = {"c": CS.control_drill("c_g4_nccl_4cards", "nccl", cards, cards[:2], graph)}
    print(json.dumps({"control": read}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
