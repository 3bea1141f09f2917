#!/usr/bin/env python3
"""Run path 12 of ``chip_smoke.py`` alone: the LM over ranks on the card,
with every gate of the smoke.

    python3 tools/lmrank_path.py

(a) sequence-parallel decode of gemma3-4b at full width in bf16 over a 2 × 2
grid of four gloo ranks on the one card, held to the plain one-rank decode;
(b) compressed data-parallel gradients of qwen2-1.5b (depth 2, float32) over
four ranks; (c) the dry run's plan for every cell and ``--run`` of the cells
that fit one card. Needs a CUDA device, no kernel build. Prints the card, the
path's lines and last its readings as one ``{"lmrank": ...}`` JSON line.
"""
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    import torch

    if not torch.cuda.is_available():
        print("lmrank_path: needs a CUDA device", file=sys.stderr)
        return 1
    print(CS.card_line(), flush=True)
    t0 = time.perf_counter()
    read = CS.lmrank_path()
    read["ab_s"] = time.perf_counter() - t0
    read["dryrun"] = CS.dryrun_path()
    read["total_s"] = time.perf_counter() - t0
    print(json.dumps({"lmrank": read}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
