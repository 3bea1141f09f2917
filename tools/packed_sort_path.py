#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``packed_sort`` check alone: the re-check's row
sort bit for bit against ``torch.sort`` of the masked rows and timed, at
small cases and at the graph500-22 and -24 packs of ``perfbench/configs``.

    python3 tools/packed_sort_path.py

Needs a CUDA device and ``nvcc``; about a minute. Prints the card, the
build's compiler report, a line a case and last the readings as one
``{"packed_sort": ...}`` JSON line.
"""
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import packed_sort as PS

    if not torch.cuda.is_available():
        print("packed_sort_path: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    lib = _build.build("packed_sort")
    print(lib.with_name(lib.name + ".log").read_text().strip(), flush=True)
    read = CS.packed_sort_path(torch.device("cuda"), PS)
    print(json.dumps({"packed_sort": read, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
