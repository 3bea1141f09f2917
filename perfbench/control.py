"""The controls: what the check must refuse, run at a cell's own size.

    python3 -m perfbench.control --workload g500-s22.query --control bf16 --seconds 10 --seeds 11 12 13

runs the cell's set-up, window and check once for each seed in one process,
with the control in the program's place, and prints each run's checks as a
JSON line. The benchmark's own runs never run a control.

* ``bf16``: the plain reference in bfloat16, one precision below the
  float32 the configuration states, answers every query from the live
  pack's valid edges.
* ``recheck_off``: the program's own rescale without the re-check of
  mirrors and RF (``recheck=False``), the step that would save most of a
  rescale's time and break the guarantee that every rescale reports the
  replication factor at its new k.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from perfbench import reference


def controls() -> dict:
    """``{name: system class}``: each a ``sut.System`` with one part replaced.
    Built on first use, since ``sut`` imports the program."""
    from perfbench import sut

    class Bf16Queries(sut.System):
        def __init__(self, *, queries: dict, **kw):
            super().__init__(queries=queries, **kw)
            self.params = queries

        def query(self, kind: str, data, source: int):
            valid = data.mask > 0
            s, d = data.edges[..., 0][valid], data.edges[..., 1][valid]
            p, v, low = self.params, self.num_vertices, torch.bfloat16
            if kind == "pagerank":
                return reference.pagerank(s, d, v, p["pagerank_iterations"], p["damping"], dtype=low), None
            if kind == "sssp":
                return reference.sssp(s, d, v, source, p["max_iters"], dtype=low)
            return reference.wcc(s, d, v, p["max_iters"], dtype=low)

    class RecheckOff(sut.System):
        def rescale(self, data, k_new: int):
            return self.rescaler.rescale(data, k_new, recheck=False)

    return {"bf16": Bf16Queries, "recheck_off": RecheckOff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", choices=("bf16", "recheck_off"), required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from perfbench import run as entry

    entry.cache_dirs(entry.ROOT)
    sys.path[:0] = [str(entry.ROOT), str(entry.ROOT / "src")]
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    from perfbench import harness

    system_cls = controls()[args.control]
    for seed in args.seeds:
        result = harness.run(args.workload, seed, args.seconds, False, "cuda", t_start=time.perf_counter(),
                             system_cls=system_cls)
        print(json.dumps({"control": args.control, "workload": args.workload, "seed": seed,
                          "correct": result["correct"], "failed": result["failed"],
                          "attempted": result["attempted"], "checks": result["checks"]}), flush=True)
        del result
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
