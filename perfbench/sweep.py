"""Find the rate a cell's query mix sustains: one sweep over fixed rates.

    python3 -m perfbench.sweep --workload g500-s22.query --seed 5 --seconds 20 --rates 8 10 12 14

sets the cell up once and serves its mix at each rate in turn for
``--seconds``, printing for each rate the served count, p50 and p95 of the
latency and the backlog's growth: the mean latency of the last third of the
queries over that of the first third, and how long after the window's close
the last answer came. A rate is sustained while the growth stays near 1.
The answers are not judged here; the benchmark's own runs judge them.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys

from perfbench import run as entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    entry.cache_dirs(entry.ROOT)
    sys.path[:0] = [str(entry.ROOT), str(entry.ROOT / "src")]
    import torch

    from perfbench import spec as specmod, stats, sut

    if not torch.cuda.is_available():
        print("perfbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    spec = specmod.Spec(entry.ROOT / "BENCHMARK.json")
    cell = spec.cell(args.workload)
    config, mix = spec.config(cell["config"]), specmod.mix(cell["traffic"])
    driver = specmod.load_module("drivers", mix["driver"])
    generator = specmod.load_module("generators", config["generator"]["module"])
    dev = torch.device("cuda")
    src, dst, v, present = generator.generate(config["generator"], dev)
    src_h, dst_h = src.cpu().numpy(), dst.cpu().numpy()
    del src, dst
    system = sut.System(num_vertices=v, device=dev, queries=mix["queries"])
    k0 = driver.first_k(config["k_range"], mix)
    data = system.pack(src_h, dst_h, k0)
    player = driver.Player(system, mix, config, seed=args.seed, present=present, annotate=False, hold=0)
    data = player.warm(data, k0)
    for rate in args.rates:
        player.mix = copy.deepcopy(mix)
        player.mix["queries"]["rate_per_s"] = rate
        data, events, _, window_s = player.play(data, args.seconds)
        q = [e for e in events if e["kind"] != "rescale" and e.get("ok")]
        lat = [e["end"] - e["due"] for e in q]
        third = max(1, len(lat) // 3)
        print(json.dumps({
            "rate_per_s": rate, "served": len(q), "failed": sum(1 for e in events if not e.get("ok")),
            "p50_ms": 1e3 * stats.percentile(lat, 50), "p95_ms": 1e3 * stats.percentile(lat, 95),
            "service_mean_ms": 1e3 * sum(e["end"] - e["start"] for e in q) / len(q),
            "growth": (sum(lat[-third:]) / third) / (sum(lat[:third]) / third),
            "last_answer_after_close_s": window_s - args.seconds,
        }), flush=True)
        del events, q
    return 0


if __name__ == "__main__":
    sys.exit(main())
