"""Mean time a query ran: from the worker's start on it to its answer on
the card after a synchronize, its wait in the queue left out (host clock)."""

KINDS = ("pagerank", "sssp", "wcc")


def read(run):
    ms = [1e3 * (e["end"] - e["start"]) for e in run.events if e["kind"] in KINDS and e.get("ok")]
    return sum(ms) / len(ms) if ms else None
