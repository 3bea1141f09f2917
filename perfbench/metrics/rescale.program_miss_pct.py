"""Share of the window's migration-program lookups that missed the
rescaler's ``ProgramCache`` and built a segment table on the host
(misses / lookups of its ``migrate`` counters over the window)."""


def read(run):
    before, after = run.counters_before, run.counters_after
    misses = after.get("misses", 0) - before.get("misses", 0)
    lookups = misses + after.get("hits", 0) - before.get("hits", 0)
    return 100.0 * misses / lookups if lookups else None
