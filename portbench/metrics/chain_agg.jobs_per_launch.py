"""Layer local re-chain (``parallel/device_service._Aggregator`` of the
chain DPs): chain jobs over dispatches in the window, from the program's
counters ``chain_agg.jobs`` / ``chain_agg.dispatches`` (a dispatch
launches one kernel a parameter group): how many jobs the gather window
merges into a launch."""

from yardstick import program


def read(ctx):
    got = program.records(ctx)
    if got is None:
        return None
    c = got[1]
    n = c.get("chain_agg.dispatches", 0)
    return c.get("chain_agg.jobs", 0) / n if n else None
