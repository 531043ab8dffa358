"""Layer local re-chain (``TorchAggregatingChainBackend`` ->
``parallel/device_service._Aggregator``): finish-thread seconds spent
waiting on the chain aggregator, per Mbp mapped: the dispatcher's wait
for peers (``chain_agg.gather``, its gather window) plus the other
callers' wait on their event (``chain_agg.wait``), from the program's
own spans (``yardstick/program.py``)."""

from yardstick import program


def read(ctx):
    s = program.finish_split(ctx)
    return None if s is None else s["agg_wait"] / ctx["mbp"]
