"""Layer local re-chain (``pipeline/local``,
``parallel/device_service.TorchAggregatingChainBackend`` -> ``chain_dp.cu``):
finish-thread seconds in the port's ``local_rechain`` trace span per Mbp
mapped, summed over the finish threads."""


def read(ctx):
    s = ctx["port_trace"].get("local_rechain")
    return None if s is None else s / ctx["mbp"]
