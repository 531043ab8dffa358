"""Layer global chain (``TorchBatchExecutor._device_chain`` ->
``ops/chain.chain_results`` -> ``chain_dp.cu``): milliseconds of the
executor's main thread in the global chain DP, read-back included, per
Mbp mapped.  The finish threads wait on it, so it moves ``map_mbps``."""


def read(ctx):
    s = ctx["spans"].get("global_chain")
    return None if s is None else s * 1e3 / ctx["mbp"]
