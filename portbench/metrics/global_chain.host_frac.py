"""Layer global chain: the share of reads whose global chain DP the
executor left to the host DP (repeat-dense, over the largest bucket, or
coordinates it cannot take), from ``TorchBatchExecutor.chained`` and
``.declined``.  A read on the host DP costs a finish thread far more
than one on the card."""


def read(ctx):
    c = ctx["counters"]
    n = c["global_chained"] + c["global_declined"]
    return None if n == 0 else c["global_declined"] / n
