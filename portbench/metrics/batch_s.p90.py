"""Layer executor (``TorchBatchExecutor.map_stream``): the 90th
percentile of a batch's seconds from its hand-over to its records
(``_run_prepared``), over the window's batches; it needs ten batches.
A steadier statistic than a per-read tail, which map_stream cannot give:
it releases a batch's records together."""

import statistics


def read(ctx):
    b = ctx["batch_s"]
    return statistics.quantiles(b, n=10)[8] if len(b) >= 10 else None
