"""Layer seeding (``TorchBatchExecutor._prepare`` -> ``index.seeds``,
``pipeline/chaining.prepare_read_anchors``, on the seeder thread): the
share of the window the seeder thread spent seeding.  Near 1 the seeder
sets the pace of ``map_mbps``."""


def read(ctx):
    return ctx["spans"].get("seeding", 0.0) / ctx["window_s"]
