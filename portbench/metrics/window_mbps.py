"""Layer executor, in the cells that do not report ``map_mbps`` end to
end: the same quantity, the bases of the reads whose records the traced
window emitted over the window's seconds.  Where the host's cores slow
at times its runs spread wider than any bound the benchmark may set, so
it stands here unbounded; its ``moves`` names ``peak_rss_gb`` only
because a per-layer metric has to name an end-to-end metric that its
cells report."""


def read(ctx):
    return ctx["mbp"] / ctx["window_s"] if ctx["reads"] else None
