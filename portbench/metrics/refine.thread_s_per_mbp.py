"""Layer refinement and fills (``pipeline/extend`` -> ``AsyncFillAligner``
-> ``ops/affine_fill`` -> ``fill_banded.cu``, ``fill_full.cu``):
finish-thread seconds in the port's ``refine`` trace span per Mbp mapped,
summed over the finish threads."""


def read(ctx):
    s = ctx["port_trace"].get("refine")
    return None if s is None else s / ctx["mbp"]
