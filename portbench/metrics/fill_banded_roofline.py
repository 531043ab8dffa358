"""Kernel ``fill_banded.cu``: the least time the card could take for the
band cells of the captured jobs (each job's target rows times 128 lanes
at 30 operations a cell), over the kernel's device time from the trace,
in percent."""

from yardstick import work


def read(ctx):
    ops, nbytes = ctx["work"].get("fill_banded", (0, 0))
    dev = sum(s for k, (_, s) in ctx.get("kernels", {}).items()
              if "fill_banded_kernel" in k)
    if not ops or not dev:
        return None
    return work.bound_s(ops, nbytes) / dev * 100
