"""Kernel ``chain_dp.cu`` (every variant: the global chain and the local
re-chains): the least time the card could take for the pairs the captured
launches' anchors need (80 operations a pair, PERF.md's kernel table),
over the kernel's device time from the trace, in percent."""

from yardstick import work


def read(ctx):
    ops, nbytes = ctx["work"].get("chain_dp", (0, 0))
    dev = sum(s for k, (_, s) in ctx.get("kernels", {}).items()
              if "chain_dp_kernel" in k)
    if not ops or not dev:
        return None
    return work.bound_s(ops, nbytes) / dev * 100
