"""Layer device (one H100): 1 - (the union of kernel, copy and memset
intervals from torch.profiler) / the window's wall time."""


def read(ctx):
    busy = ctx.get("busy_s")
    return None if busy is None else 1 - busy / ctx["window_s"]
