"""Layer executor (the finish threads of ``TorchBatchExecutor``): the
off-CPU time inside ``ex.finish`` spans that lies in no named wait
(``*_agg.gather``, ``*_agg.wait``, ``fill_wait``, ``edit_wait``), over
the finish threads' seconds in the window: mostly the interpreter lock
(``yardstick/program.py``)."""

from yardstick import program


def read(ctx):
    s = program.finish_split(ctx)
    return None if s is None else s["gil_wait"] / s["thread_s"]
