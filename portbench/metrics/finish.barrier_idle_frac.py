"""Layer executor (the finish threads of ``TorchBatchExecutor``): the
finish threads' time inside a batch (``ex.batch``) with no read open
(``ex.finish``), over their seconds in the window: the global chain
before the reads start, and the batch's tail, where threads with no read
left wait for the last (``yardstick/program.py``)."""

from yardstick import program


def read(ctx):
    s = program.finish_split(ctx)
    return None if s is None else s["barrier_idle"] / s["thread_s"]
