"""Layer refinement and fills (``AsyncFillAligner`` -> the in-process
fill service): finish-thread seconds blocked on the fill service's
answer (``fill_wait``, ``edit_wait``: only the blocked event wait), per
Mbp mapped, from the program's own spans (``yardstick/program.py``)."""

from yardstick import program


def read(ctx):
    s = program.finish_split(ctx)
    return None if s is None else s["fill_wait"] / ctx["mbp"]
