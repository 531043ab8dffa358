"""The yardstick of the port's benchmark: traffic generation, the caches
of the configuration's reference, the reduction from spans, counters and
the device trace to metrics, the work counts and peaks of the rooflines,
and the comparison with the plain reference that decides ``correct``.

Nothing here imports the JAX package; the program (``vacmap_tpu_torch``)
is imported only by ``cell.py``, and only the system under test is taken
from it.
"""
