"""The yardstick of the port's benchmark: traffic generation, weights drawn
from the seed, the driven window, the profiler reduction, the work formulas
and peaks, and the check of ``correct``.  Nothing here imports JAX or the
JAX package; only :mod:`benchlib.cell` imports the port (``repro_torch``)."""
