"""Set-up seconds: the process's start (imports, the kernels' build where a
checkout has none, the weights drawn, the engine built) to the window's
open, the set-up traffic that warms every shape included."""


def read(run):
    return run.setup_s
