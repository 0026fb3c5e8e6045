"""setup_s: seconds from the start of the run's process to the start of
the window: imports, the CUDA context, loading (a first run in a
checkout: building) the kernel library, PoissonSolver's construction,
the pool of right-hand sides and two warm solves. Host clock."""


def read(rec):
    return rec["setup_s"]
