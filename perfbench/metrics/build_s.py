"""build_s: seconds of PoissonSolver(...) in set-up (options, operator,
the multigrid hierarchy and its coarse pseudo-inverse), host clock around
the call, ending synchronised."""


def read(rec):
    return rec["setup"].get("build_s")
