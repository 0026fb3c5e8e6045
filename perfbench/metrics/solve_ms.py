"""solve_ms: the window's wall over the solves completed in it: a
time-stepper's time a step. Host clock; every solve ends synchronised,
and the window ends with the solve that crosses its length."""


def read(rec):
    if "trace" in rec:
        return None
    w = rec["window"]
    return 1e3 * w["wall_s"] / w["solves"]
