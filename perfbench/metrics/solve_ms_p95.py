"""solve_ms_p95: the 95th percentile (nearest rank) of every solve's ms in
the window, each timed by CUDA events on the device's clock, from the
solve's first enqueued work to its last: the slow steps of a
time-stepper."""

import math


def read(rec):
    if "trace" in rec:
        return None
    ms = sorted(rec["window"]["solve_ms"])
    if not ms:
        return None
    return ms[math.ceil(0.95 * len(ms)) - 1]
