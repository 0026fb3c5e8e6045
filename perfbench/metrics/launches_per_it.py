"""launches_per_it: device kernels the profiler saw in the traced window
(copies and fills not counted) over the window's iterations (a direct
solve counts one): the host's launch work an iteration, Krylov loop and
V-cycle together."""


def read(rec):
    tr = rec.get("trace")
    its = sum(rec["iterations"])
    if tr is None or its == 0 or tr["launches"] == 0:
        return None
    return tr["launches"] / its
