"""busy_pct.dist: rank 0's device time in the traced solves outside
NCCL's kernels (which spin on the card while a rank waits for the
others) over the slowest rank's wall of the same solves run untraced
just before, in %."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or tr.get("outside_nccl_s") is None or tr["untraced_wall_s"] <= 0:
        return None
    if tr["outside_nccl_s"] <= 0:
        return None
    return 100.0 * tr["outside_nccl_s"] / tr["untraced_wall_s"]
