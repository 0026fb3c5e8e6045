"""busy_pct: device time of every kernel of the traced solves over the
wall of the same solves run untraced just before (the profiler's host
work lengthens the traced wall), in %."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or tr["untraced_wall_s"] <= 0 or tr["device_s"] <= 0:
        return None
    return 100.0 * tr["device_s"] / tr["untraced_wall_s"]
