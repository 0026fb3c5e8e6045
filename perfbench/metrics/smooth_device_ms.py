"""smooth_device_ms: device ms a solve inside the program's MGSmooth
spans, by CUDA events on the device's clock: every level's pre- and
post-smoothing in every V-cycle (solvers/mg.py `_smooth`; under
Chebyshev each degree's residual kernel and torch's recurrence updates),
and any idle time of the card between them."""

from perfbench import cells


def smooth_spans(rec):
    """The window's span records and its MGSmooth spans, or None where
    there are none or they have no device interval (off the card)."""
    recs = cells.metric_module("enqueue_ms_per_it").window_spans(rec)
    if recs is None:
        return None
    spans = [s for s in recs if s["name"] == "MGSmooth"]
    if not spans or spans[0]["device_ms"] is None:
        return None
    return recs, spans


def read(rec):
    found = smooth_spans(rec)
    if found is None:
        return None
    return sum(s["device_ms"] for s in found[1]) / rec["window"]["solves"]
