"""orthog_device_ms: device ms a solve inside the program's
KSPGMRESOrthog spans, by CUDA events on the device's clock: GMRES's
Gram-Schmidt (solvers/gmres.py: each step's two whole-basis products, its
norm and its normalisation)."""

from perfbench import cells


def orthog_spans(rec):
    """The window's KSPGMRESOrthog spans, or None where there are none or
    they have no device interval (off the card)."""
    recs = cells.metric_module("enqueue_ms_per_it").window_spans(rec)
    if recs is None:
        return None
    spans = [s for s in recs if s["name"] == "KSPGMRESOrthog"]
    if not spans or spans[0]["device_ms"] is None:
        return None
    return recs, spans


def read(rec):
    found = orthog_spans(rec)
    if found is None:
        return None
    return sum(s["device_ms"] for s in found[1]) / rec["window"]["solves"]
