"""krylov_device_ms: device ms a solve of the program's KSPSolve interval
less the PCApply and MatMult spans in it, by CUDA events on the device's
clock: CG's own vector updates, reductions and final projection, and
any idle time of the card between them."""

from perfbench import cells

EVENTS = {"PCApply", "MatMult"}


def read(rec):
    spans = cells.metric_module("enqueue_ms_per_it")
    recs = spans.window_spans(rec)
    if recs is None:
        return None
    roots = [s for s in recs if s["name"] == "KSPSolve" and s["parent"] is None]
    if roots[0]["device_ms"] is None:
        return None
    _, events = spans.enclosed(recs, EVENTS, EVENTS)
    total = sum(s["device_ms"] for s in roots) - sum(s["device_ms"] for s in events)
    return total / len(roots)
