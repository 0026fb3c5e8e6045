"""sync_wait_ms: host ms a solve inside the program's KSPSync spans: the
Krylov loop's reads of the device (the stopping test's, GMRES's
Hessenberg column), the time the host waits for the card."""

from perfbench import cells


def read(rec):
    recs = cells.metric_module("enqueue_ms_per_it").window_spans(rec)
    if recs is None:
        return None
    return sum(s["host_ms"] for s in recs if s["name"] == "KSPSync") / rec["window"]["solves"]
