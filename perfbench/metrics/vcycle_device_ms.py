"""vcycle_device_ms: device ms a solve inside the program's PCApply spans
(each one V-cycle, with CG's residual update fused into its first
kernel), by CUDA events on the device's clock: its kernels, its torch
ops, and any idle time of the card between them."""

from perfbench import cells


def read(rec):
    spans = cells.metric_module("enqueue_ms_per_it")
    recs = spans.window_spans(rec)
    if recs is None:
        return None
    _, applies = spans.enclosed(recs, {"PCApply"}, {"PCApply"})
    if not applies or applies[0]["device_ms"] is None:
        return None
    return sum(s["device_ms"] for s in applies) / rec["window"]["solves"]
