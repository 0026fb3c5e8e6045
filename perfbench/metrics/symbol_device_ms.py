"""symbol_device_ms: device ms a solve inside the program's FFTSymbol
spans, by CUDA events on the device's clock: the spectral solve's
rebuild of the operator's inverse symbol (solvers/fft.py)."""

from perfbench import cells


def read(rec):
    recs = cells.metric_module("enqueue_ms_per_it").window_spans(rec)
    if recs is None:
        return None
    symbols = [s for s in recs if s["name"] == "FFTSymbol"]
    if not symbols or symbols[0]["device_ms"] is None:
        return None
    return sum(s["device_ms"] for s in symbols) / rec["window"]["solves"]
