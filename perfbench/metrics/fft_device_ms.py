"""fft_device_ms: device ms a solve of cuFFT's kernels (the forward and
inverse real transforms of the spectral solve, solvers/fft.py)."""

NAMES = ("fft", "radix")


def read(rec):
    tr = rec.get("trace")
    if tr is None or rec.get("mg") is not None:
        return None
    s = sum(sec for name, (_, sec) in tr["table"].items()
            if any(k in name.lower() for k in NAMES))
    if s <= 0:
        return None
    return 1e3 * s / rec["window"]["solves"]
