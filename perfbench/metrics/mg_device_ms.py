"""mg_device_ms: device ms a solve of the kernel families that only the
V-cycle launches: the red-black sweeps (rbsor.cu's sweep and colour
kernels), the fused transfer legs (xfer.cu's restrict and prolong-add
kernels), and cuBLAS's products (the banded y/z transfer contractions and
the coarse level's pseudo-inverse product)."""

NAMES = ("sweep_kernel", "colour_kernel", "restrict_kernel", "prolong_add_kernel",
         "gemm", "gemv", "cutlass", "xmma", "sm90_")


def read(rec):
    tr = rec.get("trace")
    if tr is None or rec.get("mg") is None:
        return None
    s = sum(sec for name, (_, sec) in tr["table"].items() if any(k in name for k in NAMES))
    if s <= 0:
        return None
    return 1e3 * s / rec["window"]["solves"]
