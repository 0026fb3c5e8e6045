"""compact_roofline: the least bytes of the compact Laplacians the solve
applies, over 3.35 TB/s, divided by the device time of K15
(compact.cu's register and tile kernels), in %.

The byte model counts one Laplacian an iteration: a CG iteration's
matvec (CG from a zero guess needs none for r0), or the residual of a
direct solve (one iteration); each reads u once and writes A u once in
the field's dtype: 0.3205 ms at 512^3 float32.
"""

from perfbench import peaks

NAMES = ("compact_reg_kernel", "compact_kernel")


def laplacian_bytes(grid, itemsize: int) -> int:
    return 2 * grid[0] * grid[1] * grid[2] * itemsize


def read(rec):
    tr = rec.get("trace")
    if tr is None or rec["order"] != 6:
        return None
    seconds = sum(sec for name, (_, sec) in tr["table"].items() if any(k in name for k in NAMES))
    nbytes = sum(rec["iterations"]) * laplacian_bytes(rec["grid"], rec["itemsize"])
    return peaks.share_pct(nbytes, seconds)
