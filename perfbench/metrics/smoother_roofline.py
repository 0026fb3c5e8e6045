"""smoother_roofline: the least bytes the solve's red-black smoothing
needs, over 3.35 TB/s, divided by the device time of the red-black
kernels (rbsor.cu's sweep and colour kernels), in %.

The byte model counts the work the configured cycle needs, whatever
kernel does it: for each V-cycle the solve needs, on every level but the
coarsest, each sweep reads b and u once and writes u once, in the dtype
that level's sweep stores (the pre-smooth's, bfloat16 at 512^3, or the
field's); the first pre-smooth sweep starts from zero and reads no u. CG
from a zero guess needs one V-cycle a Krylov iteration (M r0, then one
a step but the last); the program runs one more, which this floor does
not count.
"""

from perfbench import peaks

NAMES = ("sweep_kernel", "colour_kernel")
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


def cycle_bytes(mg: dict) -> int:
    """Least bytes of one V-cycle's smoothing."""
    pre_b, post_b = ITEMSIZE[mg["pre_dtype"]], ITEMSIZE[mg["dtype"]]
    total = 0
    for shape in mg["levels"][:-1]:
        cells = shape[0] * shape[1] * shape[2]
        if mg["pre"] > 0:
            total += cells * pre_b * (2 + 3 * (mg["pre"] - 1))
        total += cells * post_b * 3 * mg["post"]
    return total


def solve_bytes(mg: dict, iterations: int) -> int:
    return iterations * cycle_bytes(mg)


def read(rec):
    tr, mg = rec.get("trace"), rec.get("mg")
    if tr is None or mg is None:
        return None
    seconds = sum(sec for name, (_, sec) in tr["table"].items() if any(k in name for k in NAMES))
    nbytes = sum(solve_bytes(mg, its) for its in rec["iterations"])
    return peaks.share_pct(nbytes, seconds)
