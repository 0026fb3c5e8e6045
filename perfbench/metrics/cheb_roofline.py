"""cheb_roofline: the least bytes of the solve's Chebyshev smoothing over
3.35 TB/s, divided by the device time of the program's MGSmooth spans,
in %.

The byte model counts what a fused Chebyshev step has to move, whatever
today's kernels move: a step forms r = b - A x on the fly, reads x, b
and the last direction d, and writes x and d, so over the level's points
in the dtype the step ran in

    the first step from a zero guess  read b, write x (= d)       2 passes
    the first step from a given x     read x, b, write x, d       4
    a middle step                     read x, b, d, write x, d    5
    the last step                     read x, b, d, write x       4

The program counts, each solve, the degrees applied
(``MGSmooth.cheb_steps``) and the points of each kind of step by dtype
(``MGSmooth.cheb_points.<step>.<dtype>``;
``poissbox_tpu_torch.utils.profiling.counts``). The reader holds them to
the cycle the run resolved (the record's "mg": levels, sweeps, dtypes;
two degrees a sweep, at least 2, the program's rule) times the window's
V-cycles (its PCApply spans) and reads nothing where they differ. At
512^3 float32 with the bf16 pre-smooth, V(1,1): the fine level's
degree-2 pre-smooth (2 + 4 bf16 passes) and post-smooth (4 + 4 float32
passes) are 5.91 GB, 1.763 ms of floor a cycle; all seven smoothed
levels 2.015 ms.
"""

from perfbench import cells, peaks
from poissbox_tpu_torch.utils import profiling

PASSES = {"zero": 2, "first": 4, "middle": 5, "last": 4}
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}
PREFIX = "MGSmooth.cheb_points."


def degree(sweeps: int) -> int:
    return max(2 * sweeps, 2)


def cycle_points(mg: dict) -> tuple[int, dict]:
    """The degrees one V-cycle applies, and {"<step>.<dtype>": points} of
    its Chebyshev steps."""
    steps, out = 0, {}

    def add(key, n):
        if n:
            out[key] = out.get(key, 0) + n
    for shape in mg["levels"][:-1]:
        pts = shape[0] * shape[1] * shape[2]
        for sweeps, first, dt in ((mg["pre"], "zero", mg["pre_dtype"]),
                                  (mg["post"], "first", mg["dtype"])):
            if sweeps <= 0:
                continue
            d = degree(sweeps)
            steps += d
            add(f"{first}.{dt}", pts)
            add(f"middle.{dt}", (d - 2) * pts)
            add(f"last.{dt}", pts)
    return steps, out


def nbytes(points: dict) -> int:
    """Bytes of the steps in `points` ({"<step>.<dtype>": points})."""
    total = 0
    for key, n in points.items():
        step, dt = key.split(".")
        total += PASSES[step] * ITEMSIZE[dt] * n
    return total


def read(rec):
    found = cells.metric_module("smooth_device_ms").smooth_spans(rec)
    counts = getattr(profiling, "counts", None)
    mg = rec.get("mg")
    if found is None or counts is None or mg is None:
        return None
    recs, spans = found
    cycles = sum(1 for s in recs if s["name"] == "PCApply")
    roots = {s["id"] for s in recs if s["name"] == "KSPSolve" and s["parent"] is None}
    steps, counted = 0, {}
    for root, per in counts().items():
        if root not in roots:
            continue
        steps += per.get("MGSmooth.cheb_steps", 0)
        for key, n in per.items():
            if key.startswith(PREFIX):
                counted[key[len(PREFIX):]] = counted.get(key[len(PREFIX):], 0) + n
    per_cycle, points = cycle_points(mg)
    want = {k: cycles * n for k, n in points.items()}
    if (not steps or steps != cycles * per_cycle or counted != want
            or len(spans) != 2 * cycles * (len(mg["levels"]) - 1)):
        return None
    return peaks.share_pct(nbytes(counted), sum(s["device_ms"] for s in spans) / 1e3)
