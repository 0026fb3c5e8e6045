"""orthog_roofline: the least bytes of GMRES's Gram-Schmidt over 3.35
TB/s, divided by the device time of the program's KSPGMRESOrthog spans,
in %.

The byte model counts the basis rows built, whatever rows the products
happen to touch: step j of a cycle, with rows 0..j built, reads those
j + 1 rows twice (the coefficients h = V w, then w - h V) and reads and
writes w once, 2 (j + 1) + 2 passes over one field in the field's dtype.
The program counts, each solve, the steps (``KSPGMRESOrthog.steps``) and
the rows built when each ran, sum(j + 1) (``KSPGMRESOrthog.rows``;
``poissbox_tpu_torch.utils.profiling.counts``): at 512^3 float32 a
cycle of 8 steps is 88 passes, 14.1 ms of floor.
"""

from perfbench import cells, peaks
from poissbox_tpu_torch.utils import profiling


def passes(steps: int, rows: int) -> int:
    """Field passes of `steps` Gram-Schmidt steps that saw `rows` built rows."""
    return 2 * rows + 2 * steps


def read(rec):
    found = cells.metric_module("orthog_device_ms").orthog_spans(rec)
    counts = getattr(profiling, "counts", None)
    if found is None or counts is None:
        return None
    recs, spans = found
    per = counts()
    roots = [s["id"] for s in recs if s["name"] == "KSPSolve" and s["parent"] is None]
    steps = sum(per.get(r, {}).get("KSPGMRESOrthog.steps", 0) for r in roots)
    rows = sum(per.get(r, {}).get("KSPGMRESOrthog.rows", 0) for r in roots)
    if steps != len(spans):
        return None
    g = rec["grid"]
    nbytes = passes(steps, rows) * g[0] * g[1] * g[2] * rec["itemsize"]
    return peaks.share_pct(nbytes, sum(s["device_ms"] for s in spans) / 1e3)
