"""enqueue_ms_per_it: host ms of the program's KSPIteration spans, less
any KSPSync inside them, over the iterations (the spans' count): the
host's work to enqueue one Krylov iteration, its V-cycle included. Read in
the traced run, so under the profiler's own host cost.

This module also holds what every reader of the program's spans shares.
The program records spans while a torch profiler is active, so
``poissbox_tpu_torch.utils.profiling.spans()`` holds the traced window's
solves and nothing else of the run."""

from poissbox_tpu_torch.utils import profiling


def window_spans(rec):
    """The program's span records, or None where the program records no
    spans (a tree without them) or their KSPSolve roots are not as many
    as the window's solves."""
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    recs = spans()
    roots = sum(1 for s in recs if s["name"] == "KSPSolve" and s["parent"] is None)
    return recs if roots and roots == rec["window"]["solves"] else None


def enclosed(recs, names, outer):
    """The spans named in `names` that a span named in `outer` encloses,
    and those it does not."""
    by_id = {s["id"]: s for s in recs}
    inside, outside = [], []
    for s in recs:
        if s["name"] not in names:
            continue
        up = by_id.get(s["parent"])
        while up is not None and up["name"] not in outer:
            up = by_id.get(up["parent"])
        (inside if up is not None else outside).append(s)
    return inside, outside


def read(rec):
    recs = window_spans(rec)
    if recs is None:
        return None
    its = [s["host_ms"] for s in recs if s["name"] == "KSPIteration"]
    if not its:
        return None
    syncs, _ = enclosed(recs, {"KSPSync"}, {"KSPIteration"})
    return (sum(its) - sum(s["host_ms"] for s in syncs)) / len(its)
