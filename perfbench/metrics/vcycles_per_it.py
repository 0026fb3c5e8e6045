"""vcycles_per_it: the program's PCApply spans (one V-cycle each, under
the default cycle) over its KSPIteration spans. CG applies the
preconditioner once more than it iterates."""

from perfbench import cells


def read(rec):
    recs = cells.metric_module("enqueue_ms_per_it").window_spans(rec)
    if recs is None:
        return None
    its = sum(1 for s in recs if s["name"] == "KSPIteration")
    if its == 0:
        return None
    return sum(1 for s in recs if s["name"] == "PCApply") / its
