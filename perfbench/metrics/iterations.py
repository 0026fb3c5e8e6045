"""iterations: the Krylov loop's iterations a solve (SolveResult.iterations),
mean over the traced window's solves."""


def read(rec):
    its = rec["iterations"]
    if not its:
        return None
    return sum(its) / len(its)
