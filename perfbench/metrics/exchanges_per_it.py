"""exchanges_per_it: the face exchanges rank 0 started in the traced
window (the program's ``halo.COUNTS["exchanges"]``, one a block and call:
the operator's, the smoothers' and the transfers' on every distributed
level) over the window's Krylov iterations."""


def read(rec):
    its = sum(rec["iterations"])
    if rec.get("exchanges") is None or its == 0:
        return None
    return rec["exchanges"] / its
