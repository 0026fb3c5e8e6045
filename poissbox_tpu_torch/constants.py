"""Precision policy.

The JAX package's default real dtype follows JAX's global x64 switch. The
port has no global switch: every constructor takes its dtype explicitly,
float32 (the fast path) or float64 (the reference's precision of record),
and :func:`default_real` is only the dtype used when none is given.
Hopper runs float64 natively, so no kernel dispatch depends on the dtype
(the JAX package's ``mosaic_ok`` gate has no counterpart here).
"""

from __future__ import annotations

import torch


def default_real() -> torch.dtype:
    """The dtype used when a caller passes none."""
    return torch.float32


def epsilon(dtype=None) -> float:
    """Machine epsilon for `dtype` (default: :func:`default_real`)."""
    return float(torch.finfo(dtype or default_real()).eps)
