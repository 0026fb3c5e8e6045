"""The card's peaks and the roofline arithmetic of the yardstick.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its full
700 W power limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside
the tensor cores. A kernel's floor is the larger of its bytes over the
bandwidth and its operations over the rate (the arithmetic of
``chip_smoke.py``'s ``bound``); its share of the roofline is the floor
over its measured time.
"""

from __future__ import annotations

HBM_BPS = 3.35e12
F32_OPS = 67e12


def floor_s(nbytes: float, ops: float = 0.0) -> float:
    """The least seconds the card could take for this work."""
    return max(nbytes / HBM_BPS, ops / F32_OPS)


def share_pct(nbytes: float, seconds: float, ops: float = 0.0):
    """100 x floor / measured time; None where nothing was measured."""
    if seconds <= 0.0 or nbytes <= 0.0:
        return None
    return 100.0 * floor_s(nbytes, ops) / seconds
