"""Process-0 structured logging (port of :mod:`poissbox_tpu.utils.logging`).

The reference prints from every rank; in a job of several processes that
floods stdout N-processes-fold. Here reporting is process-0-only by
default. A process's rank is its ``torch.distributed`` rank once a process
group is initialised, else 0 (a single process).
"""

from __future__ import annotations

import sys

import torch.distributed as dist


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_process0() -> bool:
    return _rank() == 0


def log0(*args, file=None, all_processes: bool = False, **kw) -> None:
    """Print from process 0 (or everywhere with all_processes=True,
    prefixed by the process's rank the way the reference prefixes ranks)."""
    if all_processes:
        print(f"[p{_rank()}]", *args, file=file or sys.stdout, **kw)
    elif is_process0():
        print(*args, file=file or sys.stdout, **kw)
