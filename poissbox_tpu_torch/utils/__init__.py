"""Auxiliary subsystems (port of :mod:`poissbox_tpu.utils`): so far the
profiling helpers behind `-log_view` (:mod:`.profiling`); the logging and
debugging helpers are not ported yet."""

from poissbox_tpu_torch.utils.profiling import kernel_time, trace

__all__ = ["kernel_time", "trace"]
