"""Auxiliary subsystems (port of :mod:`poissbox_tpu.utils`): the profiling
helpers behind `-log_view` and the solve's spans (:mod:`.profiling`), process-0 logging
(:mod:`.logging`), NaN, shape and finiteness checking
(:mod:`.debugging`), the census of the collectives a rank makes
(:mod:`.census`) and the scaling model held to it (:mod:`.scaling`).
The two modules are imported here (``utils.census``, ``utils.scaling``);
``__all__`` keeps the JAX package's six names."""

from poissbox_tpu_torch.utils.profiling import kernel_time, trace
from poissbox_tpu_torch.utils.logging import log0, is_process0
from poissbox_tpu_torch.utils.debugging import enable_nan_checks, check_field
from poissbox_tpu_torch.utils import census, scaling

__all__ = ["kernel_time", "trace", "log0", "is_process0",
           "enable_nan_checks", "check_field"]
