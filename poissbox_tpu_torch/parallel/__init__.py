"""Multi-process execution (port of :mod:`poissbox_tpu.parallel`): the
process-grid planner, the periodic face exchange over ``torch.distributed``,
the correction-form operators on each rank's owned box, the uneven
decompositions' helpers, and the pencil transposes (one all-to-all a
layout change) of the compact operators and the FFT across ranks.

Each rank is one process holding one plain tensor, its owned box of every
field (the DMDA layout of the reference); halos move by point-to-point
messages to the periodic neighbour ranks and global sums by one all-reduce.
"""
