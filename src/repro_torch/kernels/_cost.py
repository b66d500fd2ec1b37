"""The kernels' side of the cost count (:mod:`repro_torch.analysis.op_cost`).

Every call of a hand-written kernel's wrapper, on any device, goes through
:func:`declared`: where a counter is active, the innermost one gets the
call's kernel name, its shape and the work the kernel's own ``work``
function declares for it (operations and bytes), and sees none of the aten
ops run inside the call (the plain version's on the CPU; the checks and
the outputs' allocation on the card and on ``meta``).  So one step counts
the same work on the CPU, on ``meta`` and on the card.  Where no counter is
active it does nothing.
"""
from __future__ import annotations

import contextlib

# the counters entered, innermost last (OpCounter.__enter__ / __exit__)
ACTIVE = []
_NULL = contextlib.nullcontext()


def declared(kernel: str, work, *shape):
    """The context of one call of ``kernel`` whose shape is ``shape``:
    ``work(*shape)`` gives its ``(operations, bytes)``."""
    if not ACTIVE:
        return _NULL
    return ACTIVE[-1].kernel_call(kernel, shape, *work(*shape))
