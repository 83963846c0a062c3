"""``span(name)``: a named host event over a ``with`` block while a
``torch.profiler`` session records, for the eval loops
(``harness/timers.py:SPANS``) and the models that mark the parts of their
step (``models/etnet.py:SPANS``). It lives below both, so a model needs
nothing of the harness to mark itself."""

import contextlib

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name):
    """A profiler event ``name`` over the ``with`` block when a
    ``torch.profiler`` session is active on this thread, else one shared
    no-op context (no allocation; the check costs a fraction of a
    microsecond).

    The event is ``_RecordFunctionFast``'s (the one torch's compiled code
    emits; a ``cpu_op`` in the Chrome trace), not ``record_function``'s:
    that dispatches a torch op on entry and exit, which releases the
    interpreter lock, and each time the loop must win it back from the
    PNG writer threads (on an H100 machine's host, 147 us a span beside
    one busy thread, against 3 us for this one)."""
    if _profiler_enabled():
        return _RecordFunctionFast(name)
    return _OFF
