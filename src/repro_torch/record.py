"""Where an op recorder hears of the calls that a ``TorchDispatchMode``
cannot see as one op.

A recorder (``analysis.trace_audit.OpRecorder``) sees every PyTorch op
of a step.  Two kinds of call are not PyTorch ops:

* a kernel wrapper's call (``kernels.*.ops``): on the card a ``ctypes``
  launch, on the CPU its plain version, on the meta device a shape
  rule.  Each is recorded as one call of its kernel, on every device
  alike, and the ops it runs inside are not recorded;
* a collective (``distributed.sharding.gather_over``): the backend's
  gather on a live mesh, copies of this rank's value over a
  ``MeshShape``.  Each is recorded as one transfer of its kind.

Nothing is recorded while no recorder is active, and the wrappers then
run as they would without this module.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

_active = None


def active():
    """The recorder in charge, or None."""
    return _active


@contextlib.contextmanager
def activated(recorder):
    """Within the block, the kernel wrappers and the collectives report
    to ``recorder``."""
    global _active
    prev, _active = _active, recorder
    try:
        yield recorder
    finally:
        _active = prev


@contextlib.contextmanager
def unrecorded():
    """Within the block, ops are not the step's (a live mesh's
    bookkeeping: its rank map is a tensor) and are not recorded."""
    if _active is None:
        yield
        return
    with _active.inside_kernel():
        yield


def kernel(name: str, int_ops: Optional[Callable] = None):
    """Decorate a kernel wrapper: under an active recorder, the call runs
    inside the recorder's kernel scope and is recorded as one call of
    ``name`` with its tensor arguments, its output and ``int_ops(*args,
    **kwargs)`` integer operations (0 without a rule)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = _active
            if rec is None or rec.in_kernel:
                return fn(*args, **kwargs)
            with rec.inside_kernel():
                out = fn(*args, **kwargs)
            rec.kernel(name, args, out, 0 if int_ops is None
                       else int_ops(*args, **kwargs))
            return out
        return call
    return wrap
