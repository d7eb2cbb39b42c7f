"""Wall-clock phase spans (port of ``repro.obs.spans``).

``SpanClock`` is a context-manager stopwatch: ``with clock("infer"):``
adds the elapsed wall seconds to that phase's window;
``drain()`` hands back the ``{phase: seconds}`` window and resets it.
Phases nest freely and the set of names is open.  The trainer uses
``step`` (one whole iteration, its host read of the return included),
``sync`` and ``checkpoint``; the serve loop ``infer`` and ``env``.
Host-side only: a span around work on the card measures its wall only
where the work ends in a read or a synchronize.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

# the trainer/serve taxonomy, for docs and the summary renderer; the
# clock itself accepts any name
TRAIN_PHASES = ("step", "sync", "eval", "checkpoint")
SERVE_PHASES = ("infer", "env")


class SpanClock:
    def __init__(self):
        self._s: Dict[str, float] = {}

    @contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._s[phase] = self._s.get(phase, 0.0) + dt

    def drain(self) -> Dict[str, float]:
        """Window flush: ``{phase: seconds}`` since the last drain."""
        out = dict(self._s)
        self._s.clear()
        return out
