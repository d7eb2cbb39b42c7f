"""Wall-clock phase spans (port of ``repro.obs.spans``).

``SpanClock`` is a context-manager stopwatch: ``with clock("infer"):``
adds the elapsed wall seconds to that phase; ``drain()`` hands back the
``{phase: seconds}`` window and resets it.  Host-side only.  The serve
loop uses ``infer`` and ``env``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

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
        out = dict(self._s)
        self._s.clear()
        return out
