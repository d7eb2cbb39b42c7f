"""RunTelemetry: the host-side aggregator one run owns (port of
``repro.obs.runlog``).

Binds together a :class:`~repro_torch.obs.sink.JsonlSink`, a
:class:`~repro_torch.obs.spans.SpanClock` and the step-window
bookkeeping behind three calls: ``span(name)`` around host phases,
``step_flush`` at each log window, ``profile`` when a trace capture
closes.  Windows are half-open ``[g0, g1)`` global-step ranges and stay
contiguous across a checkpoint resume, because the sink appends and the
first window starts at the resume step (the constructor's ``start``).
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

from repro_torch.obs.sink import SCHEMA, JsonlSink
from repro_torch.obs.spans import SpanClock


class RunTelemetry:
    def __init__(self, metrics_dir: str, *, run: Dict, name: str = "train",
                 start: int = 0):
        self.path = os.path.join(metrics_dir, f"{name}.jsonl")
        self.sink = JsonlSink(self.path, run=run)
        self.clock = SpanClock()
        self._g0 = int(start)

    def span(self, phase: str):
        return self.clock(phase)

    def step_flush(self, g: int, metrics: Dict,
                   hists: Optional[Dict] = None) -> Dict:
        """Close the window ending at global step ``g`` (inclusive) and
        write its ``step`` record; returns the record."""
        rec = {"schema": SCHEMA, "kind": "step", "t_wall": time.time(),
               "step": int(g), "window": [self._g0, int(g) + 1],
               "metrics": metrics, "spans": self.clock.drain()}
        if hists:
            rec["hists"] = hists
        self.sink.write(rec)
        self._g0 = int(g) + 1
        return rec

    def profile(self, profile_dir: str, window) -> None:
        self.sink.write({"schema": SCHEMA, "kind": "profile",
                         "t_wall": time.time(), "dir": profile_dir,
                         "window": [int(window[0]), int(window[1])]})

    def close(self) -> None:
        self.sink.close()
