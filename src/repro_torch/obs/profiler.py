"""A ``torch.profiler`` capture around a window of global steps (port of
``repro.obs.profiler``).

``ProfileWindow(dir, start, steps)`` starts a trace when the global step
first reaches ``start`` and stops it ``steps`` iterations later (or at
``stop()``, whichever comes first).  The trainer calls ``tick(g)`` once
an iteration from host code, before the iteration's work, so the trace
holds steps ``g0 .. g0 + steps - 1`` and the reported window is
``[g0, g0 + steps]``, as the reference reports it.  It records CPU
activity and, when the device is a CUDA one, the card's kernels, and at
``stop`` writes one Chrome-trace JSON into ``dir``
(``trace_<g0>_<g1>.json``, openable in Perfetto or
``chrome://tracing``).  Errors of the profiler propagate.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch


class ProfileWindow:
    def __init__(self, profile_dir: str, start: int = 0, steps: int = 1,
                 device="cpu"):
        if steps < 1:
            raise ValueError(f"profile window needs steps >= 1, got {steps}")
        self.dir = profile_dir
        self.start = int(start)
        self.steps = int(steps)
        self.device = torch.device(device)
        self.active = False
        self.done = False
        self.trace_path: Optional[str] = None
        self._window: Optional[Tuple[int, int]] = None
        self._prof = None

    def tick(self, g: int) -> Optional[Tuple[int, int]]:
        """Advance to global step ``g``.  Returns the captured
        ``(g0, g1)`` window on the tick that stops the trace, else
        ``None``."""
        if self.done:
            return None
        if not self.active and g >= self.start:
            os.makedirs(self.dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self.active = True
            self._window = (g, g)
        elif self.active:
            g0, _ = self._window
            self._window = (g0, g)
            if g - g0 >= self.steps:
                return self.stop()
        return None

    def stop(self) -> Optional[Tuple[int, int]]:
        """Stop an active trace (idempotent), write it, and return its
        window."""
        if not self.active:
            return None
        if self.device.type == "cuda":
            # the window's kernels end before the trace does
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        g0, g1 = self._window
        self.trace_path = os.path.join(self.dir, f"trace_{g0}_{g1}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self.active = False
        self.done = True
        return self._window
