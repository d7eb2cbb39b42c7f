"""Console renderer (port of ``repro.obs.console``): the one place the
library writes lines to a terminal."""
from __future__ import annotations

import sys
from typing import Dict, Optional, TextIO


class Console:
    """Minimal leveled writer.  ``verbose=False`` swallows ``info`` but
    still passes ``warn`` through."""

    def __init__(self, verbose: bool = True,
                 stream: Optional[TextIO] = None):
        self.verbose = verbose
        self.stream = stream if stream is not None else sys.stdout

    def info(self, line: str) -> None:
        if self.verbose:
            print(line, file=self.stream)

    def warn(self, line: str) -> None:
        print(f"warning: {line}", file=self.stream)


def fmt_metrics(metrics: Dict, keys, precision: int = 3) -> str:
    """Render selected metrics as ``k=v`` pairs (missing keys skipped),
    in the benchmarks' emit style."""
    parts = []
    for k in keys:
        if k not in metrics:
            continue
        v = metrics[k]
        if isinstance(v, float):
            parts.append(f"{k}={v:.{precision}f}")
        else:
            parts.append(f"{k}={v}")
    return "  ".join(parts)
