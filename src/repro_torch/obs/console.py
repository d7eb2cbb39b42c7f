"""Console renderer (port of ``repro.obs.console``): the one place the
library writes lines to a terminal."""
from __future__ import annotations

import sys
from typing import Optional, TextIO


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

