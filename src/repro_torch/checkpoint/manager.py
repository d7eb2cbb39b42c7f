"""CheckpointManager: retention and the step directory layout (port of
``repro.checkpoint.manager``).

Directory layout: ``<dir>/step_<N>.npz(.json)`` + ``<dir>/LATEST`` —
the same path strings as the reference.  ``latest_step`` scans the
directory rather than trusting LATEST.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Tuple

from repro_torch.checkpoint import checkpointer

_STEP_RE = re.compile(r"step_(\d+)\.npz$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 save_every: int = 100):
        self.dir = directory
        self.keep = keep
        self.save_every = save_every
        os.makedirs(directory, exist_ok=True)

    def path_for(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.npz")

    def all_steps(self):
        steps = []
        for p in glob.glob(os.path.join(self.dir, "step_*.npz")):
            m = _STEP_RE.search(p)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict] = None) -> str:
        path = self.path_for(step)
        md = dict(metadata or {})
        md["step"] = step
        checkpointer.save(path, tree, md)
        tmp = os.path.join(self.dir, ".latest.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(self.dir, "LATEST"))
        self._gc()
        return path

    def restore(self, like: Any, step: Optional[int] = None,
                device=None) -> Tuple[Any, Dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return checkpointer.restore(self.path_for(step), like, device)

    def metadata(self, step: Optional[int] = None) -> Dict:
        """The sidecar metadata alone — no array restore, no template."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return checkpointer.read_metadata(self.path_for(step))

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            for suffix in (".npz", ".npz.json"):
                p = os.path.join(self.dir, f"step_{s}{suffix}")
                if os.path.exists(p):
                    os.unlink(p)
