"""Device-side metric state: the ``MetricBuffer`` (port of
``repro.obs.metrics``).

The buffer is a plain nested dict of small tensors on the run's device:
counters (int32, reset on every flush), gauges (float32, last write
wins) and fixed-bucket histograms (int32 counts over static edges),
built from a :class:`MetricSpec` that is frozen for the run.  The
training iteration takes it and returns it updated, like the replay
state.  An update consumes values the iteration already computed and
feeds nothing back into the training math, draws nothing from a
generator and reads nothing back to the host, which keeps the
contract that metrics do not perturb training
(``docs/observability.md``).  :func:`flush` is the one host read, at a
log window.

Each update returns a new dict of new tensors and leaves its inputs as
they were, as the reference's do: a gauge set from the iteration's
``ret`` keeps ``ret`` itself (dtype, device, value) for the loop's own
read.  A value that already lies on the host (a Python number, or a CPU
tensor while the buffer is on the card) enters through a fill kernel,
never through a copy that would wait for the card.

Everything is 32-bit, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """The static shape of a run's metric buffer.

    ``hists`` maps a name to its (static) bucket edges; a value ``v``
    lands in bucket ``i`` when ``edges[i-1] <= v < edges[i]`` with the
    two open ends included, so counts has ``len(edges) + 1`` slots.
    """

    counters: Tuple[str, ...] = ()
    gauges: Tuple[str, ...] = ()
    hists: Tuple[Tuple[str, Tuple[float, ...]], ...] = ()

    def __post_init__(self):
        names = (list(self.counters) + list(self.gauges)
                 + [n for n, _ in self.hists])
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate metric names: {sorted(dupes)}")
        for name, edges in self.hists:
            if len(edges) < 1:
                raise ValueError(f"histogram {name!r} needs >= 1 edge")
            if list(edges) != sorted(edges):
                raise ValueError(f"histogram {name!r} edges must be "
                                 "sorted ascending")

    def edges(self, name: str) -> Tuple[float, ...]:
        for n, e in self.hists:
            if n == name:
                return e
        raise KeyError(f"no histogram named {name!r} in this spec")

    def init(self, device="cpu") -> Dict:
        """A zeroed buffer for this spec on ``device``."""
        dev = torch.device(device)
        return {
            "counters": {n: torch.zeros((), dtype=torch.int32, device=dev)
                         for n in self.counters},
            "gauges": {n: torch.zeros((), dtype=torch.float32, device=dev)
                       for n in self.gauges},
            "hists": {n: torch.zeros(len(e) + 1, dtype=torch.int32,
                                     device=dev)
                      for n, e in self.hists},
        }


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``like``'s dtype on its device: a
    tensor already there is converted on the device; a host value is
    filled in by a kernel (no copy, no wait for the card)."""
    if isinstance(value, torch.Tensor) and value.device == like.device:
        return value.detach().reshape(()).to(like.dtype)
    if isinstance(value, torch.Tensor):
        value = value.item()
    kind = int if like.dtype == torch.int32 else float
    return torch.full((), kind(value), dtype=like.dtype, device=like.device)


def counter_add(buf: Dict, name: str, value) -> Dict:
    """Increment a window counter (reset to zero on flush)."""
    c = dict(buf["counters"])
    c[name] = c[name] + _scalar(value, c[name])
    return {**buf, "counters": c}


def gauge_set(buf: Dict, name: str, value) -> Dict:
    """Record a gauge (last write in the window wins)."""
    g = dict(buf["gauges"])
    v = _scalar(value, g[name])
    # a tensor of the caller's may be a view of state written in place
    # later (the replay's): the gauge keeps its own copy
    g[name] = v.clone() if isinstance(value, torch.Tensor) else v
    return {**buf, "gauges": g}


def gauge_max(buf: Dict, name: str, value) -> Dict:
    """Record the running window maximum of a gauge."""
    g = dict(buf["gauges"])
    g[name] = torch.maximum(g[name], _scalar(value, g[name]))
    return {**buf, "gauges": g}


def hist_observe(spec: MetricSpec, buf: Dict, name: str, values) -> Dict:
    """Scatter ``values`` (any shape, on the buffer's device) into the
    named histogram: ``searchsorted(..., right=True)`` then an integer
    scatter-add, exact in any order."""
    h = dict(buf["hists"])
    counts = h[name]
    v = torch.as_tensor(values, device=counts.device).reshape(-1).to(
        torch.float32)
    edges = torch.tensor(spec.edges(name), dtype=torch.float32).to(
        counts.device)
    idx = torch.searchsorted(edges, v, right=True)
    h[name] = counts.index_add(0, idx, torch.ones_like(idx,
                                                       dtype=torch.int32))
    return {**buf, "hists": h}


def flush(spec: MetricSpec, buf: Dict) -> Tuple[Dict, Dict, Dict]:
    """The host read at a log window: ``(metrics, hists, zeroed)``.

    The whole buffer comes back in one copy (the gauges' fp32 bits
    viewed as int32 beside the counters and histogram counts).
    ``metrics`` is a flat name -> Python number dict (counters and
    gauges); ``hists`` maps name -> ``{"edges": [...], "counts":
    [...]}``, the JSONL shapes.  The returned buffer is a fresh zero
    buffer on the same device.
    """
    parts = ([buf["counters"][n].reshape(1) for n in spec.counters]
             + [buf["gauges"][n].reshape(1).view(torch.int32)
                for n in spec.gauges]
             + [buf["hists"][n] for n, _ in spec.hists])
    if not parts:
        return {}, {}, spec.init()
    device = parts[0].device
    host = torch.cat(parts).cpu()
    nc, ng = len(spec.counters), len(spec.gauges)
    metrics = {n: int(host[i]) for i, n in enumerate(spec.counters)}
    gauges = host[nc:nc + ng].view(torch.float32)
    metrics.update({n: float(gauges[i]) for i, n in enumerate(spec.gauges)})
    hists, at = {}, nc + ng
    for n, e in spec.hists:
        counts = host[at:at + len(e) + 1]
        hists[n] = {"edges": [float(x) for x in e],
                    "counts": [int(c) for c in counts]}
        at += len(e) + 1
    return metrics, hists, spec.init(device)
