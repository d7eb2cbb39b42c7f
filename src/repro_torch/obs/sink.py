"""The JSONL event sink (port of ``repro.obs.sink``): versioned schema,
one record per window.  The port writes byte for byte what the
reference writes, so either package's :func:`validate_record` and
``tools/obs_summary.py --validate`` read either package's files.

Every record is one JSON object on one line, carrying ``schema``
(:data:`SCHEMA`, bumped on breaking layout changes), ``kind`` and
``t_wall`` (unix seconds).  Four kinds exist today:

``meta``
    Run header, written once at open: ``run`` dict (the entry point,
    env, algo, config echo — whatever the caller passes).
``step``
    One training step window: ``step`` (global step at flush),
    ``window`` ``[g0, g1)`` of global steps covered, ``metrics``
    (flat name -> number), ``spans`` (phase -> wall seconds) and
    optionally ``hists`` (name -> {edges, counts}).
``serve``
    One serving window: ``window`` ``[r0, r1)`` of request counts,
    ``metrics``, ``hists`` and ``buckets`` (padded-batch-size ->
    request count).
``profile``
    A profiler capture: ``dir`` it was written to and the ``window``
    of global steps it covered.

:func:`validate_record` is the single source of truth for the shape —
the writer runs it on every append (writing a bad record is a bug,
not a condition to tolerate) and ``tools/obs_summary.py --validate``
runs it over whole files in CI.
"""
from __future__ import annotations

import json
import numbers
import os
import time
from typing import Dict, Iterator, List, Optional

SCHEMA = "obs/v1"
KINDS = ("meta", "step", "serve", "profile")


def _need(rec: Dict, key: str, kind) -> None:
    if key not in rec:
        raise ValueError(f"{rec.get('kind', '?')} record missing {key!r}")
    if not isinstance(rec[key], kind):
        raise ValueError(
            f"{rec.get('kind', '?')} record field {key!r} must be "
            f"{getattr(kind, '__name__', kind)}, got {type(rec[key]).__name__}")


def _check_metrics(metrics: Dict) -> None:
    for name, v in metrics.items():
        if not isinstance(name, str):
            raise ValueError(f"metric name must be str, got {name!r}")
        if isinstance(v, bool) or not isinstance(v, numbers.Real):
            raise ValueError(f"metric {name!r} must be a number, got {v!r}")


def _check_hists(hists: Dict) -> None:
    for name, h in hists.items():
        if not isinstance(h, dict) or set(h) != {"edges", "counts"}:
            raise ValueError(f"hist {name!r} must be {{edges, counts}}")
        if len(h["counts"]) != len(h["edges"]) + 1:
            raise ValueError(
                f"hist {name!r}: need len(counts) == len(edges) + 1, got "
                f"{len(h['counts'])} vs {len(h['edges'])}")
        if list(h["edges"]) != sorted(float(e) for e in h["edges"]):
            raise ValueError(f"hist {name!r}: edges must ascend")
        if any(int(c) < 0 for c in h["counts"]):
            raise ValueError(f"hist {name!r}: negative count")


def _check_window(rec: Dict) -> None:
    w = rec["window"]
    if (not isinstance(w, (list, tuple)) or len(w) != 2
            or not all(isinstance(x, int) for x in w) or w[0] > w[1]):
        raise ValueError(f"window must be [lo, hi] ints with lo <= hi, "
                         f"got {w!r}")


def validate_record(rec: Dict) -> Dict:
    """Raise ``ValueError`` unless ``rec`` is a well-formed obs/v1
    record; returns it unchanged so calls chain."""
    if not isinstance(rec, dict):
        raise ValueError(f"record must be a dict, got {type(rec).__name__}")
    if rec.get("schema") != SCHEMA:
        raise ValueError(f"schema must be {SCHEMA!r}, got "
                         f"{rec.get('schema')!r}")
    if rec.get("kind") not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got "
                         f"{rec.get('kind')!r}")
    _need(rec, "t_wall", numbers.Real)
    kind = rec["kind"]
    if kind == "meta":
        _need(rec, "run", dict)
    elif kind == "step":
        _need(rec, "step", int)
        _need(rec, "window", (list, tuple))
        _check_window(rec)
        _need(rec, "metrics", dict)
        _check_metrics(rec["metrics"])
        _need(rec, "spans", dict)
        _check_metrics(rec["spans"])
        if "hists" in rec:
            _check_hists(rec["hists"])
    elif kind == "serve":
        _need(rec, "window", (list, tuple))
        _check_window(rec)
        _need(rec, "metrics", dict)
        _check_metrics(rec["metrics"])
        _need(rec, "hists", dict)
        _check_hists(rec["hists"])
        _need(rec, "buckets", dict)
        for b, n in rec["buckets"].items():
            if not str(b).isdigit() or not isinstance(n, int) or n < 0:
                raise ValueError(f"buckets wants digit-keyed non-negative "
                                 f"ints, got {b!r}: {n!r}")
    elif kind == "profile":
        _need(rec, "dir", str)
        _need(rec, "window", (list, tuple))
        _check_window(rec)
    return rec


class JsonlSink:
    """Append-mode JSONL writer.

    Opened in append mode so a checkpoint-resumed run continues the
    same file — step windows stay contiguous across the restart (the
    resume-continuity test relies on this).  ``write`` validates,
    serialises and flushes each record; telemetry that lies about its
    own shape is worse than none.
    """

    def __init__(self, path: str, run: Optional[Dict] = None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a", encoding="utf-8")
        if run is not None:
            self.write({"schema": SCHEMA, "kind": "meta",
                        "t_wall": time.time(), "run": run})

    def write(self, rec: Dict) -> None:
        validate_record(rec)
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_records(path: str, validate: bool = True) -> List[Dict]:
    """Load a JSONL file back into a list of records."""
    out: List[Dict] = []
    for rec in iter_records(path, validate=validate):
        out.append(rec)
    return out


def iter_records(path: str, validate: bool = True) -> Iterator[Dict]:
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from e
            if validate:
                try:
                    validate_record(rec)
                except ValueError as e:
                    raise ValueError(f"{path}:{lineno}: {e}") from e
            yield rec
