"""Audited exceptions to the lint rules (port of
``repro.analysis.allowlist``).

``allowlist.toml`` (next to this file) holds ``[[allow]]`` entries:

    [[allow]]
    rule   = "QF201"
    path   = "src/repro_torch/rl/envs/wrappers.py"
    match  = "normalize_observation"
    reason = "factory-time guard; runs on the host before any step"

An entry suppresses a finding when ``rule`` and ``path`` match exactly
and ``match`` is either a substring of the finding's message or equal
to its qualname (empty ``match`` matches the whole file+rule).  Every
entry must carry a non-empty ``reason`` — that's the audit trail.

Two failure directions, both CI-fatal:
* an **unlisted** finding fails the run (exit 1);
* a **stale** entry — one that suppressed nothing — also fails
  (exit 2), so the allowlist can only shrink as violations get fixed.

Parsed with :mod:`tomllib` on 3.11+, with a fallback mini-parser for
the restricted string-only format on 3.10, so the gate never needs a
toml dependency.  The same parser reads the reference's allowlist.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.rules import Finding

DEFAULT_PATH = os.path.join(os.path.dirname(__file__),
                            "allowlist.toml")


@dataclasses.dataclass
class AllowEntry:
    rule: str
    path: str
    match: str = ""
    reason: str = ""
    lineno: int = 0

    def covers(self, f: Finding) -> bool:
        if f.rule != self.rule or f.path != self.path:
            return False
        if not self.match:
            return True
        return self.match in f.message or self.match == f.qualname


class AllowlistError(ValueError):
    pass


def _parse_restricted(text: str, src: str) -> List[AllowEntry]:
    """String-only [[allow]] tables — enough for this file, no toml
    module needed."""
    entries: List[AllowEntry] = []
    current: Optional[dict] = None
    for i, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[allow]]":
            current = {"lineno": i}
            entries.append(current)  # filled in place
            continue
        if "=" in line and current is not None:
            key, _, val = line.partition("=")
            key, val = key.strip(), val.strip()
            # strip trailing comments outside the quoted string
            if val.startswith('"'):
                end = val.find('"', 1)
                if end < 0:
                    raise AllowlistError(
                        f"{src}:{i}: unterminated string")
                current[key] = val[1:end]
                continue
        raise AllowlistError(
            f"{src}:{i}: unsupported syntax {line!r} — allowlist "
            "entries are [[allow]] tables of quoted strings")
    return [AllowEntry(rule=e.get("rule", ""), path=e.get("path", ""),
                       match=e.get("match", ""),
                       reason=e.get("reason", ""),
                       lineno=e["lineno"]) for e in entries]


def load_allowlist(path: str = DEFAULT_PATH) -> List[AllowEntry]:
    if not os.path.exists(path):
        return []
    with open(path, "rb") as fh:
        raw = fh.read()
    try:
        import tomllib
        data = tomllib.loads(raw.decode("utf-8"))
        entries = [AllowEntry(rule=e.get("rule", ""),
                              path=e.get("path", ""),
                              match=e.get("match", ""),
                              reason=e.get("reason", ""))
                   for e in data.get("allow", [])]
    except ModuleNotFoundError:
        entries = _parse_restricted(raw.decode("utf-8"), path)
    for e in entries:
        if not e.rule or not e.path:
            raise AllowlistError(
                f"{path}: entry missing rule/path: {e}")
        if not e.reason.strip():
            raise AllowlistError(
                f"{path}: entry for {e.rule} {e.path} has no reason "
                "— every audited exception needs one")
    return entries


def apply_allowlist(
        findings: Sequence[Finding],
        entries: Sequence[AllowEntry],
) -> Tuple[List[Finding], List[AllowEntry], List[Finding]]:
    """-> (unsuppressed findings, stale entries, suppressed)."""
    used = [False] * len(entries)
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        hit = False
        for i, e in enumerate(entries):
            if e.covers(f):
                used[i] = True
                hit = True
        (suppressed if hit else kept).append(f)
    stale = [e for i, e in enumerate(entries) if not used[i]]
    return kept, stale, suppressed
