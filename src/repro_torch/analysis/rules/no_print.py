"""QF601 — bare ``print()`` in library code (port of
``repro.analysis.rules.no_print``).

Library modules report through structured telemetry
(:mod:`repro_torch.obs`): on-device metric buffers, JSONL records and
the ``Console`` renderer — never raw ``print()``, which bypasses the
``verbose`` gate, cannot be captured into a run's telemetry and turns
log format into an implicit API.  Launch drivers
(``src/repro_torch/launch/``) are the human-facing CLIs and stay
exempt; ``repro_torch.obs.console`` itself holds the sanctioned print
sites and carries allowlist entries.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.rules import (Finding, LintContext,
                                        dotted_name, walk_body)

RULE_ID = "QF601"
SUMMARY = ("bare print() in library code (route output through "
           "repro_torch.obs: Console / JsonlSink)")


def _exempt(rel: str, cfg) -> bool:
    exempt = getattr(cfg, "qf601_exempt", ())
    return any(rel == p or rel.startswith(p.rstrip("/") + "/")
               for p in exempt)


def _is_print(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and dotted_name(node.func) == "print")


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        if _exempt(f.rel, ctx.config):
            continue
        in_func = set()
        for qn, info in f.functions.items():
            for node in walk_body(info.node):
                if _is_print(node):
                    in_func.add(id(node))
                    findings.append(Finding(
                        f.rel, node.lineno, RULE_ID,
                        f"bare print() in `{qn}` — emit through "
                        "repro_torch.obs (Console for human lines, "
                        "JsonlSink for records)", qn))
        for node in ast.walk(f.tree):
            if _is_print(node) and id(node) not in in_func:
                findings.append(Finding(
                    f.rel, node.lineno, RULE_ID,
                    "bare print() at module level — emit through "
                    "repro_torch.obs (Console for human lines, JsonlSink "
                    "for records)", ""))
    return findings
