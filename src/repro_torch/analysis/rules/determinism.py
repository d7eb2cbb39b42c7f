"""QF301 — hidden-state randomness inside step-reachable code (port of
``repro.analysis.rules.determinism``).

Randomness in a step must come from an explicit ``torch.Generator``
seeded from (seed, step), so runs are reproducible and resumable: a
``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
``bernoulli``/``multinomial`` call without ``generator=`` draws from
the process's global generator, as ``numpy.random``/stdlib ``random``
draw from hidden host state, and wall-clock reads (``time.time`` et
al.) make the step depend on when it ran.  Host-level timing *outside*
step code (e.g. serving latency measurement) is fine and not flagged.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.rules import (Finding, LintContext, dotted_name,
                                        resolve_dotted)
from repro_torch.analysis.rules.tracer_control import _own_statements

RULE_ID = "QF301"
SUMMARY = ("global-generator torch draw / numpy.random / stdlib random / "
           "wall-clock read in step-reachable code (pass an explicit "
           "generator=)")

BANNED_EXACT = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}
BANNED_PREFIXES = ("numpy.random.", "random.")
# torch draws that take the global generator unless given generator=
TORCH_DRAWS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial",
}


def _banned(resolved: str, call: ast.Call) -> bool:
    if resolved in TORCH_DRAWS:
        return not any(kw.arg == "generator" for kw in call.keywords)
    if resolved in BANNED_EXACT:
        return True
    return any(resolved.startswith(p) for p in BANNED_PREFIXES)


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        for qn, info in f.functions.items():
            if not ctx.is_reachable(f.rel, qn):
                continue
            for node in _own_statements(info.node):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name is None:
                    continue
                resolved = resolve_dotted(name, f.imports)
                if _banned(resolved, node):
                    findings.append(Finding(
                        f.rel, node.lineno, RULE_ID,
                        f"nondeterministic `{name}` in step-reachable "
                        f"`{qn}` — draw from an explicit "
                        "torch.Generator (generator=)", qn))
    return findings
