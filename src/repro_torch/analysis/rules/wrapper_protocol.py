"""QF501 — env wrappers must go through the ``_wrap`` tagging protocol
(port of ``repro.analysis.rules.wrapper_protocol``).

``wrapper_stack(env)`` is how order-sensitive compositions are
validated (e.g. ``running_normalize_observation`` refuses to wrap a
frame-stacked env).  That introspection only works if every wrapper
routes through ``_wrap``, which tags the produced step function.  A
wrapper that calls ``env.replace(step=...)`` directly produces an
untagged step and silently breaks the stack checks downstream.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.rules import (Finding, LintContext,
                                        dotted_name, resolve_dotted)

RULE_ID = "QF501"
SUMMARY = ("env wrapper rebinds reset/step without the _wrap tagging "
           "protocol (wrapper_stack would miss it)")

REBIND_KWS = {"step", "reset"}
EXEMPT_FUNCS = {"_wrap"}


def _in_scope(rel: str, cfg) -> bool:
    return any(rel == s or rel.startswith(s.rstrip("/") + "/")
               for s in cfg.qf501_scope)


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        if not _in_scope(f.rel, ctx.config):
            continue
        for qn, info in f.functions.items():
            # the tagging helper itself (by exact or trailing name —
            # it may live nested or in a class)
            leaf = qn.split(".")[-1]
            if leaf in EXEMPT_FUNCS:
                continue
            for node in ast.walk(info.node):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) and \
                        node is not info.node:
                    continue       # nested defs report under their qn
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name is None:
                    continue
                resolved = resolve_dotted(name, f.imports)
                is_replace = (name.endswith(".replace")
                              or resolved == "dataclasses.replace")
                if not is_replace:
                    continue
                kws = {kw.arg for kw in node.keywords if kw.arg}
                if kws & REBIND_KWS:
                    findings.append(Finding(
                        f.rel, node.lineno, RULE_ID,
                        f"`{name}(... {sorted(kws & REBIND_KWS)} ...)`"
                        " rebinds env functions outside _wrap — use "
                        "_wrap(env, name, reset=..., step=...)", qn))
    return findings
