"""QF401 — step code that threads buffer-sized state through a whole
copy (port of ``repro.analysis.rules.donation``).

The reference donates a jitted step's threaded state (optimizer state,
replay buffer, env state, ...), which guarantees one live copy of it:
the updated version reuses the input's buffers.  PyTorch has no
donation; the port keeps the guarantee by writing such state in place
or rebinding its leaves.  The rule flags a step-reachable function
that takes a known state name and returns it after rebinding it to a
whole copy — ``.clone()``, ``torch.clone``, ``torch.cat``/``stack``,
``copy.deepcopy``, a dict of such copies, or a tree map of
``torch.clone`` — which holds two copies live across every call.

Deliberately narrow, as the reference: ``params`` is *not* a state
name (packed actor weights may alias parameter leaves), and only
returns of *bare names* count — a function returning fresh computed
values isn't threading state.
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.rules import (Finding, LintContext, dotted_name,
                                        func_params, resolve_dotted)
from repro_torch.analysis.rules.tracer_control import _own_statements

RULE_ID = "QF401"
SUMMARY = ("step code threads a buffer-sized state tree through a "
           "whole copy (write it in place: one live copy)")

# parameter names that carry buffer-sized threaded state in this repo
STATE_NAMES = {
    "opt", "opt_state", "buf", "buffer", "replay", "target", "est",
    "env_state", "obs", "state", "caches", "rb_state",
}
COPY_CALLS = {"torch.clone", "torch.cat", "torch.concat",
              "torch.concatenate", "torch.stack", "copy.deepcopy",
              "copy.copy"}
COPY_METHODS = {"clone"}


def _is_copy(node: ast.AST, imports) -> bool:
    """Whether ``node`` builds a whole copy of what it reads."""
    if isinstance(node, ast.Dict):
        return bool(node.values) and all(
            _is_copy(v, imports) for v in node.values)
    if isinstance(node, ast.DictComp):
        return _is_copy(node.value, imports)
    if isinstance(node, ast.Lambda):
        return _is_copy(node.body, imports)
    if not isinstance(node, ast.Call):
        return False
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in COPY_METHODS:
        return True
    name = dotted_name(node.func)
    if name is not None and resolve_dotted(name, imports) in COPY_CALLS:
        return True
    # a tree map whose function copies: tree_map(torch.clone, state)
    for arg in node.args:
        fn = dotted_name(arg)
        if fn is not None and resolve_dotted(fn, imports) in COPY_CALLS:
            return True
        if isinstance(arg, ast.Lambda) and _is_copy(arg.body, imports):
            return True
    return False


def _returned_bare_names(func: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for node in _own_statements(func):
        if isinstance(node, ast.Return) and node.value is not None:
            vals = (node.value.elts
                    if isinstance(node.value, ast.Tuple)
                    else [node.value])
            for v in vals:
                if isinstance(v, ast.Name):
                    names.add(v.id)
    return names


def _copied_names(func: ast.AST, imports) -> Set[str]:
    """Names this function rebinds to a whole copy."""
    out: Set[str] = set()
    for node in _own_statements(func):
        if isinstance(node, ast.Assign) and _is_copy(node.value,
                                                     imports):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name) \
                and _is_copy(node.value, imports):
            out.add(node.target.id)
    return out


def _threaded_copies(func: ast.AST, imports) -> Set[str]:
    params = set(func_params(func))
    return ((params & STATE_NAMES) & _returned_bare_names(func)
            & _copied_names(func, imports))


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        for qn, info in f.functions.items():
            if isinstance(info.node, ast.Lambda) or \
                    not ctx.is_reachable(f.rel, qn):
                continue
            copied = _threaded_copies(info.node, f.imports)
            if copied:
                findings.append(Finding(
                    f.rel, info.node.lineno, RULE_ID,
                    f"`{qn}` threads state {sorted(copied)} through a "
                    "whole copy — write it in place (one live copy, as "
                    "the reference's donation guarantees)", qn))
    return findings
