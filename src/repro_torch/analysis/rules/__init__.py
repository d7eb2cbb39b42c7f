"""Rule registry + the shared AST context the lint rules consume.

Each rule module defines ``RULE_ID``, ``SUMMARY`` and
``check(ctx) -> list[Finding]``.  The driver
(:mod:`repro_torch.analysis.lint`) builds one :class:`LintContext` —
parsed ASTs, import maps and the cross-module step-reachability graph —
and hands it to every rule, so the (comparatively expensive)
reachability analysis runs once (port of ``repro.analysis.rules``).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One reported violation: ``path:line rule-id message``."""

    path: str          # repo-relative posix path
    line: int
    rule: str
    message: str
    qualname: str = ""  # enclosing function, for allowlist matching

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"


# ---------------------------------------------------------------------------
# per-file AST context
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FuncInfo:
    """One function (or lambda) definition with its lexical context."""

    qualname: str                 # e.g. "_value_iteration.<locals>.update"
    node: ast.AST                 # FunctionDef | AsyncFunctionDef | Lambda
    parent: Optional["FuncInfo"]  # lexically enclosing function
    cls: Optional[str]            # enclosing class name, if a method


@dataclasses.dataclass
class FileCtx:
    path: str                     # absolute
    rel: str                      # repo-relative posix (src/repro_torch/...)
    module: str                   # dotted module name (repro_torch....)
    tree: ast.Module
    # local name -> dotted target ("F" -> "torch.nn.functional",
    # "mlp_q_apply" -> "repro_torch.rl.nets.mlp_q_apply")
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    # qualname -> FuncInfo for every def/lambda in the file
    functions: Dict[str, FuncInfo] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class LintContext:
    root: str                     # repo root (absolute)
    files: List[FileCtx]
    # (rel, qualname) pairs the reachability analysis marked as step code
    reachable: set = dataclasses.field(default_factory=set)
    config: object = None         # LintConfig (lint.py)

    def file(self, rel: str) -> Optional[FileCtx]:
        for f in self.files:
            if f.rel == rel:
                return f
        return None

    def is_reachable(self, rel: str, qualname: str) -> bool:
        return (rel, qualname) in self.reachable


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_dotted(name: str, imports: Dict[str, str]) -> str:
    """Rewrite the leading alias of a dotted name via the import map:
    ``F.linear`` -> ``torch.nn.functional.linear``, ``np.random.rand``
    -> ``numpy.random.rand``.  Unknown heads pass through unchanged."""
    head, _, rest = name.partition(".")
    target = imports.get(head)
    if target is None:
        return name
    return f"{target}.{rest}" if rest else target


def build_file_ctx(path: str, rel: str, module: str,
                   source: str) -> FileCtx:
    tree = ast.parse(source, filename=path)
    ctx = FileCtx(path=path, rel=rel, module=module, tree=tree)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                ctx.imports[alias.asname or
                            alias.name.split(".")[0]] = (
                    alias.name if alias.asname else
                    alias.name.split(".")[0])
                # "import torch.nn.functional as F" binds F ->
                # torch.nn.functional; plain "import torch.nn" binds
                # only "torch"
                if alias.asname:
                    ctx.imports[alias.asname] = alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.module is None or node.level:
                continue   # relative imports: not used in this package
            for alias in node.names:
                ctx.imports[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"

    # collect defs/lambdas with qualnames
    def visit(node: ast.AST, prefix: str, parent: Optional[FuncInfo],
              cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                info = FuncInfo(qn, child, parent, cls)
                ctx.functions[qn] = info
                visit(child, f"{qn}.<locals>.", info, None)
            elif isinstance(child, ast.Lambda):
                qn = f"{prefix}<lambda@{child.lineno}>"
                info = FuncInfo(qn, child, parent, cls)
                ctx.functions[qn] = info
                visit(child, f"{qn}.<locals>.", info, None)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", parent,
                      child.name)
            else:
                visit(child, prefix, parent, cls)

    visit(tree, "", None, None)
    return ctx


def func_params(node: ast.AST) -> List[str]:
    args = node.args
    names = [a.arg for a in args.posonlyargs + args.args
             + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return names


def body_nodes(func: ast.AST):
    """Statements/expression of a def or lambda body."""
    if isinstance(func, ast.Lambda):
        return [func.body]
    return func.body


def walk_body(func: ast.AST, *, into_nested: bool = False):
    """Walk a function body, optionally stopping at nested defs (so a
    rule looking at *this* function's statements doesn't double-count
    its closures — they have their own FuncInfo entries)."""
    stack = list(body_nodes(func))
    while stack:
        node = stack.pop()
        yield node
        if not into_nested and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _load_rules():
    from repro_torch.analysis.rules import (determinism, donation,
                                            no_print, raw_matmul,
                                            tracer_control,
                                            wrapper_protocol)
    mods = [raw_matmul, tracer_control, determinism, donation,
            wrapper_protocol, no_print]
    return {m.RULE_ID: m for m in mods}


RULES = _load_rules()


def rule_ids() -> Tuple[str, ...]:
    return tuple(sorted(RULES))
