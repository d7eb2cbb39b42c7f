"""QF201 — host syncs on likely tensors in step-reachable code (port of
``repro.analysis.rules.tracer_control``).

Inside a function a training or serving step runs, a Python
``if``/``while``/``assert``/``bool()``/``int()``/``float()``/``len()``
on a tensor value, or ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``
on one, reads the value back to the host: the step waits for the card,
and a CUDA graph cannot capture it.  Shape/dtype/ndim/device accesses
are host metadata and are pruned, as are ``is None`` checks,
``isinstance``/``hasattr``/``callable`` guards and string comparisons —
the rule only fires when a *likely-tensor* value (inferred from torch
usage or tensor-attribute access) flows into the sink.
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.rules import (Finding, LintContext, body_nodes,
                                        dotted_name, func_params,
                                        resolve_dotted)

RULE_ID = "QF201"
SUMMARY = ("Python branching / bool() / len() / .item() on a likely "
           "tensor in step-reachable code (a host sync: use "
           "torch.where / masks)")

# attribute access that marks a name as tensor-like — deliberately
# excludes shape/dtype/ndim/size/device: host code reads those off
# meshes, spaces and specs all the time, and they never sync
ARRAY_ATTRS = {
    "astype", "reshape", "sum", "mean", "max", "min", "any", "all",
    "item", "at", "T", "argmax", "argmin", "clip", "squeeze",
    "ravel", "flatten", "transpose",
    # tensor methods
    "to", "view", "expand", "float", "long", "int", "bool", "clone",
    "detach", "contiguous", "unsqueeze", "permute", "clamp",
    "clamp_min", "clamp_max", "abs", "exp", "log", "sqrt", "square",
    "amax", "amin", "gather", "index_select", "masked_fill", "tolist",
    "cpu", "numpy", "cuda", "cumsum", "prod", "norm", "round",
}
# attribute chains that are host metadata
STATIC_ATTRS = {"shape", "dtype", "ndim", "size", "device", "is_cuda",
                "requires_grad", "layout"}
# call heads that produce tensors
ARRAY_PRODUCERS = ("torch.",)
# torch calls that return host values (devices, generators, dtypes,
# flags) or act on the process, not on tensors
HOST_CALLS = {
    "torch.device", "torch.Generator", "torch.is_tensor",
    "torch.is_floating_point", "torch.is_complex", "torch.finfo",
    "torch.iinfo", "torch.no_grad", "torch.enable_grad",
    "torch.inference_mode", "torch.Size", "torch.get_default_dtype",
    "torch.dtype", "torch.is_grad_enabled", "torch.manual_seed",
}
HOST_PREFIXES = ("torch.cuda.", "torch.distributed.", "torch.backends.",
                 "torch.utils.", "torch.profiler.", "torch.autograd.",
                 "torch.library.", "torch.jit.", "torch.compiler.")
# guards whose results are always host Python values
NEUTRAL_CALLS = {"isinstance", "hasattr", "callable", "getattr",
                 "type", "id", "repr", "str"}
SINK_CALLS = {"bool", "len", "int", "float"}
# methods that copy a tensor's value to the host
SINK_METHODS = {"item", "tolist", "cpu", "numpy"}


def _is_torchish(resolved: str) -> bool:
    if resolved in HOST_CALLS or resolved.startswith(HOST_PREFIXES):
        return False
    return any(resolved.startswith(p) for p in ARRAY_PRODUCERS)


SCALAR_ANNOTATIONS = {"int", "float", "str", "bool", "bytes"}


def _scalar_annotated(func: ast.AST) -> Set[str]:
    """Params annotated as plain Python scalars — config knobs like
    ``top_k: int`` flow into torch calls but are never tensors."""
    if isinstance(func, ast.Lambda):
        return set()
    out: Set[str] = set()
    args = func.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        ann = a.annotation
        if isinstance(ann, ast.Name) and ann.id in SCALAR_ANNOTATIONS:
            out.add(a.arg)
        elif isinstance(ann, ast.Constant) and \
                ann.value in SCALAR_ANNOTATIONS:
            out.add(a.arg)
    return out


def _infer_array_params(func: ast.AST, imports) -> Set[str]:
    """Params used in torch calls or via tensor attributes."""
    params = set(func_params(func)) - _scalar_annotated(func)
    arrayish: Set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name):
            if (node.value.id in params
                    and node.attr in ARRAY_ATTRS):
                arrayish.add(node.value.id)
        elif isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name is None:
                continue
            if _is_torchish(resolve_dotted(name, imports)):
                for arg in list(node.args) + [
                        kw.value for kw in node.keywords]:
                    if isinstance(arg, ast.Name) and \
                            arg.id in params:
                        arrayish.add(arg.id)
    return arrayish


class _Taint:
    """Expression-level taint evaluation against a set of names."""

    def __init__(self, tainted: Set[str], imports):
        self.tainted = tainted
        self.imports = imports

    def expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False          # x.shape etc. are host metadata
            return self.expr(node.value)
        if isinstance(node, ast.Subscript):
            return self.expr(node.value)
        if isinstance(node, ast.Call):
            # a compute method on a tainted receiver (x.sum(), y.any())
            # yields a tensor
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ARRAY_ATTRS and \
                    self.expr(node.func.value):
                return True
            name = dotted_name(node.func)
            if name is not None:
                if name in NEUTRAL_CALLS:
                    return False
                resolved = resolve_dotted(name, self.imports)
                if _is_torchish(resolved):
                    return True
            args = list(node.args) + [kw.value
                                      for kw in node.keywords]
            return any(self.expr(a) for a in args)
        if isinstance(node, ast.Compare):
            # `x is None`, `x is not None` are host values
            if all(isinstance(op, (ast.Is, ast.IsNot))
                   for op in node.ops):
                return False
            # string comparisons are config dispatch, not tensors
            operands = [node.left] + list(node.comparators)
            if any(isinstance(o, ast.Constant)
                   and isinstance(o.value, str) for o in operands):
                return False
            return any(self.expr(o) for o in operands)
        if isinstance(node, ast.BoolOp):
            return any(self.expr(v) for v in node.values)
        if isinstance(node, (ast.BinOp, ast.UnaryOp)):
            kids = ([node.left, node.right]
                    if isinstance(node, ast.BinOp)
                    else [node.operand])
            return any(self.expr(k) for k in kids)
        if isinstance(node, ast.IfExp):
            return self.expr(node.body) or self.expr(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.expr(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.expr(node.value)
        return False


def _target_names(target: ast.AST) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in target.elts:
            out.extend(_target_names(e))
        return out
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return []


def _own_statements(func: ast.AST):
    """Statements of this function, not descending into nested defs."""
    stack = list(body_nodes(func))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _check_function(f, qn, info) -> List[Finding]:
    func = info.node
    tainted = _infer_array_params(func, f.imports)
    if not tainted and not _any_torch_calls(func, f.imports):
        return []
    tt = _Taint(tainted, f.imports)

    # propagate taint through assignments to a fixpoint
    stmts = [n for n in _own_statements(func)
             if isinstance(n, (ast.Assign, ast.AugAssign,
                               ast.AnnAssign))]
    changed = True
    while changed:
        changed = False
        for st in stmts:
            if isinstance(st, ast.Assign):
                targets, value = st.targets, st.value
            elif isinstance(st, ast.AnnAssign):
                if st.value is None:
                    continue
                targets, value = [st.target], st.value
            else:  # AugAssign
                targets, value = [st.target], st.value
            if value is not None and tt.expr(value):
                for t in targets:
                    for name in _target_names(t):
                        if name not in tt.tainted:
                            tt.tainted.add(name)
                            changed = True

    findings: List[Finding] = []

    def flag(node, what):
        findings.append(Finding(
            f.rel, node.lineno, RULE_ID,
            f"{what} on a likely tensor in step-reachable `{qn}` — a "
            "host sync; use torch.where / masks", qn))

    for node in _own_statements(func):
        if isinstance(node, ast.If) and tt.expr(node.test):
            flag(node, "Python `if`")
        elif isinstance(node, ast.While) and tt.expr(node.test):
            flag(node, "Python `while`")
        elif isinstance(node, ast.Assert) and tt.expr(node.test):
            flag(node, "`assert`")
        elif isinstance(node, ast.IfExp) and tt.expr(node.test):
            flag(node, "conditional expression")
        elif isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if (name in SINK_CALLS and node.args
                    and tt.expr(node.args[0])):
                flag(node, f"`{name}()`")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in SINK_METHODS
                  and tt.expr(node.func.value)):
                flag(node, f"`.{node.func.attr}()`")
    # dedupe (an `if a and b:` can hit two paths at one line)
    seen, out = set(), []
    for fd in findings:
        key = (fd.path, fd.line, fd.message)
        if key not in seen:
            seen.add(key)
            out.append(fd)
    return out


def _any_torch_calls(func: ast.AST, imports) -> bool:
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name and _is_torchish(resolve_dotted(name, imports)):
                return True
    return False


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        for qn, info in f.functions.items():
            if not ctx.is_reachable(f.rel, qn):
                continue
            findings.extend(_check_function(f, qn, info))
    return findings
