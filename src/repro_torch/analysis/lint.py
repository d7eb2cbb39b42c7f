"""Mode 1 driver: parse ``src/repro_torch``, build the step-reachability
graph, run every rule, filter through the allowlist (port of
``repro.analysis.lint``).

The reachability graph is what makes QF201/QF301 repo-aware rather
than a grep: a function is *step-reachable* when a training or serving
step can run it, where a host sync (``.item()``, ``bool(tensor)``) or
a draw from hidden state costs the step its CUDA-graph capture and its
reproducibility —

* **R1** it is one of the port's step entry points
  (``LintConfig.step_roots``: what the reference jits as one step,
  which nothing marks in eager PyTorch), it is decorated with a
  transform (``@torch.compile``, ``@partial(torch.vmap, ...)``,
  ``torch.func.*``, ...), or it is the ``forward``/``backward`` of a
  ``torch.autograd.Function`` subclass;
* **R2** it is passed by name (or as a lambda) into a transform call
  (``torch.compile(f)``, ``torch.func.grad(loss)``,
  ``torch.utils.checkpoint.checkpoint(f, ...)``, ...);
* **R3** it follows the repo's step-function naming conventions in a
  *library* module (``*_apply``, ``*loss*``, ``step``, ``reset``,
  agent policies) — these are called through env/agent structs, which
  a static call graph cannot see;
* plus transitive closure over calls: names resolved through lexical
  scope, module scope and imports, and attribute calls name-matched
  into library modules only (driver modules — ``launch/``, ``serve/``
  — host orchestration code like latency timing that must never be
  flagged as step code unless it enters via R1/R2).
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.rules import (Finding, RULES, FileCtx,
                                        FuncInfo, LintContext,
                                        build_file_ctx, dotted_name,
                                        resolve_dotted)

# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LintConfig:
    # QF101: quantized data-path modules that must route contractions
    # through the blessed entry points.  nn/conv.py is *scoped* (not
    # blessed): its int8 forward is the Q-Conv kernel, and its raw
    # convolutions are the fp path and the STE backward, each carrying
    # an allowlist entry
    qf101_scope: Tuple[str, ...] = (
        "src/repro_torch/rl/", "src/repro_torch/serve/",
        "src/repro_torch/nn/linear.py", "src/repro_torch/nn/conv.py",
    )
    qf101_blessed: Tuple[str, ...] = (
        "src/repro_torch/core/qmatmul.py",
        "src/repro_torch/core/vact.py", "src/repro_torch/kernels/",
    )
    # QF501: modules implementing env wrappers
    qf501_scope: Tuple[str, ...] = (
        "src/repro_torch/rl/envs/wrappers.py",
    )
    # QF601: driver CLIs exempt from the no-print rule — they are the
    # human-facing surface; everything else routes through
    # repro_torch.obs (analysis/ is outside the lint universe already)
    qf601_exempt: Tuple[str, ...] = (
        "src/repro_torch/launch/",
    )
    # library modules: naming conventions + attribute name-matching
    # may mark functions here as step-reachable
    library: Tuple[str, ...] = (
        "src/repro_torch/core/", "src/repro_torch/nn/",
        "src/repro_torch/rl/", "src/repro_torch/kernels/",
        "src/repro_torch/optim/", "src/repro_torch/models/",
        "src/repro_torch/distributed/", "src/repro_torch/data/",
    )
    # the port's step entry points ("path:qualname"): the functions the
    # reference jits as one step (an iteration, a train/prefill/decode
    # step, a served forward), which PyTorch runs eagerly with nothing
    # to mark them
    step_roots: Tuple[str, ...] = (
        "src/repro_torch/rl/train_steps.py:"
        "make_onpolicy_iteration.<locals>.iteration",
        "src/repro_torch/rl/train_steps.py:"
        "_value_iteration.<locals>.iteration",
        # the metric writes the reference makes inside its iteration
        "src/repro_torch/rl/train_steps.py:"
        "make_onpolicy_iteration.<locals>.record",
        "src/repro_torch/rl/train_steps.py:"
        "_value_iteration.<locals>.record",
        "src/repro_torch/rl/trainer/evaluation.py:greedy_eval",
        "src/repro_torch/serve/engine.py:PolicyServer._run",
        "src/repro_torch/launch/steps.py:"
        "make_train_step.<locals>.train_step",
        "src/repro_torch/launch/steps.py:"
        "make_prefill_step.<locals>.prefill_step",
        "src/repro_torch/launch/steps.py:"
        "make_decode_step.<locals>.decode_step",
        "src/repro_torch/launch/serve.py:generate.<locals>.next_token",
    )
    # rules to run (all by default)
    rules: Tuple[str, ...] = ()


TRANSFORMS = {
    "torch.compile", "torch.vmap", "torch.utils.checkpoint.checkpoint",
    # the port's jax.eval_shape: the dry run's abstract trees
    "repro_torch.nn.module.eval_shape",
}
# every torch.func transform (grad, vjp, vmap, functional_call, ...)
TRANSFORM_PREFIXES = ("torch.func.",)
# base classes whose forward/backward autograd runs inside the step
AUTOGRAD_FUNCTIONS = {"torch.autograd.Function"}
AUTOGRAD_METHODS = {"forward", "backward"}
PARTIAL_NAMES = {"functools.partial", "partial"}
# attribute names too generic to name-match across modules
METHOD_DENYLIST = {
    "append", "extend", "get", "items", "keys", "values", "pop",
    "update", "setdefault", "copy", "add", "discard", "remove",
    "sort", "index", "count", "join", "split", "strip", "format",
    "startswith", "endswith", "lower", "upper", "replace", "encode",
    "decode", "read", "write", "close", "open", "flush", "mkdir",
    "exists", "tolist", "item", "block_until_ready", "astype",
    "reshape", "sum", "mean", "max", "min", "any", "all", "clip",
    "squeeze", "ravel", "flatten", "transpose", "at", "set",
    "dump", "dumps", "load", "loads", "render",
    # tensor methods
    "to", "view", "expand", "clone", "detach", "contiguous", "float",
    "long", "int", "cpu", "cuda", "numpy", "unsqueeze", "permute",
    "size", "dim", "numel", "copy_", "zero_", "fill_", "clamp",
}
# R3 conventions: leaf names a step enters through struct fields
CONVENTION_EXACT = {"step", "reset", "greedy", "sampled", "behave",
                    "init", "apply"}
CONVENTION_SUFFIX = ("_apply",)
CONVENTION_SUBSTR = ("loss",)


def _is_transform(resolved: str) -> bool:
    return resolved in TRANSFORMS or resolved.startswith(
        TRANSFORM_PREFIXES)


def _is_library(rel: str, cfg: LintConfig) -> bool:
    return any(rel == p or rel.startswith(p.rstrip("/") + "/")
               for p in cfg.library)


def _leaf(qualname: str) -> str:
    return qualname.split(".")[-1]


def _matches_convention(leaf: str) -> bool:
    if leaf in CONVENTION_EXACT:
        return True
    if any(leaf.endswith(s) for s in CONVENTION_SUFFIX):
        return True
    return any(s in leaf for s in CONVENTION_SUBSTR)


# ---------------------------------------------------------------------------
# file collection
# ---------------------------------------------------------------------------


def collect_files(root: str,
                  paths: Optional[List[str]] = None) -> List[FileCtx]:
    """Parse the lint universe.  ``paths`` (absolute or root-relative)
    overrides the default ``src/repro_torch/**`` sweep — used by the
    fixture self-tests."""
    out: List[FileCtx] = []
    if paths is None:
        base = os.path.join(root, "src", "repro_torch")
        paths = []
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames.sort()
            # the checker does not lint itself
            if os.path.basename(dirpath) == "analysis" and \
                    os.path.dirname(dirpath) == base:
                dirnames[:] = []
                continue
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    paths.append(os.path.join(dirpath, fn))
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        rel = os.path.relpath(ap, root).replace(os.sep, "/")
        module = _module_name(rel)
        with open(ap, "r", encoding="utf-8") as fh:
            src = fh.read()
        out.append(build_file_ctx(ap, rel, module, src))
    return out


def _module_name(rel: str) -> str:
    parts = rel.split("/")
    if parts[:1] == ["src"]:
        parts = parts[1:]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


# ---------------------------------------------------------------------------
# step-reachability graph
# ---------------------------------------------------------------------------


class _Reach:
    def __init__(self, files: List[FileCtx], cfg: LintConfig):
        self.files = files
        self.cfg = cfg
        self.by_module: Dict[str, FileCtx] = {
            f.module: f for f in files}
        # leaf name -> [(file, qualname)] in library modules only
        self.lib_by_leaf: Dict[str, List[Tuple[FileCtx, str]]] = {}
        for f in files:
            if not _is_library(f.rel, cfg):
                continue
            for qn in f.functions:
                self.lib_by_leaf.setdefault(_leaf(qn), []).append(
                    (f, qn))
        # lambda node -> qualname per file
        self.node_qn: Dict[int, Tuple[FileCtx, str]] = {}
        for f in files:
            for qn, info in f.functions.items():
                self.node_qn[id(info.node)] = (f, qn)
        self.reachable: Set[Tuple[str, str]] = set()
        self.work: List[Tuple[FileCtx, str]] = []

    def mark(self, f: FileCtx, qn: str):
        key = (f.rel, qn)
        if key not in self.reachable and qn in f.functions:
            self.reachable.add(key)
            self.work.append((f, qn))

    # -- name resolution -------------------------------------------------
    def resolve_name(self, f: FileCtx, scope: Optional[FuncInfo],
                     name: str) -> Optional[Tuple[FileCtx, str]]:
        # lexical scope chain (nested defs)
        info = scope
        while info is not None:
            cand = f"{info.qualname}.<locals>.{name}"
            if cand in f.functions:
                return f, cand
            info = info.parent
        # module level (incl. methods of module-level classes is NOT
        # name-only reachable here; plain defs only)
        if name in f.functions:
            return f, name
        # imports: from repro_torch.x import name
        target = f.imports.get(name)
        if target and target.startswith("repro_torch."):
            mod, _, leaf = target.rpartition(".")
            other = self.by_module.get(mod)
            if other and leaf in other.functions:
                return other, leaf
            # "from repro_torch.rl import rollout" style: a module
            other = self.by_module.get(target)
            if other:
                return None
        return None

    def resolve_attr(self, f: FileCtx, name: str) -> List[
            Tuple[FileCtx, str]]:
        """``x.foo`` / ``mod.foo`` call targets."""
        resolved = resolve_dotted(name, f.imports)
        if resolved.startswith("repro_torch."):
            mod, _, leaf = resolved.rpartition(".")
            other = self.by_module.get(mod)
            if other and leaf in other.functions:
                return [(other, leaf)]
        leaf = name.rsplit(".", 1)[-1]
        if leaf in METHOD_DENYLIST:
            return []
        # struct-field dispatch (env.step, agent.behave, buf.sample):
        # name-match into library modules only
        return list(self.lib_by_leaf.get(leaf, []))

    # -- roots ------------------------------------------------------------
    def _decorator_is_transform(self, f: FileCtx,
                                dec: ast.AST) -> bool:
        if isinstance(dec, ast.Call):
            name = dotted_name(dec.func)
            if name is None:
                return False
            resolved = resolve_dotted(name, f.imports)
            if _is_transform(resolved):
                return True
            if resolved in PARTIAL_NAMES and dec.args:
                inner = dotted_name(dec.args[0])
                return bool(inner) and _is_transform(resolve_dotted(
                    inner, f.imports))
            return False
        name = dotted_name(dec)
        return bool(name) and _is_transform(resolve_dotted(
            name, f.imports))

    @staticmethod
    def _autograd_classes(f: FileCtx) -> Set[str]:
        """Names of the classes in ``f`` that subclass
        ``torch.autograd.Function``."""
        out = set()
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef) and any(
                    (b := dotted_name(base)) and resolve_dotted(
                        b, f.imports) in AUTOGRAD_FUNCTIONS
                    for base in node.bases):
                out.add(node.name)
        return out

    def seed(self):
        by_rel = {f.rel: f for f in self.files}
        for root in self.cfg.step_roots:
            rel, _, qn = root.partition(":")
            f = by_rel.get(rel)
            if f is None:
                continue       # outside this run's universe
            if qn not in f.functions:
                raise ValueError(f"step root {root!r} names no function "
                                 f"of {rel}")
            self.mark(f, qn)
        for f in self.files:
            # R1: transform decorators
            for qn, info in f.functions.items():
                node = info.node
                if not isinstance(node, ast.Lambda):
                    for dec in node.decorator_list:
                        if self._decorator_is_transform(f, dec):
                            self.mark(f, qn)
                # R3: naming conventions in library modules
                if _is_library(f.rel, self.cfg) and \
                        _matches_convention(_leaf(qn)):
                    self.mark(f, qn)
            # R1: autograd runs a Function's forward and backward
            fns = self._autograd_classes(f)
            for qn, info in f.functions.items():
                if info.cls in fns and _leaf(qn) in AUTOGRAD_METHODS:
                    self.mark(f, qn)
            # R2 also takes the functions handed to Fn.apply(...)
            applies = {f"{c}.apply" for c in fns}
            # R2: functions passed into transform calls, anywhere
            for node in ast.walk(f.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                is_transform = False
                if name is not None:
                    resolved = resolve_dotted(name, f.imports)
                    is_transform = (
                        _is_transform(resolved) or name in applies
                        or (resolved in PARTIAL_NAMES and node.args
                            and (inner := dotted_name(node.args[0]))
                            is not None
                            and _is_transform(resolve_dotted(
                                inner, f.imports))))
                if not is_transform:
                    continue
                scope = self._enclosing_scope(f, node)
                for arg in list(node.args) + [kw.value for kw in
                                              node.keywords]:
                    if isinstance(arg, ast.Lambda):
                        hit = self.node_qn.get(id(arg))
                        if hit:
                            self.mark(*hit)
                    elif isinstance(arg, ast.Name):
                        hit = self.resolve_name(f, scope, arg.id)
                        if hit:
                            self.mark(*hit)

    def _enclosing_scope(self, f: FileCtx,
                         node: ast.AST) -> Optional[FuncInfo]:
        # cheapest correct option: find the innermost FuncInfo whose
        # subtree contains the node
        best, best_depth = None, -1
        for qn, info in f.functions.items():
            depth = qn.count(".")
            if depth <= best_depth:
                continue
            for sub in ast.walk(info.node):
                if sub is node:
                    best, best_depth = info, depth
                    break
        return best

    # -- propagation -------------------------------------------------------
    def propagate(self):
        while self.work:
            f, qn = self.work.pop()
            info = f.functions[qn]
            for node in ast.walk(info.node):
                # nested defs have their own reachability entries;
                # tracing falls through into them only via calls
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name is None:
                    continue
                if "." in name:
                    for hit in self.resolve_attr(f, name):
                        self.mark(*hit)
                else:
                    hit = self.resolve_name(f, info, name)
                    if hit:
                        self.mark(*hit)


def build_reachability(files: List[FileCtx],
                       cfg: LintConfig) -> Set[Tuple[str, str]]:
    r = _Reach(files, cfg)
    r.seed()
    r.propagate()
    return r.reachable


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def run_lint(root: str, paths: Optional[List[str]] = None,
             config: Optional[LintConfig] = None) -> List[Finding]:
    cfg = config or LintConfig()
    files = collect_files(root, paths)
    ctx = LintContext(root=root, files=files, config=cfg)
    ctx.reachable = build_reachability(files, cfg)
    findings: List[Finding] = []
    active = cfg.rules or tuple(sorted(RULES))
    for rule_id in active:
        findings.extend(RULES[rule_id].check(ctx))
    findings.sort(key=lambda fd: (fd.path, fd.line, fd.rule))
    return findings
