"""QF101 — raw matmul/conv primitives outside the blessed entry points
(port of ``repro.analysis.rules.raw_matmul``).

Quantized data-path modules (``rl/``, ``serve/``, ``nn/linear.py``,
``nn/conv.py``) must route every contraction through
``core/qmatmul.py`` (Q-MAC) or ``nn/conv.py``'s Q-Conv so the
fake-quant insertion points stay consistent and every int8 product
runs on the hand-written kernels.  A raw ``torch.matmul`` in a net
silently skips quantization and desyncs train/serve bit-parity.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.rules import (Finding, LintContext,
                                        dotted_name, resolve_dotted)

RULE_ID = "QF101"
SUMMARY = ("raw matmul/conv primitive in a quantized data-path module "
           "(use core.qmatmul / nn.conv)")

# fully-resolved dotted names that perform a contraction
BANNED_CALLS = {
    "torch.matmul", "torch.mm", "torch.bmm", "torch.einsum",
    "torch.tensordot", "torch.dot", "torch.inner", "torch._int_mm",
    "torch.nn.functional.linear", "torch.nn.functional.conv1d",
    "torch.nn.functional.conv2d",
}


def _in_scope(rel: str, cfg) -> bool:
    if any(rel == b or rel.startswith(b.rstrip("/") + "/")
           for b in cfg.qf101_blessed):
        return False
    return any(rel == s or rel.startswith(s.rstrip("/") + "/")
               for s in cfg.qf101_scope)


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.files:
        if not _in_scope(f.rel, ctx.config):
            continue
        # map node -> enclosing function qualname for reporting
        owner = {}
        for qn, info in f.functions.items():
            for node in ast.walk(info.node):
                owner.setdefault(id(node), qn)
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                if name is None:
                    continue
                resolved = resolve_dotted(name, f.imports)
                if resolved in BANNED_CALLS:
                    findings.append(Finding(
                        f.rel, node.lineno, RULE_ID,
                        f"raw contraction `{name}` — route through "
                        "core.qmatmul / nn.conv",
                        owner.get(id(node), "")))
            elif isinstance(node, ast.BinOp) and isinstance(
                    node.op, ast.MatMult):
                findings.append(Finding(
                    f.rel, node.lineno, RULE_ID,
                    "`@` matmul operator — route through "
                    "core.qmatmul / nn.conv",
                    owner.get(id(node), "")))
    return findings
