"""``python -m repro_torch.analysis`` — run the static checker (port of
``repro.analysis.cli``).

    python -m repro_torch.analysis              # lint + trace audit
    python -m repro_torch.analysis lint         # AST rules only (fast)
    python -m repro_torch.analysis trace        # trace audit only
    python -m repro_torch.analysis trace --fast --device cpu
    python -m repro_torch.analysis --list-rules

The trace audit runs on the card unless ``--device cpu``.  Exit codes:
0 clean, 1 findings, 2 stale allowlist / config error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.analysis.allowlist import (AllowlistError,
                                            apply_allowlist,
                                            load_allowlist, DEFAULT_PATH)
from repro_torch.analysis.lint import LintConfig, run_lint
from repro_torch.analysis.rules import RULES, Finding, rule_ids


def _find_root(start: str) -> str:
    d = os.path.abspath(start)
    while True:
        if os.path.isdir(os.path.join(d, "src", "repro_torch")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            raise SystemExit(
                "repro_torch.analysis: could not locate the repo root "
                "(no src/repro_torch above cwd) — pass --root")
        d = parent


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant checker: AST lint + trace audit")
    p.add_argument("mode", nargs="?", default="all",
                   choices=["all", "lint", "trace"])
    p.add_argument("--root", default=None,
                   help="repo root (default: walk up from cwd)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (lint mode)")
    p.add_argument("--allowlist", default=DEFAULT_PATH,
                   help="allowlist toml (default: the committed one)")
    p.add_argument("--no-allowlist", action="store_true",
                   help="report raw findings, ignore the allowlist")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write findings as JSON to this path")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--trace-fast", "--fast", dest="trace_fast",
                   action="store_true",
                   help="trace audit on a reduced combo sample "
                        "(per-family coverage instead of the full "
                        "env x net x algo x precision sweep)")
    p.add_argument("--device", default=None,
                   help="where the trace audit runs (default: cuda)")
    return p


def _emit(findings: List[Finding], json_out: Optional[str],
          extra: Optional[dict] = None) -> None:
    for f in findings:
        print(f.render())
    if json_out:
        payload = {"findings": [f.__dict__ for f in findings]}
        payload.update(extra or {})
        with open(json_out, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for rid in rule_ids():
            print(f"{rid}  {RULES[rid].SUMMARY}")
        from repro_torch.analysis import trace_audit
        for rid, summary in sorted(trace_audit.CHECKS.items()):
            print(f"{rid}  {summary}")
        return 0

    root = args.root or _find_root(os.getcwd())
    findings: List[Finding] = []
    extra: dict = {}
    # the rules this run checks: an entry of another rule is neither
    # used nor stale here
    checked = set()

    if args.mode in ("all", "lint"):
        cfg = LintConfig()
        if args.rules:
            want = tuple(r.strip() for r in args.rules.split(","))
            unknown = [r for r in want if r not in RULES]
            if unknown:
                print(f"unknown rule ids: {unknown}",
                      file=sys.stderr)
                return 2
            cfg = LintConfig(rules=want)
        checked.update(cfg.rules or RULES)
        findings.extend(run_lint(root, config=cfg))

    if args.mode in ("all", "trace"):
        from repro_torch.analysis import trace_audit
        checked.update(trace_audit.CHECKS)
        tr = trace_audit.run_trace_audit(fast=args.trace_fast,
                                         device=args.device)
        findings.extend(tr.findings)
        extra["trace_combos"] = tr.combos_checked

    if args.no_allowlist:
        _emit(findings, args.json_out, extra)
        return 1 if findings else 0

    try:
        entries = load_allowlist(args.allowlist)
    except AllowlistError as e:
        print(f"allowlist error: {e}", file=sys.stderr)
        return 2

    entries = [e for e in entries if e.rule in checked]
    kept, stale, suppressed = apply_allowlist(findings, entries)
    _emit(kept, args.json_out,
          {**extra, "suppressed": len(suppressed),
           "stale_allowlist": len(stale)})
    if suppressed:
        print(f"[allowlist] {len(suppressed)} finding(s) suppressed "
              f"by audited entries", file=sys.stderr)
    if stale:
        for e in stale:
            print(f"stale allowlist entry: rule={e.rule} "
                  f"path={e.path} match={e.match!r} — it suppresses "
                  "nothing; remove it", file=sys.stderr)
        return 2
    return 1 if kept else 0


if __name__ == "__main__":
    raise SystemExit(main())
