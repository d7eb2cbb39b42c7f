"""Self-tests for ``repro_torch.analysis``'s lint, held against the
reference's checker (``repro.analysis``) where the two share semantics.

Every rule gets positives (its torch fixture fires) and negatives (the
compliant twins, the blessed and exempt paths stay quiet); the allowlist
parser and filter are held against the reference's on the reference's
own allowlist and findings; the CLI's exit codes against the
reference's CLI on the same cases; the port's step-reachable set
against the reference's jit-reachable set, module by module.
"""
import dataclasses
import os

import pytest

from repro.analysis import cli as ref_cli
from repro.analysis import allowlist as ref_allow
from repro.analysis import lint as ref_lint
from repro.analysis.rules import Finding as RefFinding
from repro_torch.analysis import cli
from repro_torch.analysis.allowlist import (AllowEntry, AllowlistError,
                                            DEFAULT_PATH, apply_allowlist,
                                            load_allowlist)
from repro_torch.analysis.lint import (LintConfig, build_reachability,
                                       collect_files, run_lint)
from repro_torch.analysis.rules import Finding, rule_ids

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = "tests/torch_analysis_fixtures"


def fixture_config(**over):
    cfg = LintConfig(
        qf101_scope=(FIXDIR + "/",),
        qf101_blessed=(FIXDIR + "/fx_blessed.py",),
        qf501_scope=(FIXDIR + "/fx_qf501.py",),
        library=(FIXDIR + "/",),
        step_roots=(FIXDIR + "/fx_qf201.py:iteration",),
    )
    return dataclasses.replace(cfg, **over) if over else cfg


def lint_fixtures(*names, **over):
    paths = [os.path.join(ROOT, FIXDIR, n) for n in names]
    return run_lint(ROOT, paths=paths, config=fixture_config(**over))


def lines_of(findings, rule):
    return sorted(f.line for f in findings if f.rule == rule)


def fixture_line(name, needle):
    with open(os.path.join(ROOT, FIXDIR, name), encoding="utf-8") as fh:
        for i, line in enumerate(fh, 1):
            if needle in line:
                return i
    raise AssertionError(f"{needle!r} not in {name}")


@pytest.fixture(scope="module")
def tree_findings():
    """Each package's raw lint findings over its own tree, once."""
    return {"port": run_lint(ROOT), "ref": ref_lint.run_lint(ROOT)}


# ---------------------------------------------------------------------------
# the rules: positives and negatives on the torch fixtures
# ---------------------------------------------------------------------------


def test_qf101_raw_matmul_fires_and_blessed_is_exempt():
    findings = lint_fixtures("fx_qf101.py", "fx_blessed.py")
    assert {f.rule for f in findings} == {"QF101"}
    want = {fixture_line("fx_qf101.py", needle) for needle in (
        "torch.matmul", "x @ w", "F.linear", "torch._int_mm")}
    assert set(lines_of(findings, "QF101")) == want
    assert not [f for f in findings if "fx_blessed" in f.path]
    assert fixture_line("fx_qf101.py", "torch.add") not in \
        lines_of(findings, "QF101")


def test_qf201_host_syncs_fire_with_reachability():
    findings = lint_fixtures("fx_qf201.py")
    assert {f.rule for f in findings} == {"QF201"}
    got = lines_of(findings, "QF201")
    # R3 conventions, a Function's forward, torch.compile and a step root
    for needle in ("x.sum() > 0", ".item()", "len(y)", "bool(x.any())",
                   "carry.sum() > 0", "y.cpu()"):
        assert fixture_line("fx_qf201.py", needle) in got, needle
    for needle in ("x.shape[0] > n", "mask is None", "y.mean() > 0"):
        assert fixture_line("fx_qf201.py", needle) not in got, needle
    assert all("host sync" in f.message for f in findings)
    assert {f.qualname for f in findings} >= {"_Flip.forward", "_helper"}


def test_qf301_hidden_randomness_fires_only_when_reachable():
    findings = lint_fixtures("fx_qf301.py")
    assert {f.rule for f in findings} == {"QF301"}
    got = lines_of(findings, "QF301")
    for needle in ("np.random.rand", "time.time()", "random.random",
                   "torch.randn(x.shape)"):
        assert fixture_line("fx_qf301.py", needle) in got, needle
    assert fixture_line("fx_qf301.py", "generator=gen") not in got
    assert fixture_line("fx_qf301.py", "# negative: not step") not in got


def test_qf401_whole_copies_of_threaded_state_fire():
    findings = lint_fixtures("fx_qf401.py")
    assert {f.rule for f in findings} == {"QF401"}
    assert {f.qualname for f in findings} == {"bad_update", "bad_moments"}


def test_qf501_untagged_wrapper_fires_outside_wrap():
    findings = lint_fixtures("fx_qf501.py")
    assert {f.rule for f in findings} == {"QF501"}
    assert lines_of(findings, "QF501") == [
        fixture_line("fx_qf501.py", "# QF501 positive")]


def test_qf601_bare_print_fires_in_library_code():
    findings = lint_fixtures("fx_qf601.py")
    assert {f.rule for f in findings} == {"QF601"}
    got = lines_of(findings, "QF601")
    for needle in ("QF601 module positive", "QF601 positive",
                   "QF601 method positive"):
        assert fixture_line("fx_qf601.py", needle) in got
    for needle in ("console.info", "stream.write"):
        assert fixture_line("fx_qf601.py", needle) not in got
    assert "Reporter.dump" in {f.qualname for f in findings}


@pytest.mark.parametrize("rule,over", [
    ("QF601", {"qf601_exempt": (FIXDIR + "/fx_qf601.py",)}),
    ("QF501", {"qf501_scope": ()}),
    ("QF101", {"qf101_blessed": (FIXDIR + "/",)}),
])
def test_exempt_and_blessed_paths_are_skipped(rule, over):
    findings = lint_fixtures("fx_qf601.py", "fx_qf501.py", "fx_qf101.py",
                             **over)
    assert findings and rule not in {f.rule for f in findings}


def test_rules_filter_restricts_the_run():
    findings = lint_fixtures("fx_qf101.py", "fx_qf301.py",
                             rules=("QF301",))
    assert findings and {f.rule for f in findings} == {"QF301"}


def test_rule_ids_are_the_references():
    from repro.analysis.rules import rule_ids as ref_rule_ids
    assert rule_ids() == ref_rule_ids()


def test_a_step_root_naming_no_function_is_refused():
    with pytest.raises(ValueError, match="names no function"):
        lint_fixtures("fx_qf201.py",
                      step_roots=(FIXDIR + "/fx_qf201.py:missing",))


# ---------------------------------------------------------------------------
# allowlist semantics, against the reference's
# ---------------------------------------------------------------------------


def _fields(entries):
    return [(e.rule, e.path, e.match, e.reason) for e in entries]


def test_load_allowlist_reads_the_references_file_as_the_reference():
    path = ref_allow.DEFAULT_PATH
    assert _fields(load_allowlist(path)) == \
        _fields(ref_allow.load_allowlist(path))
    # the fallback mini-parser agrees too
    from repro_torch.analysis.allowlist import _parse_restricted
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    assert _fields(_parse_restricted(text, path)) == \
        _fields(ref_allow._parse_restricted(text, path))


def _as_ref(f: Finding) -> RefFinding:
    return RefFinding(**dataclasses.asdict(f))


def test_apply_allowlist_matches_the_reference(tree_findings):
    """The reference's own findings and allowlist, plus a stale entry
    and a near miss: the same kept, stale and suppressed lists."""
    raw = tree_findings["ref"]
    entries = ref_allow.load_allowlist(ref_allow.DEFAULT_PATH)
    entries = entries + [
        ref_allow.AllowEntry("QF101", "src/repro/nope.py", "", "stale"),
        ref_allow.AllowEntry("QF601", "src/repro/obs/console.py",
                             "Console.nothing", "near miss")]
    want = ref_allow.apply_allowlist(raw, entries)
    port_entries = [AllowEntry(e.rule, e.path, e.match, e.reason)
                    for e in entries]
    got = apply_allowlist([Finding(**dataclasses.asdict(f))
                           for f in raw], port_entries)
    assert [list(map(_as_ref, got[0])), _fields(got[1]),
            list(map(_as_ref, got[2]))] == \
        [want[0], _fields(want[1]), want[2]]
    assert got[2] and len(got[1]) == 2


def test_committed_allowlist_parses_with_reasons():
    entries = load_allowlist(DEFAULT_PATH)
    assert entries and all(e.reason.strip() for e in entries)
    assert all(e.path.startswith("src/repro_torch/") for e in entries)


def test_allowlist_rejects_entries_without_reason(tmp_path):
    p = tmp_path / "allow.toml"
    p.write_text('[[allow]]\nrule = "QF201"\n'
                 'path = "src/repro_torch/x.py"\n')
    with pytest.raises(AllowlistError):
        load_allowlist(str(p))


# ---------------------------------------------------------------------------
# the real tree is clean (modulo the committed allowlist)
# ---------------------------------------------------------------------------


def test_real_tree_lint_is_clean_and_allowlist_not_stale(tree_findings):
    kept, stale, suppressed = apply_allowlist(
        tree_findings["port"], load_allowlist(DEFAULT_PATH))
    assert kept == [], "\n".join(f.render() for f in kept)
    assert stale == [], f"stale allowlist entries: {stale}"
    assert suppressed


def test_cli_lint_exits_clean_on_the_tree(capsys):
    assert cli.main(["lint", "--root", ROOT]) == 0
    capsys.readouterr()


def _allowlists(tmp_path):
    """Variants of each package's committed allowlist: (name -> path)
    for the port and for the reference."""
    out = {}
    for pkg, path in (("port", DEFAULT_PATH),
                      ("ref", ref_allow.DEFAULT_PATH)):
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        blocks = text.split("[[allow]]")
        variants = {
            "stale": text + '\n[[allow]]\nrule = "QF101"\npath = '
                            '"src/nowhere.py"\nreason = "stale"\n',
            "no_reason": text + '\n[[allow]]\nrule = "QF101"\npath = '
                                '"src/nowhere.py"\n',
            "missing": "[[allow]]".join(blocks[:-1]),
        }
        for name, body in variants.items():
            p = tmp_path / f"{pkg}_{name}.toml"
            p.write_text(body)
            out[(pkg, name)] = str(p)
    return out


@pytest.mark.parametrize("case,want", [
    ("clean", 0), ("no_allowlist", 1), ("unknown_rule", 2),
    ("stale", 2), ("no_reason", 2), ("missing", 1),
])
def test_cli_exit_codes_match_the_references(case, want, tree_findings,
                                             tmp_path, monkeypatch,
                                             capsys):
    """The two CLIs on the same case give the same exit code: each lints
    its own tree (the findings computed once) under its own allowlist."""
    files = _allowlists(tmp_path)

    def cached(pkg):
        def run(root, paths=None, config=None):
            rules = config.rules if config is not None else ()
            return [f for f in tree_findings[pkg]
                    if not rules or f.rule in rules]
        return run

    monkeypatch.setattr(cli, "run_lint", cached("port"))
    monkeypatch.setattr(ref_cli, "run_lint", cached("ref"))
    codes = {}
    for pkg, main in (("port", cli.main), ("ref", ref_cli.main)):
        argv = ["lint", "--root", ROOT]
        if case == "no_allowlist":
            argv.append("--no-allowlist")
        elif case == "unknown_rule":
            argv += ["--rules", "QF999"]
        elif case != "clean":
            argv += ["--allowlist", files[(pkg, case)]]
        codes[pkg] = main(argv)
    capsys.readouterr()
    assert codes == {"port": want, "ref": want}


def test_cli_lists_every_rule_and_check(capsys):
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in rule_ids() + ("QF901", "QF902", "QF903", "QF904"):
        assert rid in out


# ---------------------------------------------------------------------------
# reachability: the port's step code holds the reference's traced code
# ---------------------------------------------------------------------------

# the reference's jit-reachable functions whose port counterpart (same
# module, same qualname) is not step-reachable, and why.  The dry run's
# abstract trees (launch/steps' abstract_params/abstract_caches) reach
# the inits, quantize_params and the caches' inits through
# nn.module.eval_shape, as the reference's reach them through
# jax.eval_shape
REACH_EXCEPTIONS = {
    ("src/repro/nn/module.py", "param"):
        "the reference's inits box each leaf with param(); the port's "
        "inits return unboxed trees, their axes given by each family's "
        "param_axes, so no init, abstract or real, calls param",
}


def test_port_reachability_holds_the_references():
    ref_files = ref_lint.collect_files(ROOT)
    ref_reach = ref_lint.build_reachability(ref_files, ref_lint.LintConfig())
    files = collect_files(ROOT)
    reach = build_reachability(files, LintConfig())
    have = {(f.rel, qn) for f in files for qn in f.functions}

    def port_key(rel, qn):
        return rel.replace("src/repro/", "src/repro_torch/", 1), qn

    missing = {(rel, qn) for rel, qn in ref_reach
               if port_key(rel, qn) in have
               and port_key(rel, qn) not in reach}
    assert missing == set(REACH_EXCEPTIONS), sorted(
        missing ^ set(REACH_EXCEPTIONS))
    assert all(len(r) > 40 for r in REACH_EXCEPTIONS.values())
    # the step roots reach the iterations' whole programs
    for key in [("src/repro_torch/rl/actor_learner.py", "collect"),
                ("src/repro_torch/rl/ppo.py", "minibatch_epochs"),
                ("src/repro_torch/rl/value.py", "polyak"),
                ("src/repro_torch/core/qmatmul.py", "q_matmul"),
                ("src/repro_torch/obs/metrics.py", "gauge_set")]:
        assert key in reach, key
