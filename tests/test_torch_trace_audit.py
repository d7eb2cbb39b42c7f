"""Self-tests for ``repro_torch.analysis.trace_audit``, held against the
reference's audit (``repro.analysis.trace_audit``) where its pieces run
here: the accepted combos, the grid table, the packed trees' scale
shapes and the threaded state's avals under ``jax.eval_shape``.  Each
check gets a poisoned input that fires; the fast sweep runs clean on the
CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.analysis import trace_audit as ref_ta
from repro.checkpoint.checkpointer import _path_str
from repro_torch.analysis import cli
from repro_torch.analysis import trace_audit as ta
from repro_torch.core.fxp import QTensor

DEV = "cpu"


@pytest.fixture(scope="module")
def fast_sweep():
    return ta.run_trace_audit(fast=True, device=DEV)


def test_accepted_combos_equal_the_references():
    combos = ta.accepted_combos()
    assert combos == [tuple(c) for c in ref_ta.accepted_combos()]
    assert len(combos) == 54
    assert len({c[1:] for c in combos}) == 18


def test_scale_table_equals_the_references():
    for shape in [(32, 64), (3, 32, 64), (3, 3, 8, 16), (7,), (2, 2, 2, 2,
                                                               2), ()]:
        assert ta.expected_scale_shape(shape) == \
            ref_ta.expected_scale_shape(shape)


def _scale_shapes(tree, out, path="params"):
    if isinstance(tree, QTensor) or type(tree).__name__ == "QTensor":
        out[path] = (tuple(tree.qvalue.shape), tuple(tree.scale.shape),
                     tree.bits)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _scale_shapes(v, out, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _scale_shapes(v, out, f"{path}[{i}]")
    return out


@pytest.mark.parametrize("combo", [("cartpole", "mlp", "dqn"),
                                   ("catch", "conv", "qrdqn"),
                                   ("pendulum", "mlp", "ddpg")])
def test_qf902_on_reference_params_carried_across(combo):
    """The reference's initial params, carried into torch: QF902 clean
    at w8 and w4, and the port's packed scale shapes are the
    reference's packed tree's."""
    from repro.core.policy import QuantPolicy as RefPolicy
    from repro.core.quantizer import quantize_params as ref_quantize
    from repro.rl.inference import build_env, make_value_agent
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.quantizer import quantize_params

    env_name, net, algo = combo
    env = build_env(env_name, net)
    params = make_value_agent(algo, env.spec, jax.random.PRNGKey(0),
                              net=net).params
    tparams = jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)),
                           params)
    for bits in (8, 4):
        assert ta.audit_qtensor_grids(tparams, bits, "trace:test") == []
        ref = jax.eval_shape(lambda p: ref_quantize(p, RefPolicy(
            w_bits=bits, per_channel=True)), params)
        got = quantize_params(tparams, QuantPolicy(w_bits=bits,
                                                   per_channel=True))
        want = _scale_shapes(ref, {})
        assert want and _scale_shapes(got, {}) == want


def test_qf902_wrong_grid_qtensor_fires():
    wrong = QTensor(torch.zeros((4, 8), dtype=torch.int8),
                    torch.ones((1, 1)), 8)
    found = ta.check_packed_tree({"w": wrong}, 8, "trace:test")
    assert [f.rule for f in found] == ["QF902"]
    assert "(1, 8)" in found[0].message
    odd = QTensor(torch.zeros((5,), dtype=torch.int8), torch.ones((1,)), 8)
    found = ta.check_packed_tree({"w": odd}, 8, "trace:test")
    assert found and "grid table" in found[0].message
    bits = QTensor(torch.zeros((4, 8), dtype=torch.int8),
                   torch.ones((1, 8)), 4)
    found = ta.check_packed_tree([bits], 8, "trace:test")
    assert "packed bits 4" in found[0].message


# ---------------------------------------------------------------------------
# QF901a — the recorder
# ---------------------------------------------------------------------------


def test_qf901_recorder_sees_wide_values_outside_kernels():
    x = torch.ones(3)
    rec = ta.OpRecorder()
    with ta.recording(rec):
        (x.to(torch.float64) * 2.0).sum()
    assert rec.wide_dtypes() == ["float64"] and rec.ops >= 3
    rec = ta.OpRecorder()
    with ta.recording(rec):
        torch.sin(x) * 2.0
    assert rec.wide_dtypes() == [] and rec.ops == 2
    # the plain Q-MAC embeds the integer product in fp64: not audited
    from repro_torch.kernels.qmac import ops
    q = torch.ones((2, 4), dtype=torch.int8)
    rec = ta.OpRecorder()
    with ta.recording(rec):
        ops.qmac_i8(q, q.t().contiguous())
    assert rec.wide_dtypes() == []
    assert ops.qmac_i8_plain.__name__ == "qmac_i8_plain"   # restored


def test_qf901_injected_float64_in_the_step_fires(monkeypatch):
    from repro_torch.rl import train_steps

    real = train_steps.episode_returns_from

    def wide(rewards, boundary):
        ret, n = real(rewards.to(torch.float64), boundary)
        return ret.to(torch.float32), n

    monkeypatch.setattr(train_steps, "episode_returns_from", wide)
    found = ta.audit_step("cartpole", "mlp", "dqn", "fp32", device=DEV)
    assert [f.rule for f in found] == ["QF901"]
    assert "float64" in found[0].message
    assert "src/repro_torch/" in found[0].message


# ---------------------------------------------------------------------------
# QF901b — threaded-state parity
# ---------------------------------------------------------------------------


def test_qf901_state_parity_catches_drift():
    z = torch.zeros(3)
    assert ta.state_parity_mismatches({"a": z}, {"a": z}, "est") == []
    drift = ta.state_parity_mismatches(
        {"a": z}, {"a": z.to(torch.float16)}, "est")
    assert len(drift) == 1 and "float16" in drift[0]
    assert len(ta.state_parity_mismatches(
        {"a": z}, {"a": torch.zeros((3, 1))}, "obs")) == 1
    assert "structure" in ta.state_parity_mismatches(
        {"a": z}, {"b": z}, "opt")[0]


def test_qf901_injected_dtype_drift_in_the_step_fires(monkeypatch):
    from repro_torch.rl import train_steps
    from repro_torch.tree import tree_map

    real = train_steps.polyak

    def half(target, online, tau):
        return tree_map(lambda t: t.to(torch.float16),
                        real(target, online, tau))

    monkeypatch.setattr(train_steps, "polyak", half)
    found = ta.audit_step("cartpole", "mlp", "dqn", "fp32", device=DEV)
    assert found and {f.rule for f in found} == {"QF901"}
    assert all("drift: target/" in f.message and "float16" in f.message
               for f in found)


def _ref_avals(builder, combo):
    it, args, threaded, slots, _ = builder(*combo)
    out = jax.eval_shape(it, *args)
    return {("replay" if name == "buf" else name, _path_str(p)):
            (tuple(leaf.shape), str(leaf.dtype))
            for i, name in enumerate(slots)
            for p, leaf in jax.tree_util.tree_flatten_with_path(out[i])[0]}


@pytest.mark.parametrize("combo,builder", [
    (("cartpole", "mlp", "dqn", "fxp8"), ref_ta._build_value_step),
    (("catch", "conv", "ppo", "fxp8"), ref_ta._build_onpolicy_step),
])
def test_threaded_state_equals_the_references_eval_shape(combo, builder):
    """The port's state after one iteration, leaf by leaf, against the
    avals of the reference's ``jax.eval_shape`` of its iteration.  The
    reference's env-state PRNG keys (uint32 ``.key``) have no port leaf:
    the port keys its envs with an int64 (stream id, counter) pair."""
    want = {k: v for k, v in _ref_avals(builder, combo).items()
            if not (k[1].endswith(".key") and v[1] == "uint32")}
    trainer = ta.build_trainer(*combo, device=DEV)
    _, out, _ = ta.run_iteration(trainer)
    got = {(name, p): (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for name in ta._SLOTS
           for p, t in ta._leaves(getattr(out, name))
           if not p.endswith(".key")}
    assert got == want


# ---------------------------------------------------------------------------
# QF903 — the serving ladder
# ---------------------------------------------------------------------------


def test_qf903_bucket_ladder_clean_then_leak_detected(monkeypatch):
    from repro_torch.rl.inference import build_env, make_value_agent
    from repro_torch.serve import engine
    from repro_torch.serve.loader import ServedPolicy

    assert ta.audit_buckets("cartpole", "mlp", max_bucket=4,
                            device=DEV) == []
    env = build_env("cartpole", "mlp")
    agent = make_value_agent("dqn", env.spec,
                             torch.Generator().manual_seed(0), device=DEV)
    server = engine.PolicyServer(
        ServedPolicy.from_agent(agent, "cartpole"), max_bucket=4)
    rec = ta.BucketRecorder(server)
    server.warmup(n_slots=1)          # warms bucket 1 alone
    rec.serving()
    server.act(torch.zeros((2, 4)))
    found = ta.check_bucket_ladder(server, rec, "trace:test")
    assert [f.rule for f in found] == ["QF903", "QF903"]
    assert "warmed [1, 2]" in found[0].message
    assert "[2] ran for the first time" in found[1].message
    # a leak past the pad-to-bucket boundary: 3 rows run unpadded
    monkeypatch.setattr(engine, "bucket_for", lambda n, sizes: n)
    server.act(torch.zeros((3, 4)))
    found = ta.check_bucket_ladder(server, rec, "trace:test")
    assert any("[3] rows ran off the bucket ladder" in f.message
               for f in found)


# ---------------------------------------------------------------------------
# QF904 — storage held in place
# ---------------------------------------------------------------------------


def test_qf904_replay_holds_its_storage_then_a_clone_fires(monkeypatch):
    trainer = ta.build_trainer("cartpole", "mlp", "dqn", "fp32",
                               device=DEV)
    state, out, before = ta.run_iteration(trainer)
    assert sorted(before) == ["replay/.actions", "replay/.discounts",
                              "replay/.next_obs", "replay/.obs",
                              "replay/.rewards"]
    assert ta.storage_mismatches(before, out) == []
    assert int(out.replay.size) == 8

    from repro_torch.rl.replay import uniform
    real = uniform.replay_add

    def copying(buf, *cols):
        return real(buf._replace(obs=buf.obs.clone()), *cols)

    monkeypatch.setattr(uniform, "replay_add", copying)
    found = ta.audit_step("cartpole", "mlp", "dqn", "fp32", device=DEV)
    assert [(f.rule, "replay/.obs" in f.message) for f in found] == \
        [("QF904", True)]


# ---------------------------------------------------------------------------
# the sweep and the CLI
# ---------------------------------------------------------------------------


def test_trace_audit_fast_sweep_is_clean(fast_sweep):
    assert fast_sweep.findings == [], "\n".join(
        f.render() for f in fast_sweep.findings)
    # one combo a family (18), the 5 sharded value combos, 2 ladders
    assert len(fast_sweep.combos_checked) == 25
    assert fast_sweep.held["onpolicy"] == []
    assert "replay/.tree" in fast_sweep.held["value/per"]
    # the CPU runs the kernels' plain versions: no launch
    assert not any(fast_sweep.launches.values())


def test_cli_trace_exits_clean(fast_sweep, monkeypatch, tmp_path, capsys):
    seen = {}

    def run(fast=False, combos=None, device=None):
        seen.update(fast=fast, device=device)
        return fast_sweep

    monkeypatch.setattr(ta, "run_trace_audit", run)
    out = tmp_path / "trace.json"
    assert cli.main(["trace", "--fast", "--device", "cpu", "--json",
                     str(out)]) == 0
    assert seen == {"fast": True, "device": "cpu"}
    bad = dataclasses.replace(fast_sweep, findings=[ta.Finding(
        "trace:test", 0, "QF904", "replay/.obs left its storage")])
    monkeypatch.setattr(ta, "run_trace_audit", lambda **_: bad)
    assert cli.main(["trace", "--device", "cpu"]) == 1
    capsys.readouterr()


def test_the_audit_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ta.run_trace_audit(combos=[])
