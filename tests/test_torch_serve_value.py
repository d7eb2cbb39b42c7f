"""Serving every value-family checkpoint in the port against the JAX
package, on the CPU: a checkpoint the reference trained (dqn and qrdqn
over the mlp net on cartpole, qrdqn over the conv net on catch with
four stacked frames, ddpg on pendulum with scalar critics and with TQC's
quantile critics) loads in the port, whose server answers the
reference's server's greedy actions on the same observations at w8 and
w4, with no w8 parity mismatch; ``serve_policy``'s telemetry validates
in the reference; and a checkpoint the port trained restores in the
reference.

The port's server runs the eager program, so its actions are held bit
for bit against the reference's server run op by op, with the
reference's DDPG actor squashing through torch's tanh (XLA's and
torch's differ in the last bit).  Against the reference's server
compiled, as it ships, discrete actions are equal and DDPG's within
rtol=1e-6: compiled, XLA fuses multiply-adds of the forward and rounds
each once, which moves an action by an ulp.
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.rl.trainer.value import value_train as jvalue_train
from repro.serve import PolicyServer as JServer
from repro.serve import check_parity as jcheck_parity
from repro.serve import load_policy as jload
from repro_torch.launch import serve_policy as tlaunch
from repro_torch.rl.trainer import value_train
from repro_torch.serve import PolicyServer, check_parity, load_policy
from repro_torch.tree import tree_leaves

torch_tanh_in_reference = importlib.import_module(
    "test_torch_hrl_train").torch_tanh_in_reference

TINY = dict(iters=2, n_envs=4, rollout_len=4, replay_capacity=64,
            updates_per_iter=1, learn_start=8, save_every=1,
            verbose=False, seed=0)

RUNS = {
    "dqn_mlp": dict(algo="dqn", env_name="cartpole"),
    "qrdqn_mlp": dict(algo="qrdqn", env_name="cartpole"),
    "qrdqn_conv": dict(algo="qrdqn", env_name="catch", net="conv",
                       frame_stack_k=4),
    "ddpg": dict(algo="ddpg", env_name="pendulum"),
    "ddpg_tqc": dict(algo="ddpg", env_name="pendulum", tqc_drop=2),
}


@pytest.fixture(scope="module")
def reference_ckpts(tmp_path_factory):
    """Each run's checkpoint, trained by the reference (made on first
    use)."""
    made = {}

    def get(run):
        if run not in made:
            d = str(tmp_path_factory.mktemp(f"ref_{run}"))
            kw = dict(RUNS[run])
            jvalue_train(kw.pop("algo"), kw.pop("env_name"), ckpt_dir=d,
                         **TINY, **kw)
            made[run] = d
        return made[run]

    return get


def _obs(policy, n, seed):
    shape = tuple(policy.env.obs_shape)
    return np.random.default_rng(seed).normal(size=(n,) + shape).astype(
        np.float32)


def _reference_actions(jp, precision, obs):
    """The reference server's actions on ``obs``: (op by op, compiled)."""
    srv = JServer(jp, precision=precision, max_bucket=8)
    with jax.disable_jit():
        eager = np.asarray(srv.act(jnp.asarray(obs)))
    return eager, np.asarray(srv.act(jnp.asarray(obs)))


def _assert_actions(got, jp, precision, obs):
    eager, compiled = _reference_actions(jp, precision, obs)
    assert got.shape == eager.shape == compiled.shape
    np.testing.assert_array_equal(got, eager, err_msg=precision)
    if jp.algo == "ddpg":
        np.testing.assert_allclose(got, compiled, rtol=1e-6, atol=0,
                                   err_msg=precision)
    else:
        np.testing.assert_array_equal(got, compiled, err_msg=precision)


def _leaves_equal(mine, theirs):
    a, b = tree_leaves(mine), jax.tree.leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_reference_checkpoint_served_by_the_port(run, reference_ckpts,
                                                 torch_tanh_in_reference,
                                                 tmp_path, capsys):
    ck = reference_ckpts(run)
    jp, tp = jload(ck), load_policy(ck, device="cpu")
    cfg = RUNS[run]
    assert (tp.algo, tp.net, tp.env_name, tp.frame_stack, tp.step) == (
        cfg["algo"], cfg.get("net", "mlp"), cfg["env_name"],
        cfg.get("frame_stack_k", 1), 1)
    _leaves_equal(tp.params, jp.params)
    if tp.net == "conv":
        for a, b in zip(tp.norm_stats, jp.norm_stats, strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # 11 requests through max_bucket 8: a full bucket, then 3 padded to 4
    obs = _obs(tp, 11, seed=len(run))
    for precision in ("w8", "w4"):
        got = PolicyServer(tp, precision=precision, max_bucket=8).act(
            torch.from_numpy(obs)).numpy()
        _assert_actions(got, jp, precision, obs)
    assert check_parity(tp, "w8", n_obs=64) == 0
    assert check_parity(tp, "w8", n_obs=64) == jcheck_parity(jp, "w8",
                                                             n_obs=64)
    # the CLI: parity, telemetry the reference reads, a profile record
    m, p = str(tmp_path / "m"), str(tmp_path / "p")
    tlaunch.main(["--ckpt", ck, "--device", "cpu", "--check-parity",
                  "--episodes", "2", "--slots", "4", "--batch-bucket", "4",
                  "--metrics-every", "8", "--metrics-dir", m,
                  "--profile-dir", p])
    out = capsys.readouterr().out
    assert "parity vs evaluation at w8: 0 mismatching actions" in out
    recs = jobs.read_records(os.path.join(m, "serve.jsonl"))
    assert recs[0]["run"]["algo"] == cfg["algo"]
    kinds = [r["kind"] for r in recs]
    assert kinds[0] == "meta" and kinds[-1] == "profile"
    assert kinds.count("serve") >= 1 and os.listdir(p)


@pytest.mark.parametrize("run", ["ddpg", "ddpg_tqc"])
def test_ddpg_serves_the_bare_actor(run, reference_ckpts):
    """The served subtree is the actor alone, re-wrapped for the heads;
    ``mode="sample"`` is the bounded Gaussian around the greedy action."""
    tp = load_policy(reference_ckpts(run), device="cpu")
    packed, _ = tp.pack("w8")
    assert set(tp.params) == {"actor", "critic"}
    assert set(tp.agent.from_behaviour(packed)) == {"actor"}
    obs = torch.from_numpy(_obs(tp, 64, seed=3))
    greedy = PolicyServer(tp).act(obs)
    sampled = PolicyServer(tp, mode="sample", temperature=0.5).act(obs)
    assert sampled.shape == greedy.shape == (64, 1)
    assert not torch.equal(sampled, greedy)
    assert float(sampled.min()) >= -2.0 and float(sampled.max()) <= 2.0


@pytest.mark.parametrize("run", sorted(RUNS))
def test_port_checkpoint_restores_in_the_reference(run, tmp_path,
                                                   torch_tanh_in_reference):
    ck = str(tmp_path / "ck")
    params, _ = value_train(ckpt_dir=ck, device="cpu", **TINY, **RUNS[run])
    jp, tp = jload(ck), load_policy(ck, device="cpu")
    assert (jp.algo, jp.step) == (RUNS[run]["algo"], 1)
    _leaves_equal(params, jp.params)
    _leaves_equal(tp.params, jp.params)
    obs = _obs(tp, 8, seed=9)
    got = PolicyServer(tp, precision="w8", max_bucket=8).act(
        torch.from_numpy(obs))
    _assert_actions(got.numpy(), jp, "w8", obs)
