"""The PPO training loop of the PyTorch port against the JAX package:
the weight sync, one whole on-policy iteration, the trainer, its
checkpoints and its CLI.

The iteration is held with the reference's own draws: its Gumbel noise
(``k1, k2 = split(key)``; the one-device collect's ``fold_in(k1, 0)``,
``split(., T)`` per step) and its minibatch permutations (``key, sub =
split(key)`` per epoch from ``k2``), drawn with JAX and passed in.  The
reference iteration runs jitted on a one-device mesh.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.core import policy as jpolicy
from repro.launch.mesh import make_host_mesh
from repro.nn.module import unbox
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import constant as jconstant
from repro.rl import actor_learner as jal
from repro.rl import nets as jnets
from repro.rl import ppo as jppo
from repro.rl.dists import Categorical as JCategorical
from repro.rl.envs import cartpole as jcp
from repro.rl.train_steps import make_onpolicy_iteration as jmake_iteration
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.core import policy as tpolicy
from repro_torch.launch import rl_train as tcli
from repro_torch.optim import AdamWConfig, adamw_init, constant
from repro_torch.rl import actor_learner as tal
from repro_torch.rl import nets as tnets
from repro_torch.rl import ppo as tppo
from repro_torch.rl.dists import Categorical
from repro_torch.rl.envs import cartpole as tcp
from repro_torch.rl.envs import make as tmake
from repro_torch.rl.train_steps import (IterationDraws, iteration_generator,
                                        make_onpolicy_iteration)
from repro_torch.rl.trainer import OnPolicyTrainer, rl_train
from repro_torch.tree import tree_leaves

test_ppo = importlib.import_module("test_torch_ppo")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# weight sync
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_pack_and_sync_bytes_exact(bits):
    jp, tp = test_ppo.ref_params(0)
    assert tal.sync_bytes(tal.pack_weights(tp, bits)) == \
        jal.sync_bytes(jal.pack_weights(jp, bits))
    if bits < 32:
        jw = jax.tree.leaves(jal.unpack_weights(jal.pack_weights(jp, bits)))
        tw = tree_leaves(tal.unpack_weights(tal.pack_weights(tp, bits)))
        for a, b in zip(tw, jw, strict=True):
            np.testing.assert_array_equal(_np(a).view(np.int32),
                                          np.asarray(b).view(np.int32))


def test_fleetsync_staleness_derives_alive_mask():
    fs = tal.FleetSync(3, max_lag=1)
    fs.push("v0")
    assert fs.fetch() == "v0"
    assert fs.alive().tolist() == [True] * 3
    fs.push("v1")
    fs.fetch(0, slots=[0, 1])
    assert fs.staleness().tolist() == [0, 0, 1]
    assert fs.alive().tolist() == [True, True, True]
    fs.push("v2")
    fs.fetch(0, slots=[0, 1])
    assert fs.staleness().tolist() == [0, 0, 2]
    assert fs.alive().tolist() == [True, True, False]
    assert tal.fleet_mask(fs.alive(), 2).tolist() == [1, 1, 1, 1, 0, 0]


def test_fleetsync_doublebuf_fetch_lags_one_version():
    fs = tal.FleetSync(2, max_lag=1)
    fs.push("v0")
    assert fs.fetch(1) == "v0"
    fs.push("v1")
    assert fs.fetch(1) == "v0"
    fs.push("v2")
    assert fs.fetch(1) == "v1"
    assert fs.alive().tolist() == [True, True]
    assert fs.version == 2


# ---------------------------------------------------------------------------
# one whole on-policy iteration
# ---------------------------------------------------------------------------


def reference_draws(key, rollout_len, n_envs, n_actions, epochs, n):
    k1, k2 = jax.random.split(key)
    noise = test_ppo.rollout_noise(jax.random.fold_in(k1, 0), rollout_len,
                                   n_envs, n_actions)
    perms, k = [], k2
    for _ in range(epochs):
        k, sub = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(sub, n)))
    return noise, np.stack(perms)


@pytest.mark.parametrize("algo", ["ppo", "a2c"])
def test_one_onpolicy_iteration_against_reference(algo):
    """4 cartpole envs x 6 steps (no episode ends), fxp8 actors, the
    fp32 learner: every action equal, log-probs and values within
    rtol=1e-5, and the updated params and Adam moments within
    atol=1e-5 + rtol=1e-4 of the reference's jitted iteration."""
    n, steps = 4, 6
    pcfg_j = jppo.PPOConfig() if algo == "ppo" else jppo.PPOConfig(
        epochs=1, minibatches=1)
    pcfg_t = tppo.PPOConfig() if algo == "ppo" else tppo.PPOConfig(
        epochs=1, minibatches=1)
    loss_j = jppo.ppo_loss if algo == "ppo" else jppo.a2c_loss
    loss_t = tppo.ppo_loss if algo == "ppo" else tppo.a2c_loss
    jp, tp = test_ppo.ref_params(4)
    js, ts = test_ppo.cartpole_states(n, 21)
    key = jax.random.PRNGKey(13)

    k1, _ = jax.random.split(key)
    jres = jax.jit(lambda p, k, s, o: jal.collect(
        p, jcp.make(), jnets.mlp_ac_apply, jpolicy.FXP8, k, s, o, steps))(
        jal.pack_weights(jp, 8), jax.random.fold_in(k1, 0), js,
        jax.vmap(jcp._obs)(js))

    jit_it = jmake_iteration(
        jcp.make(), jnets.mlp_ac_apply, jpolicy.FXP8, make_host_mesh(1),
        JCategorical(), pcfg_j, loss_j, jconstant(3e-3),
        JAdamWConfig(weight_decay=0.0, max_grad_norm=0.5),
        rollout_len=steps, n_envs=n, n_slots=1)
    # the jitted iteration donates the env state: collect runs first
    jout = jit_it(jp, jadamw_init(jp), js, jax.vmap(jcp._obs)(js),
                  jal.pack_weights(jp, 8), key, None,
                  jnp.ones((1,), bool))
    noise, perms = reference_draws(key, steps, n, 2, pcfg_t.epochs, n * steps)
    draws = IterationDraws(torch.from_numpy(noise), torch.from_numpy(perms))
    it = make_onpolicy_iteration(
        tmake("cartpole"), tnets.mlp_ac_apply, tpolicy.FXP8, Categorical(),
        pcfg_t, loss_t, constant(3e-3),
        AdamWConfig(weight_decay=0.0, max_grad_norm=0.5), rollout_len=steps,
        n_envs=n)
    packed = tal.pack_weights(tp, 8)
    tres = it.rollout_phase(packed, draws, ts, tcp._obs(ts))
    tout = it(tp, adamw_init(tp), ts, tcp._obs(ts), packed, draws, None,
              torch.ones(1, dtype=torch.bool))

    jt, tt = jres.traj, tres.traj
    assert not _np(tt.boundary).any()
    np.testing.assert_array_equal(_np(tt.actions), np.asarray(jt.actions))
    errs = {}
    for f in ("log_probs", "values"):
        got, want = _np(getattr(tt, f)), np.asarray(getattr(jt, f))
        errs[f] = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for name, got, want in (("params", tout[0], jout[0]),
                            ("mu", tout[1]["mu"], jout[1]["mu"]),
                            ("nu", tout[1]["nu"], jout[1]["nu"])):
        worst = 0.0
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want),
                        strict=True):
            a, b = _np(a), np.asarray(b)
            worst = max(worst, float(np.abs(a - b).max()))
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        errs[name] = worst
    assert int(tout[1]["count"]) == int(jout[1]["count"]) == \
        pcfg_t.epochs * pcfg_t.minibatches
    np.testing.assert_allclose(_np(tout[3]), np.asarray(jout[3]), rtol=1e-6,
                               atol=1e-6)
    print(f"{algo}: largest abs errors against the reference: {errs}")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _small(**kw):
    return {**dict(device="cpu", iters=2, n_envs=4, rollout_len=8,
                   verbose=False), **kw}


def test_rl_train_runs_and_draws_by_step():
    params, history = rl_train(**_small())
    assert len(history) == 2 and all(np.isfinite(history))
    assert all(torch.isfinite(x).all() for x in tree_leaves(params))
    again, _ = rl_train(**_small())
    for a, b in zip(tree_leaves(params), tree_leaves(again), strict=True):
        assert torch.equal(a, b)
    g0 = iteration_generator(0, 5, torch.device("cpu"))
    g1 = iteration_generator(0, 5, torch.device("cpu"))
    g2 = iteration_generator(0, 6, torch.device("cpu"))
    a = torch.rand(8, generator=g0)
    assert torch.equal(a, torch.rand(8, generator=g1))
    assert not torch.equal(a, torch.rand(8, generator=g2))


def test_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """A run checkpointed after iteration 1 and resumed for iteration 2
    ends bit for bit where an uninterrupted 3-iteration run does."""
    full = OnPolicyTrainer(**_small(iters=3))
    s_full, h_full = full.train()
    ck = str(tmp_path / "ck")
    OnPolicyTrainer(**_small(iters=2, ckpt_dir=ck, save_every=1)).train()
    assert TManager(ck).latest_step() == 1
    resumed = OnPolicyTrainer(**_small(iters=3, ckpt_dir=ck, save_every=1))
    s_res, h_res = resumed.train()
    assert h_res == h_full[2:]
    for a, b in zip(tree_leaves(tuple(s_full)), tree_leaves(tuple(s_res)),
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_crosses_to_the_reference_and_back(tmp_path):
    """Params and optimizer state written by the port restore through
    the reference's CheckpointManager, bit for bit, and a checkpoint the
    reference writes from them restores in the port."""
    ck = str(tmp_path / "port")
    trainer = OnPolicyTrainer(**_small(ckpt_dir=ck, save_every=1))
    state, _ = trainer.train()
    jp0 = unbox(jnets.mlp_ac_init(jax.random.PRNGKey(0), 4, 2))
    jtmpl = (jp0, None, jadamw_init(jp0), None, None, None)
    (jparams, _, jopt, _, _, _), md = JManager(ck).restore(jtmpl)
    assert md["schema"] == "trainstate/v1" and md["stage"] == "all"
    for a, b in zip(tree_leaves((state.params, state.opt)),
                    jax.tree.leaves((jparams, jopt)), strict=True):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
        assert _np(a).dtype == np.asarray(b).dtype
    back = str(tmp_path / "ref")
    JManager(back).save(7, (jparams, None, jopt, None, None, None),
                        metadata={"schema": "trainstate/v1"})
    ttmpl = (state.params, None, state.opt, None, None, None)
    (tparams, _, topt, _, _, _), _ = TManager(back).restore(ttmpl)
    for a, b in zip(tree_leaves((tparams, topt)),
                    tree_leaves((state.params, state.opt)), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_cli_prints_iteration_lines(capsys):
    tcli.main(["--device", "cpu", "--iters", "2", "--n-envs", "4",
               "--rollout-len", "8"])
    out = capsys.readouterr().out
    assert "iter    0  return" in out and "iter    1  return" in out
    assert "done in" in out


@pytest.mark.parametrize("argv,match", [
    (["--agent", "hrl", "--two-stage", "--mesh-devices", "2"],
     "exposes 1 device"),
    (["--mesh-devices", "2"], "exposes 1 device"),
    (["--mesh", "production"], "needs 256 ranks"),
    (["--algo", "dqn", "--mesh", "host"], None)])
def test_unported_flags_name_their_slice(argv, match, capsys):
    """The mesh flags, which named the sharded slice until it came, now
    do what the reference's do on one rank: more devices than the world
    holds and the production mesh are refused, and ``--mesh host`` runs
    the value family over a one-slot mesh."""
    args = ["--device", "cpu", "--iters", "1", "--n-envs", "4",
            "--rollout-len", "8"] + argv
    if match is None:
        tcli.main(args)
        assert "1 actor slot(s) x 4 envs" in capsys.readouterr().out
        return
    with pytest.raises(ValueError, match=match):
        tcli.main(args)


@pytest.mark.parametrize("argv", [
    ["--algo", "dqn"], ["--replay-capacity", "50000"], ["--n-step", "3"],
    ["--updates-per-iter", "4"], ["--learn-start", "256"],
    ["--env", "acrobot"], ["--env", "mountain_car"], ["--env", "pendulum"]])
def test_flags_of_the_value_slice_now_run(argv, capsys):
    """The value family's flags and the classic-control envs, which named
    their slice until it came: the on-policy loop ignores the value
    knobs, as the reference's does, and every env trains."""
    tcli.main(["--device", "cpu", "--iters", "1", "--n-envs", "4",
               "--rollout-len", "8"] + argv)
    assert "done in" in capsys.readouterr().out


def test_cli_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="on-policy"):
        tcli.main(["--device", "cpu", "--replay", "per"])
    with pytest.raises(ValueError, match="requires --agent hrl"):
        tcli.main(["--device", "cpu", "--two-stage"])
    with pytest.raises(ValueError, match="obs shape"):
        tcli.main(["--device", "cpu", "--env", "keydoor", "--iters", "1"])
