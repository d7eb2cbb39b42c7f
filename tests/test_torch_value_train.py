"""The value family's training loop in the PyTorch port against the JAX
package: one whole iteration of each algo, the trainer, its checkpoints
and its CLI.

One iteration starts from the reference's state (params, target, Adam
state, replay, envs) and takes the reference's draws, derived from its
key as its iteration splits it: ``k_collect, k_update = split(key)``;
per step ``split(k_collect, T)``, each split again by ``egreedy`` (a
random action, a uniform) or drawn as the DDPG actor's normals; per
update ``k_update, k_s, k_n = split(k_update, 3)``, ``k_s`` the replay
draw (uniform slots in ``[0, size)``, or PER's stratification
uniforms) and ``k_n`` DDPG's smoothing normals.  The reference's
iteration runs op by op (``jax.disable_jit``: compiled XLA fuses the
fxp8 actor's multiply-adds and rounds them otherwise), with torch's
tanh where the DDPG actor squashes.  Bars: actions equal; observations,
rewards and the replay's float columns within rtol=1e-6, atol=1e-6
(each library's sin and cos in the env); its integer columns, pointer
and size exact; PER's tree and max priority within rtol=1e-5; params,
targets and Adam moments within atol 1e-5 + rtol 1e-4 (the bar of the
one-iteration PPO test); Adam counts exact.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl.trainer.value import ValueTrainer as JValueTrainer
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.launch import rl_train as tcli
from repro_torch.rl.envs.spaces import Discrete
from repro_torch.rl.train_steps import ValueDraws
from repro_torch.rl.trainer import ValueTrainer, value_eval, value_train
from repro_torch.tree import leaves_with_path, tree_leaves, tree_unflatten

hrl_train = importlib.import_module("test_torch_hrl_train")
catch_draws = hrl_train.catch_draws
torch_tanh_in_reference = hrl_train.torch_tanh_in_reference

CPU = torch.device("cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


SMALL = dict(iters=4, n_envs=4, rollout_len=4, replay_capacity=64,
             updates_per_iter=2, learn_start=8, verbose=False, seed=0)

RUNS = {
    "dqn": dict(algo="dqn", env_name="cartpole"),
    "dqn_per": dict(algo="dqn", env_name="cartpole", replay="per"),
    "qrdqn_conv": dict(algo="qrdqn", env_name="catch", net="conv",
                       frame_stack_k=2),
    "ddpg": dict(algo="ddpg", env_name="pendulum"),
    "ddpg_tqc": dict(algo="ddpg", env_name="pendulum", tqc_drop=2),
    # learn_start 256 > the 16 transitions of the first iteration: the
    # updates run with every weight 0
    "dqn_per_underfill": dict(algo="dqn", env_name="cartpole",
                              replay="per", learn_start=None),
}


def reference_value_draws(key, tr, size):
    """The draws the reference's value iteration makes from ``key``
    (op by op), as the port's ``ValueDraws``; ``size`` is the replay
    size after the iteration's add."""
    T, B, U = tr.rollout_len, tr.n_envs, tr.updates_per_iter
    cfg = tr.agent.cfg
    space = tr.env.action_space
    k_collect, k_update = jax.random.split(key)
    acts, us, noise = [], [], []
    with jax.disable_jit():
        for k in jax.random.split(k_collect, T):
            if isinstance(space, Discrete) or hasattr(space, "n"):
                k1, k2 = jax.random.split(k)
                acts.append(np.asarray(jax.random.randint(k1, (B,), 0,
                                                          space.n)))
                us.append(np.asarray(jax.random.uniform(k2, (B,))))
            else:
                noise.append(np.asarray(jax.random.normal(
                    k, (B,) + tuple(space.shape))))
        replay, smooth = [], []
        for _ in range(U):
            k_update, k_s, k_n = jax.random.split(k_update, 3)
            n = cfg.batch_size
            if tr.replay == "per":
                replay.append(np.asarray(jax.random.uniform(k_s, (n,))))
            else:
                replay.append(np.asarray(jax.random.randint(
                    k_s, (n,), 0, max(size, 1))))
            if noise:
                smooth.append(np.asarray(jax.random.normal(
                    k_n, (n,) + tuple(space.shape))))
    stack = lambda xs: _t(np.stack(xs)) if xs else None  # noqa: E731
    return ValueDraws(stack(acts), stack(us), stack(noise), stack(replay),
                      stack(smooth))


def _port_state(state, ref):
    """The port's state with every leaf the reference's (its env keys
    excepted: the port's streams carry the injected reset draws)."""
    leaves = []
    for (path, mine), r in zip(leaves_with_path(tuple(state)),
                               jax.tree.leaves(ref), strict=True):
        keep = path[-1] == ".key"
        leaves.append(mine if keep else _t(r).to(mine.dtype))
    return type(state)(*tree_unflatten(tuple(state), leaves))


@pytest.fixture
def masked_reference_sample(monkeypatch):
    """The reference's underfill guard with its compiled semantics (a 0/1
    mask on the weights) while its iteration runs op by op, where it
    would raise instead."""
    from repro.rl.replay import per as jper
    from repro.rl.replay import uniform as juni

    def check_min_size(size, min_size):
        return (size >= min_size).astype(jnp.float32)

    for mod in (juni, jper):
        monkeypatch.setattr(mod, "check_min_size", check_min_size)


def one_iteration(kw):
    """The reference's first iteration and the port's from its state and
    draws: (reference (state, ret, n_ep), port's, port's trainer, port's
    state before)."""
    jtr = JValueTrainer(**kw)
    jstate = jtr.init_state()
    before = jax.tree.map(np.asarray, jstate)
    key = jax.random.fold_in(jtr.key, 0)
    with jax.disable_jit():
        jout = jtr.step(jtr.build_iteration(), jstate, jtr.pack(jstate),
                        key, 0, None, None)
    ttr = ValueTrainer(device="cpu", **kw)
    tstate = _port_state(ttr.init_state(), before)
    draws = reference_value_draws(key, ttr, ttr.size_after(0))
    it = ttr.build_iteration()
    out = it(tstate.params, tstate.target, tstate.opt, tstate.replay,
             ttr.pack(tstate), tstate.est, tstate.obs, draws, 0)
    return jout, out, ttr, tstate


def _close(got, want, what, rtol=1e-4, atol=1e-5):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_one_iteration_against_reference(run, catch_draws,
                                         torch_tanh_in_reference,
                                         masked_reference_sample):
    kw = {**SMALL, **RUNS[run]}
    if kw.get("learn_start", 8) is None:
        kw.pop("learn_start")
    if kw["env_name"] == "catch":
        catch_draws(kw["seed"] + 1, kw["n_envs"])
    (jstate, jret, jn), out, ttr, start = one_iteration(kw)
    params, target, opt, buf, est, obs, ret, n_ep = out
    assert int(n_ep) == int(jn)
    np.testing.assert_allclose(float(ret), float(jret), rtol=1e-6)
    _close(params, jstate.params, "params")
    _close(target, jstate.target, "target")
    jopt, topt = jstate.opt, opt
    if kw["algo"] != "ddpg":
        jopt, topt = {"all": jopt}, {"all": topt}
    for name in jopt:
        _close(topt[name]["mu"], jopt[name]["mu"], f"{name} mu")
        _close(topt[name]["nu"], jopt[name]["nu"], f"{name} nu")
        assert int(topt[name]["count"]) == int(jopt[name]["count"]) == \
            kw["updates_per_iter"]
    store, jstore = (buf.store, jstate.replay.store) \
        if kw.get("replay") == "per" else (buf, jstate.replay)
    for f in ("obs", "rewards", "next_obs", "discounts", "actions"):
        np.testing.assert_allclose(_np(getattr(store, f)),
                                   _np(getattr(jstore, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    assert int(store.ptr) == int(jstore.ptr)
    assert int(store.size) == int(jstore.size) == ttr.size_after(0)
    if kw.get("replay") == "per":
        np.testing.assert_allclose(_np(buf.tree), _np(jstate.replay.tree),
                                   rtol=1e-5)
        np.testing.assert_allclose(_np(buf.max_p), _np(jstate.replay.max_p),
                                   rtol=1e-5)
    for (path, a), b in zip(leaves_with_path(est),
                            jax.tree.leaves(jstate.est), strict=True):
        if path[-1] != ".key":
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                       atol=1e-6, err_msg=str(path))
    np.testing.assert_allclose(_np(obs), _np(jstate.obs), rtol=1e-6,
                               atol=1e-6)
    if run == "dqn_per_underfill":
        # masked updates: params unmoved, Adam counted, priorities
        # rewritten off the insertion maximum
        for a, b in zip(tree_leaves(params), tree_leaves(start.params),
                        strict=True):
            assert torch.equal(a, b)
        leaves = _np(buf.tree)[len(_np(buf.tree)) // 2:][:16]
        assert (leaves != 1.0).any()


# ---------------------------------------------------------------------------
# the trainer and its checkpoints
# ---------------------------------------------------------------------------

def _small(run, **kw):
    out = {**SMALL, **RUNS[run], "device": "cpu", **kw}
    if out.get("learn_start", 8) is None:
        out.pop("learn_start")
    return out


class _Stop(Exception):
    pass


class _Crashing(ValueTrainer):
    """A run that dies before its step 2 (after step 1's checkpoint)."""

    def step(self, iteration, state, packed, gen, g, stage_ctx, alive):
        if g == 2:
            raise _Stop
        return super().step(iteration, state, packed, gen, g, stage_ctx,
                            alive)


@pytest.mark.parametrize("run", ["dqn_per", "ddpg_tqc", "qrdqn_conv"])
def test_resume_is_bitwise_the_uninterrupted_run(run, tmp_path):
    """A 4-iteration run that dies after iteration 1's checkpoint and is
    resumed for iterations 2-3 ends bit for bit where an uninterrupted
    run does: params, targets, optimizer, replay (the PER tree
    included) and envs."""
    full = ValueTrainer(**_small(run))
    s_full, h_full = full.train()
    ck = str(tmp_path / "ck")
    with pytest.raises(_Stop):
        _Crashing(**_small(run, ckpt_dir=ck, save_every=1)).train()
    assert TManager(ck).latest_step() == 1
    md = TManager(ck).metadata()
    assert md["algo"] == RUNS[run]["algo"] and md["it"] == 1
    assert md["schema"] == "trainstate/v1"
    resumed = ValueTrainer(**_small(run, ckpt_dir=ck, save_every=1))
    s_res, h_res = resumed.train()
    assert h_res == h_full[2:]
    for a, b in zip(tree_leaves(tuple(s_full)), tree_leaves(tuple(s_res)),
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_restores_in_the_reference(tmp_path):
    """A port checkpoint of a PER run restores through the reference's
    trainer, flags validated and every leaf bitwise (the replay and its
    tree included)."""
    from repro.checkpoint import CheckpointManager as JManager
    ck = str(tmp_path / "ck")
    tr = ValueTrainer(**_small("dqn_per", iters=2, ckpt_dir=ck,
                               save_every=1))
    state, _ = tr.train()
    kw = {k: v for k, v in _small("dqn_per", iters=2).items()
          if k != "device"}
    jtr = JValueTrainer(ckpt_dir=ck, **kw)
    jstate, md = jtr.restore(JManager(ck), jtr.init_state())
    assert md["replay"] == "per" and jtr.resume_start(md) == 2
    for (path, a), b in zip(leaves_with_path(tuple(state)),
                            jax.tree.leaves(jstate), strict=True):
        if path[-1] != ".key":
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=str(path))


@pytest.mark.parametrize("flag,value,match", [
    ("replay", "uniform", "--replay"), ("tqc_drop", 0, "--tqc-drop"),
    ("algo", "qrdqn", "--algo")])
def test_resume_refuses_changed_flags(flag, value, match, tmp_path):
    run = "ddpg_tqc" if flag == "tqc_drop" else "dqn_per"
    ck = str(tmp_path / "ck")
    ValueTrainer(**_small(run, iters=2, ckpt_dir=ck, save_every=1)).train()
    assert TManager(ck).latest_step() == 1
    with pytest.raises(ValueError, match=match):
        ValueTrainer(**_small(run, ckpt_dir=ck, **{flag: value})).train()


def test_value_train_and_eval_draw_by_step():
    """Two runs of the same flags agree bit for bit; the evaluation
    returns a finite mean over completed episodes, and over the pixel
    pipeline with the run's merged normalizer."""
    from repro_torch.rl.envs.wrappers import merge_norm_stats, norm_stats_of
    p1, h1 = value_train(**_small("dqn"))
    p2, h2 = value_train(**_small("dqn"))
    assert h1 == h2
    for a, b in zip(tree_leaves(p1), tree_leaves(p2), strict=True):
        assert torch.equal(a, b)
    ret, n_ep = value_eval("dqn", "cartpole", p1, n_envs=4, n_steps=64,
                           actor_policy="fxp8", device="cpu")
    assert np.isfinite(ret) and n_ep > 0
    out = {}
    p, _ = value_train(**_small("qrdqn_conv"), state_out=out)
    stats = merge_norm_stats(norm_stats_of(out["env_state"]))
    ret, n_ep = value_eval("qrdqn", "catch", p, n_envs=4, net="conv",
                           frame_stack_k=2, norm_stats=stats,
                           actor_policy="fxp8", device="cpu")
    assert n_ep > 0 and -1.0 <= ret <= 1.0


def test_value_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {k: v for k, v in _small("dqn").items() if k != "device"}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ValueTrainer(**kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        value_eval("dqn", "cartpole", None)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--algo", "dqn"], ["--algo", "dqn", "--replay", "per"],
    ["--algo", "qrdqn", "--env", "catch", "--net", "conv",
     "--frame-stack", "4"],
    ["--algo", "ddpg", "--env", "pendulum"],
    ["--algo", "ddpg", "--env", "pendulum", "--tqc-drop", "2"],
    ["--algo", "qrdqn", "--env", "acrobot", "--replay-capacity", "500",
     "--n-step", "1", "--updates-per-iter", "1", "--learn-start", "16"],
    ["--algo", "dqn", "--env", "mountain_car"],
    ["--env", "pendulum"], ["--env", "acrobot"],
    ["--env", "mountain_car", "--algo", "a2c"]])
def test_cli_runs_every_algo_and_env_on_cpu(argv, capsys):
    tcli.main(["--device", "cpu", "--iters", "2", "--n-envs", "4",
               "--rollout-len", "8"] + argv)
    out = capsys.readouterr().out
    assert "iter    0  return" in out and "iter    1  return" in out
    assert "done in" in out
    if "--algo" in argv and argv[argv.index("--algo") + 1] in (
            "dqn", "qrdqn", "ddpg"):
        assert "replay     64" in out


@pytest.mark.parametrize("argv,err,match", [
    (["--algo", "dqn", "--two-stage"], ValueError, "on-policy"),
    (["--algo", "qrdqn", "--agent", "hrl"], ValueError, "on-policy"),
    (["--algo", "dqn", "--sync", "doublebuf"], ValueError, "--mesh host"),
    (["--algo", "dqn", "--per-alpha", "0.5"], ValueError, "--replay per"),
    (["--replay", "per"], ValueError, "on-policy"),
    (["--tqc-drop", "2"], ValueError, "on-policy"),
    (["--algo", "ddpg"], ValueError, "Box action space"),
    (["--algo", "dqn", "--env", "pendulum"], ValueError, "Discrete"),
    (["--algo", "ddpg", "--env", "pendulum", "--net", "conv"], ValueError,
     "image"),
    (["--algo", "dqn", "--tqc-drop", "2"], ValueError, "twin critics"),
    (["--algo", "dqn", "--net", "conv"], ValueError, "image"),
    (["--algo", "dqn", "--frame-stack", "4"], ValueError, "frame-stack"),
    (["--algo", "dqn", "--mesh", "host", "--mesh-devices", "2"], ValueError,
     "exposes 1 device")])
def test_cli_refuses_what_the_reference_refuses(argv, err, match):
    with pytest.raises(err, match=match):
        tcli.main(["--device", "cpu", "--iters", "1"] + argv)
