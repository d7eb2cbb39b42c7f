"""PPO from pixels in the PyTorch port against the JAX package: catch,
the MLP view of image envs, the conv actor-critic, a whole conv run
over the pixel pipeline, its checkpoint and its CLI.

Weights are the reference's, carried across with ``from_numpy_tree``;
catch's reset columns are the reference's, drawn from its per-env keys
and injected (threefry cannot be matched from a seed).  Bars, each
stated where it is used: bitwise for the env, the int8 weight sync and
integer payloads, rtol=1e-6 for fp32 layers and the fxp8 epilogue, and
atol 1e-5 + rtol 1e-4 for params and Adam moments after an iteration
run from the reference's state (the bar of the one-iteration PPO test;
the harness is ``tests/test_torch_hrl_train.py``'s).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.core import policy as jpolicy
from repro.nn.module import unbox
from repro.optim import adamw_init as jadamw_init
from repro.rl import inference as jinf
from repro.rl import nets as jnets
from repro.rl.actor_learner import pack_weights as jpack
from repro.rl.actor_learner import unpack_weights as junpack
from repro.rl.envs import catch as jcatch
from repro.rl.envs import make as jmake
from repro.rl.envs import wrappers as jwr
from repro.rl.rollout import init_envs as jinit_envs
from repro.rl.trainer import onpolicy_state as jonpolicy_state
from repro.rl.trainer.onpolicy import OnPolicyTrainer as JTrainer
from repro.rl.trainer.onpolicy import make_agent as jmake_agent
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.core import policy as tpolicy
from repro_torch.core.fxp import QTensor
from repro_torch.launch import rl_train as tcli
from repro_torch.rl import inference as tinf
from repro_torch.rl import nets as tnets
from repro_torch.rl.actor_learner import pack_weights as tpack
from repro_torch.rl.actor_learner import unpack_weights as tunpack
from repro_torch.rl.envs import catch as tcatch
from repro_torch.rl.envs import make as tmake
from repro_torch.rl.envs import wrappers as twr
from repro_torch.rl.rollout import env_keys, init_envs
from repro_torch.rl.trainer import OnPolicyTrainer as TTrainer
from repro_torch.rl.trainer import make_agent as tmake_agent
from repro_torch.rl.trainer import rl_train
from repro_torch.tree import tree_leaves

hrl_train = importlib.import_module("test_torch_hrl_train")
catch_draws = hrl_train.catch_draws

CPU = torch.device("cpu")
B = 8


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# catch
# ---------------------------------------------------------------------------


def _catch_states(seed):
    """Catch states for ``B`` envs: balls one row above the bottom over
    the paddle and away from it, the paddle at both walls, one row on
    its last tick with the ball high (a truncation) and the rest in
    mid-flight."""
    rng = np.random.default_rng(seed)
    ball_row = rng.integers(0, 8, B).astype(np.int32)
    ball_col = rng.integers(0, 5, B).astype(np.int32)
    paddle = rng.integers(0, 5, B).astype(np.int32)
    t = ball_row.copy()
    ball_row[:3] = 8                          # reach the bottom this step
    ball_col[:3], paddle[:3] = (2, 0, 4), (2, 0, 4)
    actions = rng.integers(0, 3, B).astype(np.int32)
    actions[:3] = (1, 2, 2)                   # caught, missed, wall-stay
    paddle[3], actions[3] = 0, 0              # pushed into the left wall
    ball_row[4], t[4] = 3, 9                  # the horizon, ball high
    return dict(ball_row=ball_row, ball_col=ball_col, paddle_col=paddle,
                t=t), actions


def _jstate(s, keys):
    return jcatch.EnvState(*(jnp.asarray(s[f]) for f in
                             ("ball_row", "ball_col", "paddle_col", "t")),
                           keys)


def _tstate(s):
    return tcatch.EnvState(*(_t(s[f]) for f in
                             ("ball_row", "ball_col", "paddle_col", "t")),
                           env_keys(0, B, CPU))


@pytest.fixture
def fresh_columns(monkeypatch):
    """The next reset's ball column of each env, as the reference draws
    it from its key, injected into the port's env (by stream id)."""
    def install(jkeys):
        cols = torch.tensor([int(jax.random.randint(
            jax.random.split(k)[1], (), 0, jcatch.COLS, jnp.int32))
            for k in jkeys])
        ids = env_keys(0, B, CPU)[:, 0]

        def uniform_ints(key, draw, high):
            return cols[(key[:, :1] == ids[None]).to(torch.int64).argmax(1)]

        monkeypatch.setattr(tcatch, "uniform_ints", uniform_ints)
    return install


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_catch_step_exact(seed, fresh_columns):
    """One step from the same states and actions with the reference's
    reset draws injected: obs, reward, done, truncated, final_obs and
    every state field bitwise (catches, a miss, both walls, a
    truncation, auto-resets included)."""
    s, a = _catch_states(seed)
    jkeys = jax.random.split(jax.random.PRNGKey(seed), B)
    fresh_columns(jkeys)
    jout = jax.vmap(jcatch.step)(_jstate(s, jkeys), jnp.asarray(a))
    tout = tcatch.step(_tstate(s), _t(a))
    for i in range(1, 6):
        np.testing.assert_array_equal(_np(tout[i]), np.asarray(jout[i]))
        assert _np(tout[i]).dtype == np.asarray(jout[i]).dtype
    for f in ("ball_row", "ball_col", "paddle_col", "t"):
        np.testing.assert_array_equal(_np(getattr(tout[0], f)),
                                      np.asarray(getattr(jout[0], f)))
    reward, done, trunc = (_np(x) for x in tout[2:5])
    assert list(reward[:3]) == [1.0, -1.0, 1.0] and done[:3].all()
    assert trunc[4] and not done[4]
    assert (_np(tout[0].key)[:, 1] == (done | trunc)).all()


def test_catch_reset_render_and_draws(fresh_columns):
    """Reset: the reference's frame for the same ball column, bitwise;
    the port's own draws cover every column and advance each key."""
    jkeys = jax.random.split(jax.random.PRNGKey(4), B)
    fresh_columns(jkeys)
    jst, jobs = jax.vmap(jcatch.reset)(jkeys)
    tst, tobs = tcatch.reset(env_keys(0, B, CPU))
    np.testing.assert_array_equal(_np(tobs), np.asarray(jobs))
    np.testing.assert_array_equal(_np(tst.ball_col), np.asarray(jst.ball_col))
    assert tobs.shape == (B, 10, 5, 1) and tobs.dtype == torch.float32
    assert tmake("catch").spec == tcatch.make().spec
    assert (tmake("catch").spec.obs_shape, tmake("catch").spec.n_actions,
            tmake("catch").spec.max_steps) == ((10, 5, 1), 3, 10)


def test_catch_own_reset_draws():
    st, obs = init_envs(tmake("catch"), 3, 256, "cpu")
    assert set(st.ball_col.tolist()) == set(range(5))
    assert (st.key[:, 1] == 1).all() and (st.ball_row == 0).all()
    assert (st.paddle_col == 2).all() and (obs.sum((1, 2, 3)) == 2).all()
    again, _ = init_envs(tmake("catch"), 3, 256, "cpu")
    assert torch.equal(again.ball_col, st.ball_col)


# ---------------------------------------------------------------------------
# the MLP view of image envs and the launch-path validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["keydoor", "catch"])
def test_build_env_mlp_flattens_images(name):
    """``build_env(env, "mlp")`` ends in ``ensure_vector_obs`` in both
    packages: keydoor's frames are (3072,), catch's (50,)."""
    want = jinf.build_env(name, "mlp").obs_shape
    assert tinf.build_env(name, "mlp").obs_shape == want == (
        (3072,) if name == "keydoor" else (50,))
    assert twr.wrapper_stack(tinf.build_env(name, "mlp")) == (
        "flatten_observation",)
    assert tinf.build_env("cartpole", "mlp").obs_shape == (4,)
    assert twr.wrapper_stack(tinf.build_env("cartpole", "mlp")) == ()


def test_flatten_observation_step_matches(fresh_columns):
    s, a = _catch_states(5)
    jkeys = jax.random.split(jax.random.PRNGKey(5), B)
    fresh_columns(jkeys)
    jenv = jwr.flatten_observation(jcatch.make())
    tenv = twr.flatten_observation(tmake("catch"))
    assert tenv.obs_shape == jenv.obs_shape == (50,)
    jout = jax.vmap(jenv.step)(_jstate(s, jkeys), jnp.asarray(a))
    tout = tenv.step(_tstate(s), _t(a))
    for i in (1, 5):
        assert tuple(tout[i].shape) == (B, 50)
        np.testing.assert_array_equal(_np(tout[i]), np.asarray(jout[i]))


def test_build_env_and_net_validation():
    """The errors of the reference's ``tests/test_pixel_rl.py``
    validation test that the port's slice has, with the same texts."""
    for build in (jinf.build_env, tinf.build_env):
        with pytest.raises(ValueError, match="--net conv"):
            build("cartpole", "conv", 1)
        with pytest.raises(ValueError, match="requires --net conv"):
            build("cartpole", "mlp", 4)
        with pytest.raises(ValueError, match="unknown net"):
            build("catch", "resnet", 1)
    with pytest.raises(ValueError, match="requires --net conv"):
        rl_train("cartpole", "mlp", iters=1, frame_stack_k=4,
                 verbose=False, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for agent, env, net, match in (
            ("hrl", "keydoor", "conv", "drop --net"),
            ("hrl", "cartpole", "mlp", "needs image"),
            ("mlp", "cartpole", "conv", "needs image"),
            ("mlp", "keydoor", "mlp", "obs shape")):
        with pytest.raises(ValueError, match=match):
            jmake_agent(agent, jmake(env), jax.random.PRNGKey(0), None, net)
        with pytest.raises(ValueError, match=match):
            tmake_agent(agent, tmake(env), gen, net, "cpu")


# ---------------------------------------------------------------------------
# the conv actor-critic
# ---------------------------------------------------------------------------


def _conv_ac(obs_shape, head, seed=0):
    jp = unbox(jnets.conv_ac_init(jax.random.PRNGKey(seed), obs_shape,
                                  head))
    return jp, from_numpy_tree(jax.tree.map(np.asarray, jp), CPU)


@pytest.mark.parametrize("obs_shape,head", [((10, 5, 4), 3),
                                            ((32, 32, 12), 4)])
def test_conv_ac_layout_and_fp32_forward(obs_shape, head):
    """The port's init has the reference's tree and shapes; the fp32
    forward on the reference's weights within rtol=1e-6."""
    jp, tp = _conv_ac(obs_shape, head)
    mine = tnets.conv_ac_init(torch.Generator().manual_seed(0), obs_shape,
                              head)
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [x.shape for x in jax.tree.leaves(jp)]
    obs = np.random.default_rng(1).normal(size=(6,) + obs_shape).astype(
        np.float32)
    jl, jv = jnets.conv_ac_apply(jp, jnp.asarray(obs))
    tl, tv = tnets.conv_ac_apply(tp, _t(obs))
    for got, want in ((tl, jl), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("obs_shape,head", [((10, 5, 4), 3),
                                            ((32, 32, 12), 4)])
def test_conv_ac_fxp8_packed_forward(obs_shape, head):
    """The fxp8 actor as ``collect`` runs it (int8-synced weights,
    dequantized, under FXP8): the sync's int payloads and scales
    bitwise (the 4-D conv kernels per output channel), logits and
    values within rtol=1e-6 of the reference run op by op."""
    jp, tp = _conv_ac(obs_shape, head, seed=2)
    jw, tw = jpack(jp, 8), tpack(tp, 8)
    tleaves = [y for x in tree_leaves(tw) for y in (
        (x.qvalue, x.scale) if isinstance(x, QTensor) else (x,))]
    for a, b in zip(tleaves, jax.tree.leaves(jw), strict=True):
        a, b = _np(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert sum(x.ndim == 4 and x.dtype == torch.int8 for x in tleaves) == 2
    obs = np.random.default_rng(3).normal(size=(8,) + obs_shape).astype(
        np.float32)
    with jax.disable_jit():
        jl, jv = jnets.conv_ac_apply(junpack(jw), jnp.asarray(obs),
                                     jpolicy.FXP8)
    tl, tv = tnets.conv_ac_apply(tunpack(tw), _t(obs), tpolicy.FXP8)
    for got, want in ((tl, jl), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# whole runs over the pixel pipeline
# ---------------------------------------------------------------------------


CONV_RUN = dict(env_name="catch", agent="mlp", net="conv", frame_stack_k=2,
                iters=3, n_envs=4, rollout_len=4)


def test_conv_run_against_reference(catch_draws):
    """``rl_train(catch, net=conv, frame_stack_k=2, iters=3, n_envs=4,
    rollout_len=4)`` against the reference's trainer on the same initial
    params, envs and draws, each port iteration from the reference's
    state before it (three iterations cross catch's episode end and
    auto-reset through the Welford carry and the frame stack):
    returns equal, params and Adam moments after every iteration within
    atol 1e-5 + rtol 1e-4, and the final normalizer statistics, frames
    and observations within rtol=1e-6."""
    jt, jhist, tt, thist = hrl_train.paired_runs(catch_draws, **CONV_RUN)
    np.testing.assert_allclose(thist, jhist, rtol=1e-6, atol=1e-6)
    for g, ((_, tp, to), (jp, jo)) in enumerate(zip(tt.rec, jt.rec,
                                                    strict=True)):
        hrl_train._close(tp, jp, f"params at {g}")
        hrl_train._close(to["mu"], jo["mu"], f"mu at {g}")
        hrl_train._close(to["nu"], jo["nu"], f"nu at {g}")
    tst, jst = tt.final, jt.final
    tstats, jstats = twr.norm_stats_of(tst.est), jwr.norm_stats_of(jst.est)
    assert int(tstats.count[0]) == 13       # the reset frame + 12 steps
    for a, b in ((tstats.count, jstats.count), (tstats.mean, jstats.mean),
                 (tstats.m2, jstats.m2), (tst.est.frames, jst.est.frames),
                 (tst.obs, jst.obs)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("actor_policy", ["fxp8", None])
def test_pixel_ppo_trains_both_precisions(actor_policy):
    """catch trains 3 iterations under --net conv at fxp8 and fp32
    actors, no flatten anywhere, and the params move; ``state_out``
    carries the fleet's Welford statistics for a frozen evaluation."""
    out = {}
    params, hist = rl_train("catch", "mlp", iters=3, n_envs=8,
                            rollout_len=16, actor_policy=actor_policy,
                            net="conv", frame_stack_k=4, verbose=False,
                            device="cpu", state_out=out)
    assert len(hist) == 3 and all(np.isfinite(h) for h in hist)
    env = tinf.build_env("catch", "conv", 4)
    init, _ = tmake_agent("mlp", env, torch.Generator().manual_seed(0),
                          "conv", "cpu")
    delta = sum(float((a - b).abs().sum()) for a, b in zip(
        tree_leaves(init), tree_leaves(params), strict=True))
    assert delta > 0
    stats = twr.merge_norm_stats(twr.norm_stats_of(out["env_state"]))
    assert float(stats.count) == 8 * (3 * 16 + 1)
    assert tuple(stats.mean.shape) == (10, 5, 1)
    frozen = tinf.build_env("catch", "conv", 4, norm_stats=stats)
    est, obs = init_envs(frozen, 123, 4, "cpu")
    assert tuple(obs.shape) == (4, 10, 5, 4)
    assert not isinstance(est.inner, twr.RunningNormState)


def test_pixel_checkpoint_crosses_packages(tmp_path):
    """A conv checkpoint whose env state holds the pixel pipeline's
    ``NormStats`` and frame stack: written by the port it restores in
    the reference, and the reference's restores and resumes in the
    port."""
    kw = dict(env_name="catch", agent="mlp", net="conv", frame_stack_k=2,
              iters=2, n_envs=4, rollout_len=4, save_every=1,
              verbose=False)
    d = str(tmp_path / "port")
    tstate, _ = TTrainer(device="cpu", ckpt_dir=d, **kw).train()
    jenv = jinf.build_env("catch", "conv", 2)
    jtr = JTrainer(**kw)
    est0, obs0 = jinit_envs(jenv, jax.random.PRNGKey(1), 4)
    jp = jtr._init_params
    jstate, md = JManager(d).restore(jonpolicy_state(jp, jadamw_init(jp),
                                                     est0, obs0))
    assert md["stage"] == "all" and md["step"] == 1
    assert isinstance(jstate.est.inner.stats, jwr.NormStats)
    for a, b in zip(tree_leaves(tuple(tstate)), jax.tree.leaves(jstate),
                    strict=True):
        hrl_train._same_leaf(a, b)
    back = str(tmp_path / "ref")
    jstate_r, _ = JTrainer(ckpt_dir=back, **kw).train()
    tr = TTrainer(device="cpu", ckpt_dir=back, **{**kw, "iters": 3})
    restored, rmd = tr.restore(TManager(back), tr.init_state())
    assert isinstance(restored.est.inner.stats, twr.NormStats)
    assert tr.resume_start(rmd) == 2
    for a, b in zip(tree_leaves(tuple(restored)),
                    jax.tree.leaves(jstate_r), strict=True):
        hrl_train._same_leaf(a, b)
    _, hist = tr.train()
    assert len(hist) == 1 and np.isfinite(hist[0])


def test_port_holds_cudnn_to_deterministic_algorithms():
    """The learner's convolutions on the card are reproducible (the
    card run is held by ``test_torch_cuda.py``)."""
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.allow_tf32


def test_cli_trains_pixels(capsys):
    tcli.main(["--device", "cpu", "--env", "catch", "--net", "conv",
               "--frame-stack", "2", "--iters", "2", "--n-envs", "4",
               "--rollout-len", "4"])
    out = capsys.readouterr().out
    assert "mesh {'data': 1, 'model': 1} (1 devices): 1 actor slot(s) x " \
        "4 envs" in out
    assert "iter    1  return" in out and "done in" in out
    tcli.main(["--device", "cpu", "--env", "catch", "--agent", "hrl",
               "--two-stage", "--iters", "1", "--n-envs", "4",
               "--rollout-len", "4", "--algo", "a2c"])
    out = capsys.readouterr().out
    assert "[stage=action]" in out and "[stage=subgoal]" in out
