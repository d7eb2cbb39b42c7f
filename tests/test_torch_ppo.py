"""The PPO slice's pure pieces against the JAX package: cartpole,
action distributions, the mlp actor-critic, rollout, GAE and the PPO /
A2C losses.

Shared inputs come from seeded numpy; weights are the reference's
``mlp_ac_init`` carried across with ``from_numpy_tree``; sampling draws
are the reference's, drawn with JAX and injected (threefry and Philox
cannot be matched from a seed).  Bars, each stated where it is used:
exact for integer results and flags, bitwise for the fxp8 actor on the
same tanh, rtol=1e-6 for fp32 layers, rtol=1e-5 for losses and their
gradients.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core import vact as jvact
from repro.nn.module import unbox
from repro.rl import dists as jdists
from repro.rl import nets as jnets
from repro.rl import ppo as jppo
from repro.rl.actor_learner import collect as jcollect
from repro.rl.actor_learner import pack_weights as jpack
from repro.rl.envs import cartpole as jcp
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.core import policy as tpolicy
from repro_torch.rl import dists as tdists
from repro_torch.rl import gae as tgae
from repro_torch.rl import nets as tnets
from repro_torch.rl import ppo as tppo
from repro_torch.rl import rollout as troll
from repro_torch.rl.actor_learner import collect as tcollect
from repro_torch.rl.actor_learner import pack_weights as tpack
from repro_torch.rl.envs import cartpole as tcp
from repro_torch.rl.envs import make as tmake
from repro_torch.tree import tree_leaves

# modules whose names ``repro.rl`` also exports as functions
jgae = importlib.import_module("repro.rl.gae")
jroll = importlib.import_module("repro.rl.rollout")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def ref_params(seed=0, obs_dim=4, head=2, hidden=64):
    """The reference's initial actor-critic as numpy, and the same
    weights in the port."""
    p = jax.tree.map(np.asarray, unbox(jnets.mlp_ac_init(
        jax.random.PRNGKey(seed), obs_dim, head, hidden)))
    return jax.tree.map(jnp.asarray, p), from_numpy_tree(p, "cpu")


def cartpole_states(b, seed):
    """Cartpole states away from the limits, as (jax, torch) EnvStates;
    the torch keys are the port's (draws cannot be shared)."""
    rng = np.random.default_rng(seed)
    f = [rng.uniform(-0.05, 0.05, b).astype(np.float32) for _ in range(4)]
    t = rng.integers(0, 400, b).astype(np.int32)
    return states_from(f, t)


def states_from(fields, t):
    b = len(t)
    js = jcp.EnvState(*(jnp.asarray(v) for v in fields), jnp.asarray(t),
                      jax.random.split(jax.random.PRNGKey(0), b))
    ts = tcp.EnvState(*(_t(v) for v in fields), _t(t),
                      troll.env_keys(0, b, torch.device("cpu")))
    return js, ts


def rollout_noise(key, n_steps, b, n_actions):
    """The Gumbel draws ``rollout`` consumes under ``key``: one
    ``categorical`` per step key of ``split(key, n_steps)``, which is
    ``argmax(gumbel(step_key, logits.shape) + logits)`` (jax 0.9)."""
    return np.stack([np.asarray(jax.random.gumbel(k, (b, n_actions)))
                     for k in jax.random.split(key, n_steps)])


# ---------------------------------------------------------------------------
# cartpole
# ---------------------------------------------------------------------------


def test_cartpole_step_on_injected_states():
    """One step from the same states and actions: obs within rtol=1e-6,
    atol=1e-7 (cos and sin are each library's own and may differ in the
    last bit); rewards, done and truncated exact.  Rows 0-3 cross a
    limit (x, -x, theta, the 500-step horizon), well away from the
    thresholds; their pre-reset ``final_obs`` is compared and their
    fresh state checked for range, since reset draws differ."""
    rng = np.random.default_rng(3)
    b = 12
    f = [rng.uniform(-0.04, 0.04, b).astype(np.float32) for _ in range(4)]
    f[0][0], f[1][0] = 2.39, 1.5            # x passes +2.4
    f[0][1], f[1][1] = -2.39, -1.5          # x passes -2.4
    f[2][2], f[3][2] = 0.2, 1.5             # theta passes 12 degrees
    t = rng.integers(0, 400, b).astype(np.int32)
    t[3] = 499                              # the horizon
    f = [x.astype(np.float32) for x in f]
    actions = rng.integers(0, 2, b).astype(np.int32)
    js, ts = states_from(f, t)
    jout = jax.vmap(jcp.step)(js, jnp.asarray(actions))
    tout = tcp.step(ts, _t(actions))
    _, jobs, jr, jd, jtr, jfin = jout
    tstate, tobs, tr, td, ttr, tfin = tout
    np.testing.assert_array_equal(_np(tr), _np(jr))
    np.testing.assert_array_equal(_np(td), _np(jd))
    np.testing.assert_array_equal(_np(ttr), _np(jtr))
    assert _np(td)[:3].all() and not _np(td)[3] and _np(ttr)[3]
    np.testing.assert_allclose(_np(tfin), _np(jfin), rtol=1e-6, atol=1e-7)
    live = ~(_np(td) | _np(ttr))
    np.testing.assert_allclose(_np(tobs)[live], _np(jobs)[live], rtol=1e-6,
                               atol=1e-7)
    fresh = _np(tobs)[~live]
    assert (np.abs(fresh) <= 0.05).all()
    assert (_np(tstate.t)[~live] == 0).all()
    assert (_np(tstate.t)[live] == t[live] + 1).all()


def test_cartpole_reset_draws_and_key():
    env = tmake("cartpole")
    est, obs = troll.init_envs(env, 5, 64, "cpu")
    o = _np(obs)
    assert o.shape == (64, 4) and o.dtype == np.float32
    assert (np.abs(o) <= 0.05).all()
    assert len(np.unique(o[:, 0])) == 64
    assert (_np(est.key)[:, 1] == 1).all() and (_np(est.t) == 0).all()
    again, obs2 = troll.init_envs(env, 5, 64, "cpu")
    assert torch.equal(obs, obs2)


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------


def test_categorical_log_prob_entropy_and_sampling():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(64, 5)) * 3).astype(np.float32)
    actions = rng.integers(0, 5, 64).astype(np.int32)
    jd, td = jdists.Categorical(), tdists.Categorical()
    np.testing.assert_allclose(
        _np(td.log_prob(_t(logits), _t(actions))),
        np.asarray(jd.log_prob(jnp.asarray(logits), jnp.asarray(actions))),
        rtol=1e-6)
    np.testing.assert_allclose(_np(td.entropy(_t(logits))),
                               np.asarray(jd.entropy(jnp.asarray(logits))),
                               rtol=1e-6)
    for i in range(5):
        key = jax.random.PRNGKey(i)
        want = np.asarray(jd.sample(key, jnp.asarray(logits)))
        g = np.asarray(jax.random.gumbel(key, logits.shape))
        got = _np(td.sample_with(_t(g), _t(logits)))
        np.testing.assert_array_equal(got, want)
    # the generator path gives valid, seeded actions
    gen = torch.Generator().manual_seed(0)
    a = td.sample(gen, _t(logits))
    assert a.dtype == torch.int32 and int(a.min()) >= 0 and int(a.max()) < 5
    g1 = td.noise(torch.Generator().manual_seed(1), (3, 5))
    assert torch.equal(g1, td.noise(torch.Generator().manual_seed(1),
                                    (3, 5)))
    assert torch.isfinite(g1).all()


def test_tanh_gaussian_against_reference():
    rng = np.random.default_rng(1)
    dp = rng.normal(size=(32, 4)).astype(np.float32)
    jd, td = jdists.TanhGaussian(-2.0, 2.0), tdists.TanhGaussian(-2.0, 2.0)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jd.sample(key, jnp.asarray(dp)))
    noise = np.asarray(jax.random.normal(key, (32, 2)))
    got = _np(td.sample_with(_t(noise), _t(dp)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        _np(td.log_prob(_t(dp), _t(want))),
        np.asarray(jd.log_prob(jnp.asarray(dp), jnp.asarray(want))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(td.entropy(_t(dp))),
                               np.asarray(jd.entropy(jnp.asarray(dp))),
                               rtol=1e-6)
    from repro_torch.rl.envs.spaces import Box, Discrete
    assert isinstance(tdists.distribution_for(Discrete(3)),
                      tdists.Categorical)
    with pytest.raises(ValueError, match="finite Box"):
        tdists.distribution_for(Box(-np.inf, np.inf, (1,)))


# ---------------------------------------------------------------------------
# the mlp actor-critic
# ---------------------------------------------------------------------------


def _obs(b, seed):
    return (np.random.default_rng(seed).normal(size=(b, 4)) * 0.5).astype(
        np.float32)


def test_mlp_ac_layout_and_fp32_forward():
    jp, tp = ref_params(0)
    tparams = tnets.mlp_ac_init(torch.Generator().manual_seed(0), 4, 2)
    assert [tuple(x.shape) for x in tree_leaves(tparams)] == \
        [x.shape for x in jax.tree.leaves(jp)]
    obs = _obs(16, 1)
    jl, jv = jnets.mlp_ac_apply(jp, jnp.asarray(obs))
    tl, tv = tnets.mlp_ac_apply(tp, _t(obs))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture
def torch_tanh_in_reference(monkeypatch):
    """The reference's native tanh computed by torch: XLA's tanh and
    torch's differ in the last bit at about 58% of fp32 inputs, so this
    is what lets the rest of the fxp8 program be held bit for bit."""
    def tanh(x):
        return jnp.asarray(torch.tanh(_t(np.asarray(x))).numpy())
    monkeypatch.setitem(jvact._NATIVE, "tanh", tanh)


@pytest.mark.parametrize("b", [1, 8, 32])
def test_fxp8_actor_forward_bitwise(torch_tanh_in_reference, b):
    """The fxp8 actor as ``collect`` runs it (int8-synced weights,
    dequantized, under FXP8) on the same obs: logits and values bit for
    bit against the reference run eagerly, given the same tanh."""
    jp, tp = ref_params(0)
    obs = _obs(b, b)
    jw = jax.tree.map(lambda x: x, jpack(jp, 8))
    from repro.rl.actor_learner import unpack_weights as junpack
    from repro_torch.rl.actor_learner import unpack_weights as tunpack
    with jax.disable_jit():
        jl, jv = jnets.mlp_ac_apply(junpack(jw), jnp.asarray(obs),
                                    jpolicy.FXP8)
    tl, tv = tnets.mlp_ac_apply(tunpack(tpack(tp, 8)), _t(obs),
                                tpolicy.FXP8)
    np.testing.assert_array_equal(_np(tl).view(np.int32),
                                  np.asarray(jl).view(np.int32))
    np.testing.assert_array_equal(_np(tv).view(np.int32),
                                  np.asarray(jv).view(np.int32))


def test_fxp8_actor_forward_with_each_librarys_tanh():
    """With each library's own tanh the int8 codes agree except at rare
    rounding ties: logits and values within rtol=1e-5, greedy actions
    equal."""
    jp, tp = ref_params(1)
    obs = _obs(64, 7)
    jl, jv = jnets.mlp_ac_apply(jp, jnp.asarray(obs), jpolicy.FXP8)
    tl, tv = tnets.mlp_ac_apply(tp, _t(obs), tpolicy.FXP8)
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jv).max()))
    np.testing.assert_array_equal(_np(tl).argmax(-1),
                                  np.asarray(jl).argmax(-1))


# ---------------------------------------------------------------------------
# rollout
# ---------------------------------------------------------------------------


def test_rollout_with_injected_draws():
    """The fxp8 collection of 6 steps from 4 envs (no episode ends):
    actions equal, log-probs and values within rtol=1e-5, observations
    within rtol=1e-6, atol=1e-6 (the env's cos/sin, and the actor's
    tanh, are each library's own)."""
    n, steps = 4, 6
    jp, tp = ref_params(2)
    js, ts = cartpole_states(n, 11)
    jobs = jax.vmap(jcp._obs)(js)
    key = jax.random.PRNGKey(9)
    jres = jax.jit(lambda p, k, s, o: jcollect(
        p, jcp.make(), jnets.mlp_ac_apply, jpolicy.FXP8, k, s, o, steps))(
        jpack(jp, 8), key, js, jobs)
    noise = rollout_noise(key, steps, n, 2)
    tres = tcollect(tpack(tp, 8), tmake("cartpole"), tnets.mlp_ac_apply,
                    tpolicy.FXP8, _t(noise), ts, tcp._obs(ts), steps)
    jt, tt = jres.traj, tres.traj
    assert not _np(tt.boundary).any()
    np.testing.assert_array_equal(_np(tt.actions), np.asarray(jt.actions))
    for f in ("log_probs", "values"):
        np.testing.assert_allclose(_np(getattr(tt, f)),
                                   np.asarray(getattr(jt, f)), rtol=1e-5,
                                   atol=1e-6)
    for f in ("obs", "next_obs"):
        np.testing.assert_allclose(_np(getattr(tt, f)),
                                   np.asarray(getattr(jt, f)), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(_np(tt.rewards), np.asarray(jt.rewards))
    np.testing.assert_allclose(_np(tres.last_value),
                               np.asarray(jres.last_value), rtol=1e-5,
                               atol=1e-6)


def test_episode_returns_from():
    rng = np.random.default_rng(4)
    rew = rng.normal(size=(20, 6)).astype(np.float32)
    bound = rng.random((20, 6)) < 0.2
    bound[:, 0] = False                     # an env with no episode
    jr, jn = jroll.episode_returns_from(jnp.asarray(rew),
                                        jnp.asarray(bound))
    tr, tn = troll.episode_returns_from(_t(rew), _t(bound))
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(tr), float(jr), rtol=1e-6)


# ---------------------------------------------------------------------------
# GAE and the PPO batch
# ---------------------------------------------------------------------------


def _traj_arrays(t, b, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    dones = rng.random((t, b)) < 0.1
    trunc = (rng.random((t, b)) < 0.1) & ~dones
    return dict(obs=f32(t, b, 4), actions=rng.integers(0, 2, (t, b)).astype(
        np.int32), log_probs=-np.abs(f32(t, b)), values=f32(t, b),
        rewards=f32(t, b), dones=dones, truncated=trunc,
        next_obs=f32(t, b, 4)), f32(b)


@pytest.mark.parametrize("truncation", [False, True])
def test_gae(truncation):
    a, last = _traj_arrays(9, 5, 0)
    boot = np.random.default_rng(1).normal(size=(9, 5)).astype(np.float32)
    kw_j = kw_t = {}
    if truncation:
        kw_j = dict(truncated=jnp.asarray(a["truncated"]),
                    bootstrap_values=jnp.asarray(boot))
        kw_t = dict(truncated=_t(a["truncated"]), bootstrap_values=_t(boot))
    jadv, jret = jgae.gae(jnp.asarray(a["rewards"]), jnp.asarray(a["values"]),
                          jnp.asarray(a["dones"]), jnp.asarray(last),
                          0.99, 0.95, **kw_j)
    tadv, tret = tgae.gae(_t(a["rewards"]), _t(a["values"]), _t(a["dones"]),
                          _t(last), 0.99, 0.95, **kw_t)
    np.testing.assert_allclose(_np(tadv), np.asarray(jadv), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tret), np.asarray(jret), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tgae.normalize(tadv)),
                               np.asarray(jgae.normalize(jadv)), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="bootstrap_values"):
        tgae.gae(_t(a["rewards"]), _t(a["values"]), _t(a["dones"]),
                 _t(last), truncated=_t(a["truncated"]))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("value_fn", [False, True])
def test_batch_from_traj(masked, value_fn):
    a, last = _traj_arrays(6, 4, 2)
    jt = jroll.Trajectory(**{k: jnp.asarray(v) for k, v in a.items()})
    tt = troll.Trajectory(**{k: _t(v) for k, v in a.items()})
    mask = np.array([1, 0, 1, 1], np.float32)
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    jb = jppo.batch_from_traj(
        jt, jnp.asarray(last), cfg_j,
        actor_mask=jnp.asarray(mask) if masked else None,
        value_fn=(lambda o: o.sum(-1)) if value_fn else None)
    tb = tppo.batch_from_traj(
        tt, _t(last), cfg_t, actor_mask=_t(mask) if masked else None,
        value_fn=(lambda o: o.sum(-1)) if value_fn else None)
    assert set(tb) == set(jb)
    for k in jb:
        np.testing.assert_allclose(_np(tb[k]), np.asarray(jb[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the losses and their gradients
# ---------------------------------------------------------------------------


def _loss_batch(n, seed, masked):
    rng = np.random.default_rng(seed)
    b = dict(obs=_obs(n, seed), actions=rng.integers(0, 2, n).astype(
        np.int32), log_probs=np.log(rng.uniform(0.3, 0.7, n)).astype(
        np.float32), advantages=rng.normal(size=n).astype(np.float32),
        returns=rng.normal(size=n).astype(np.float32))
    if masked:
        b["mask"] = (rng.random(n) < 0.7).astype(np.float32)
    return b


def _fp32_apply(fn):
    return lambda p, o: fn(p, o, None)


@pytest.mark.parametrize("loss", ["ppo_loss", "a2c_loss"])
@pytest.mark.parametrize("masked", [False, True])
def test_losses_and_gradients(loss, masked):
    """Loss, stats and the gradient of every leaf within rtol=1e-5 (of
    the leaf's largest entry for the gradients)."""
    jp, tp = ref_params(3)
    batch = _loss_batch(48, 5, masked)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    (jl, jstats), jg = jax.value_and_grad(getattr(jppo, loss), has_aux=True)(
        jp, _fp32_apply(jnets.mlp_ac_apply), jb, jppo.PPOConfig())
    (tl, tstats), tg = tppo.value_and_grad(
        getattr(tppo, loss), tp, _fp32_apply(tnets.mlp_ac_apply), tb,
        tppo.PPOConfig())
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(tstats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for got, want in zip(tree_leaves(tg), jax.tree.leaves(jg), strict=True):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_stage_masks_and_minibatch_refusal():
    params = {"stem": {"w": np.ones((2, 2), np.float32)},
              "subgoal": {"w": np.ones((2, 2), np.float32),
                          "b": np.ones(2, np.float32)},
              "action": {"w": np.ones((2, 3), np.float32)}}
    tparams = from_numpy_tree(params, "cpu")
    for stage in ("all", "action", "subgoal"):
        jm = jppo.stage_mask(params, stage)
        tm = tppo.stage_mask(tparams, stage)
        assert tree_leaves(tm) == jax.tree.leaves(jm)
        tg = tppo.apply_stage_mask(tparams, tm)
        jg = jppo.apply_stage_mask(jax.tree.map(jnp.asarray, params), jm)
        for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg), strict=True):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    _, tp = ref_params(0)
    batch = {k: _t(v) for k, v in _loss_batch(10, 0, False).items()}
    with pytest.raises(ValueError, match="does not divide"):
        tppo.minibatch_epochs(torch.zeros((4, 10), dtype=torch.int64), tp,
                              None, batch, None, tppo.PPOConfig(), None)
