"""Batched torch keydoor and pixel wrappers against the JAX package.

Both packages step from identical injected states with identical
actions.  Reset draws cannot be matched from a seed (the reference draws
with ``jax.random.choice``), so rows that hit an episode boundary are
compared on what does not depend on the draw: reward, flags and the
pre-reset ``final_obs``; their fresh state is checked for validity.
Rendering, stepping and frame stacking are exact; the running
normalizer is held at rtol=1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl.envs import keydoor as jkd
from repro.rl.envs import make as jmake
from repro.rl.envs import registered as jregistered
from repro.rl.envs import spaces as jspaces
from repro.rl.envs import wrappers as jwr
from repro_torch.rl.envs import keydoor as tkd
from repro_torch.rl.envs import make as tmake
from repro_torch.rl.envs import registered as tregistered
from repro_torch.rl.envs import spaces as tspaces
from repro_torch.rl.envs import wrappers as twr
from repro_torch.rl.envs.base import uniform_ints
from repro_torch.rl.rollout import env_keys, init_envs

B = 8


def _states(seed, boundaries=True):
    """Keydoor states for ``B`` envs: distinct cells, a mix of key
    holders, agents next to the key or the door, and (with
    ``boundaries``) rows on the last tick, so one step crosses pickups,
    door openings and time-limit truncations."""
    rng = np.random.default_rng(seed)
    agent, key_pos, door = [], [], []
    for _ in range(B):
        cells = rng.permutation(64)[:3]
        pos = np.stack([cells // 8, cells % 8], -1)
        agent.append(pos[0])
        key_pos.append(pos[1])
        door.append(pos[2])
    agent = np.array(agent, np.int32)
    key_pos = np.array(key_pos, np.int32)
    door = np.array(door, np.int32)
    has_key = rng.random(B) < 0.5
    # row 0 steps onto the key, row 1 (holding it) onto the door
    agent[0] = key_pos[0] + np.array([1, 0]) if key_pos[0, 0] < 7 \
        else key_pos[0] - np.array([1, 0])
    agent[1] = door[1] + np.array([1, 0]) if door[1, 0] < 7 \
        else door[1] - np.array([1, 0])
    has_key[0], has_key[1] = False, True
    ok = ~((agent[:, None] == np.stack([key_pos, door], 1)).all(-1)).any(1)
    assert ok[:2].all()
    t = rng.integers(0, 60, B).astype(np.int32)
    if boundaries:
        t[2:4] = 63
    actions = rng.integers(0, 4, B).astype(np.int32)
    actions[0] = 1 if key_pos[0, 0] > agent[0, 0] else 0
    actions[1] = 1 if door[1, 0] > agent[1, 0] else 0
    return dict(agent=agent, key_pos=key_pos, door=door, has_key=has_key,
                t=t), actions


def _jstate(s):
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    return jkd.EnvState(*(jnp.asarray(s[f]) for f in
                          ("agent", "key_pos", "door", "has_key", "t")),
                        keys)


def _tstate(s):
    keys = env_keys(0, B, torch.device("cpu"))
    return tkd.EnvState(*(torch.from_numpy(s[f]) for f in
                          ("agent", "key_pos", "door", "has_key", "t")),
                        keys)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_render_exact():
    s, _ = _states(0)
    s["has_key"][:] = [True, False] * (B // 2)
    want = jax.vmap(jkd._render)(_jstate(s))
    got = tkd.render(_tstate(s))
    assert got.shape == (B, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), _np(want))


def _check_fresh(st, obs, rows):
    cells = torch.stack([st.agent, st.key_pos, st.door], 1)[rows]
    flat = cells[..., 0] * 8 + cells[..., 1]
    assert ((flat >= 0) & (flat < 64)).all()
    for r in flat:
        assert len(set(r.tolist())) == 3
    assert (st.t[rows] == 0).all() and not st.has_key[rows].any()
    np.testing.assert_array_equal(_np(obs[rows]), _np(tkd.render(st)[rows]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keydoor_step_exact(seed):
    s, a = _states(seed)
    jout = jax.vmap(jkd.step)(_jstate(s), jnp.asarray(a))
    tout = tkd.step(_tstate(s), torch.from_numpy(a))
    for i in (2, 3, 4, 5):       # reward, done, truncated, final_obs
        np.testing.assert_array_equal(_np(tout[i]), _np(jout[i]))
    done, trunc = _np(tout[3]), _np(tout[4])
    assert done[1] and trunc[2] and trunc[3] and not done[0]
    assert _np(tout[2])[0] == np.float32(-0.01 + 0.5)
    live = ~(done | trunc)
    for f in ("agent", "key_pos", "door", "has_key", "t"):
        np.testing.assert_array_equal(_np(getattr(tout[0], f))[live],
                                      _np(getattr(jout[0], f))[live])
    np.testing.assert_array_equal(_np(tout[1])[live], _np(jout[1])[live])
    _check_fresh(tout[0], tout[1], torch.from_numpy(~live))


def test_reset_draws_distinct_cells_and_advances_the_key():
    env = tmake("keydoor")
    st, obs = init_envs(env, 5, 64, "cpu")
    _check_fresh(st, obs, torch.ones(64, dtype=torch.bool))
    assert (st.key[:, 1] == 1).all()
    assert len({tuple(r) for r in st.agent.tolist()}) > 8
    st2, _ = init_envs(env, 5, 64, "cpu")
    assert torch.equal(st2.agent, st.agent)          # a function of the seed
    u = uniform_ints(env_keys(0, 4096, torch.device("cpu")), 0,
                     torch.tensor(64))
    counts = torch.bincount(u, minlength=64).float()
    assert counts.min() > 0.5 * counts.mean()


def test_frame_stack_exact():
    k = 3
    s, a = _states(3)
    frames = np.random.default_rng(3).random((B, k, 32, 32, 3)).astype(
        np.float32)
    jenv = jwr.frame_stack(jkd.make(), k)
    tenv = twr.frame_stack(tmake("keydoor"), k)
    assert tenv.obs_shape == jenv.obs_shape == (32, 32, 3 * k)
    jout = jax.vmap(jenv.step)(
        jwr.FrameStackState(_jstate(s), jnp.asarray(frames)),
        jnp.asarray(a))
    tout = tenv.step(twr.FrameStackState(_tstate(s),
                                         torch.from_numpy(frames)),
                     torch.from_numpy(a))
    for i in (2, 3, 4, 5):
        np.testing.assert_array_equal(_np(tout[i]), _np(jout[i]))
    live = ~(_np(tout[3]) | _np(tout[4]))
    np.testing.assert_array_equal(_np(tout[1])[live], _np(jout[1])[live])
    np.testing.assert_array_equal(_np(tout[0].frames)[live],
                                  _np(jout[0].frames)[live])
    # a boundary refills the buffer with the fresh episode's frame
    fresh = tout[0].frames[torch.from_numpy(~live)]
    assert torch.equal(fresh, fresh[:, :1].expand_as(fresh))
    with pytest.raises(ValueError, match="k >= 1"):
        twr.frame_stack(tmake("keydoor"), 0)


def _stats(seed, batch=True):
    rng = np.random.default_rng(seed)
    lead = (B,) if batch else ()
    count = rng.integers(1, 50, lead).astype(np.float32)
    mean = rng.random(lead + (32, 32, 3)).astype(np.float32) * 0.2
    m2 = rng.random(lead + (32, 32, 3)).astype(np.float32) \
        * np.reshape(count, lead + (1, 1, 1)) * 0.05
    if batch:
        m2[:, :4] = 0.0        # pixels never lit: std 0, eps guards
    return count, mean, m2


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)


def test_running_normalization_matches():
    s, a = _states(4, boundaries=False)
    a[:2] = 2                                   # no pickup, no door
    count, mean, m2 = _stats(4)
    jenv = jwr.running_normalize_observation(jkd.make())
    tenv = twr.running_normalize_observation(tmake("keydoor"))
    jst = jwr.RunningNormState(_jstate(s), jwr.NormStats(
        *map(jnp.asarray, (count, mean, m2))))
    tst = twr.RunningNormState(_tstate(s), twr.NormStats(
        *map(torch.from_numpy, (count, mean, m2))))
    jout = jax.vmap(jenv.step)(jst, jnp.asarray(a))
    tout = tenv.step(tst, torch.from_numpy(a))
    assert not (_np(tout[3]) | _np(tout[4])).any()
    for i in (1, 5):
        _close(tout[i], jout[i])
    for f in range(3):
        _close(tout[0].stats[f], jout[0].stats[f])
    # reset: the first frame seeds a per-env carry of count 1
    _, obs = tenv.reset(env_keys(1, B, torch.device("cpu")))
    assert obs.abs().max() == 0.0           # (x - x) / (0 + eps)
    # the carry is what norm_stats_of finds, through a frame stack
    stacked = twr.pixel_pipeline(tmake("keydoor"), 2)
    assert twr.wrapper_stack(stacked) == ("frame_stack",
                                          "running_normalize_observation")
    st, _ = init_envs(stacked, 0, B, "cpu")
    assert twr.norm_stats_of(st).count.shape == (B,)
    with pytest.raises(ValueError, match="raw env"):
        twr.running_normalize_observation(twr.frame_stack(
            tmake("keydoor"), 2))
    with pytest.raises(TypeError, match="carry"):
        twr.norm_stats_of(st.inner.inner)


def test_merge_and_frozen_normalization_match():
    count, mean, m2 = _stats(5)
    jm = jwr.merge_norm_stats(jwr.NormStats(
        *map(jnp.asarray, (count, mean, m2))))
    tm = twr.merge_norm_stats(twr.NormStats(
        *map(torch.from_numpy, (count, mean, m2))))
    for f in range(3):
        _close(tm[f], jm[f])
    s, a = _states(5)
    jenv = jwr.pixel_pipeline(jkd.make(), 1, stats=jm)
    tenv = twr.pixel_pipeline(tmake("keydoor"), 1, stats=tm)
    jout = jax.vmap(jenv.step)(_jstate(s), jnp.asarray(a))
    tout = tenv.step(_tstate(s), torch.from_numpy(a))
    _close(tout[5], jout[5])
    live = ~(_np(tout[3]) | _np(tout[4]))
    _close(_np(tout[1])[live], _np(jout[1])[live])


# ---------------------------------------------------------------------------
# the affine transforms, the time limit, the sub-goal oracle, flat_dim
# ---------------------------------------------------------------------------

def test_normalize_observation_and_scale_reward_exact():
    """``(obs - mean) / std`` with obs-shaped stats and a reward scale,
    stepped from the same states: observations, final observations and
    rewards bitwise the reference's."""
    s, a = _states(6)
    mean = np.random.default_rng(6).random((32, 32, 3)).astype(np.float32)
    std = np.float32(0.3)
    jenv = jwr.scale_reward(jwr.normalize_observation(jkd.make(), mean,
                                                      std), 0.25)
    tenv = twr.scale_reward(twr.normalize_observation(tmake("keydoor"),
                                                      mean, std), 0.25)
    assert twr.wrapper_stack(tenv) == jwr.wrapper_stack(jenv) == (
        "scale_reward", "normalize_observation")
    jout = jax.vmap(jenv.step)(_jstate(s), jnp.asarray(a))
    tout = tenv.step(_tstate(s), torch.from_numpy(a))
    for i in (2, 3, 4, 5):
        np.testing.assert_array_equal(_np(tout[i]), _np(jout[i]))
    live = ~(_np(tout[3]) | _np(tout[4]))
    np.testing.assert_array_equal(_np(tout[1])[live], _np(jout[1])[live])
    _, obs = tenv.reset(env_keys(2, B, torch.device("cpu")))
    assert obs.dtype == torch.float32 and obs.shape == (B, 32, 32, 3)


@pytest.mark.parametrize("mean,std", [(1.0, 2.0),
                                      ([-0.3, 0.0], [0.9, 0.035]),
                                      (0.0, [-1.0, 1.0])])
def test_normalize_observation_bounds(mean, std):
    """The transformed space: the tightest interval enclosing the
    elementwise bounds, as the reference computes it (mountain_car's
    Box(-1.2, 0.6)); zero std refused."""
    mean, std = np.float32(mean), np.float32(std)
    jsp = jwr.normalize_observation(jmake("mountain_car"), mean,
                                    std).observation_space
    tsp = twr.normalize_observation(tmake("mountain_car"), mean,
                                    std).observation_space
    assert (tsp.low, tsp.high, tsp.shape) == (jsp.low, jsp.high, jsp.shape)
    assert tsp.bounded
    with pytest.raises(ValueError, match="non-zero"):
        twr.normalize_observation(tmake("mountain_car"), 0.0,
                                  np.array([1.0, 0.0], np.float32))


def test_time_limit_against_the_reference():
    """The wrapper's counter, flags, rewards and final observations
    bitwise the reference's from the same states: rows at the wrapper's
    limit time out (truncated, not done), a row that opens the door on
    the limit tick is done, the inner env's own truncations pass
    through; a timed-out row is a fresh episode from the wrapper's
    stream, which moves on."""
    s, a = _states(7)
    t = np.array([9, 9, 3, 9, 9, 0, 8, 9], np.int32)
    jenv = jwr.time_limit(jkd.make(), 10)
    tenv = twr.time_limit(tmake("keydoor"), 10)
    assert tenv.spec.max_steps == jenv.spec.max_steps == 10
    keys = env_keys(3, B, torch.device("cpu"))
    jst = jwr.TimeLimitState(_jstate(s), jnp.asarray(t),
                             jax.random.split(jax.random.PRNGKey(1), B))
    tst = twr.TimeLimitState(_tstate(s), torch.from_numpy(t), keys)
    jout = jax.vmap(jenv.step)(jst, jnp.asarray(a))
    tout = tenv.step(tst, torch.from_numpy(a))
    for i in (2, 3, 4, 5):
        np.testing.assert_array_equal(_np(tout[i]), _np(jout[i]))
    np.testing.assert_array_equal(_np(tout[0].t), _np(jout[0].t))
    done, trunc = _np(tout[3]), _np(tout[4])
    assert done[1] and not trunc[1]          # the door on the limit tick
    assert trunc[0] and trunc[4] and trunc[7] and trunc[2]
    timeout = np.array([i in (0, 4, 7) for i in range(B)])
    live = ~(done | trunc)
    for f in ("agent", "key_pos", "door", "has_key", "t"):
        np.testing.assert_array_equal(
            _np(getattr(tout[0].inner, f))[live],
            _np(getattr(jout[0].inner, f))[live])
    fresh, fresh_obs = tkd.reset(keys)
    rows = torch.from_numpy(timeout)
    for f in fresh._fields:
        assert torch.equal(getattr(tout[0].inner, f)[rows],
                           getattr(fresh, f)[rows]), f
    assert torch.equal(tout[1][rows], fresh_obs[rows])
    assert not torch.equal(tout[0].key[rows], keys[rows])
    assert torch.equal(tout[0].key[~rows], keys[~rows])


def test_time_limit_truncates_and_force_resets():
    """The reference's own test (tests/test_envs.py), batched: pendulum
    (inner horizon 200) cut at 5 steps."""
    env = twr.time_limit(tmake("pendulum"), 5)
    assert env.spec.max_steps == 5
    s, obs = init_envs(env, 0, B, "cpu")
    assert (s.t == 0).all()
    for _ in range(5):
        s, obs, r, d, tr, final_obs = env.step(s, torch.zeros((B, 1)))
    assert tr.all() and not d.any()
    assert (s.t == 0).all() and (s.inner.t == 0).all()
    assert ((obs >= -8.0) & (obs <= 8.0)).all()
    assert not torch.allclose(final_obs, obs)


def test_subgoal_reached():
    s, a = _states(8)
    jst, tst = _jstate(s), _tstate(s)
    np.testing.assert_array_equal(_np(tkd.subgoal_reached(tst)),
                                  _np(jax.vmap(jkd.subgoal_reached)(jst)))
    jst = jax.vmap(jkd.step)(jst, jnp.asarray(a))[0]
    tst = tkd.step(tst, torch.from_numpy(a))[0]
    live = ~_np(tkd.step(_tstate(s), torch.from_numpy(a))[3])
    np.testing.assert_array_equal(_np(tkd.subgoal_reached(tst))[live],
                                  _np(jkd.subgoal_reached(jst))[live])
    assert _np(tkd.subgoal_reached(tst))[0]         # row 0 picked the key


@pytest.mark.parametrize("name", sorted(jregistered()))
def test_flat_dim(name):
    assert sorted(tregistered()) == sorted(jregistered())
    jenv, tenv = jmake(name), tmake(name)
    for jsp, tsp in ((jenv.observation_space, tenv.observation_space),
                     (jenv.action_space, tenv.action_space)):
        assert tspaces.flat_dim(tsp) == jspaces.flat_dim(jsp)
