"""The port's classic-control envs (pendulum, acrobot, mountain_car)
against the JAX package, and one PPO iteration on pendulum.

Both packages reset from the reference's draws: the reference's key of
each env is split as its ``_fresh`` splits it, and the values it draws
at each reset are injected into the port's ``uniform_floats`` by stream
id and counter.  Both then step from the same states with the same
actions.  The reference runs op by op (``jax.disable_jit``: compiled XLA
may contract a multiply-add into an FMA).  Bars:

* with one library's ``sin`` and ``cos`` on both sides (the
  reference's, patched into the port's env module), 200 steps bitwise:
  observations, rewards, flags, ``final_obs`` and every state field,
  across truncations, terminations and resets;
* with each library's own ``sin`` and ``cos`` (they differ in the last
  bit), one step from the same states within rtol=1e-6, atol=1e-6, and
  flags exact;
* ``angle_wrap`` bitwise (the floored remainder is exact).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl.envs import acrobot as jacro
from repro.rl.envs import base as jbase
from repro.rl.envs import mountain_car as jmc
from repro.rl.envs import pendulum as jpend
from repro_torch.rl.envs import acrobot as tacro
from repro_torch.rl.envs import base as tbase
from repro_torch.rl.envs import make as tmake
from repro_torch.rl.envs import mountain_car as tmc
from repro_torch.rl.envs import pendulum as tpend
from repro_torch.rl.rollout import env_keys

test_ppo = importlib.import_module("test_torch_ppo")

B = 8
CPU = torch.device("cpu")
RESETS = 6          # reset draws tabulated per env

# (reference module, port module, draw shape, minval, maxval)
ENVS = {
    "pendulum": (jpend, tpend, (2,), [-np.pi, -1.0], [np.pi, 1.0]),
    "acrobot": (jacro, tacro, (4,), -0.1, 0.1),
    "mountain_car": (jmc, tmc, (), -0.6, -0.4),
}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _bits(x):
    return _np(x).view(np.int32) if _np(x).dtype == np.float32 else _np(x)


def _xla_fn(name):
    """The reference library's elementwise ``name`` as a torch function
    (op by op, on the host), for the port's bitwise case."""
    fn = getattr(jnp, name)

    def call(x):
        return torch.from_numpy(np.array(fn(jnp.asarray(x.numpy()))))
    return call


class _XlaLibm:
    """``torch`` with the reference library's ``sin`` and ``cos``."""

    sin = staticmethod(_xla_fn("sin"))
    cos = staticmethod(_xla_fn("cos"))

    def __getattr__(self, name):
        return getattr(torch, name)


@pytest.fixture
def same_libm(monkeypatch):
    """One library's sin and cos on both sides: the reference's, computed
    op by op on the same [B] arrays it computes them on, patched into
    the port's env module."""
    def install(tmod):
        monkeypatch.setattr(tmod, "torch", _XlaLibm())
    return install


def _fresh_from(name, vals, key):
    """The reference's fresh ``EnvState`` from its drawn ``vals``."""
    jmod = ENVS[name][0]
    t = jnp.zeros((), jnp.int32)
    if name == "pendulum":
        return jmod.EnvState(vals[0], vals[1], t, key)
    if name == "acrobot":
        return jmod.EnvState(vals[0], vals[1], vals[2], vals[3], t, key)
    return jmod.EnvState(vals[0], jnp.zeros(()), t, key)


@pytest.fixture
def ref_resets(monkeypatch):
    """Reference keys for ``B`` envs and the values the reference draws
    at each of their resets (its ``split`` and ``uniform``, op by op).
    The port's ``uniform_floats`` is replaced by those values (by stream
    id and counter), and the reference's ``_fresh`` by a lookup of the
    same values and next keys (by key), checked against ``_fresh``
    first: its threefry, run op by op every step, would otherwise take
    most of the test's time."""
    def install(name, seed):
        jmod, tmod, shape, lo, hi = ENVS[name]
        jkeys = jax.random.split(jax.random.PRNGKey(seed), B)
        width = max(int(np.prod(shape)), 1)
        table = np.zeros((B, RESETS, width), np.float32)
        chain = {}
        with jax.disable_jit():
            for b in range(B):
                k = jkeys[b]
                for c in range(RESETS):
                    nk, sub = jax.random.split(k)
                    table[b, c] = np.asarray(jax.random.uniform(
                        sub, shape, minval=jnp.asarray(lo),
                        maxval=jnp.asarray(hi))).reshape(-1)
                    chain[tuple(np.asarray(k).tolist())] = (
                        np.asarray(nk), table[b, c])
                    k = nk
        ids = env_keys(seed, B, CPU)[:, 0]
        tab = torch.from_numpy(table)

        def uniform_floats(key, draw, low, high):
            b = (key[:, :1] == ids[None]).to(torch.int64).argmax(1)
            return tab[b, key[:, 1], draw]

        keys_tab = jnp.asarray(np.stack([np.array(k, np.uint32)
                                         for k in chain]))
        next_tab = jnp.asarray(np.stack([v[0] for v in chain.values()]))
        vals_tab = jnp.asarray(np.stack([v[1] for v in chain.values()]))

        def fresh(key):
            i = jnp.argmax(jnp.all(keys_tab == key, axis=-1))
            return _fresh_from(name, vals_tab[i], next_tab[i])

        with jax.disable_jit():
            want = jax.vmap(jmod._fresh)(jkeys)
            got = jax.vmap(fresh)(jkeys)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                        strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        monkeypatch.setattr(jmod, "_fresh", fresh)
        monkeypatch.setattr(tmod, "uniform_floats", uniform_floats)
        return jkeys, env_keys(seed, B, CPU)
    return install


def _actions(name, rng, n):
    if name == "pendulum":
        return rng.uniform(-2.5, 2.5, (n, B, 1)).astype(np.float32)
    return rng.integers(0, 3, (n, B)).astype(np.int32)


def _inject(name, js, ts, rng):
    """Spread the step counters so boundaries fall on different steps,
    and put one env on its terminal set (mountain_car: at the flag with
    speed; acrobot: swung up)."""
    t = (np.arange(B) * 23 % (jmc.MAX_STEPS if name != "acrobot"
                              else 497)).astype(np.int32)
    if name == "acrobot":
        t[:] = np.array([0, 460, 470, 480, 300, 200, 100, 490], np.int32)
    js = js._replace(t=jnp.asarray(t))
    ts = ts._replace(t=torch.from_numpy(t))
    if name == "mountain_car":
        pos = np.asarray(js.position).copy()
        vel = np.asarray(js.velocity).copy()
        pos[1], vel[1] = 0.49, 0.05
        js = js._replace(position=jnp.asarray(pos), velocity=jnp.asarray(vel))
        ts = ts._replace(position=torch.from_numpy(pos),
                         velocity=torch.from_numpy(vel))
    if name == "acrobot":
        t1 = np.asarray(js.theta1).copy()
        t1[1] = 3.0
        js = js._replace(theta1=jnp.asarray(t1))
        ts = ts._replace(theta1=torch.from_numpy(t1))
    return js, ts


@pytest.mark.parametrize("name", sorted(ENVS))
def test_reset_and_steps_bitwise(name, ref_resets, same_libm):
    """Reset, then 200 steps: bitwise, with one library's sin and cos on
    both sides, through every truncation, termination and auto-reset."""
    jmod, tmod = ENVS[name][:2]
    same_libm(tmod)
    jkeys, tkeys = ref_resets(name, 3)
    rng = np.random.default_rng(4)
    n_steps = 200
    acts = _actions(name, rng, n_steps)
    with jax.disable_jit():
        js, jobs = jax.vmap(jmod.reset)(jkeys)
    ts, tobs = tmod.reset(tkeys)
    np.testing.assert_array_equal(_bits(tobs), _bits(jobs))
    js, ts = _inject(name, js, ts, rng)
    jstep = jax.vmap(jmod.step)
    resets = dones = truncs = 0
    for i in range(n_steps):
        with jax.disable_jit():
            js, jobs, jr, jd, jtr, jfo = jstep(js, jnp.asarray(acts[i]))
        ts, tobs, tr, td, ttr, tfo = tmod.step(ts, torch.from_numpy(acts[i]))
        for got, want in ((tobs, jobs), (tr, jr), (td, jd), (ttr, jtr),
                          (tfo, jfo)):
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"step {i}")
        for f in ts._fields:
            if f != "key":
                np.testing.assert_array_equal(
                    _bits(getattr(ts, f)), _bits(getattr(js, f)),
                    err_msg=f"step {i} field {f}")
        dones += int(_np(td).sum())
        truncs += int(_np(ttr).sum())
        resets += int((_np(td) | _np(ttr)).sum())
    assert truncs >= B // 2 and resets <= B * (RESETS - 2)
    if name != "pendulum":
        assert dones >= 1
    else:
        assert dones == 0


@pytest.mark.parametrize("name", sorted(ENVS))
def test_one_step_with_each_librarys_libm(name):
    """One step from random states with each library's own sin and cos:
    observations within rtol=1e-6, atol=1e-6, rewards too (pendulum's
    cost reads no libm function), flags exact."""
    jmod, tmod = ENVS[name][:2]
    rng = np.random.default_rng(11)
    n = 64
    if name == "pendulum":
        f = [rng.uniform(-6, 6, n), rng.uniform(-8, 8, n)]
    elif name == "acrobot":
        f = [rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
             rng.uniform(-12, 12, n), rng.uniform(-28, 28, n)]
    else:
        f = [rng.uniform(-1.2, 0.45, n), rng.uniform(-0.07, 0.07, n)]
    f = [x.astype(np.float32) for x in f]
    t = rng.integers(0, 150, n).astype(np.int32)
    js = jmod.EnvState(*(jnp.asarray(x) for x in f), jnp.asarray(t),
                       jax.random.split(jax.random.PRNGKey(0), n))
    ts = tmod.EnvState(*(torch.from_numpy(x) for x in f),
                       torch.from_numpy(t), env_keys(0, n, CPU))
    a = (rng.uniform(-2.5, 2.5, (n, 1)) if name == "pendulum"
         else rng.integers(0, 3, n)).astype(
        np.float32 if name == "pendulum" else np.int32)
    with jax.disable_jit():
        jout = jax.vmap(jmod.step)(js, jnp.asarray(a))
    tout = tmod.step(ts, torch.from_numpy(a))
    for k in (2, 3, 4):
        np.testing.assert_array_equal(_np(tout[k]), _np(jout[k]))
    for k in (2, 5):
        np.testing.assert_allclose(_np(tout[k]), _np(jout[k]), rtol=1e-6,
                                   atol=1e-6)
    # the fresh episode's obs comes from each package's own reset draw
    live = ~(_np(tout[3]) | _np(tout[4]))
    assert live.sum() >= n // 2
    np.testing.assert_allclose(_np(tout[1])[live], _np(jout[1])[live],
                               rtol=1e-6, atol=1e-6)


def test_angle_wrap_bitwise():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-50, 50, 4096),
                        [-np.pi, np.pi, 0.0, -0.0, 3 * np.pi, -3 * np.pi,
                         2 * np.pi, 1e-30, -1e-30]]).astype(np.float32)
    with jax.disable_jit():
        want = jbase.angle_wrap(jnp.asarray(x))
    got = tbase.angle_wrap(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", sorted(ENVS))
def test_specs_match_the_reference(name):
    jspec, tspec = ENVS[name][0].make().spec, tmake(name).spec
    assert tspec.name == jspec.name and tspec.max_steps == jspec.max_steps
    assert tspec.obs_shape == jspec.obs_shape
    assert tspec.continuous == jspec.continuous == (name == "pendulum")
    ja, ta = jspec.action_space, tspec.action_space
    if name == "pendulum":
        assert (ta.low, ta.high, ta.shape) == (ja.low, ja.high, ja.shape)
    else:
        assert ta.n == ja.n == 3


def test_pendulum_truncates_with_the_pre_reset_obs(ref_resets):
    """At the 200-step horizon every env reports ``truncated`` (never
    ``done``), ``final_obs`` is the pre-reset observation and ``obs``
    the fresh episode's first."""
    _, tkeys = ref_resets("pendulum", 5)
    ts, _ = tpend.reset(tkeys)
    ts = ts._replace(t=torch.full((B,), tpend.MAX_STEPS - 1,
                                  dtype=torch.int32))
    a = torch.zeros(B, 1)
    out, obs, r, d, tr, fo = tpend.step(ts, a)
    assert tr.all() and not d.any()
    theta_dot = torch.clamp(ts.theta_dot + tpend.DT * (
        15.0 * torch.sin(ts.theta) + 3.0 * a[:, 0]), -8.0, 8.0)
    theta = ts.theta + tpend.DT * theta_dot
    assert torch.equal(fo, torch.stack([torch.cos(theta), torch.sin(theta),
                                        theta_dot], -1))
    assert (out.t == 0).all() and torch.equal(obs, tpend._obs(out))
    assert torch.equal(out.key[:, 1], ts.key[:, 1] + 1)


def _pendulum_states(n, seed):
    rng = np.random.default_rng(seed)
    f = [rng.uniform(-1, 1, n).astype(np.float32),
         rng.uniform(-1, 1, n).astype(np.float32)]
    t = rng.integers(0, 100, n).astype(np.int32)
    js = jpend.EnvState(*(jnp.asarray(v) for v in f), jnp.asarray(t),
                        jax.random.split(jax.random.PRNGKey(0), n))
    ts = tpend.EnvState(*(torch.from_numpy(v) for v in f),
                        torch.from_numpy(t), env_keys(0, n, CPU))
    return js, ts


def test_one_ppo_iteration_on_pendulum():
    """The TanhGaussian head: 4 pendulum envs x 6 steps, fxp8 actors,
    the fp32 learner, with the reference's normals injected; actions,
    log-probs and values within rtol=1e-5 (each library's tanh, sin and
    cos), the updated params and Adam moments within atol=1e-5 +
    rtol=1e-4 of the reference's jitted iteration."""
    from repro.core import policy as jpolicy
    from repro.launch.mesh import make_host_mesh
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.optim import adamw_init as jadamw_init
    from repro.optim import constant as jconstant
    from repro.rl import actor_learner as jal
    from repro.rl import nets as jnets
    from repro.rl import ppo as jppo
    from repro.rl.dists import TanhGaussian as JTanhGaussian
    from repro.rl.train_steps import make_onpolicy_iteration as jmake
    from repro_torch.core import policy as tpolicy
    from repro_torch.optim import AdamWConfig, adamw_init, constant
    from repro_torch.rl import actor_learner as tal
    from repro_torch.rl import nets as tnets
    from repro_torch.rl import ppo as tppo
    from repro_torch.rl.dists import TanhGaussian
    from repro_torch.rl.train_steps import (IterationDraws,
                                            make_onpolicy_iteration)
    from repro_torch.tree import tree_leaves

    n, steps = 4, 6
    jp, tp = test_ppo.ref_params(2, obs_dim=3, head=2)
    js, ts = _pendulum_states(n, 9)
    key = jax.random.PRNGKey(21)
    ocfg_j = JAdamWConfig(weight_decay=0.0, max_grad_norm=0.5)
    jit_it = jmake(jpend.make(), jnets.mlp_ac_apply, jpolicy.FXP8,
                   make_host_mesh(1), JTanhGaussian(-2.0, 2.0),
                   jppo.PPOConfig(), jppo.ppo_loss, jconstant(3e-3),
                   ocfg_j, rollout_len=steps, n_envs=n, n_slots=1)
    k1, k2 = jax.random.split(key)
    jres = jax.jit(lambda p, k, s, o: jal.collect(
        p, jpend.make(), jnets.mlp_ac_apply, jpolicy.FXP8, k, s, o, steps))(
        jal.pack_weights(jp, 8), jax.random.fold_in(k1, 0), js,
        jax.vmap(jpend._obs)(js))
    jout = jit_it(jp, jadamw_init(jp), js, jax.vmap(jpend._obs)(js),
                  jal.pack_weights(jp, 8), key, None, jnp.ones((1,), bool))
    noise = np.stack([np.asarray(jax.random.normal(k, (n, 1)))
                      for k in jax.random.split(jax.random.fold_in(k1, 0),
                                                steps)])
    perms, k = [], k2
    for _ in range(tppo.PPOConfig().epochs):
        k, sub = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(sub, n * steps)))
    draws = IterationDraws(torch.from_numpy(noise),
                           torch.from_numpy(np.stack(perms)))
    it = make_onpolicy_iteration(
        tmake("pendulum"), tnets.mlp_ac_apply, tpolicy.FXP8,
        TanhGaussian(-2.0, 2.0), tppo.PPOConfig(), tppo.ppo_loss,
        constant(3e-3), AdamWConfig(weight_decay=0.0, max_grad_norm=0.5),
        rollout_len=steps, n_envs=n)
    packed = tal.pack_weights(tp, 8)
    tres = it.rollout_phase(packed, draws, ts, tpend._obs(ts))
    tout = it(tp, adamw_init(tp), ts, tpend._obs(ts), packed, draws, None,
              torch.ones(1, dtype=torch.bool))
    jt, tt = jres.traj, tres.traj
    assert not _np(tt.boundary).any()
    for f in ("actions", "log_probs", "values", "rewards", "next_obs"):
        np.testing.assert_allclose(_np(getattr(tt, f)),
                                   np.asarray(getattr(jt, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    for got, want in ((tout[0], jout[0]), (tout[1]["mu"], jout[1]["mu"]),
                      (tout[1]["nu"], jout[1]["nu"])):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want),
                        strict=True):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)
