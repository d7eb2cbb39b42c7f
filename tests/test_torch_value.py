"""The value family's pure pieces against the JAX package: n-step
targets, the ε-greedy policy, polyak, TQC truncation, the DQN, QR-DQN
and DDPG losses with their gradients, and the value nets' forwards.

Weights are the reference's initial params carried across with
``from_numpy_tree``; draws (ε-greedy's random actions and uniforms,
DDPG's target-smoothing normals) are the reference's, drawn with JAX
from its key and passed in.  The reference runs op by op
(``jax.disable_jit``) where a bar is bitwise.  Bars, each stated where
it is used: bitwise for n-step targets, ε, polyak, the truncation and
the fxp8 ReLU nets; rtol=1e-6 for fp32 forwards; rtol=1e-5 of each
leaf's largest entry for losses, TD errors and gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core import vact as jvact
from repro.nn.module import unbox
from repro.rl import nets as jnets
from repro.rl import value as jval
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.core import policy as tpolicy
from repro_torch.rl import nets as tnets
from repro_torch.rl import value as tval
from repro_torch.rl.ppo import value_and_grad
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(x):
    a = _np(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _pair(tree):
    """(reference tree, port tree) from a reference init."""
    p = jax.tree.map(np.asarray, unbox(tree))
    return jax.tree.map(jnp.asarray, p), from_numpy_tree(p, CPU)


def _close(got, want, rtol=1e-5, what=""):
    """Each leaf within rtol of its entries and of its largest entry."""
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        a, b = _np(a), _np(b)
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-30),
            err_msg=what)


# ---------------------------------------------------------------------------
# n-step targets, ε, polyak, truncation
# ---------------------------------------------------------------------------

def _chunk(T, B, seed):
    rng = np.random.default_rng(seed)
    rew = rng.normal(size=(T, B)).astype(np.float32)
    dones = rng.random((T, B)) < 0.12
    trunc = (rng.random((T, B)) < 0.12) & ~dones
    dones[-1, 0] = True            # a termination on the chunk's tail
    trunc[-2, 1], dones[-2, 1] = True, False
    nobs = rng.normal(size=(T, B, 3)).astype(np.float32)
    return rew, dones, trunc, nobs


@pytest.mark.parametrize("n", [1, 3, 5, 12])
def test_nstep_targets_bitwise(n):
    """Windows stopped by terminations and truncations, and cut by the
    chunk's tail: returns, successors and discounts bitwise."""
    rew, dones, trunc, nobs = _chunk(8, 6, n)
    with jax.disable_jit():
        want = jval.nstep_targets(jnp.asarray(rew), jnp.asarray(dones),
                                  jnp.asarray(trunc), jnp.asarray(nobs),
                                  0.99, n)
    got = tval.nstep_targets(_t(rew), _t(dones), _t(trunc), _t(nobs),
                             0.99, n)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert (_np(got[2])[dones] == 0).all() if n == 1 else True
    with pytest.raises(ValueError, match="n >= 1"):
        tval.nstep_targets(_t(rew), _t(dones), _t(trunc), _t(nobs), 0.99, 0)


def test_epsilon_and_beta_bitwise_and_egreedy_with_the_references_draws():
    """ε and PER's β bitwise the reference's compiled values (which fuse
    the multiply-add), ε-greedy actions equal under the reference's
    draws, the first maximum winning a tie."""
    from repro_torch.rl.train_steps import beta_at
    cfg = tval.DQNConfig(eps_decay_steps=1200)
    jcfg = jval.DQNConfig(eps_decay_steps=1200)
    for step in (0, 1, 7, 333, 599, 600, 1199, 1200, 5000):
        want = jax.jit(lambda s: jval.epsilon(s, jcfg))(jnp.int32(step))
        assert np.float32(tval.epsilon(step, cfg)).view(np.int32) == \
            np.asarray(want).view(np.int32)
        want = jax.jit(lambda it: 0.4 + (1.0 - 0.4) * jnp.clip(
            it / 300, 0.0, 1.0))(jnp.int32(step))
        assert np.float32(beta_at(step, 0.4, 300)).view(np.int32) == \
            np.asarray(want).view(np.int32)
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 3)).astype(np.float32)
    q[5] = [1.0, 1.0, 0.0]                     # a tie: the first wins
    key = jax.random.PRNGKey(4)
    for eps in (0.0, 0.3, 1.0):
        want = jval.egreedy(key, jnp.asarray(q), jnp.float32(eps))
        k1, k2 = jax.random.split(key)
        rand = jax.random.randint(k1, (64,), 0, 3)
        u = jax.random.uniform(k2, (64,))
        got = tval.egreedy(_t(q), eps, _t(rand), _t(u))
        np.testing.assert_array_equal(_np(got), _np(want))
        assert got.dtype == torch.int32


def test_polyak_bitwise():
    jt, tt = _pair(jnets.mlp_q_init(jax.random.PRNGKey(0), 4, 2, 16))
    jo, to = _pair(jnets.mlp_q_init(jax.random.PRNGKey(1), 4, 2, 16))
    with jax.disable_jit():
        want = jval.polyak(jt, jo, 0.01)
    got = tval.polyak(tt, to, 0.01)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_truncated_target_quantiles_values():
    rng = np.random.default_rng(2)
    z1 = rng.normal(size=(16, 25)).astype(np.float32)
    z2 = rng.normal(size=(16, 25)).astype(np.float32)
    z2[:, :3] = z1[:, :3]                      # ties across critics
    for drop in (0, 2, 49):
        want = jval.truncated_target_quantiles(jnp.asarray(z1),
                                               jnp.asarray(z2), drop)
        got = tval.truncated_target_quantiles(_t(z1), _t(z2), drop)
        np.testing.assert_array_equal(_np(got), _np(want))
    with pytest.raises(ValueError, match="leaves no target"):
        tval.truncated_target_quantiles(_t(z1), _t(z2), 50)


def test_configs_match_the_reference():
    for tcls, jcls in ((tval.DQNConfig, jval.DQNConfig),
                       (tval.QRDQNConfig, jval.QRDQNConfig),
                       (tval.DDPGConfig, jval.DDPGConfig)):
        assert tcls().__dict__ == jcls().__dict__
    assert tval.DDPGConfig(low=-2.0, high=2.0).half_range == 2.0
    for kw, match in (({"critic_quantiles": 0}, ">= 1"),
                      ({"critic_quantiles": 2, "tqc_drop": 4}, "at least"),
                      ({"tqc_drop": 1}, "prunes")):
        with pytest.raises(ValueError, match=match):
            tval.DDPGConfig(**kw)


def test_quantile_huber_and_taus():
    rng = np.random.default_rng(3)
    theta = rng.normal(size=(8, 5)).astype(np.float32) * 2
    target = rng.normal(size=(8, 7)).astype(np.float32) * 2
    np.testing.assert_array_equal(_np(tval.quantile_taus(5)),
                                  _np(jval.quantile_taus(5)))
    for kappa in (1.0, 0.5):
        want = jval.quantile_huber(jnp.asarray(theta), jnp.asarray(target),
                                   kappa)
        got = tval.quantile_huber(_t(theta), _t(target), kappa)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# losses and their gradients
# ---------------------------------------------------------------------------

def _value_batch(rng, n, obs_dim, act, weight=True):
    b = {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
         "actions": act,
         "rewards": rng.normal(size=n).astype(np.float32),
         "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
         "discounts": (0.99 ** 3 * (rng.random(n) > 0.2)).astype(
             np.float32)}
    if weight:
        w = rng.uniform(0.1, 1.0, n).astype(np.float32)
        b["weight"] = w / w.max()
    return b


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


@pytest.mark.parametrize("algo,double,weight", [
    ("dqn", True, True), ("dqn", False, False), ("qrdqn", True, True),
    ("qrdqn", False, True)])
def test_q_losses_and_gradients(algo, double, weight):
    """Loss, |td| and the gradient on fixed batches (with PER-like
    weights or none), Double-DQN selection on and off."""
    rng = np.random.default_rng(7)
    n, nq = 32, 8
    if algo == "dqn":
        init = lambda k: jnets.mlp_q_init(k, 4, 3, 16)  # noqa: E731
        japply, tapply = jnets.mlp_q_apply, tnets.mlp_q_apply
        jcfg, tcfg = jval.DQNConfig(double=double), \
            tval.DQNConfig(double=double)
        jloss, tloss = jval.dqn_loss_td, tval.dqn_loss_td
    else:
        init = lambda k: jnets.mlp_qr_init(k, 4, 3, nq, 16)  # noqa: E731
        japply = lambda p, o: jnets.mlp_qr_apply(p, o, 3, nq)  # noqa: E731
        tapply = lambda p, o: tnets.mlp_qr_apply(p, o, 3, nq)  # noqa: E731
        jcfg = jval.QRDQNConfig(double=double, n_quantiles=nq)
        tcfg = tval.QRDQNConfig(double=double, n_quantiles=nq)
        jloss, tloss = jval.qrdqn_loss_td, tval.qrdqn_loss_td
    jp, tp = _pair(init(jax.random.PRNGKey(0)))
    jtg, ttg = _pair(init(jax.random.PRNGKey(1)))
    act = rng.integers(0, 3, n).astype(np.int32)
    jb, tb = _both(_value_batch(rng, n, 4, act, weight))
    (jl, jtd), jg = jax.value_and_grad(jloss, has_aux=True)(
        jp, jtg, japply, jb, jcfg)
    (tl, ttd), tg = value_and_grad(tloss, tp, ttg, tapply, tb, tcfg)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5)
    _close(ttd, jtd, what="|td|")
    _close(tg, jg, what="grads")
    assert float(tloss(tp, ttg, tapply, tb, tcfg)[0]) == float(tl)


@pytest.mark.parametrize("quantiles,drop", [(1, 0), (6, 2)])
def test_ddpg_losses_and_gradients(quantiles, drop):
    """The twin-critic loss (TD3 min-backup, or TQC's truncated pooled
    quantiles) with the reference's smoothing normals, and the actor
    loss through the critics: losses, |td| and gradients."""
    rng = np.random.default_rng(8)
    n, obs_dim, d = 24, 3, 1
    jcfg = jval.DDPGConfig(low=-2.0, high=2.0, critic_quantiles=quantiles,
                           tqc_drop=drop)
    tcfg = tval.DDPGConfig(low=-2.0, high=2.0, critic_quantiles=quantiles,
                           tqc_drop=drop)
    if quantiles > 1:
        cinit = lambda k: jnets.mlp_twin_qr_init(  # noqa: E731
            k, obs_dim, d, quantiles, 16)
        jcrit, tcrit = jnets.mlp_twin_qr_apply, tnets.mlp_twin_qr_apply
    else:
        cinit = lambda k: jnets.mlp_twin_q_init(k, obs_dim, d, 16)  # noqa: E731
        jcrit, tcrit = jnets.mlp_twin_q_apply, tnets.mlp_twin_q_apply
    jc, tc = _pair(cinit(jax.random.PRNGKey(0)))
    jtc, ttc = _pair(cinit(jax.random.PRNGKey(1)))
    ja, ta = _pair(jnets.mlp_pi_init(jax.random.PRNGKey(2), obs_dim, d, 16))
    jta, tta = _pair(jnets.mlp_pi_init(jax.random.PRNGKey(3), obs_dim, d,
                                       16))

    def jact(p, o):
        return jnets.mlp_pi_apply(p, o, -2.0, 2.0)

    def tact(p, o):
        return tnets.mlp_pi_apply(p, o, -2.0, 2.0)

    act = rng.uniform(-2, 2, (n, d)).astype(np.float32)
    jb, tb = _both(_value_batch(rng, n, obs_dim, act))
    key = jax.random.PRNGKey(9)
    normals = jax.random.normal(key, (n, d))
    (jl, jtd), jg = jax.value_and_grad(jval.ddpg_critic_loss_td,
                                       has_aux=True)(
        jc, jtc, jta, jcrit, jact, jb, jcfg, key)
    (tl, ttd), tg = value_and_grad(tval.ddpg_critic_loss_td, tc, ttc, tta,
                                   tcrit, tact, tb, tcfg, _t(normals))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5)
    _close(ttd, jtd, what="|td|")
    _close(tg, jg, what="critic grads")
    jal, jag = jax.value_and_grad(jval.ddpg_actor_loss)(ja, jc, jcrit,
                                                        jact, jb)
    (tal, _), tag = value_and_grad(
        lambda p, *a: (tval.ddpg_actor_loss(p, *a), {}), ta, tc, tcrit,
        tact, tb)
    np.testing.assert_allclose(_np(tal), _np(jal), rtol=1e-5)
    _close(tag, jag, what="actor grads")


def test_underfill_weights_zero_every_loss():
    rng = np.random.default_rng(4)
    jp, tp = _pair(jnets.mlp_q_init(jax.random.PRNGKey(0), 4, 2, 8))
    b = _value_batch(rng, 8, 4, rng.integers(0, 2, 8).astype(np.int32))
    b["weight"] = np.zeros(8, np.float32)
    _, tb = _both(b)
    (loss, td), g = value_and_grad(tval.dqn_loss_td, tp, tp,
                                   tnets.mlp_q_apply, tb, tval.DQNConfig())
    assert float(loss) == 0.0 and float(td.abs().sum()) > 0
    assert all(float(x.abs().sum()) == 0.0 for x in tree_leaves(g))


# ---------------------------------------------------------------------------
# the value nets
# ---------------------------------------------------------------------------

NETS = {
    "mlp_q": (lambda k: jnets.mlp_q_init(k, 4, 2),
              lambda g: tnets.mlp_q_init(g, 4, 2),
              jnets.mlp_q_apply, tnets.mlp_q_apply, (4,)),
    "mlp_qr": (lambda k: jnets.mlp_qr_init(k, 6, 3, 32),
               lambda g: tnets.mlp_qr_init(g, 6, 3, 32),
               lambda p, o, pol=None: jnets.mlp_qr_apply(p, o, 3, 32, pol),
               lambda p, o, pol=None: tnets.mlp_qr_apply(p, o, 3, 32, pol),
               (6,)),
    "mlp_pi": (lambda k: jnets.mlp_pi_init(k, 3, 1),
               lambda g: tnets.mlp_pi_init(g, 3, 1),
               lambda p, o, pol=None: jnets.mlp_pi_apply(p, o, -2.0, 2.0,
                                                         pol),
               lambda p, o, pol=None: tnets.mlp_pi_apply(p, o, -2.0, 2.0,
                                                         pol), (3,)),
    "conv_qr": (lambda k: jnets.conv_qr_init(k, (10, 5, 4), 3, 32),
                lambda g: tnets.conv_qr_init(g, (10, 5, 4), 3, 32),
                lambda p, o, pol=None: jnets.conv_qr_apply(p, o, 3, 32, pol),
                lambda p, o, pol=None: tnets.conv_qr_apply(p, o, 3, 32, pol),
                (10, 5, 4)),
}
TWINS = {
    "mlp_twin_q": (lambda k: jnets.mlp_twin_q_init(k, 3, 1),
                   lambda g: tnets.mlp_twin_q_init(g, 3, 1),
                   jnets.mlp_twin_q_apply, tnets.mlp_twin_q_apply),
    "mlp_twin_qr": (lambda k: jnets.mlp_twin_qr_init(k, 3, 1, 25),
                    lambda g: tnets.mlp_twin_qr_init(g, 3, 1, 25),
                    jnets.mlp_twin_qr_apply, tnets.mlp_twin_qr_apply),
}


@pytest.fixture
def torch_tanh_in_reference(monkeypatch):
    """The reference's native tanh computed by torch (op by op), so the
    fxp8 DDPG actor can be held bit for bit."""
    def tanh(x):
        return jnp.asarray(torch.tanh(_t(np.asarray(x))).numpy())
    monkeypatch.setitem(jvact._NATIVE, "tanh", tanh)


@pytest.mark.parametrize("name", sorted(NETS))
def test_value_net_layout_and_forwards(name, torch_tanh_in_reference):
    """The port's init has the reference's tree and shapes; from the
    reference's weights the fp32 forward within rtol=1e-6 and the fxp8
    forward (int8-synced weights, as the behaviour actors run it)
    bitwise (conv: within rtol=1e-6 of the largest entry, the conv's
    fp32 sums run in another order)."""
    from repro.rl.actor_learner import pack_weights as jpack
    from repro.rl.actor_learner import unpack_weights as junpack
    from repro_torch.rl.actor_learner import pack_weights as tpack
    from repro_torch.rl.actor_learner import unpack_weights as tunpack
    jinit, tinit, japply, tapply, shape = NETS[name]
    jp, tp = _pair(jinit(jax.random.PRNGKey(0)))
    mine = tinit(torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [x.shape for x in jax.tree.leaves(jp)]
    obs = np.random.default_rng(1).normal(size=(9,) + shape).astype(
        np.float32)
    _close(tapply(tp, _t(obs)), japply(jp, jnp.asarray(obs)), rtol=1e-6)
    with jax.disable_jit():
        want = japply(junpack(jpack(jp, 8)), jnp.asarray(obs),
                      jpolicy.FXP8)
    got = tapply(tunpack(tpack(tp, 8)), _t(obs), tpolicy.FXP8)
    if name.startswith("conv"):
        _close(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_ddpg_actor_fxp8_with_each_librarys_tanh():
    """With each library's own tanh the fxp8 actor's actions agree
    within rtol=1e-5 (an ulp of tanh can move an int8 code at a rounding
    tie only)."""
    jinit, _, japply, tapply, _ = NETS["mlp_pi"]
    jp, tp = _pair(jinit(jax.random.PRNGKey(5)))
    obs = np.random.default_rng(6).normal(size=(64, 3)).astype(np.float32)
    want = japply(jp, jnp.asarray(obs), jpolicy.FXP8)
    got = tapply(tp, _t(obs), tpolicy.FXP8)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_critic_forwards(name):
    jinit, tinit, japply, tapply = TWINS[name]
    jp, tp = _pair(jinit(jax.random.PRNGKey(0)))
    mine = tinit(torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [x.shape for x in jax.tree.leaves(jp)]
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(7, 3)).astype(np.float32)
    act = rng.uniform(-2, 2, (7, 1)).astype(np.float32)
    want = japply(jp, jnp.asarray(obs), jnp.asarray(act))
    got = tapply(tp, _t(obs), _t(act))
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        _close(g, w, rtol=1e-6)
