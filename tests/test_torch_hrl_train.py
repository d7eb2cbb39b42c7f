"""Two-stage PPO of the E2HRL agent in the PyTorch port against the JAX
package: the learner's gradients through ``hrl.apply``, the conv stem's
backward at each asymmetric SAME pad, whole two-stage runs and their
checkpoints.

Weights are the reference's, carried across with ``from_numpy_tree``.
A whole run is held against the reference's trainer with the
reference's own draws: each iteration's Gumbel noise and minibatch
permutations from ``fold_in(PRNGKey(seed), g)`` at global step g (as
``tests/test_torch_trainer.py`` draws them), and catch's reset columns,
drawn from the reference's per-env keys and injected into the port's
env.  The reference's actor runs op by op with torch's tanh (as the
port's other actor tests hold it bitwise), and each port iteration
starts from the reference's state before that step, so an ulp of the
learners' fp32 sums, which can move an int8 weight code at a rounding
tie, does not carry into the next step.  Bars, each stated where it is
used: rtol=1e-5 for losses and gradients (of the leaf's largest
entry), rtol=1e-6 for the fp32 conv's VJP, and atol 1e-5 + rtol 1e-4
for params and Adam moments after an iteration, the bar of the
one-iteration PPO test.
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs.e2hrl import HRLConfig as JHRLConfig
from repro.models import hrl as jhrl
from repro.nn import conv as jconv
from repro.nn.module import unbox
from repro.core import vact as jvact
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.rl import actor_learner as jal
from repro.rl import ppo as jppo
from repro.rl.envs import make as jmake
from repro.rl.rollout import episode_returns as jepisode_returns
from repro.rl.rollout import init_envs as jinit_envs
from repro.rl.trainer import onpolicy_state as jonpolicy_state
from repro.rl.trainer.onpolicy import OnPolicyTrainer as JTrainer
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.configs.e2hrl import HRLConfig as THRLConfig
from repro_torch.core.fxp import QTensor
from repro_torch.models import hrl as thrl
from repro_torch.nn import conv as tconv
from repro_torch.rl import ppo as tppo
from repro_torch.rl.envs import catch as tcatch
from repro_torch.rl.rollout import env_keys
from repro_torch.rl.train_steps import IterationDraws
from repro_torch.rl.trainer import OnPolicyTrainer as TTrainer
from repro_torch.rl.trainer import rl_train
from repro_torch.tree import leaves_with_path, tree_leaves, tree_unflatten

test_trainer = importlib.import_module("test_torch_trainer")

CPU = torch.device("cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the learner: gradients through hrl.apply and the conv stem's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,c", [(32, 32, 3), (10, 5, 1), (5, 3, 16),
                                   (3, 2, 32)])
def test_conv_stem_vjp_at_asymmetric_pads(h, w, c):
    """The fp32 stride-2 SAME conv the learner differentiates: 32 -> 16
    and 10 -> 5 pad (0, 1), 5 -> 3 and 3 -> 2 pad (1, 1).  Output and
    the input, weight and bias cotangents within rtol=1e-6 (of the
    largest entry) of ``jax.vjp`` of the reference's conv."""
    rng = np.random.default_rng(h * 7 + w)
    x = rng.normal(size=(3, h, w, c)).astype(np.float32)
    p = {"w": (rng.normal(size=(3, 3, c, 8)) * 0.3).astype(np.float32),
         "b": rng.normal(size=8).astype(np.float32)}
    jfn = lambda x, p: jconv.conv2d_apply(p, x, stride=2)  # noqa: E731
    jout, vjp = jax.vjp(jfn, jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    gout = rng.normal(size=jout.shape).astype(np.float32)
    jdx, jdp = vjp(jnp.asarray(gout))
    tx = _t(x).requires_grad_()
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tout = tconv.conv2d_apply(tp, tx, stride=2)
    tdx, tdw, tdb = torch.autograd.grad(tout, (tx, tp["w"], tp["b"]),
                                        _t(gout))
    for got, want in ((tout, jout), (tdx, jdx), (tdw, jdp["w"]),
                      (tdb, jdp["b"])):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))


def _hrl_batch(obs_shape, n, n_actions, seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.uniform(size=(n,) + obs_shape).astype(np.float32),
        actions=rng.integers(0, n_actions, n).astype(np.int32),
        log_probs=np.log(rng.uniform(0.2, 0.5, n)).astype(np.float32),
        advantages=rng.normal(size=n).astype(np.float32),
        returns=rng.normal(size=n).astype(np.float32),
        mask=(rng.random(n) < 0.8).astype(np.float32))


@pytest.mark.parametrize("obs_shape,n_actions", [((32, 32, 3), 4),
                                                 ((10, 5, 1), 3)])
@pytest.mark.parametrize("loss", ["ppo_loss", "a2c_loss"])
def test_hrl_learner_loss_and_gradients(obs_shape, n_actions, loss):
    """The fp32 learner on the published-width E2HRL agent (keydoor's
    and catch's frames): loss, stats and every gradient leaf within
    rtol=1e-5 of ``jax.value_and_grad`` of the reference."""
    jc = JHRLConfig(obs_shape=obs_shape, n_actions=n_actions)
    tc = THRLConfig(obs_shape=obs_shape, n_actions=n_actions)
    jp = unbox(jhrl.init(jax.random.PRNGKey(3), jc))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), CPU)
    batch = _hrl_batch(obs_shape, 24, n_actions, 5)
    (jl, jstats), jg = jax.value_and_grad(getattr(jppo, loss), has_aux=True)(
        jp, lambda p, o: jhrl.apply(p, o, jc)[:2],
        {k: jnp.asarray(v) for k, v in batch.items()}, jppo.PPOConfig())
    (tl, tstats), tg = tppo.value_and_grad(
        getattr(tppo, loss), tp, lambda p, o: thrl.apply(p, o, tc)[:2],
        {k: _t(v) for k, v in batch.items()}, tppo.PPOConfig())
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    n = 0
    for got, want in zip(tree_leaves(tg), jax.tree.leaves(jg), strict=True):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
        n += int(np.abs(want).max() > 0)
    assert n == len(jax.tree.leaves(jg))      # every leaf has a gradient


# ---------------------------------------------------------------------------
# whole two-stage runs with the reference's draws
# ---------------------------------------------------------------------------


def reference_columns(seed, n, resets=8):
    """The ball columns the reference's catch draws for each of ``n``
    envs reset from ``split(PRNGKey(seed), n)``: [n, resets], reset r of
    env i in column r (``_fresh`` splits the env's key each reset)."""
    cols = np.zeros((n, resets), np.int64)
    for i, k in enumerate(jax.random.split(jax.random.PRNGKey(seed), n)):
        for r in range(resets):
            k, sub = jax.random.split(k)
            cols[i, r] = int(jax.random.randint(sub, (), 0, 5, jnp.int32))
    return cols


@pytest.fixture
def catch_draws(monkeypatch):
    """Install the reference's catch reset columns in the port's env for
    envs reset from ``env_keys(seed, n)``: each env's draw is looked up
    by its stream id and its reset counter."""
    def install(seed, n):
        cols = torch.from_numpy(reference_columns(seed, n))
        ids = env_keys(seed, n, CPU)[:, 0]

        def uniform_ints(key, draw, high):
            assert draw == 0 and int(high) == tcatch.COLS
            row = (key[:, :1] == ids[None]).to(torch.int64).argmax(1)
            return cols[row, key[:, 1]]

        monkeypatch.setattr(tcatch, "uniform_ints", uniform_ints)
    return install


@pytest.fixture
def torch_tanh_in_reference(monkeypatch):
    """The reference's native tanh computed by torch (XLA's and torch's
    differ in the last bit at about 58% of fp32 inputs, which can flip
    the sub-goal's requantized int8 code at a rounding tie), through a
    callback that also runs under ``jit`` and ``grad`` (its derivative
    ``1 - tanh^2``, as ``jnp.tanh``'s)."""
    @jax.custom_jvp
    def tanh(x):
        return jax.pure_callback(
            lambda a: torch.tanh(_t(a)).numpy(),
            jax.ShapeDtypeStruct(x.shape, x.dtype), x,
            vmap_method="expand_dims")

    @tanh.defjvp
    def _(primals, tangents):
        y = tanh(primals[0])
        return y, tangents[0] * (1 - y * y)

    monkeypatch.setitem(jvact._NATIVE, "tanh", tanh)


class JRecorder(JTrainer):
    """The reference's trainer, recording its state before each step
    and (params, opt) after it.

    Its iteration is the body of the reference's
    ``make_onpolicy_iteration`` at one slot, from the reference's own
    functions, with the actor's rollout run op by op: compiled, XLA
    fuses the fxp8 actor's multiply-adds and rounds them otherwise,
    which can flip a requantized int8 code (the port follows the
    eager program, as ``tests/test_torch_hrl.py`` holds it).  The
    learner stays compiled."""

    def build_iteration(self):
        env, apply_fn, dist = self.env, self.apply_fn, self.dist
        pcfg, n_envs = self.pcfg, self.n_envs

        def opt_step(p, s, g):
            p, s, _ = jadamw_update(g, s, p, self.sched, self.ocfg)
            return p, s

        @jax.jit
        def learn(params, opt, res, key, gmask, alive):
            batch = jppo.batch_from_traj(
                res.traj, res.last_value, pcfg,
                actor_mask=jal.fleet_mask(alive, n_envs),
                value_fn=lambda o: apply_fn(params, o, None)[1])
            params, opt, _ = jppo.minibatch_epochs(
                key, params, opt, batch, lambda p, o: apply_fn(p, o, None),
                pcfg, opt_step, loss_fn=self.loss_fn, grad_mask=gmask,
                dist=dist)
            return params, opt, jepisode_returns(res.traj)

        def iteration(params, opt, est, obs, packed, key, gmask, alive):
            k1, k2 = jax.random.split(key)
            with jax.disable_jit():
                res = jal.collect(packed, env, apply_fn, self.a_policy,
                                  jax.random.fold_in(k1, 0), est, obs,
                                  self.rollout_len, dist)
            params, opt, (ret, n_ep) = learn(params, opt, res, k2, gmask,
                                             alive)
            return params, opt, res.final_env, res.final_obs, ret, n_ep

        return iteration

    def step(self, iteration, state, packed, key, g, stage_ctx, alive,
             mbuf=None):
        self.before.append(jax.tree.map(np.asarray, state))
        out = super().step(iteration, state, packed, key, g, stage_ctx,
                           alive, mbuf)
        self.rec.append(jax.tree.map(np.asarray, (out[0].params,
                                                  out[0].opt)))
        return out


class TRecorder(TTrainer):
    """The port's trainer on the reference's draws, each iteration from
    the reference's state before that step (its env keys excepted: the
    port's streams carry the injected reset draws), recording (params,
    opt) after each step.  A step so starts from the reference's own
    int8 sync: the learners' ulp-level differences, which can move an
    int8 weight code at a rounding tie, do not carry from one step to
    the next."""

    def step(self, iteration, state, packed, gen, g, stage_ctx, alive):
        state = self._reference_state(state, self.ref.before[g])
        packed = self.pack(state)
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), g)
        n = self.rollout_len * self.n_envs
        noise, perms = test_trainer.reference_draws(
            key, self.rollout_len, self.n_envs, self.head_dim,
            self.pcfg.epochs, n)
        self.packed.append(packed)
        params, opt, est, obs, ret, n_ep = iteration(
            state.params, state.opt, state.est, state.obs, packed,
            IterationDraws(_t(noise), _t(perms)), stage_ctx, alive)
        self.rec.append((state.params, params, opt))
        state = type(state)(params, None, opt, None, est, obs)
        return state, ret, n_ep

    @staticmethod
    def _reference_state(state, before):
        leaves = []
        for (path, mine), ref in zip(leaves_with_path(tuple(state)),
                                     jax.tree.leaves(before), strict=True):
            keep = path[-1] == ".key"
            leaves.append(mine if keep else _t(ref).to(mine.dtype))
        return type(state)(*tree_unflatten(tuple(state), leaves))


def paired_runs(catch_draws, **kw):
    """The reference's and the port's run of the same configuration,
    from the reference's initial params, envs and draws."""
    kw = {**dict(verbose=False, seed=0), **kw}
    jt = JRecorder(**kw)
    jt.rec, jt.before = [], []
    jt.final, jhist = jt.train()
    catch_draws(kw["seed"] + 1, kw["n_envs"])
    tt = TRecorder(device="cpu", **kw)
    tt.rec, tt.packed, tt.ref = [], [], jt
    tt._init_params = from_numpy_tree(
        jax.tree.map(np.asarray, jt._init_params), CPU)
    tt.final, thist = tt.train()
    return jt, jhist, tt, thist


def _close(got, want, what):
    worst = 0.0
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        a, b = _np(a), np.asarray(b)
        worst = max(worst, float(np.abs(a - b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=what)
    return worst


HRL_RUN = dict(env_name="catch", agent="hrl", iters=2, n_envs=4,
               rollout_len=4, two_stage=True)


def test_two_stage_run_against_reference(catch_draws,
                                         torch_tanh_in_reference):
    """``rl_train(catch, agent=hrl, iters=2, n_envs=4, rollout_len=4,
    two_stage=True)`` against the reference's trainer on the same
    initial params, envs and draws, each port iteration from the
    reference's state before it: the int8 weight sync (the 4-D conv
    kernels per output channel) bitwise, the returns equal, and params
    and Adam moments after every iteration of both stages within atol
    1e-5 + rtol 1e-4.  In stage "action" the sub-goal subtree stays
    bitwise as it was, with zero moments; in stage "subgoal" stem,
    action and value move on the moments carried from stage "action",
    by what the reference's move (atol 1e-5 + rtol 1e-4)."""
    jt, jhist, tt, thist = paired_runs(catch_draws, **HRL_RUN)
    assert len(thist) == len(jhist) == 4
    np.testing.assert_allclose(thist, jhist, rtol=1e-6, atol=1e-6)
    from repro.rl.actor_learner import pack_weights as jpack
    for g in range(4):
        jpacked = jax.tree.leaves(jpack(
            jax.tree.map(jnp.asarray, jt.before[g].params), 8))
        tpacked = [y for x in tree_leaves(tt.packed[g]) for y in (
            (x.qvalue, x.scale) if isinstance(x, QTensor) else (x,))]
        for a, b in zip(tpacked, jpacked, strict=True):
            a, b = _np(a), np.asarray(b)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert sum(x.ndim == 4 and x.dtype == torch.int8 for x in tpacked) == 3
    errs = []
    for g, ((tb, tp, to), (jp, jo)) in enumerate(zip(tt.rec, jt.rec,
                                                     strict=True)):
        errs.append((_close(tp, jp, f"params at {g}"),
                     _close(to["mu"], jo["mu"], f"mu at {g}"),
                     _close(to["nu"], jo["nu"], f"nu at {g}")))
        assert int(to["count"]) == int(jo["count"]) == 16 * (g + 1)
        jb = jt.before[g].params
        for name in ("stem", "subgoal", "action", "value"):
            moved = [a - b for a, b in zip(tree_leaves(tp[name]),
                                           tree_leaves(tb[name]),
                                           strict=True)]
            jmoved = [np.asarray(a) - np.asarray(b) for a, b in zip(
                jax.tree.leaves(jp[name]), jax.tree.leaves(jb[name]),
                strict=True)]
            frozen = g < 2 and name == "subgoal"
            assert all(not d.any() for d in moved) == frozen, (g, name)
            assert all(not d.any() for d in jmoved) == frozen, (g, name)
            for a, b in zip(moved, jmoved, strict=True):
                np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-5)
        if g < 2:
            assert not any(m.any() for m in
                           tree_leaves(to["mu"]["subgoal"]))
    print(f"largest abs errors (params, mu, nu) by step: {errs}")


def test_two_stage_mask_freezes_only_the_first_stage_subtree():
    """The grad-mask wiring on the port's own init: stage "action" leaves
    the sub-goal subtree bitwise as it was, stage "subgoal" from fresh
    Adam moments leaves stem, action and value bitwise as they were."""
    tr = TTrainer("catch", "hrl", iters=1, n_envs=4, rollout_len=8,
                  two_stage=True, device="cpu", verbose=False)
    state = tr.init_state()
    it = tr.build_iteration()
    packed = tr.pack(state)
    gen = torch.Generator().manual_seed(0)
    for stage, frozen in (("action", ("subgoal",)),
                          ("subgoal", ("stem", "action", "value"))):
        params, *_ = it(state.params, state.opt, state.est, state.obs,
                        packed, tr.draws(gen), tr.stage_setup(state, stage),
                        torch.ones(1, dtype=torch.bool))
        for name in params:
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(params[name]), tree_leaves(state.params[name]),
                strict=True))
            assert same == (name in frozen), (stage, name)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_two_stage_checkpoint_records_stage_and_resumes_in_stage(
        tmp_path, capsys):
    """The port's version of the reference's test: steps are global
    (g = stage * iters + it) and tagged with the stage, so a resume
    lands inside stage "subgoal"; a run without --two-stage refuses the
    checkpoint."""
    d = str(tmp_path / "ck")
    kw = dict(env_name="catch", agent="hrl", iters=2, n_envs=4,
              rollout_len=4, two_stage=True, ckpt_dir=d, save_every=1,
              device="cpu")
    rl_train(verbose=False, **kw)
    capsys.readouterr()
    mgr = TManager(d)
    assert mgr.latest_step() == 3            # 2 stages x 2 iters - 1
    md = mgr.metadata()
    assert md["stage"] == "subgoal" and md["stage_iter"] == 1
    for sfx in (".npz", ".npz.json"):
        os.unlink(os.path.join(d, f"step_3{sfx}"))
    _, hist = rl_train(verbose=True, **kw)
    out = capsys.readouterr().out
    assert "resumed at global iter 3 (stage subgoal, iter 0 done)" in out
    assert "[stage=action]" not in out and "[stage=subgoal]" in out
    assert len(hist) == 1                    # exactly the missing iter
    with pytest.raises(ValueError, match="saved in stage"):
        rl_train(verbose=False, **{**kw, "two_stage": False})


def test_two_stage_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """Resumed at g = 3 from the checkpoint of g = 2, the run ends bit
    for bit where the uninterrupted one does (the draws are a function
    of the global step, the stage mask of the recorded stage)."""
    kw = dict(env_name="catch", agent="hrl", iters=2, n_envs=4,
              rollout_len=4, two_stage=True, device="cpu", verbose=False)
    full, _ = TTrainer(**kw).train()
    d = str(tmp_path / "ck")
    TTrainer(**{**kw, "iters": 2}, ckpt_dir=d, save_every=1).train()
    for sfx in (".npz", ".npz.json"):
        os.unlink(os.path.join(d, f"step_3{sfx}"))
    resumed, hist = TTrainer(**kw, ckpt_dir=d, save_every=1).train()
    assert len(hist) == 1
    for a, b in zip(tree_leaves(tuple(full)), tree_leaves(tuple(resumed)),
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _same_leaf(a, b):
    """Equal values; the env's int64 key stream ids compare modulo 2^32,
    since the reference reads int64 as int32 without x64 (and the port
    reads the reference's uint32 keys as int64)."""
    a, b = _np(a), np.asarray(b)
    if a.dtype.kind in "iu":
        a, b = a.astype(np.int64) % 2**32, b.astype(np.int64) % 2**32
    np.testing.assert_array_equal(a, b)


def test_two_stage_checkpoint_crosses_packages(tmp_path):
    """A two-stage checkpoint written by the port restores through the
    reference's manager (params, Adam state, catch's env state and
    observations, its stage metadata), and one the reference writes
    resumes in the port inside the recorded stage."""
    d = str(tmp_path / "port")
    kw = dict(env_name="catch", agent="hrl", iters=2, n_envs=4,
              rollout_len=4, two_stage=True, save_every=1, verbose=False)
    tstate, _ = TTrainer(device="cpu", ckpt_dir=d, **kw).train()
    jtr = JTrainer(**kw)
    jp = jtr._init_params
    est0, obs0 = jinit_envs(jmake("catch"), jax.random.PRNGKey(1), 4)
    jstate, md = JManager(d).restore(jonpolicy_state(jp, jadamw_init(jp),
                                                     est0, obs0))
    assert (md["stage"], md["stage_iter"], md["step"]) == ("subgoal", 1, 3)
    for a, b in zip(tree_leaves(tuple(tstate)), jax.tree.leaves(jstate),
                    strict=True):
        _same_leaf(a, b)
    back = str(tmp_path / "ref")
    jstate_r, _ = JTrainer(ckpt_dir=back, **{**kw, "iters": 1}).train()
    tr = TTrainer(device="cpu", ckpt_dir=back, **kw)
    restored, rmd = tr.restore(TManager(back), tr.init_state())
    assert tr.resume_start(rmd) == 3        # stage "subgoal", iter 1
    for a, b in zip(tree_leaves(tuple(restored)),
                    jax.tree.leaves(jstate_r), strict=True):
        _same_leaf(a, b)
    _, hist = tr.train()
    assert len(hist) == 1 and np.isfinite(hist[0])
