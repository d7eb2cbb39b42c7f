"""The sharded actor-learner fleet of the PyTorch port, piece by piece,
against the JAX package: the mesh, the sharded map, the fleet's
collects, the sharded replay facade, the compressed gradient mean and
one sharded value update.

One rank runs in this process (a world of one on a ``FileStore``).
Eight ranks run as spawned gloo processes (``repro_torch.distributed.
ranks.run_ranks``, one CPU thread each, killed at a deadline), all the
eight-rank checks in one launch: ``repro_torch.distributed.checks``
holds their bodies.

The reference's per-slot collects run op by op (``jax.disable_jit``:
compiled XLA fuses the fxp8 actor's multiply-adds) with torch's cos and
sin in its cartpole, torch's tanh in its actor and torch's log-softmax
in its categorical, so the
two packages compute every trajectory leaf with the same functions and
are held bitwise.  The reference's collectives run under ``jax.vmap(...,
axis_name="data")`` over a stack of the slots, where ``psum``, ``pmax``
and ``all_gather`` work on the vmapped axis.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core import vact as jvact
from repro.launch import mesh as jmesh
from repro.nn.module import unbox
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import compression as jcomp
from repro.optim import constant as jconstant
from repro.rl import actor_learner as jal
from repro.rl import inference as jinf
from repro.rl import nets as jnets
from repro.rl import value as jval
from repro.rl.envs import cartpole as jcp
from repro.rl.replay import sharded as jsharded
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.core import policy as tpolicy
from repro_torch.distributed import checks, sharding
from repro_torch.distributed.ranks import run_ranks
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import compression as tcomp
from repro_torch.rl import actor_learner as tal
from repro_torch.rl import inference as tinf
from repro_torch.rl import nets as tnets
from repro_torch.rl.envs import cartpole as tcp
from repro_torch.rl.replay import sharded as tsharded
from repro_torch.rl.rollout import init_envs
from repro_torch.tree import leaves_with_path, tree_leaves

test_ppo = importlib.import_module("test_torch_ppo")

CPU = torch.device("cpu")
N_RANKS = 8
T = 6                        # rollout steps of the fleet checks (no
                             # episode ends: resets draw each package's own)
B_SLOT = 2                   # envs a slot
EPS = 0.25                   # ε of the value fleet (exact in fp32)
COMP_CASES = [(b, s) for b in (4, 8, 16, 32) for s in ("gather", "psum")]
COMP_SHAPE = (2, N_RANKS, 48, 37)   # (steps, slots, ...)



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch work is small: one intra-op thread, as on the
    spawned ranks, restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    """A float array's bit pattern (an int array as it is)."""
    a = np.ascontiguousarray(_np(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want, what=""):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _torch_op(fn):
    """A JAX function computed by torch, through a callback that also
    runs under ``vmap``."""
    def op(x, *args, **kw):
        return jax.pure_callback(
            lambda a: fn(torch.from_numpy(np.array(a))).numpy(),
            jax.ShapeDtypeStruct(x.shape, x.dtype), x,
            vmap_method="expand_dims")
    return op


class _JnpTorchTrig:
    """``jax.numpy`` with torch's cos and sin (each library's libm
    differs in the last bit at some inputs)."""
    cos = staticmethod(_torch_op(torch.cos))
    sin = staticmethod(_torch_op(torch.sin))

    def __getattr__(self, name):
        return getattr(jnp, name)


def _patch_one_libm(mp):
    """The reference's cartpole trig, native tanh and categorical
    log-softmax computed by torch."""
    @jax.custom_jvp
    def tanh(x):
        return _torch_op(torch.tanh)(x)

    @tanh.defjvp
    def _(primals, tangents):
        y = tanh(primals[0])
        return y, tangents[0] * (1 - y * y)

    mp.setitem(jvact._NATIVE, "tanh", tanh)
    mp.setattr(jcp, "jnp", _JnpTorchTrig())
    mp.setattr(jax.nn, "log_softmax", _torch_op(
        lambda x: torch.log_softmax(x, dim=-1)))


# ---------------------------------------------------------------------------
# inputs shared by the one-rank and eight-rank fleet checks
# ---------------------------------------------------------------------------


def fleet_inputs(n_slots=N_RANKS):
    """The cartpole fleets' inputs for ``n_slots`` slots of ``B_SLOT``
    envs: the reference's (params, states, per-slot keys) and the port's
    (packed weights, states, global draws made from those keys)."""
    B = n_slots * B_SLOT
    jp, tp = test_ppo.ref_params(4)
    js, ts = test_ppo.cartpole_states(B, 21)
    jagent = jinf.make_value_agent("dqn", jcp.make().spec,
                                   jax.random.PRNGKey(5))
    vnp = jax.tree.map(np.asarray, unbox(
        jagent.behaviour_subtree(jagent.params)))
    jv, tv = jax.tree.map(jnp.asarray, vnp), from_numpy_tree(vnp, CPU)
    jvs, tvs = test_ppo.cartpole_states(B, 22)
    key = jax.random.PRNGKey(13)
    on_keys = [jax.random.fold_in(key, d) for d in range(n_slots)]
    v_keys = list(jal.slot_keys(key, n_slots))
    noise = np.concatenate([test_ppo.rollout_noise(k, T, B_SLOT, 2)
                            for k in on_keys], axis=1)
    acts, us = [], []
    for k in v_keys:
        a, u = [], []
        for sk in jax.random.split(k, T):
            k1, k2 = jax.random.split(sk)
            a.append(np.asarray(jax.random.randint(k1, (B_SLOT,), 0, 2)))
            u.append(np.asarray(jax.random.uniform(k2, (B_SLOT,))))
        acts.append(np.stack(a))
        us.append(np.stack(u))
    port = dict(packed=tal.pack_weights(tp, 8), est=ts, obs=tcp._obs(ts),
                noise=_t(noise), value_packed=tal.pack_weights(tv, 8),
                value_est=tvs, value_obs=tcp._obs(tvs),
                actions=_t(np.concatenate(acts, 1)),
                uniforms=_t(np.concatenate(us, 1)), eps=EPS, n_steps=T,
                reset_seed=3)
    ref = dict(jp=jp, js=js, jv=jv, jvs=jvs, on_keys=on_keys,
               v_keys=v_keys, agent=jagent)
    return port, ref


def reference_slots(ref):
    """Every slot's reference collects at once (op by op, vmapped over
    the slots, so each slot's reductions stay its own as under the
    reference's ``shard_map``): the on-policy ``collect`` of slot ``d``
    under ``fold_in(key, d)`` and the value family's ``collect_value``
    under ``slot_keys(key, n)[d]``, each on its own envs.  Leaves carry
    a leading slot axis."""
    def by_slot(tree):
        return jax.tree.map(
            lambda x: x.reshape((-1, B_SLOT) + x.shape[1:]), tree)

    def on(key, js):
        return jal.collect(jal.pack_weights(ref["jp"], 8), jcp.make(),
                           jnets.mlp_ac_apply, jpolicy.FXP8, key, js,
                           jax.vmap(jcp._obs)(js), T)

    def value(key, jvs):
        return jal.collect_value(
            jal.pack_weights(ref["jv"], 8), jinf.build_env("cartpole", "mlp"),
            ref["agent"].behave, jpolicy.FXP8, key, jvs,
            jax.vmap(jcp._obs)(jvs), T, jnp.float32(EPS))

    with jax.disable_jit():
        return (jax.vmap(on)(jnp.stack(ref["on_keys"]), by_slot(ref["js"])),
                jax.vmap(value)(jnp.stack(ref["v_keys"]),
                                by_slot(ref["jvs"])))


def _slot(tree, d):
    return jax.tree.map(lambda x: x[d], tree)


@pytest.fixture(scope="module")
def fleet():
    """The eight-slot fleets' inputs and every slot's reference
    collects (computed once: op by op they take seconds)."""
    port, ref = fleet_inputs()
    with pytest.MonkeyPatch.context() as mp:
        _patch_one_libm(mp)
        want = reference_slots(ref)
    return port, want


def slot0(port):
    """The fleet inputs of slot 0 alone (its envs, its share of the
    global draws)."""
    out = dict(port)
    for k in ("est", "obs", "value_est", "value_obs"):
        out[k] = tal.slot_key(port[k], 0, N_RANKS)
    for k in ("noise", "actions", "uniforms"):
        out[k] = tal.slot_key(port[k], 0, N_RANKS, dim=1)
    return out


def assert_slot(got_on, got_value, want_on, want_value, d):
    """The port's global results, slot ``d``'s envs, bitwise the
    reference's slot (the env keys excepted: the port's reset streams
    are its own, so no episode may end in these rollouts)."""
    sl = slice(d * B_SLOT, (d + 1) * B_SLOT)
    assert not np.asarray(want_on.traj.dones | want_on.traj.truncated).any()
    assert not np.asarray(want_value[1][3] | want_value[1][4]).any()
    traj, last, final_env, final_obs = got_on
    for f, a, b in zip(want_on.traj._fields, traj, want_on.traj,
                       strict=True):
        _same(_np(a)[:, sl], b, f"slot {d} traj.{f}")
    _same(_np(last)[sl], want_on.last_value, f"slot {d} last_value")
    _same(_np(final_obs)[sl], want_on.final_obs, f"slot {d} final_obs")
    for f in ("x", "x_dot", "theta", "theta_dot", "t"):
        _same(_np(getattr(final_env, f))[sl],
              getattr(want_on.final_env, f), f"slot {d} final_env.{f}")
    (est, obs), vtraj = got_value
    (west, wobs), wtraj = want_value
    _same(_np(obs)[sl], wobs, f"slot {d} value obs")
    for f in ("x", "x_dot", "theta", "theta_dot", "t"):
        _same(_np(getattr(est, f))[sl], getattr(west, f),
              f"slot {d} value env.{f}")
    for i, (a, b) in enumerate(zip(vtraj, wtraj, strict=True)):
        _same(_np(a)[:, sl], b, f"slot {d} value traj[{i}]")


# ---------------------------------------------------------------------------
# one rank (this process)
# ---------------------------------------------------------------------------


def test_host_mesh_and_its_banner_are_the_references():
    mesh = tmesh.make_host_mesh(device=CPU)
    assert tmesh.describe(mesh) == jmesh.describe(jmesh.make_host_mesh(1)) \
        == "mesh {'data': 1, 'model': 1} (1 devices)"
    assert sharding.data_axes(mesh) == ("data",)
    assert sharding.data_axis_size(mesh) == 1
    assert sharding.slot_index(mesh) == 0
    jm = jmesh.make_host_mesh(1)
    from repro.distributed import sharding as jsh
    for extra, bs in ((1, None), (2, 8), (0, 3)):
        assert sharding.batch_spec(mesh, extra, bs) == \
            tuple(jsh.batch_spec(jm, extra, bs))
    with pytest.raises(ValueError, match="exposes 1 device"):
        tmesh.make_host_mesh(2, device=CPU)
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh(device=CPU)


def test_one_rank_shard_map_is_the_identity():
    mesh = tmesh.make_host_mesh(device=CPU)
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    tree = {"a": x, "b": (x[:, 0], torch.arange(4, dtype=torch.int16))}
    for got, want in zip(tree_leaves(sharding.gather_rows(
            sharding.local_rows(tree, mesh), mesh)), tree_leaves(tree),
            strict=True):
        _same(got, want)
    _same(sharding.psum(x, mesh), x)
    _same(sharding.pmax(x, mesh), x)
    assert tal.slot_keys(x, 1)[0] is not None
    _same(tal.slot_keys(x, 1)[0], x)
    _same(tal.slot_key(x, 1, 2, dim=0), x[2:])


def test_one_rank_collects_are_the_unsharded_and_the_references(fleet):
    """At one rank ``collect_sharded``/``collect_value_sharded`` equal
    the port's ``collect``/``collect_value`` bitwise on every leaf, and
    the reference's one-device collects (its sharded collect at one
    device is its collect under ``fold_in(key, 0)``, which
    tests/test_distributed_rl.py holds)."""
    port, (want_on, want_value) = fleet
    port = slot0(port)
    mesh = tmesh.make_host_mesh(device=CPU)
    env = tcp.make()
    args = (port["packed"], env, tnets.mlp_ac_apply, tpolicy.FXP8,
            port["noise"], port["est"], port["obs"], T)
    got = tal.collect_sharded(*args, mesh)
    for a, b in zip(tree_leaves(tuple(got)),
                    tree_leaves(tuple(tal.collect(*args))), strict=True):
        _same(a, b)
    agent = tinf.make_value_agent("dqn", env.spec, device=CPU)
    vargs = (port["value_packed"], env, agent.behave, tpolicy.FXP8,
             lambda t: (port["actions"][t], port["uniforms"][t]),
             port["value_est"], port["value_obs"], T, EPS)
    vgot = tal.collect_value_sharded(*vargs, mesh)
    for a, b in zip(tree_leaves(vgot), tree_leaves(tal.collect_value(*vargs)),
                    strict=True):
        _same(a, b)
    assert_slot(tuple(got), vgot, _slot(want_on, 0), _slot(want_value, 0), 0)


def per_slot_collects(port, n_slots):
    """The port's one-device collects of each slot's envs with its
    share of the global draws, merged along the env axis: the program
    the sharded fleet runs, in one process."""
    env = tcp.make()
    parts = [tal.collect(port["packed"], env, tnets.mlp_ac_apply,
                         tpolicy.FXP8, tal.slot_key(port["noise"], d,
                                                    n_slots, dim=1),
                         tal.slot_key(port["est"], d, n_slots),
                         tal.slot_key(port["obs"], d, n_slots), T)
             for d in range(n_slots)]
    merged, mask = tal.merge_results(parts, torch.ones(n_slots,
                                                       dtype=torch.bool))
    agent = tinf.make_value_agent("dqn", env.spec, device=CPU)
    vparts = [tal.collect_value(
        port["value_packed"], env, agent.behave, tpolicy.FXP8,
        lambda t, d=d: tal.slot_key((port["actions"][t],
                                     port["uniforms"][t]), d, n_slots),
        tal.slot_key(port["value_est"], d, n_slots),
        tal.slot_key(port["value_obs"], d, n_slots), T, EPS)
        for d in range(n_slots)]
    value = ((tal._zip_map(lambda *x: torch.cat(x), [p[0][0] for p in vparts]),
              torch.cat([p[0][1] for p in vparts])),
             tuple(torch.cat([p[1][i] for p in vparts], dim=1)
                   for i in range(6)))
    return parts, merged, mask, value


def test_fleet_mask_and_merge_results():
    m = tal.fleet_mask(torch.tensor([True, False, True]), 4)
    assert m.tolist() == [1.0] * 4 + [0.0] * 4 + [1.0] * 4
    port, _ = fleet_inputs(2)
    parts = per_slot_collects(port, 2)[0]
    merged, mask = tal.merge_results(parts, torch.tensor([True, False]))
    for i, leaf in enumerate(tree_leaves(tuple(merged))):
        pieces = [tree_leaves(tuple(p))[i] for p in parts]
        dim = 1 if leaf.dim() > 1 and leaf.shape[0] == T else 0
        _same(leaf, torch.cat(pieces, dim=dim))
    assert mask.tolist() == [1.0] * B_SLOT + [0.0] * B_SLOT
    cfg = tal.ActorLearnerConfig()
    assert cfg == tal.ActorLearnerConfig(**vars(jal.ActorLearnerConfig()))


def test_uneven_envs_and_meshes_without_data_axes_raise():
    mesh = tmesh.make_host_mesh(device=CPU)
    port = {"packed": None, "noise": torch.zeros(T, 2, 2),
            "est": None, "obs": torch.zeros(2, 4)}

    class NoData:
        mesh_dim_names = ("model",)
    with pytest.raises(ValueError, match="no data axes"):
        tal.collect_sharded(port["packed"], tcp.make(), tnets.mlp_ac_apply,
                            tpolicy.FXP8, port["noise"], port["est"],
                            port["obs"], T, NoData())
    with pytest.raises(ValueError, match="does not divide"):
        tal._check_fleet(_FakeMesh(8), 12)
    assert tal._check_fleet(mesh, 3) == 1


class _FakeMesh:
    """An (n, 1) mesh's names and shape, for the checks that need no
    group."""

    def __init__(self, n):
        self.mesh_dim_names = ("data", "model")
        self.mesh = torch.zeros(n, 1)


# ---------------------------------------------------------------------------
# the replay facade (slot-major, no ranks)
# ---------------------------------------------------------------------------


def _transitions(rng, n_slots, b):
    return (rng.normal(size=(n_slots, b, 4)).astype(np.float32),
            rng.integers(0, 2, (n_slots, b)).astype(np.int32),
            rng.normal(size=(n_slots, b)).astype(np.float32),
            rng.normal(size=(n_slots, b, 4)).astype(np.float32),
            (0.97 * (rng.random((n_slots, b)) > 0.1)).astype(np.float32))


def _reference_draws(kind, key, n_slots, n, state):
    """The draws the reference facade's ``sample`` makes from ``key``,
    slot by slot, as the port's global draws."""
    n_local = n // n_slots
    out = []
    for d, k in enumerate(jal.slot_keys(key, n_slots)):
        if kind == "per":
            out.append(np.asarray(jax.random.uniform(k, (n_local,))))
        else:
            size = int(np.asarray(state.size)[d])
            out.append(np.asarray(jax.random.randint(
                k, (n_local,), 0, max(size, 1))))
    return _t(np.concatenate(out))


@pytest.mark.parametrize("kind", ["uniform", "per"])
@pytest.mark.parametrize("n_slots", [1, 2, 8])
def test_sharded_replay_facade_against_the_reference(kind, n_slots):
    """Three adds (the third wrapping each slot's buffer), two samples
    and a priority write-back: every state leaf and batch column
    bitwise the reference's, with the reference's draws injected."""
    rng = np.random.default_rng(n_slots)
    cap, n = 16 * n_slots, 8 * n_slots
    jr = jsharded.make_sharded_replay(kind, n_slots, cap, (4,))
    tr = tsharded.make_sharded_replay(kind, n_slots, cap, (4,))
    # the reference's facade compiled (op by op it compiles each
    # primitive at each shape); the above-min_size samples are the same
    jadd, jupdate = jax.jit(jr.add), jax.jit(jr.update)
    jsample = jax.jit(jr.sample, static_argnums=(2,),
                      static_argnames=("min_size",))
    js, ts = jr.init(), tr.init()
    for b in (6, 7, 9):
        cols = _transitions(rng, n_slots, b)
        js = jadd(js, *(jnp.asarray(c) for c in cols))
        ts = tr.add(ts, *(_t(c) for c in cols))
    for a, b in zip(tree_leaves(ts), jax.tree.leaves(js), strict=True):
        _same(a, b)
    store = js.store if kind == "per" else js
    for i, beta in enumerate((0.4, 1.0)):
        key = jax.random.PRNGKey(10 + i)
        jb = jsample(js, key, n, min_size=4, beta=jnp.float32(beta))
        tb = tr.sample(ts, _reference_draws(kind, key, n_slots, n, store),
                       min_size=4, beta=beta)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            _same(tb[k], jb[k], f"{kind} n_slots={n_slots} batch[{k}]")
    td = rng.normal(size=(n_slots, n // n_slots)).astype(np.float32)
    js = jupdate(js, jb["indices"], jnp.asarray(td))
    ts = tr.update(ts, tb["indices"], _t(td))
    for (path, a), b in zip(leaves_with_path(ts), jax.tree.leaves(js),
                            strict=True):
        if kind == "per" and path[0] in (".tree", ".max_p"):
            # the written-back mass is (|td| + eps) ** alpha: each
            # library's pow, held as tests/test_torch_replay.py holds it
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)
        else:
            _same(a, b)
    with pytest.raises(ValueError, match="min_size"):
        tr.sample(tr.init(), _t(np.zeros(n, np.int64)), min_size=4)


def test_sharded_replay_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="does not divide evenly"):
        tsharded.make_sharded_replay("uniform", 3, 16, (4,))
    with pytest.raises(ValueError, match="n_slots must be"):
        tsharded.make_sharded_replay("uniform", 0, 16, (4,))
    tr = tsharded.make_sharded_replay("uniform", 2, 16, (4,))
    with pytest.raises(ValueError, match="batch size 3"):
        tr.sample(tr.init(), _t(np.zeros(3, np.int64)))


def test_per_global_weights_and_normalize():
    """The base ``N * probs / n_slots`` bitwise; the weights, its power
    ``-beta``, within one ulp (each library's pow: 4 of these 120
    differ by one ulp); the normalization bitwise."""
    rng = np.random.default_rng(3)
    probs = rng.uniform(1e-4, 0.3, (8, 5)).astype(np.float32)
    for size, beta, n in ((1000, 0.4, 8), (0, 1.0, 1), (37, 0.7, 4)):
        jw = jsharded.per_global_weights(jnp.asarray(probs), jnp.int32(size),
                                         jnp.float32(beta), n)
        tw = tsharded.per_global_weights(_t(probs), torch.tensor(size,
                                         dtype=torch.int32), beta, n)
        _same(tsharded.per_global_weights(_t(probs), size, -1.0, n),
              jsharded.per_global_weights(jnp.asarray(probs), size,
                                          jnp.float32(-1.0), n))
        np.testing.assert_array_max_ulp(_np(tw), np.asarray(jw), maxulp=1)
        _same(tsharded.normalize_weights(_t(jw), _t(jw).max()),
              jsharded.normalize_weights(jw, jnp.max(jw)))


def test_compression_ratio_is_the_references():
    for bits in (4, 8, 16, 32):
        for n in (2, 8, 256):
            for s in ("gather", "psum"):
                assert tcomp.compression_ratio(bits, n, s) == \
                    jcomp.compression_ratio(bits, n, s)


def test_one_rank_compression_is_exact():
    """At one rank the compressed mean is the codes times the scale and
    the error the residual; bits 32 is ``g`` itself."""
    mesh = tmesh.make_host_mesh(device=CPU)
    g = torch.randn(5, 7, generator=torch.Generator().manual_seed(1))
    for strategy in ("gather", "psum"):
        mean, err = tcomp.compressed_psum_mean(g, mesh, 8, None, strategy)
        q, scale = tcomp.shared_codes(g, mesh, 8)
        _same(mean, q * scale)
        _same(err, g - q * scale)
        mean, err = tcomp.compressed_psum_mean(g, mesh, 32, None, strategy)
        _same(mean, g)
        _same(err, torch.zeros_like(g))


# ---------------------------------------------------------------------------
# eight ranks: one launch, then the checks of its results
# ---------------------------------------------------------------------------


def _value_cases():
    """The sharded value updates: (name, algo, env, alive)."""
    live = [True] * N_RANKS
    dead = list(live)
    dead[3] = False
    return [("dqn", "dqn", "cartpole", live),
            ("dqn_dead", "dqn", "cartpole", dead),
            ("qrdqn", "qrdqn", "cartpole", live),
            ("ddpg", "ddpg", "pendulum", live)]


LEARN_START = 16


def _smoothing_key(d):
    return jax.random.PRNGKey(100 + d)


def value_case_inputs(algo, env_name):
    """The reference agent (params, target) and one batch a slot."""
    spec = jinf.build_env(env_name, "mlp").spec
    agent = jinf.make_value_agent(algo, spec, jax.random.PRNGKey(0),
                                  learn_start=LEARN_START)
    target = jinf.make_value_agent(algo, spec, jax.random.PRNGKey(1)).params
    rng = np.random.default_rng(len(algo))
    n_local = agent.cfg.batch_size // N_RANKS
    obs_dim = spec.obs_shape[0]
    batches = []
    for _ in range(N_RANKS):
        if algo == "ddpg":
            act = rng.uniform(-2, 2, (n_local, 1)).astype(np.float32)
        else:
            act = rng.integers(0, spec.action_space.n, n_local).astype(
                np.int32)
        batches.append({
            "obs": rng.normal(size=(n_local, obs_dim)).astype(np.float32),
            "actions": act,
            "rewards": rng.normal(size=n_local).astype(np.float32),
            "next_obs": rng.normal(size=(n_local, obs_dim)).astype(
                np.float32),
            "discounts": (0.99 ** 3 * (rng.random(n_local) > 0.2)).astype(
                np.float32)})
    # the critic's target smoothing normals: slot d's are the reference's
    # draw from _smoothing_key(d)
    smoothing = np.concatenate([np.asarray(jax.random.normal(
        _smoothing_key(d), (n_local, 1))) for d in range(N_RANKS)])
    as_np = lambda t: jax.tree.map(np.asarray, unbox(t))  # noqa: E731
    return agent, as_np(agent.params), as_np(target), batches, smoothing


@pytest.fixture(scope="module")
def eight():
    """Every eight-rank check in one launch: each rank's results."""
    port, _ = fleet_inputs()
    rng = np.random.default_rng(11)
    gs = rng.normal(size=COMP_SHAPE).astype(np.float32)
    gs[1, 5] *= 40.0              # one slot's scale dominates step 1
    jobs = {"fleet": ("fleet_collects", port),
            "comp": ("compressed_means", dict(gs=gs, cases=COMP_CASES,
                                              steps=COMP_SHAPE[0]))}
    for name, algo, env_name, alive in _value_cases():
        _, params, target, batches, smoothing = value_case_inputs(
            algo, env_name)
        jobs[name] = ("value_update", dict(
            algo=algo, env_name=env_name, params=params, target=target,
            batches=batches, alive=alive, smoothing=smoothing, lr=1e-3,
            learn_start=LEARN_START))
    out = run_ranks(checks.suite, N_RANKS, jobs, deadline_s=240)
    return {"ranks": out, "gs": gs}


def test_eight_ranks_hold_the_same_global_results(eight):
    """Every rank holds the same gathered trajectories, means and
    updated params."""
    first = eight["ranks"][0]
    for r, res in enumerate(eight["ranks"][1:], 1):
        for name in ("fleet",) + tuple(c[0] for c in _value_cases()):
            for a, b in zip(jax.tree.leaves(res[name]),
                            jax.tree.leaves(first[name]), strict=True):
                _same(a, b, f"rank {r} {name}")
        for case, rows in res["comp"].items():
            for a, b in zip(rows, first["comp"][case], strict=True):
                _same(a["mean"], b["mean"], f"rank {r} {case} mean")
                if "scale" in a:
                    _same(a["scale"], b["scale"], f"rank {r} {case} scale")


def test_eight_slot_fleet_per_slot_against_the_reference(eight, fleet):
    """Each slot's trajectory, last values and final env state and obs
    (on-policy), and its value-family trajectory and final env state
    and obs, bitwise the reference's ``collect``/``collect_value`` on
    that slot's envs with that slot's draws."""
    got = eight["ranks"][0]["fleet"]
    on = checks_tuple(got["onpolicy"])
    want_on, want_value = fleet[1]
    for d in range(N_RANKS):
        assert_slot(on, got["value"], _slot(want_on, d),
                    _slot(want_value, d), d)


def checks_tuple(res):
    """A gathered ``RolloutResult`` as (traj, last, final_env, obs) with
    the port's field names."""
    from repro_torch.rl.rollout import Trajectory
    traj, last, final_env, final_obs = res
    return Trajectory(*traj), last, tcp.EnvState(*final_env), final_obs


def test_eight_slot_collect_is_the_per_slot_program(eight, fleet):
    """The sharded collects at eight ranks equal the port's one-device
    collects of each slot (its envs, its share of the global draws)
    merged in slot order, bitwise; and the sharded reset equals the
    unsharded one.  (Not the one-slot collect of all 16 envs: the fxp8
    actor requantizes each activation on its tensor's absmax, so a
    slot's codes depend on the slot's batch, as on the reference's
    devices.)"""
    got = eight["ranks"][0]["fleet"]
    _, merged, _, value = per_slot_collects(fleet[0], N_RANKS)
    for a, b in zip(jax.tree.leaves(got["onpolicy"]),
                    tree_leaves(tuple(merged)), strict=True):
        _same(a, b)
    for a, b in zip(jax.tree.leaves(got["value"]), tree_leaves(value),
                    strict=True):
        _same(a, b)
    reset = init_envs(tcp.make(), 3, N_RANKS * B_SLOT, CPU)
    for a, b in zip(jax.tree.leaves(got["reset"]), tree_leaves(reset),
                    strict=True):
        _same(a, b)


@pytest.mark.parametrize("bits,strategy", COMP_CASES)
def test_compressed_mean_against_the_reference_under_vmap(eight, bits,
                                                          strategy):
    """Two steps, the error buffer carried: each slot's codes, the
    shared scale, the error and the mean bitwise the reference's (the
    psum strategy's int32 sum and the gather strategy's slot-ordered sum
    of integers are exact; bits 32's fp32 slot-ordered sum is the order
    the reference's vmapped ``psum`` sums in, on these inputs)."""
    gs = eight["gs"]
    qmax = {4: 7.0, 8: 127.0, 16: 32767.0}.get(bits)

    def ref(g, e):
        mean, err = jcomp.compressed_psum_mean(g, "data", bits, e, strategy)
        if qmax is None:
            return mean, err, mean, mean
        corr = g + e
        amax = jax.lax.pmax(jnp.max(jnp.abs(corr)), "data")
        scale = jnp.maximum(amax, 1e-12) / qmax
        q = jnp.clip(jnp.round(corr / scale), -qmax, qmax)
        return mean, err, q, scale

    err = jnp.zeros(gs.shape[1:], jnp.float32)
    for k in range(gs.shape[0]):
        mean, err, q, scale = jax.vmap(ref, axis_name="data")(
            jnp.asarray(gs[k]), err)
        for r, res in enumerate(eight["ranks"]):
            got = res["comp"][f"{bits}-{strategy}"][k]
            what = f"bits {bits} {strategy} step {k} rank {r}"
            if qmax is None:
                _same(got["mean"], mean[r], what + " mean")
                _same(got["error"], err[r], what + " error")
                continue
            _same(got["codes"], q[r], what + " codes")
            _same(got["scale"], scale[r], what + " scale")
            _same(got["mean"], mean[r], what + " mean")
            _same(got["error"], err[r], what + " error")


def _close_to_max(got, want, what):
    """Each leaf within 1e-5 of its largest magnitude (PERF.md §2)."""
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                    strict=True):
        a, b = np.asarray(a), np.asarray(b)
        tol = 1e-5 * max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= tol, what


@pytest.mark.parametrize("case", [c[0] for c in _value_cases()])
def test_sharded_value_update_against_the_reference(eight, case):
    """One sharded update: the learner's gradient (the slot-ordered sum
    over the mesh divided by the live slots) against the reference's
    per-slot ``jax.grad`` summed over the live slots and divided by
    their count, within 1e-5 of each leaf's largest entry; AdamW given
    that gradient within atol 1e-5 + rtol 1e-4 of the reference's."""
    _, name_algo, env_name, alive = next(c for c in _value_cases()
                                         if c[0] == case)
    agent, params, target, batches, smoothing = value_case_inputs(
        name_algo, env_name)
    got = eight["ranks"][0][case]
    cfg = agent.cfg
    n_live = sum(alive)
    n_local = cfg.batch_size // N_RANKS
    jp = jax.tree.map(jnp.asarray, params)
    jt = jax.tree.map(jnp.asarray, target)

    stacked = {k: jnp.stack([b[k] for b in batches]) for k in batches[0]}
    stacked["weight"] = jnp.repeat(jnp.asarray(alive, jnp.float32)[:, None],
                                   n_local, axis=1)
    keys = jnp.stack([_smoothing_key(d) for d in range(N_RANKS)])

    def jbatch(d):
        return {k: v[d] for k, v in stacked.items()}

    def mean_of(grad_fn):
        """``grad_fn(d)``'s sum over the live slots over their count,
        each slot's gradient from one compiled program vmapped over the
        slots."""
        per_slot = jax.jit(jax.vmap(grad_fn))(jnp.arange(N_RANKS))
        return jax.tree.map(
            lambda g: sum(g[d] for d in range(N_RANKS) if alive[d]) / n_live,
            per_slot)

    ocfg = JAdamWConfig(weight_decay=0.0, max_grad_norm=10.0)

    def adamw(g, p):
        p2, s2, _ = jadamw_update(jax.tree.map(jnp.asarray, g),
                                  jadamw_init(p), p, jconstant(1e-3), ocfg)
        return p2, s2

    if name_algo == "ddpg":
        want_c = mean_of(lambda d: jax.grad(
            jval.ddpg_critic_loss_td, has_aux=True)(
            jp["critic"], jt["critic"], jt["actor"], agent.critic_apply,
            agent.act, jbatch(d), cfg, keys[d])[0])
        _close_to_max(got["grads"]["critic"], want_c, "critic grads")
        new_c = jax.tree.map(jnp.asarray, got["params"]["critic"])
        want_a = mean_of(lambda d: jax.grad(jval.ddpg_actor_loss)(
            jp["actor"], new_c, agent.critic_apply, agent.act, jbatch(d)))
        _close_to_max(got["grads"]["actor"], want_a, "actor grads")
        for sub in ("critic", "actor"):
            p2, s2 = adamw(got["grads"][sub], jp[sub])
            for a, b in zip(jax.tree.leaves((got["params"][sub],
                                             got["opt"][sub]["mu"],
                                             got["opt"][sub]["nu"])),
                            jax.tree.leaves((p2, s2["mu"], s2["nu"])),
                            strict=True):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        return
    want = mean_of(lambda d: jax.grad(agent.loss_fn, has_aux=True)(
        jp, jt, lambda p, o: agent.q_apply(p, o, None), jbatch(d), cfg)[0])
    _close_to_max(got["grads"]["q"], want, f"{case} grads")
    p2, s2 = adamw(got["grads"]["q"], jp)
    for a, b in zip(jax.tree.leaves((got["params"], got["opt"]["mu"],
                                     got["opt"]["nu"])),
                    jax.tree.leaves((p2, s2["mu"], s2["nu"])), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert int(got["opt"]["count"]) == 1

