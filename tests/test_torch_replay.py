"""The port's replay subsystem against the JAX package: the uniform
circular buffer, the sum tree and prioritized replay.

Both packages take the same adds and the same draws (the slots or
stratification uniforms the reference draws from its key, passed to the
port).  Bars: uniform buffers byte for byte after the same adds
(including a batch larger than the capacity) and the same batches;
sum-tree nodes bitwise after random updates with duplicate slots of
different values (last occurrence wins), every internal node the bitwise
sum of its children; ``find`` exact, queries on interval boundaries and
zero-mass leaves included; PER's max-priority insertion and tree
bitwise, its importance weights and probabilities within rtol=1e-6 (a
``pow`` of each library); the underfill mask and the eager raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl.replay import per as jper
from repro.rl.replay import sum_tree as jtree
from repro.rl.replay import uniform as juni
from repro.rl.replay.base import make_replay as jmake_replay
from repro_torch.rl.replay import make_replay, replay_size
from repro_torch.rl.replay import per as tper
from repro_torch.rl.replay import sum_tree as ttree
from repro_torch.rl.replay import uniform as tuni

OBS = (3, 2)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def _batch(rng, n, act_shape=(), act_dtype=np.int32):
    obs = rng.normal(size=(n,) + OBS).astype(np.float32)
    act = (rng.integers(0, 5, (n,) + act_shape).astype(act_dtype)
           if act_dtype == np.int32 else
           rng.normal(size=(n,) + act_shape).astype(np.float32))
    return (obs, act, rng.normal(size=n).astype(np.float32),
            rng.normal(size=(n,) + OBS).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32))


def assert_internal_sums_exact(tree):
    nodes = _np(tree)
    L = len(nodes) // 2
    left, right = nodes[2:2 * L:2], nodes[3:2 * L:2]
    np.testing.assert_array_equal(nodes[1:L], left + right)


# ---------------------------------------------------------------------------
# uniform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act_shape,act_dtype", [((), np.int32),
                                                 ((1,), np.float32)])
def test_uniform_buffers_byte_identical(act_shape, act_dtype):
    """Adds of 5, 7, 13 (past the 16-slot capacity, wrapping), then 40
    (more than the capacity: the prefix is dropped), then 3: every field
    byte for byte after each add, and the same slots gather the same
    batch."""
    cap = 16
    rng = np.random.default_rng(0)
    jdt = jnp.int32 if act_dtype == np.int32 else jnp.float32
    tdt = torch.int32 if act_dtype == np.int32 else torch.float32
    jb = juni.replay_init(cap, OBS, act_shape, jdt)
    tb = tuni.replay_init(cap, OBS, act_shape, tdt)
    for b in (5, 7, 13, 40, 3):
        cols = _batch(rng, b, act_shape, act_dtype)
        jb = juni.replay_add(jb, *(jnp.asarray(c) for c in cols))
        tb = tuni.replay_add(tb, *(_t(c) for c in cols))
        for f, got, want in zip(tb._fields, tb, jb, strict=True):
            _same(got, want, f"after a batch of {b}: {f}")
    key = jax.random.PRNGKey(7)
    jbatch = juni.replay_sample(jb, key, 10)
    slots = jax.random.randint(key, (10,), 0, jnp.maximum(jb.size, 1))
    tbatch = tuni.replay_sample(tb, _t(slots))
    for k in ("obs", "actions", "rewards", "next_obs", "discounts",
              "weight"):
        _same(tbatch[k], jbatch[k], k)
    np.testing.assert_array_equal(_np(tbatch["indices"]),
                                  _np(jbatch["indices"]))


def test_write_slots_drops_the_prefix():
    for ptr, cap, b in ((3, 8, 5), (6, 8, 5), (2, 8, 8), (5, 8, 19)):
        jd, jidx, jnew = juni.write_slots(jnp.int32(ptr), cap, b)
        td, tidx, tnew = tuni.write_slots(torch.tensor(ptr, dtype=torch.int32),
                                          cap, b)
        assert td == jd
        np.testing.assert_array_equal(_np(tidx), _np(jidx))
        assert int(tnew) == int(jnew) and tnew.dtype == torch.int32
        assert len(set(_np(tidx).tolist())) == len(_np(tidx))


def test_underfill_raises_eagerly_and_masks_in_the_iteration():
    """A direct sample below ``min_size`` raises as the reference's eager
    call does; inside the iteration (``masked``) the weights are 0, as
    the reference's jitted sample gives them."""
    rng = np.random.default_rng(1)
    cols = _batch(rng, 6)
    jb = juni.replay_add(juni.replay_init(32, OBS), *map(jnp.asarray, cols))
    tb = tuni.replay_add(tuni.replay_init(32, OBS), *map(_t, cols))
    slots = torch.tensor([0, 5, 3])
    with pytest.raises(ValueError, match="min_size=8"):
        tuni.replay_sample(tb, slots, min_size=8)
    with pytest.raises(ValueError, match="min_size=8"):
        juni.replay_sample(jb, jax.random.PRNGKey(0), 3, min_size=8)
    masked = tuni.replay_sample(tb, slots, min_size=8, masked=True)
    want = jax.jit(lambda b, k: juni.replay_sample(b, k, 3, min_size=8))(
        jb, jax.random.PRNGKey(0))
    _same(masked["weight"], want["weight"])
    assert float(masked["weight"].sum()) == 0.0
    ok = tuni.replay_sample(tb, slots, min_size=6, masked=True)
    assert _np(ok["weight"]).tolist() == [1.0, 1.0, 1.0]
    pst = tper.per_add(tper.per_init(32, OBS), *map(_t, cols))
    jst = jper.per_add(jper.per_init(32, OBS), *map(jnp.asarray, cols))
    u = torch.rand(4, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="min_size=8"):
        tper.per_sample(pst, u, min_size=8)
    pm = tper.per_sample(pst, u, min_size=8, masked=True)
    assert float(pm["weight"].abs().sum()) == 0.0
    assert int(replay_size(pst)) == int(jper.PERState(*jst).store.size) == 6


# ---------------------------------------------------------------------------
# sum tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [1, 2, 23, 64])
def test_sum_tree_updates_with_duplicates_bitwise(capacity):
    """Random batches of updates, each with duplicate slots carrying
    different values: the whole tree (node 0's parked writes included)
    bitwise the reference's, internal sums exact, the last occurrence
    of a slot kept."""
    rng = np.random.default_rng(capacity)
    jt, tt = jtree.init(capacity), ttree.init(capacity)
    assert tt.shape == jt.shape and tt.dtype == torch.float32
    for _ in range(6):
        m = int(rng.integers(1, 2 * capacity + 2))
        idx = rng.integers(0, capacity, m).astype(np.int32)
        vals = rng.uniform(0.0, 10.0, m).astype(np.float32)
        with jax.disable_jit():
            jt = jtree.update(jt, jnp.asarray(idx), jnp.asarray(vals))
        tt = ttree.update(tt, _t(idx), _t(vals))
        _same(tt, jt)
        assert_internal_sums_exact(tt)
        last = {int(i): v for i, v in zip(idx, vals, strict=True)}
        got = _np(ttree.get(tt, torch.tensor(sorted(last))))
        np.testing.assert_array_equal(got, [last[i] for i in sorted(last)])


def test_sum_tree_find_exact_on_boundaries_and_zero_mass():
    """Queries at every interval boundary, just below each, inside each,
    and at 0 land on the reference's leaves; zero-mass leaves are never
    reached; stratified draws give the same slots and masses."""
    mass = np.array([0.0, 1.5, 0.0, 0.0, 2.25, 0.5, 0.0, 3.0, 1.0, 0.0,
                     0.0, 0.125], np.float32)
    slots = np.arange(len(mass), dtype=np.int32)
    jt = jtree.update(jtree.init(len(mass)), jnp.asarray(slots),
                      jnp.asarray(mass))
    tt = ttree.update(ttree.init(len(mass)), _t(slots), _t(mass))
    _same(tt, jt)
    edges = np.cumsum(mass).astype(np.float32)
    u = np.concatenate([[0.0], edges[:-1], np.nextafter(edges, 0),
                        edges - 0.1, np.float32(edges[-1]) * np.linspace(
                            0, 0.999, 97)]).astype(np.float32)
    u = u[(u >= 0) & (u < edges[-1])]
    with jax.disable_jit():
        want = _np(jtree.find(jt, jnp.asarray(u)))
    got = _np(ttree.find(tt, _t(u)))
    np.testing.assert_array_equal(got, want)
    assert (mass[got] > 0).all()
    key = jax.random.PRNGKey(3)
    with jax.disable_jit():
        jidx, jm = jtree.stratified_sample(jt, key, 16)
    tidx, tm = ttree.stratified_sample(tt, _t(jax.random.uniform(key, (16,))))
    np.testing.assert_array_equal(_np(tidx), _np(jidx))
    _same(tm, jm)


def test_stratified_sample_guards_the_right_edge():
    """A uniform of 1 - 2^-24 in the last stratum stays below the total
    (the ``t * (1 - 1e-7)`` guard) and lands on the last leaf with
    mass."""
    mass = np.array([1.0, 2.0, 0.0, 0.0], np.float32)
    tt = ttree.update(ttree.init(4), torch.arange(4), _t(mass))
    u = torch.full((4,), 1.0 - 2 ** -24)
    idx, m = ttree.stratified_sample(tt, u)
    assert _np(idx).tolist()[-1] == 1 and (_np(m) > 0).all()


# ---------------------------------------------------------------------------
# prioritized replay
# ---------------------------------------------------------------------------

def _per_pair(cap, adds, seed=0):
    rng = np.random.default_rng(seed)
    js, ts = jper.per_init(cap, OBS), tper.per_init(cap, OBS)
    for b in adds:
        cols = _batch(rng, b)
        js = jper.per_add(js, *map(jnp.asarray, cols))
        ts = tper.per_add(ts, *map(_t, cols))
    return js, ts


def test_per_max_priority_insertion_and_refresh():
    """New slots enter at the running max priority; a refresh with
    duplicate slots of different TD errors writes ``(|td| + eps) **
    alpha`` (the last duplicate's), raises the max, and later inserts
    take it: tree bitwise, max within rtol=1e-6."""
    js, ts = _per_pair(24, (10,))
    _same(ts.tree, js.tree)
    idx = np.array([1, 4, 4, 7, 1, 9], np.int32)
    td = np.array([0.5, 3.0, 0.25, 1.5, 2.0, 0.0], np.float32)
    with jax.disable_jit():
        js = jper.per_update(js, jnp.asarray(idx), jnp.asarray(td), 0.6)
    ts = tper.per_update(ts, _t(idx), _t(td), 0.6)
    np.testing.assert_allclose(_np(ts.tree), _np(js.tree), rtol=1e-6)
    np.testing.assert_allclose(_np(ts.max_p), _np(js.max_p), rtol=1e-6)
    want = {1: 2.0, 4: 0.25, 7: 1.5, 9: 0.0}
    for slot, e in want.items():
        leaf = float(ttree.get(ts.tree, torch.tensor([slot]))[0])
        np.testing.assert_allclose(leaf, (e + tper.PRIORITY_EPS) ** 0.6,
                                   rtol=1e-6)
    rng = np.random.default_rng(5)
    cols = _batch(rng, 6)
    js = jper.per_add(js, *map(jnp.asarray, cols))
    ts = tper.per_add(ts, *map(_t, cols))
    new = _np(ttree.get(ts.tree, torch.arange(10, 16)))
    np.testing.assert_array_equal(new, np.full(6, _np(ts.max_p)))
    assert_internal_sums_exact(ts.tree)


@pytest.mark.parametrize("beta", [0.4, 0.7, 1.0])
def test_per_sample_weights(beta):
    """From the same tree and uniforms: slots exact, probabilities and
    max-normalized importance weights within rtol=1e-6, the batch
    columns byte for byte."""
    js, ts = _per_pair(40, (12, 9, 7), seed=2)
    idx = np.arange(0, 28, 2, dtype=np.int32)
    td = np.linspace(0, 4, len(idx)).astype(np.float32)
    with jax.disable_jit():
        js = jper.per_update(js, jnp.asarray(idx), jnp.asarray(td), 0.6)
    ts = tper.per_update(ts, _t(idx), _t(td), 0.6)
    ts = ts._replace(tree=_t(js.tree), max_p=_t(js.max_p))
    key = jax.random.PRNGKey(11)
    with jax.disable_jit():
        jb = jper.per_sample(js, key, 16, beta=jnp.float32(beta))
    tb = tper.per_sample(ts, _t(jax.random.uniform(key, (16,))), beta=beta)
    np.testing.assert_array_equal(_np(tb["indices"]), _np(jb["indices"]))
    for k in ("obs", "actions", "rewards", "next_obs", "discounts"):
        _same(tb[k], jb[k], k)
    for k in ("probs", "weight"):
        np.testing.assert_allclose(_np(tb[k]), _np(jb[k]), rtol=1e-6,
                                   err_msg=k)
    assert float(tb["weight"].max()) == 1.0


def test_per_sample_on_an_empty_buffer_returns_legal_slots():
    ts = tper.per_init(8, OBS)
    b = tper.per_sample(ts, torch.rand(4), masked=True)
    assert (_np(b["indices"]) == 0).all()
    assert np.isfinite(_np(b["weight"])).all()


def test_make_replay_facade():
    """The facade over both backends: shapes, draws in range, the
    uniform update an identity, PER's a refresh, and the reference's
    validation."""
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(0)
    for kind in ("uniform", "per"):
        rb = make_replay(kind, 32, OBS, (1,), torch.float32)
        jrb = jmake_replay(kind, 32, OBS, (1,), jnp.float32)
        state = rb.add(rb.init(), *map(_t, _batch(rng, 20, (1,),
                                                    np.float32)))
        jstate = jrb.add(jrb.init(), *map(jnp.asarray, _batch(
            np.random.default_rng(3), 20, (1,), np.float32)))
        assert int(replay_size(state)) == 20
        draws = rb.draw(gen, (64,), 20, "cpu")
        if kind == "uniform":
            assert draws.dtype == torch.int64
            assert 0 <= int(draws.min()) and int(draws.max()) < 20
        else:
            assert draws.dtype == torch.float32
            assert 0 <= float(draws.min()) and float(draws.max()) < 1
        b = rb.sample(state, draws[:8], min_size=4, beta=0.5)
        assert b["obs"].shape == (8,) + OBS and b["actions"].shape == (8, 1)
        after = rb.update(state, b["indices"], torch.ones(8))
        assert (after is state) == (kind == "uniform")
        assert rb.prioritized == jrb.prioritized == (kind == "per")
        assert type(jstate).__name__ == type(state).__name__
    with pytest.raises(ValueError, match="replay kind"):
        make_replay("ring", 8, OBS)
    with pytest.raises(ValueError, match="alpha"):
        make_replay("per", 8, OBS, alpha=1.5)
