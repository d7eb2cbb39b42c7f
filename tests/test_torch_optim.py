"""Optimizers of the PyTorch port against the JAX package
(``repro.optim``): the clip and finiteness guards, the schedules and
AdamW, given the same gradients.

fp32 reductions and the bias corrections' powers run in each library's
own order, so the bar is rtol=1e-6 (the leaves are taken in the same
sorted-key order on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.tree import tree_leaves

RTOL = 1e-6


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"torso": {"fc1": {"w": n(4, 8), "b": n(8)},
                      "fc2": {"w": n(8, 8), "b": n(8)}},
            "pi": {"w": n(8, 2), "b": n(2)}, "v": {"w": n(8, 1), "b": n(1)}}


def _j(tree):
    return {k: _j(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _close(got, want, rtol=RTOL):
    """Every leaf of a torch tree against the numpy leaves of a JAX
    tree, in the same order."""
    import jax
    want = [np.asarray(x) for x in jax.tree.leaves(want)]
    got = [x.detach().numpy() for x in tree_leaves(got)]
    assert len(got) == len(want)
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_global_norm_and_clip(scale):
    g = _tree(1, scale)
    jn = joptim.global_norm(_j(g))
    tn = toptim.global_norm(from_numpy_tree(g, "cpu"))
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    jc, jnorm = joptim.clip_by_global_norm(_j(g), 0.5)
    tc, tnorm = toptim.clip_by_global_norm(from_numpy_tree(g, "cpu"), 0.5)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=RTOL)
    _close(tc, jc)


def test_zero_nonfinite():
    g = _tree(2)
    g["pi"]["w"][0, 1] = np.nan
    g["v"]["b"][0] = np.inf
    jc, jflag = joptim.zero_nonfinite(_j(g))
    tc, tflag = toptim.zero_nonfinite(from_numpy_tree(g, "cpu"))
    assert bool(tflag) and bool(jflag)
    _close(tc, jc, rtol=0)
    _, clean = toptim.zero_nonfinite(from_numpy_tree(_tree(3), "cpu"))
    assert not bool(clean)


@pytest.mark.parametrize("name,args", [("constant", (3e-3,)),
                                       ("linear_warmup", (1e-3, 10)),
                                       ("warmup_cosine", (1e-3, 10, 100)),
                                       ("inverse_sqrt", (1e-3, 10))])
def test_schedules(name, args):
    jf, tf = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for step in (0, 1, 5, 10, 57, 100, 250):
        want = jf(jnp.asarray(step, jnp.int32))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("cfg", [
    dict(weight_decay=0.0, max_grad_norm=0.5),      # the PPO learner's
    dict(),                                         # the defaults
    dict(weight_decay=0.01, max_grad_norm=None)])
def test_adamw_three_steps(cfg):
    """Three AdamW steps from the same params and gradients: params,
    moments, count and stats within rtol=1e-6; the state keeps the
    reference's layout (fp32 moments, an int32 count)."""
    params = _tree(4)
    jp, tp = _j(params), from_numpy_tree(params, "cpu")
    js, ts = joptim.adamw_init(jp), toptim.adamw_init(tp)
    assert ts["count"].dtype == torch.int32 and ts["count"].shape == ()
    jcfg, tcfg = joptim.AdamWConfig(**cfg), toptim.AdamWConfig(**cfg)
    sched_j, sched_t = joptim.constant(3e-3), toptim.constant(3e-3)
    for i in range(3):
        g = _tree(10 + i, scale=[0.1, 2.0, 1e-4][i])
        jp, js, jstats = joptim.adamw_update(_j(g), js, jp, sched_j, jcfg)
        with torch.no_grad():
            tp, ts, tstats = toptim.adamw_update(
                from_numpy_tree(g, "cpu"), ts, tp, sched_t, tcfg)
        _close(tp, jp)
        _close(ts["mu"], js["mu"])
        _close(ts["nu"], js["nu"])
        assert int(ts["count"]) == int(js["count"]) == i + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=RTOL)
        assert int(tstats["nonfinite"]) == int(jstats["nonfinite"]) == 0
