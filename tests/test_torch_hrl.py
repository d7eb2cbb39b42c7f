"""The E2HRL agent (FC-HRL and LSTM-HRL) of the PyTorch port against the
JAX package, at a small width (16x16x3 frames, conv channels (4, 8),
sub-goal hidden 8).

Weights are the reference's, carried across with ``from_numpy_tree``.
Under ``FXP8.replace(act_backend="cordic")`` (the ``xla`` branch) logits
and values are bitwise the reference's, and so are those of packed
FC-HRL.  At ``backend="pallas"`` the port is held at rtol=atol=1e-6
against the reference's functions composed in the test: ``embed`` at
``xla`` (the reference's Pallas and XLA Q-Conv routes differ by ulps
that its per-tensor requantization grows, and the port's Q-Conv is the
XLA route's program), then ``subgoal`` and the heads at ``pallas``
(Pallas Q-MAC and Q-LSTM in interpret mode).  Softmax probabilities are
held at rtol=1e-6 (row sums in another order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import e2hrl as jcfg
from repro.core import policy as jpolicy
from repro.core import quantizer as jquant
from repro.models import hrl as jhrl
from repro.nn.linear import linear_apply as jlinear
from repro.nn.module import unbox
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.configs import e2hrl as tcfg
from repro_torch.core import policy as tpolicy
from repro_torch.core import quantizer as tquant
from repro_torch.models import hrl as thrl
from repro_torch.tree import leaves_with_path

SMALL = dict(obs_shape=(16, 16, 3), conv_channels=(4, 8), subgoal_hidden=8,
             n_actions=4)
CORDIC8 = (jpolicy.FXP8.replace(act_backend="cordic"),
           tpolicy.FXP8.replace(act_backend="cordic"))
PALLAS = (CORDIC8[0].with_backend("pallas"), CORDIC8[1].with_backend("pallas"))


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@functools.cache
def _make(kind):
    """(kind, jax cfg, port cfg, jax params, port params, obs)."""
    jc = jcfg.HRLConfig(subgoal_kind=kind, **SMALL)
    tc = tcfg.HRLConfig(subgoal_kind=kind, **SMALL)
    jp = unbox(jhrl.init(jax.random.PRNGKey(0), jc))
    tp = from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    window = (3,) if kind == "lstm" else ()
    obs = np.random.default_rng(1).uniform(
        size=(5,) + window + SMALL["obs_shape"]).astype(np.float32)
    return kind, jc, tc, jp, tp, obs


@pytest.fixture(params=["fc", "lstm"])
def agent(request):
    return _make(request.param)


def _ref_apply(jp, obs, jc, jpol):
    """The reference's ``apply`` op by op (``lax.scan`` included: XLA
    fuses a compiled step's multiply-adds and rounds them otherwise)."""
    with jax.disable_jit():
        logits, value, _ = jhrl.apply(jp, jnp.asarray(obs), jc, jpol)
    return np.asarray(logits), np.asarray(value)


@pytest.mark.parametrize("name", ["CONFIG", "CONFIG_LSTM"])
def test_configs_equal_the_reference(name):
    assert dataclasses.asdict(getattr(tcfg, name)) == \
        dataclasses.asdict(getattr(jcfg, name))
    assert [f.name for f in dataclasses.fields(tcfg.HRLConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.HRLConfig)]


@pytest.mark.parametrize("kind", ["fc", "lstm"])
@pytest.mark.parametrize("full", [False, True])
def test_init_gives_the_reference_tree(kind, full):
    if full:
        jc = jcfg.HRLConfig(subgoal_kind=kind)
        tc = tcfg.HRLConfig(subgoal_kind=kind)
        jp = from_numpy_tree(jax.tree.map(
            np.asarray, unbox(jhrl.init(jax.random.PRNGKey(0), jc))), "cpu")
    else:
        _, jc, tc, _, jp, _ = _make(kind)
    tp = thrl.init(torch.Generator().manual_seed(0), tc, device="cpu")
    want = [(p, tuple(x.shape), x.dtype) for p, x in leaves_with_path(jp)]
    got = [(p, tuple(x.shape), x.dtype) for p, x in leaves_with_path(tp)]
    assert got == want
    assert isinstance(tp["stem"]["convs"], list)
    assert thrl._flat_dim(tc) == jhrl._flat_dim(jc)


def test_weights_cross_with_from_numpy_tree(agent):
    kind, _, _, jp, tp, _ = agent
    want = jax.tree_util.tree_leaves_with_path(jp)
    got = leaves_with_path(tp)
    assert len(got) == len(want)
    assert isinstance(tp["stem"]["convs"], list)
    flat = {"/".join(map(str, p)): x for p, x in got}
    for path, w in want:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        np.testing.assert_array_equal(flat[key].numpy(), np.asarray(w))


def test_apply_bitwise_under_cordic_fxp8(agent):
    kind, jc, tc, jp, tp, obs = agent
    want_logits, want_value = _ref_apply(jp, obs, jc, CORDIC8[0])
    logits, value, state = thrl.apply(tp, torch.from_numpy(obs), tc,
                                      CORDIC8[1])
    _bits_equal(logits.numpy(), want_logits)
    _bits_equal(value.numpy(), want_value)
    assert (state is None) == (kind == "fc")
    want_p = np.asarray(jhrl.action_probs(jnp.asarray(want_logits),
                                          CORDIC8[0]))
    got_p = thrl.action_probs(logits, CORDIC8[1]).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=1e-6, atol=0)


def test_packed_fc_hrl_bitwise():
    _, jc, tc, jp, tp, obs = _make("fc")
    jq = jquant.quantize_params(jp, jpolicy.FXP8)
    tq = tquant.quantize_params(tp, tpolicy.FXP8)
    want_logits, want_value = _ref_apply(jq, obs, jc, CORDIC8[0])
    logits, value, _ = thrl.apply(tq, torch.from_numpy(obs), tc, CORDIC8[1])
    _bits_equal(logits.numpy(), want_logits)
    _bits_equal(value.numpy(), want_value)


def test_pallas_against_the_reference_composed(agent):
    kind, jc, tc, jp, tp, obs = agent
    o = jnp.asarray(obs)
    if kind == "lstm":
        b, k = obs.shape[:2]
        e_seq = jhrl.embed(jp, o.reshape((b * k,) + o.shape[2:]), jc,
                           CORDIC8[0]).reshape(b, k, -1)
        e = e_seq[:, -1]
        g, _ = jhrl.subgoal(jp, e_seq, jc, PALLAS[0])
    else:
        e = jhrl.embed(jp, o, jc, CORDIC8[0])
        g, _ = jhrl.subgoal(jp, e, jc, PALLAS[0])
    feat = jnp.concatenate([e, g], axis=-1)
    want_logits = np.asarray(jlinear(jp["action"]["fc"], feat, PALLAS[0]))
    want_value = np.asarray(jlinear(jp["value"], feat, PALLAS[0])[..., 0])
    logits, value, _ = thrl.apply(tp, torch.from_numpy(obs), tc, PALLAS[1])
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(value.numpy(), want_value, rtol=1e-6,
                               atol=1e-6)
    want_p = np.asarray(jhrl.action_probs(jnp.asarray(want_logits),
                                          PALLAS[0]))
    got_p = thrl.action_probs(logits, PALLAS[1]).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=1e-6, atol=1e-6)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        thrl.init(torch.Generator().manual_seed(0),
                  tcfg.HRLConfig(**SMALL))
