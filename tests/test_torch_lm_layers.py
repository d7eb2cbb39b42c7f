"""The LM layers of the PyTorch port (norms, RoPE, FFNs, embeddings,
attention with its KV cache, the LM head) against the JAX package, at
small widths.

The same numpy inputs and params go to both packages; the reference
runs op by op (``jax.disable_jit()``: compiled XLA fuses multiply-adds
and rounds otherwise).  Tolerances:

* integer payloads, int8 KV payloads and scales, masks: bitwise;
* fp32 outputs: ``rtol=1e-6`` with an absolute part of 1e-6 of the
  output's largest magnitude (``close``).  The two libraries sum a
  contraction in another order and their ``exp``, ``rsqrt``, ``sin``
  and ``cos`` differ in the last bit, so an entry near zero carries the
  rounding of the larger terms that cancel into it;
* with the ``one_library`` fixture the reference's library primitives
  (``jnp.einsum``, ``jax.nn.softmax``, ``jax.lax.rsqrt``, ``jnp.sin``,
  ``jnp.cos``, the sigmoid of its SiLU, ``jnp.tanh`` (GELU's),
  ``jnp.mean`` and ``jnp.var`` (LayerNorm's), ``jnp.power`` to a Python
  float (LayerNorm's ``** -0.5``), ``jnp.exp`` and ``jnp.log`` (the
  sinusoidal positions'), and for the ssm and hybrid layers
  ``jax.nn.silu``, ``jax.nn.sigmoid``, ``jax.nn.softplus``,
  ``jnp.cumsum`` and the depthwise ``jax.lax.conv_general_dilated`` of
  ``causal_conv1d_apply``, and for the MoE layer its router's fp32
  product, ``jnp.sum`` over the last axis (the gates' renormalisation)
  and the array method's ``sum(axis=1)`` of a 3-D array (the combine's
  sum over k)) are computed by the port's
  (``repro_torch.core.exact``: through fp64, rounded once), and the
  layer under an int8 policy is then held bitwise: with each library's
  own last bits an activation can land on the other side of a rounding
  tie and move an int8 code.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax._src.numpy as jnp_src
import jax._src.numpy.reductions as jreductions
import jax._src.numpy.ufuncs as jufuncs
import repro.core.vact as jvact
from repro.core import policy as jpolicy
from repro.core.fxp import QTensor as JQTensor
from repro.launch import serve as jserve
from repro.models import common as jcommon
from repro.nn import attention as jattn
from repro.nn import linear as jlinear
from repro.nn import mlp as jmlp
from repro.nn import moe as jmoe
from repro.nn import norm as jnorm
from repro.nn import rotary as jrotary
from repro.nn.module import unbox
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.core import exact
from repro_torch.core import vact as tvact
from repro_torch.core import policy as tpolicy
from repro_torch.core.fxp import QTensor
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.nn import attention as tattn
from repro_torch.nn import linear as tlinear
from repro_torch.nn import mlp as tmlp
from repro_torch.nn import norm as tnorm
from repro_torch.nn import rotary as trotary


# ---------------------------------------------------------------------------
# helpers shared with test_torch_lm_serve.py
# ---------------------------------------------------------------------------

def to_torch(a):
    """A numpy or jax array as a CPU tensor (bf16 kept as bf16)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(jnp.bfloat16)
    return t.numpy()


def carry(tree):
    """The reference's params as the port's CPU tree."""
    return from_numpy_tree(jax.tree.map(np.asarray, unbox(tree)), "cpu")


def bits_equal(got, want):
    got, want = np.ascontiguousarray(
        to_numpy(got) if isinstance(got, torch.Tensor) else got), \
        np.ascontiguousarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def close(got, want, rtol=1e-6, scale=1e-6):
    """fp32 agreement: ``rtol`` plus ``scale`` times the largest |want|
    (see the module docstring)."""
    if isinstance(got, torch.Tensor):
        got = to_numpy(got)
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()))


def _via_torch(orig, fn):
    """``orig`` computed by the torch function ``fn`` (also inside the
    reference's traced regions: ``jax.checkpoint`` traces even with jit
    disabled).  Under ``jax.grad`` its derivative is ``orig``'s own, at
    the same inputs (the training parity tests hold the reference's
    gradients so)."""
    def f(*args, **kw):
        def call(*a):
            return to_numpy(fn(*[to_torch(x) for x in a], **kw))

        def value(*a):
            if not any(isinstance(x, jax.core.Tracer) for x in a):
                return jnp.asarray(call(*a))
            shape = jax.eval_shape(lambda *b: orig(*b, **kw), *a)
            return jax.pure_callback(call, shape, *a)

        if not any(isinstance(a, jax.core.Tracer) for a in args):
            return value(*args)
        with_vjp = jax.custom_vjp(value)
        with_vjp.defvjp(
            lambda *a: (value(*a), a),
            lambda a, g: jax.vjp(lambda *b: orig(*b, **kw), *a)[1](g))
        return with_vjp(*args)
    return f


def _port_einsum(spec):
    def fn(*ts, preferred_element_type=None):
        dtype = None if preferred_element_type is None else torch.float32
        return exact.einsum(spec, *ts, dtype=dtype)
    return fn


def _port_softmax(t, axis=-1):
    assert axis == -1
    return tattn._softmax(t)


def _port_depthwise(lhs, rhs):
    """The causal conv's taps ``lhs`` [B, S + W - 1, C] against ``rhs``
    [W, 1, C], as ``nn.conv.causal_conv1d_apply`` sums them."""
    taps = lhs.unfold(1, rhs.shape[0], 1)
    return exact.einsum("bscw,wc->bsc", taps, rhs[:, 0, :])


@pytest.fixture
def one_library(monkeypatch):
    """The reference's library primitives computed by the port's, so both
    packages round every primitive alike (see the module docstring)."""
    einsum = jnp.einsum

    def jeinsum(spec, *ops, **kw):
        return _via_torch(lambda *a, **k: einsum(spec, *a, **k),
                          _port_einsum(spec))(*ops, **kw)

    def reduction(orig, fn):
        def f(x, axis=None, keepdims=False, **kw):
            assert axis == -1 and keepdims and not kw
            return _via_torch(lambda a: orig(a, axis=-1, keepdims=True),
                              fn)(x)
        return f

    def unary(orig, fn):
        """``orig`` of an array or a Python float (weak-typed fp32)."""
        port = _via_torch(orig, fn)
        return lambda x: port(jnp.asarray(x, jnp.float32)
                              if isinstance(x, float) else x)

    power = jufuncs._power

    def jpower(x1, x2):
        # ``x ** e`` for a Python float ``e`` (LayerNorm's ``** -0.5``);
        # an array exponent (RoPE's ``theta ** e``) stays the reference's
        if isinstance(x2, float):
            return _via_torch(lambda a: power(a, x2),
                              lambda t: exact.pow(t, x2))(x1)
        return power(x1, x2)

    conv = jax.lax.conv_general_dilated

    def jconv(lhs, rhs, window_strides, padding, **kw):
        # the depthwise 1-D conv of causal_conv1d_apply; any other conv
        # stays the reference's
        if (padding == "VALID" and tuple(window_strides) == (1,)
                and kw == {"dimension_numbers": ("NWC", "WIO", "NWC"),
                           "feature_group_count": lhs.shape[-1]}):
            return _via_torch(
                lambda a, b: conv(a, b, window_strides, padding, **kw),
                _port_depthwise)(lhs, rhs)
        return conv(lhs, rhs, window_strides, padding, **kw)

    cumsum = jnp.cumsum

    def jcumsum(x, axis=None, **kw):
        if jnp.issubdtype(jnp.result_type(x), jnp.integer):
            return cumsum(x, axis=axis, **kw)   # exact in any order (MoE's
            #                                     dispatch offsets)
        assert isinstance(axis, int) and not kw
        return _via_torch(lambda a: cumsum(a, axis=axis),
                          lambda t: exact.cumsum(t, axis))(x)

    jsum = jnp.sum

    def last_axis_sum(x, axis=None, *args, keepdims=False, **kw):
        # the MoE gates' renormalisation; any other sum stays the
        # reference's
        if axis == -1 and keepdims and not args and not kw:
            return _via_torch(lambda a: jsum(a, axis=-1, keepdims=True),
                              exact.total)(x)
        return jsum(x, axis, *args, keepdims=keepdims, **kw)

    method_sum = jreductions.sum

    def k_sum(x, axis=None, dtype=None, out=None, keepdims=False,
              initial=None, where=None, **kw):
        # the array method's sum(axis=1) of a 3-D array: the MoE
        # combine's sum over k
        if (axis == 1 and jnp.ndim(x) == 3 and not keepdims
                and dtype is out is initial is where is None):
            return _via_torch(lambda a: method_sum(a, axis=1),
                              lambda t: exact.total(t, 1)[:, 0])(x)
        return method_sum(x, axis=axis, dtype=dtype, out=out,
                          keepdims=keepdims, initial=initial, where=where,
                          **kw)

    router_qmm = jmoe.q_matmul

    def router(x, w, policy=None):
        # the MoE router's fp32 product (no policy); any other product
        # stays the reference's
        if policy is not None:
            return router_qmm(x, w, policy)
        wf = w.deq(jnp.float32) if isinstance(w, JQTensor) else w
        return _via_torch(
            lambda a, b: router_qmm(a, b, None),
            lambda a, b: exact.einsum("td,de->te", a, b,
                                      dtype=torch.float32))(x, wf)

    monkeypatch.setattr(jnp, "sum", last_axis_sum)
    monkeypatch.setattr(jreductions, "sum", k_sum)
    monkeypatch.setattr(jmoe, "q_matmul", router)
    sigmoid = _via_torch(jax.nn.sigmoid, exact.sigmoid)
    tanh = unary(jnp.tanh, exact.tanh)
    monkeypatch.setattr(jnp, "tanh", tanh)
    # jax.nn.gelu's tanh (its module reads jax._src.numpy)
    monkeypatch.setattr(jnp_src, "tanh", tanh)
    monkeypatch.setattr(jnp, "exp", unary(jnp.exp, exact.exp))
    monkeypatch.setattr(jnp, "log", unary(jnp.log, exact.log))
    monkeypatch.setattr(jnp, "mean", reduction(jnp.mean, exact.mean))
    monkeypatch.setattr(jnp, "var", reduction(jnp.var, exact.var))
    monkeypatch.setattr(jufuncs, "_power", jpower)
    monkeypatch.setattr(jnp, "einsum", jeinsum)
    monkeypatch.setattr(jax.nn, "softmax",
                        _via_torch(jax.nn.softmax, _port_softmax))
    monkeypatch.setattr(jax.lax, "rsqrt", _via_torch(jax.lax.rsqrt,
                                                     exact.rsqrt))
    monkeypatch.setattr(jnp, "sin", _via_torch(jnp.sin, exact.sin))
    monkeypatch.setattr(jnp, "cos", _via_torch(jnp.cos, exact.cos))
    monkeypatch.setitem(jvact._NATIVE, "silu", lambda x: x * sigmoid(x))
    monkeypatch.setattr(jax.nn, "sigmoid", sigmoid)
    monkeypatch.setattr(jax.nn, "silu", lambda x: x * sigmoid(x))
    monkeypatch.setattr(jax.nn, "softplus",
                        _via_torch(jax.nn.softplus, exact.softplus))
    monkeypatch.setattr(jnp, "cumsum", jcumsum)
    monkeypatch.setattr(jax.lax, "conv_general_dilated", jconv)


def policies(name):
    return jpolicy.get_policy(name), tpolicy.get_policy(name)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _normal(shape, seed=0, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# norms, RoPE, FFNs
# ---------------------------------------------------------------------------

def test_initializers_match_the_reference_statistics():
    from repro_torch.nn.module import normal_init, ones_init
    g = torch.Generator().manual_seed(0)
    x = normal_init(0.02)(g, (256, 64))
    assert x.dtype == torch.float32
    assert abs(float(x.std()) / 0.02 - 1) < 0.05
    assert torch.equal(ones_init()(g, (3, 5), torch.bfloat16),
                       torch.ones(3, 5, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    x = jnp.asarray(_normal((2, 5, 64), 1, 3.0)).astype(dtype)
    scale = _normal((64,), 2) + 1.0
    with jax.disable_jit():
        want = jnorm.rmsnorm_apply({"scale": jnp.asarray(scale)}, x)
    got = tnorm.rmsnorm_apply({"scale": torch.from_numpy(scale)},
                              to_torch(x))
    assert got.dtype == to_torch(want).dtype
    if dtype == "float32":
        close(got, want)
    else:
        # bf16 output: one bf16 ulp (2^-8) where the fp32 rsqrt scalar
        # rounds to the other side
        close(got, np.asarray(want, np.float32), rtol=2 ** -7, scale=0)


def test_layernorm():
    x = _normal((3, 7, 48), 3, 2.0) + 0.5
    p = {"scale": _normal((48,), 4) + 1.0, "bias": _normal((48,), 5)}
    with jax.disable_jit():
        want = jnorm.layernorm_apply(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x))
    got = tnorm.layernorm_apply({k: torch.from_numpy(v)
                                 for k, v in p.items()}, torch.from_numpy(x))
    close(got, want)


LIBRARIES = ["one_library", "own"]


def _libraries(request, library):
    """Under ``one_library`` the result is held bitwise; with each
    library's own primitives within rtol 1e-6 + atol 1e-6."""
    if library == "one_library":
        request.getfixturevalue("one_library")
        return bits_equal
    return lambda got, want, atol=1e-6: np.testing.assert_allclose(
        to_numpy(got), np.asarray(want), rtol=1e-6, atol=atol)


@pytest.mark.parametrize("library", LIBRARIES)
def test_gelu(request, library):
    """``core.vact``'s native GELU is ``jax.nn.gelu``'s expression
    (approximate=True) op by op, its tanh through fp64: 200,000 draws of
    3 N(0, 1) and the edges, and the int8 requant under w8a8."""
    check = _libraries(request, library)
    x = np.concatenate([_normal((200000,), 60, 3.0), np.array(
        [0.0, -0.0, -4.879, 4.879, -12.0, 12.0, 1e-30, -1e-30, 30.0, -30.0],
        np.float32)])
    with jax.disable_jit():
        want = jvact.activation(jnp.asarray(x), "gelu")
        want_q = jvact.activation(jnp.asarray(x[:4096]), "gelu",
                                  policies("w8a8")[0])
    check(tvact.activation(torch.from_numpy(x), "gelu"), want)
    got_q = tvact.activation(torch.from_numpy(x[:4096]), "gelu",
                             policies("w8a8")[1])
    if library == "one_library":
        bits_equal(got_q, want_q)


@pytest.mark.parametrize("library", LIBRARIES)
def test_layernorm_at_d1280(request, library):
    """whisper's width: [64, 1280] rows off zero mean."""
    check = _libraries(request, library)
    x = _normal((64, 1280), 61, 2.0) + 0.5
    p = {"scale": _normal((1280,), 62, 0.1) + 1.0,
         "bias": _normal((1280,), 63, 0.1)}
    with jax.disable_jit():
        want = jnorm.layernorm_apply(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x))
    check(tnorm.layernorm_apply({k: torch.from_numpy(v)
                                 for k, v in p.items()},
                                torch.from_numpy(x)), want)


@pytest.mark.parametrize("length", [8, 50, 448])
@pytest.mark.parametrize("library", LIBRARIES)
def test_sinusoidal_positions_at_d1280(request, library, length):
    """whisper's width, up to its 448-token decoder context.  With each
    library's own ``exp`` a frequency can differ by an ulp, and the angle
    ``pos * inv`` then by up to ``pos`` ulps of ``inv`` (<= 1): the table
    within atol 1e-6 plus one fp32 ulp of 1 (2^-23) a position."""
    check = _libraries(request, library)
    with jax.disable_jit():
        want = jcommon.sinusoidal_positions(length, 1280)
    got = tcommon.sinusoidal_positions(length, 1280)
    if library == "one_library":
        check(got, want)
    else:
        check(got, want, atol=1e-6 + (length - 1) * 2.0 ** -23)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("offset", [0, 37, 4095])
def test_rope_at_decode_offsets(theta, offset):
    x = _normal((2, 3, 4, 16), offset)
    pos = (offset + np.arange(3)[None].repeat(2, 0)
           + np.array([[0], [5]])).astype(np.int32)
    with jax.disable_jit():
        want = jrotary.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        freqs = jrotary.rope_freqs(16, theta)
    bits_equal(trotary.rope_freqs(16, theta), freqs)
    close(trotary.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta), want)


def _swiglu_params(seed, d=32, f=64):
    return {"w_gate": {"w": _normal((d, f), seed, d ** -0.5)},
            "w_up": {"w": _normal((d, f), seed + 1, d ** -0.5)},
            "w_down": {"w": _normal((f, d), seed + 2, f ** -0.5)}}


@pytest.mark.parametrize("policy", ["fp32", "w8a8"])
def test_swiglu(one_library, policy):
    jp, tp = policies(policy)
    p = _swiglu_params(7)
    x = _normal((2, 5, 32), 8)
    with jax.disable_jit():
        want = jmlp.swiglu_apply(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), jp)
    got = tmlp.swiglu_apply(carry(p), torch.from_numpy(x), tp)
    if policy == "fp32":
        close(got, want)
    else:
        bits_equal(got, want)


@pytest.mark.parametrize("policy,act", [
    pytest.param("fp32", "relu", id="fp32"),
    pytest.param("w8a8", "relu", id="w8a8"),
    pytest.param("fp32", "gelu", id="fp32-gelu"),
    pytest.param("w8a8", "gelu", id="w8a8-gelu")])
def test_mlp(request, policy, act):
    """GELU (whisper's) under w8a8 with ``one_library``: the requantized
    activation's int8 codes and the output bitwise."""
    if act == "gelu" and policy != "fp32":
        request.getfixturevalue("one_library")
    jp, tp = policies(policy)
    p = {"w_in": {"w": _normal((32, 64), 9, 32 ** -0.5),
                  "b": _normal((64,), 10, 0.1)},
         "w_out": {"w": _normal((64, 32), 11, 0.125),
                   "b": _normal((32,), 12, 0.1)}}
    x = _normal((2, 5, 32), 13)
    with jax.disable_jit():
        want = jmlp.mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jp, act=act)
    got = tmlp.mlp_apply(carry(p), torch.from_numpy(x), tp, act=act)
    if policy == "fp32":
        close(got, want)
    else:
        bits_equal(got, want)


def test_mlp_and_swiglu_init_shapes():
    g = torch.Generator().manual_seed(0)
    p = tmlp.swiglu_init(g, 8, 24)
    assert {k: tuple(v["w"].shape) for k, v in p.items()} == {
        "w_gate": (8, 24), "w_up": (8, 24), "w_down": (24, 8)}
    p = tmlp.mlp_init(g, 8, 24)
    assert tuple(p["w_in"]["b"].shape) == (24,)
    assert "b" not in tmlp.mlp_init(g, 8, 24, bias=False)["w_out"]


# ---------------------------------------------------------------------------
# embeddings and the LM head
# ---------------------------------------------------------------------------

def _tables(bits):
    emb = _normal((40, 16), 14, 0.02)
    jemb = jnp.asarray(emb)
    if bits is None:
        return {"emb": jemb}, {"emb": torch.from_numpy(emb)}
    q = JQTensor.quant(jemb, bits, channel_axis=1)
    return {"emb": q}, {"emb": QTensor(to_torch(q.qvalue),
                                       to_torch(q.scale), bits)}


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_embedding_apply(bits):
    jt, tt = _tables(bits)
    ids = _rng(15).integers(0, 40, (3, 6)).astype(np.int32)
    with jax.disable_jit():
        want = jlinear.embedding_apply(jt, jnp.asarray(ids))
    bits_equal(tlinear.embedding_apply(tt, torch.from_numpy(ids)), want)


@pytest.mark.parametrize("bits,policy", [(None, "fp32"), (None, "w8a8"),
                                         (8, "fp32"), (8, "w8a8"),
                                         (4, "w4a8")])
def test_embedding_attend(bits, policy):
    jt, tt = _tables(bits)
    jp, tp = policies(policy)
    x = _normal((2, 3, 16), 16)
    with jax.disable_jit():
        want = jlinear.embedding_attend(jt, jnp.asarray(x), jp)
    got = tlinear.embedding_attend(tt, torch.from_numpy(x), tp)
    if policy == "fp32":
        close(got, want)
    else:
        bits_equal(got, want)


@pytest.mark.parametrize("n_valid", [None, 37, 40])
@pytest.mark.parametrize("policy", ["fp32", "w8a8"])
def test_logits_from_hidden(n_valid, policy):
    jp, tp = policies(policy)
    head = _normal((16, 40), 17, 0.25)
    x = _normal((2, 3, 16), 18)
    with jax.disable_jit():
        want = jcommon.logits_from_hidden(jnp.asarray(x), jnp.asarray(head),
                                          None, jp, n_valid=n_valid)
    got = tcommon.logits_from_hidden(torch.from_numpy(x),
                                     torch.from_numpy(head), None, tp,
                                     n_valid=n_valid)
    if policy == "fp32":
        close(got, want)
    else:
        bits_equal(got, want)


@pytest.mark.parametrize("chunk", [None, 4, 5])
def test_cross_entropy_and_chunked_ce(chunk):
    logits = _normal((2, 8, 40), 19, 3.0)
    labels = _rng(20).integers(0, 40, (2, 8)).astype(np.int32)
    mask = (_rng(21).random((2, 8)) > 0.3).astype(np.float32)
    with jax.disable_jit():
        want = jcommon.chunked_ce(lambda h: h, jnp.asarray(logits),
                                  jnp.asarray(labels), jnp.asarray(mask),
                                  chunk=chunk)
        want_plain = jcommon.cross_entropy(jnp.asarray(logits),
                                           jnp.asarray(labels))
    got = tcommon.chunked_ce(lambda h: h, torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             torch.from_numpy(mask), chunk=chunk)
    close(got, want)
    close(tcommon.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels)), want_plain)


def test_sinusoidal_positions():
    with jax.disable_jit():
        want = jcommon.sinusoidal_positions(50, 32)
    # angles reach 49 rad: one ulp of an angle moves sin/cos by ~4e-6
    close(tcommon.sinusoidal_positions(50, 32), want, scale=1e-5)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def _cache_pair(kv_bits, ring, seed=22, B=2, T=6, Hk=2, D=8):
    """A reference cache and the port's copy, with some positions
    written already."""
    jc = jattn.init_cache(B, T, Hk, D, kv_bits, ring=ring)
    k0, v0 = _normal((B, 3, Hk, D), seed), _normal((B, 3, Hk, D), seed + 1)
    with jax.disable_jit():
        jc = jattn.cache_update(jc, jnp.asarray(k0), jnp.asarray(v0), 0,
                                kv_bits)
    return jc, {k: to_torch(v) for k, v in jc.items()}


@pytest.mark.parametrize("kv_bits", [32, 8])
@pytest.mark.parametrize("index,S", [(3, 1), (5, 1), (2, 2), (5, 3)])
def test_cache_update(kv_bits, index, S):
    jc, tc = _cache_pair(kv_bits, ring=False)
    k, v = _normal((2, S, 2, 8), 23), _normal((2, S, 2, 8), 24)
    with jax.disable_jit():
        want = jattn.cache_update(jc, jnp.asarray(k), jnp.asarray(v),
                                  index, kv_bits)
    got = tattn.cache_update(tc, torch.from_numpy(k), torch.from_numpy(v),
                             index, kv_bits)
    assert sorted(got) == sorted(want)
    for key in want:
        bits_equal(got[key], want[key])


@pytest.mark.parametrize("kv_bits", [32, 8])
@pytest.mark.parametrize("index,S", [(3, 1), (7, 1), (4, 4)])
def test_ring_update(kv_bits, index, S):
    jc, tc = _cache_pair(kv_bits, ring=True)
    k, v = _normal((2, S, 2, 8), 25), _normal((2, S, 2, 8), 26)
    with jax.disable_jit():
        want = jattn.cache_update(jc, jnp.asarray(k), jnp.asarray(v),
                                  index, kv_bits)
    got = tattn.cache_update(tc, torch.from_numpy(k), torch.from_numpy(v),
                             index, kv_bits)
    for key in want:
        bits_equal(got[key], want[key])


@pytest.mark.parametrize("kv_bits", [32, 8])
def test_cache_kv(kv_bits):
    jc, tc = _cache_pair(kv_bits, ring=False)
    with jax.disable_jit():
        want = jattn.cache_kv(jc)
    for got, w in zip(tattn.cache_kv(tc), want, strict=True):
        bits_equal(got, w)


@pytest.mark.parametrize("kv_bits", [32, 8])
def test_pad_caches(kv_bits):
    """Stacked layer caches, a ring cache (passed through) and a nested
    tuple, padded by 5 slots."""
    lin, _ = _cache_pair(kv_bits, ring=False)
    ring, _ = _cache_pair(kv_bits, ring=True)
    stacked = {k: jnp.stack([v, v + 1]) for k, v in lin.items()}
    tree = {"layers": stacked, "misc": (ring, {"n": jnp.arange(3)})}
    want = jserve.pad_caches(tree, 5)
    got = tserve.pad_caches(jax.tree.map(to_torch, tree), 5)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(to_numpy, got, is_leaf=lambda x: isinstance(
            x, torch.Tensor)))
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (_, g), (_, w) in zip(flat_g, flat_w, strict=True):
        bits_equal(g, w)


@pytest.mark.parametrize("causal,window,valid", [(True, None, None),
                                                 (False, None, None),
                                                 (True, 3, None),
                                                 (True, None, 5),
                                                 (True, 2, 6)])
def test_mask_bias(causal, window, valid):
    q_pos = np.array([[4, 5, 6], [0, 1, 2]], np.int32)
    k_pos = np.arange(8, dtype=np.int32)[None].repeat(2, 0)
    want = jattn._mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos), causal,
                            window, valid)
    got = tattn._mask_bias(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                           causal, window, valid)
    bits_equal(got, want)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)

# name -> (AttnConfig overrides, S)
ATTN_CASES = {
    "causal_gqa": ({}, 12),
    "bidirectional": ({"causal": False}, 12),
    "mha": ({"n_kv_heads": 4}, 12),
    "chunked": ({"q_chunk": 16}, 32),
    "direct_s32": ({"q_chunk": 512}, 32),
    "ragged_chunk": ({"q_chunk": 5}, 12),
    "window": ({"window": 4}, 12),
    "qkv_bias": ({"qkv_bias": True}, 12),
    "qk_norm": ({"qk_norm": True}, 12),
    "no_rope": ({"rope": False}, 12),
}


def _attn_params(cfg, seed):
    d, H, Hk, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": {"w": _normal((d, H * D), seed, d ** -0.5)},
         "wk": {"w": _normal((d, Hk * D), seed + 1, d ** -0.5)},
         "wv": {"w": _normal((d, Hk * D), seed + 2, d ** -0.5)},
         "wo": {"w": _normal((H * D, d), seed + 3, (H * D) ** -0.5)}}
    if cfg.qkv_bias:
        for i, k in enumerate(("wq", "wk", "wv")):
            p[k]["b"] = _normal((p[k]["w"].shape[1],), seed + 4 + i, 0.1)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": _normal((D,), seed + 8, 0.1) + 1}
        p["k_norm"] = {"scale": _normal((D,), seed + 9, 0.1) + 1}
    return p


def _check(got, want, policy):
    if policy == "fp32":
        close(got, want)
    else:
        bits_equal(got, want)


@pytest.mark.parametrize("policy", ["fp32", "w8a8kv8"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_apply_and_its_cache(one_library, case, policy):
    over, S = ATTN_CASES[case]
    jcfg = jattn.AttnConfig(**{**ATTN, **over})
    tcfg = tattn.AttnConfig(**dataclasses.asdict(jcfg))
    jp, tp = policies(policy)
    p = _attn_params(jcfg, 30)
    x = _normal((2, S, 32), 31)
    with jax.disable_jit():
        want, wcache = jattn.attention_apply(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg, jp,
            return_cache=True, kv_bits=jp.kv_bits)
    got, gcache = tattn.attention_apply(carry(p), torch.from_numpy(x), tcfg,
                                        tp, return_cache=True,
                                        kv_bits=tp.kv_bits)
    _check(got, want, policy)
    assert sorted(gcache) == sorted(wcache)
    for key in wcache:
        if policy == "fp32":
            close(gcache[key], wcache[key])
        else:
            bits_equal(gcache[key], wcache[key])


@pytest.mark.parametrize("policy", ["fp32", "w8a8kv8"])
@pytest.mark.parametrize("case", ["causal_gqa", "mha", "window", "qkv_bias",
                                  "qk_norm", "ring"])
def test_attention_decode(one_library, case, policy):
    """Prefill 6 positions, then 5 decode steps against a cache of 12
    slots (``ring``: a 4-slot ring buffer with window 4)."""
    over = {"window": 4} if case == "ring" else ATTN_CASES[case][0]
    jcfg = jattn.AttnConfig(**{**ATTN, **over})
    tcfg = tattn.AttnConfig(**dataclasses.asdict(jcfg))
    jp, tp = policies(policy)
    kv = jp.kv_bits
    p = _attn_params(jcfg, 40)
    jparams, tparams = jax.tree.map(jnp.asarray, p), carry(p)
    x = _normal((2, 11, 32), 41)
    cap = 4 if case == "ring" else 12
    jc = jattn.init_cache(2, cap, jcfg.n_kv_heads, 8, kv,
                          ring=case == "ring")
    tc = {k: to_torch(v) for k, v in jc.items()}
    with jax.disable_jit():
        for t in range(11):
            xt = jnp.asarray(x[:, t:t + 1])
            want, jc = jattn.attention_decode(jparams, xt, jcfg, jc,
                                              jnp.asarray(t, jnp.int32), jp,
                                              kv_bits=kv)
            got, tc = tattn.attention_decode(tparams,
                                             torch.from_numpy(x[:, t:t + 1]),
                                             tcfg, tc, t, tp, kv_bits=kv)
            _check(got, want, policy)
            for key in jc:
                if policy == "fp32" and key in ("k", "v"):
                    close(tc[key], jc[key])
                else:
                    bits_equal(tc[key], jc[key])


@pytest.mark.parametrize("policy", ["fp32", "w8a8kv8"])
def test_cross_attention(one_library, policy):
    """The cross branch: prefill against encoder states (no causal mask,
    RoPE on q only), then decode against their int8/fp cache."""
    jcfg = jattn.AttnConfig(**ATTN, cross=True)
    tcfg = tattn.AttnConfig(**dataclasses.asdict(jcfg))
    jp, tp = policies(policy)
    p = _attn_params(jcfg, 50)
    jparams, tparams = jax.tree.map(jnp.asarray, p), carry(p)
    x, enc = _normal((2, 5, 32), 51), _normal((2, 7, 32), 52)
    with jax.disable_jit():
        want = jattn.attention_apply(jparams, jnp.asarray(x), jcfg, jp,
                                     encoder_out=jnp.asarray(enc))
        k = np.asarray(jattn.linear_apply(jparams["wk"], jnp.asarray(enc),
                                          jp)).reshape(2, 7, 2, 8)
        v = np.asarray(jattn.linear_apply(jparams["wv"], jnp.asarray(enc),
                                          jp)).reshape(2, 7, 2, 8)
        jcross = jattn.cache_update(jattn.init_cache(2, 7, 2, 8, jp.kv_bits),
                                    jnp.asarray(k), jnp.asarray(v), 0,
                                    jp.kv_bits)
        wdec, _ = jattn.attention_decode(jparams, jnp.asarray(x[:, :1]),
                                         jcfg, None, jnp.asarray(3, jnp.int32),
                                         jp, cross_cache=jcross,
                                         kv_bits=jp.kv_bits)
    got = tattn.attention_apply(tparams, torch.from_numpy(x), tcfg, tp,
                                encoder_out=torch.from_numpy(enc))
    _check(got, want, policy)
    tcross = {kk: to_torch(vv) for kk, vv in jcross.items()}
    gdec, _ = tattn.attention_decode(tparams, torch.from_numpy(x[:, :1]),
                                     tcfg, None, 3, tp, cross_cache=tcross,
                                     kv_bits=tp.kv_bits)
    _check(gdec, wdec, policy)


def test_attention_init_tree():
    cfg = tattn.AttnConfig(**ATTN, qkv_bias=True, qk_norm=True)
    p = tattn.attention_init(torch.Generator().manual_seed(0), cfg)
    jpar = unbox(jattn.attention_init(jax.random.PRNGKey(0),
                                      jattn.AttnConfig(**ATTN, qkv_bias=True,
                                                       qk_norm=True)))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jpar)
    assert jax.tree.map(lambda t: tuple(t.shape), p, is_leaf=lambda x:
                        isinstance(x, torch.Tensor)) == shapes
