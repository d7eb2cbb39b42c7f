"""Quantization core of the PyTorch port against the JAX package.

The same seeded numpy inputs go through ``repro.core`` and
``repro_torch.core``; payloads, scales and dequantized values must agree
bit for bit, including exact ``.5`` ties (both round half to even) and
all-zero rows (the ``1e-12`` scale clamp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fxp as jfxp
from repro.core import policy as jpolicy
from repro.core import qmatmul as jqmm
from repro.core import quantizer as jquant
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.core import fxp as tfxp
from repro_torch.core import policy as tpolicy
from repro_torch.core import qmatmul as tqmm
from repro_torch.core import quantizer as tquant


def _inputs(shape, seed=0):
    """Normal values, one row of exact ties on the unit grid (absmax 127
    makes the 8-bit scale exactly 1.0) and one all-zero row."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x = x.reshape(-1, shape[-1])
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                    np.float32)
    x[0] = np.resize(ties, shape[-1])
    x[-1] = 0.0
    return x.reshape(shape)


def _same_bits(a, b):
    """Bitwise equality of a JAX result and a torch result."""
    a = np.asarray(a)
    b = b.detach().cpu().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_presets_match_names_and_fields():
    assert set(tpolicy.PRESETS) == set(jpolicy.PRESETS)
    assert len(tpolicy.PRESETS) == 12
    for name, jp in jpolicy.PRESETS.items():
        tp = tpolicy.get_policy(name)
        for f in ("name", "w_bits", "a_bits", "kv_bits", "grad_bits",
                  "comm_bits", "backend", "act_backend", "per_channel",
                  "cordic_iters"):
            assert getattr(tp, f) == getattr(jp, f), (name, f)
        assert str(tp.compute_dtype).split(".")[-1] == \
            jnp.dtype(jp.compute_dtype).name
        assert tpolicy.cordic_iterations(tp) == \
            jpolicy.cordic_iterations(jp)
    with pytest.raises(KeyError, match="unknown quant policy"):
        tpolicy.get_policy("w2")


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_quantize_bitwise(bits, axis):
    x = _inputs((9, 8), seed=bits)
    qj, sj = jfxp.quantize(jnp.asarray(x), bits, channel_axis=axis)
    qt, st = tfxp.quantize(torch.from_numpy(x), bits, channel_axis=axis)
    _same_bits(qj, qt)
    _same_bits(sj, st)
    _same_bits(jfxp.dequantize(qj, sj), tfxp.dequantize(qt, st))
    _same_bits(jfxp.absmax_scale(jnp.asarray(x), bits, axis),
               tfxp.absmax_scale(torch.from_numpy(x), bits, axis))


def test_quantize_32_bits_passes_through():
    x = _inputs((4, 8))
    q, s = tfxp.quantize(torch.from_numpy(x), 32)
    assert torch.equal(q, torch.from_numpy(x))
    assert s.shape == (1, 1) and float(s) == 1.0
    assert tfxp.fake_quant(torch.from_numpy(x), 32) is not None
    assert tfxp.fxp_dtype(4) == torch.int8 and tfxp.fxp_qmax(4) == 7.0


@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_and_rowwise_bitwise(bits):
    x = _inputs((6, 3, 16), seed=3)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _same_bits(jfxp.fake_quant(xj, bits), tfxp.fake_quant(xt, bits))
    _same_bits(jfxp.fake_quant(xj, bits, 2), tfxp.fake_quant(xt, bits, 2))
    _same_bits(jfxp.fake_quant_rowwise(xj, bits),
               tfxp.fake_quant_rowwise(xt, bits))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_rowwise_bitwise(bits):
    x = _inputs((2, 5, 12), seed=4)
    qj, sj = jqmm.quantize_rowwise(jnp.asarray(x), bits)
    qt, st = tqmm.quantize_rowwise(torch.from_numpy(x), bits)
    _same_bits(qj, qt)
    _same_bits(sj, st)
    # the all-zero row sits on the clamp: scale 1e-12 / qmax, codes 0
    assert float(st[-1, -1, 0]) == np.float32(1e-12) / np.float32(
        tfxp.fxp_qmax(bits))
    assert int(qt[-1, -1].abs().max()) == 0


def _param_tree(seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {"fc": {"w": n(24, 8), "b": n(8)},
            "convs": [{"w": n(3, 3, 4, 6), "b": n(6)}],
            "stack": {"w": n(2, 8, 5)},
            "table": {"emb": n(10, 4)},
            "other": {"v": n(4, 4)}}


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_params_bitwise(bits, per_channel):
    tree = _param_tree(bits)
    tree["fc"]["w"][3] = 0.0                      # a zero input row
    tree["fc"]["w"][:, 2] = 0.0                   # a zero output channel
    jpol = jpolicy.QuantPolicy(w_bits=bits, per_channel=per_channel)
    tpol = tpolicy.QuantPolicy(w_bits=bits, per_channel=per_channel)
    jq = jquant.quantize_params(
        {k: _jnp_tree(v) for k, v in tree.items()}, jpol)
    tq = tquant.quantize_params(from_numpy_tree(tree, "cpu"), tpol)
    for path in (("fc", "w"), ("convs", 0, "w"), ("stack", "w"),
                 ("table", "emb")):
        a, b = _get(jq, path), _get(tq, path)
        assert isinstance(a, jfxp.QTensor) and isinstance(b, tfxp.QTensor)
        assert a.bits == b.bits == bits
        _same_bits(a.qvalue, b.qvalue)
        _same_bits(a.scale, b.scale)
    # biases, 1-D leaves and non-weight names stay fp
    for path in (("fc", "b"), ("convs", 0, "b"), ("other", "v")):
        assert isinstance(_get(tq, path), torch.Tensor)
    assert tquant.quantized_nbytes(tq) == jquant.quantized_nbytes(jq)
    back = tquant.dequantize_params(tq)
    _same_bits(jquant.dequantize_params(jq)["fc"]["w"], back["fc"]["w"])


def test_quantize_params_fp32_is_identity():
    tree = from_numpy_tree(_param_tree(), "cpu")
    assert tquant.quantize_params(tree, tpolicy.FP32) is tree


def _jnp_tree(t):
    if isinstance(t, dict):
        return {k: _jnp_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_jnp_tree(v) for v in t]
    return jnp.asarray(t)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("n", [8, 9])
def test_nibbles_bitwise(n):
    q = (np.arange(n, dtype=np.int64) * 5 % 15 - 7).astype(np.int8)
    pj = jfxp.pack_nibbles(jnp.asarray(q))
    pt = tfxp.pack_nibbles(torch.from_numpy(q))
    _same_bits(pj, pt)
    _same_bits(jfxp.unpack_nibbles(pj, n), tfxp.unpack_nibbles(pt, n))
    assert torch.equal(tfxp.unpack_nibbles(pt, n), torch.from_numpy(q))


def test_qtensor_bytes_and_dense_view():
    x = _inputs((16, 8))
    qj = jfxp.QTensor.quant(jnp.asarray(x), 8, channel_axis=1)
    qt = tfxp.QTensor.quant(torch.from_numpy(x), 8, channel_axis=1)
    assert tfxp.nbytes_of(qt) == jfxp.nbytes_of(qj) == 16 * 8 + 8 * 4
    assert tfxp.is_qtensor(qt) and not tfxp.is_qtensor(qt.qvalue)
    _same_bits(jfxp.as_dense(qj), tfxp.as_dense(qt))
    assert qt.shape == (16, 8) and qt.ndim == 2 and qt.dtype == torch.int8
    dense = torch.from_numpy(x)
    assert tfxp.as_dense(dense) is dense
    assert tfxp.as_dense(dense, torch.float64).dtype == torch.float64


# ---------------------------------------------------------------------------
# straight-through gradients
# ---------------------------------------------------------------------------


def _grad_t(fn, x, g):
    """Gradient of sum(fn(x) * g) with respect to x, in torch."""
    xt = torch.from_numpy(x).requires_grad_()
    (fn(xt) * torch.from_numpy(g)).sum().backward()
    return xt.grad


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("axis", [None, 1])
def test_fake_quant_ste_gradient_bitwise(bits, axis):
    """The reference's custom_vjp passes the cotangent through; so must
    the port, at every entry (not only at the absmax entries, which is
    all that autograd through round() would reach)."""
    x = _inputs((4, 8), seed=10 + bits)
    g = np.random.default_rng(bits).normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda v: (jfxp.fake_quant(v, bits, axis)
                               * jnp.asarray(g)).sum())(jnp.asarray(x))
    _same_bits(want, _grad_t(lambda v: tfxp.fake_quant(v, bits, axis),
                             x, g))
    # d/dx sum(fake_quant(x)) is 1 everywhere
    ones = np.ones_like(x)
    assert torch.equal(_grad_t(lambda v: tfxp.fake_quant(v, bits, axis),
                               x, ones), torch.from_numpy(ones))


@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_rowwise_ste_gradient_bitwise(bits):
    x = _inputs((3, 4, 8), seed=20 + bits)
    g = np.random.default_rng(bits).normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda v: (jfxp.fake_quant_rowwise(v, bits)
                               * jnp.asarray(g)).sum())(jnp.asarray(x))
    _same_bits(want, _grad_t(lambda v: tfxp.fake_quant_rowwise(v, bits),
                             x, g))


# ---------------------------------------------------------------------------
# the paper's Eq. (1) quantizer and the EMA calibrator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("kind", ["normal", "positive", "negative", "zeros"])
def test_quantize_eq1_bitwise(kind, n):
    """q and scale bitwise the reference's, a span on each side of zero,
    one side only, and none (the 1e-12 floor)."""
    x = _inputs((16, 32), 6)
    x = {"normal": x, "positive": np.abs(x) + 0.1,
         "negative": -np.abs(x) - 0.1, "zeros": np.zeros_like(x)}[kind]
    jq, js = jfxp.quantize_eq1(jnp.asarray(x), n)
    tq, ts = tfxp.quantize_eq1(torch.from_numpy(x), n)
    _same_bits(jq, tq)
    _same_bits(js[None], ts[None])          # 0-dim: viewed as one entry


@pytest.mark.parametrize("momentum", [0.99, 0.9])
def test_ema_calibrator_bitwise(momentum):
    """The abs-max EMA over a stream of activations: the first update
    takes the abs-max, the rest the EMA, each state bitwise."""
    jc = jquant.EmaCalibrator(momentum)
    tc = tquant.EmaCalibrator(momentum)
    js, ts = jc.init(), tc.init()
    _same_bits(js[None], ts[None])          # 0-dim: viewed as one entry
    for i in range(6):
        x = _inputs((8, 16), 10 + i) * (1.0 + i)
        js = jc.update(js, jnp.asarray(x))
        ts = tc.update(ts, torch.from_numpy(x))
        _same_bits(js[None], ts[None])
