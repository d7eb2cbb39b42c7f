"""Q-MAC of the PyTorch port against the JAX package.

On the CPU the port's wrappers take the plain PyTorch version of the
kernel; it is held against the Pallas Q-MAC in interpret mode (int32
exactly equal) and against the reference oracle's fused epilogue
(bitwise), and ``q_matmul`` is held against ``repro.core.q_matmul``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fxp as jfxp
from repro.core import policy as jpolicy
from repro.core import qmatmul as jqmm
from repro.kernels.qmac import ops as jops
from repro.kernels.qmac import ref as jref
from repro_torch.core import fxp as tfxp
from repro_torch.core import policy as tpolicy
from repro_torch.core import qmatmul as tqmm
from repro_torch.kernels.qmac import ops as tops
from repro_torch.kernels.qmac import ref as tref

# the serving path's shapes at a small batch, plus ragged ones
SHAPES = [(7, 2048, 128), (7, 128, 4), (1, 128, 4), (33, 17, 9),
          (5, 12, 1), (16, 64, 40)]


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    qx = rng.integers(-128, 128, (m, k)).astype(np.int8)
    qw = rng.integers(-128, 128, (k, n)).astype(np.int8)
    sx = rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32)
    sw = rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32)
    return qx, qw, sx, sw


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_qmac_equals_pallas_interpret(m, k, n):
    qx, qw, sx, sw = _operands(m, k, n, seed=m + k + n)
    want = np.asarray(jops.qmac_i8(jnp.asarray(qx), jnp.asarray(qw)))
    got = tops.qmac_i8(_t(qx), _t(qw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.qmac_i8(_t(qx), _t(qw)).numpy(),
                                  want)
    # fused epilogue: bitwise equal to the reference oracle's (acc*sx)*sw
    deq_want = np.asarray(jref.qmac_i8_deq(jnp.asarray(qx), jnp.asarray(sx),
                                           jnp.asarray(qw), jnp.asarray(sw)))
    deq = tops.qmac_i8_deq(_t(qx), _t(sx), _t(qw), _t(sw))
    assert deq.dtype == torch.float32
    np.testing.assert_array_equal(deq.numpy().view(np.int32),
                                  deq_want.view(np.int32))
    np.testing.assert_array_equal(
        tref.qmac_i8_deq(_t(qx), _t(sx), _t(qw), _t(sw)).numpy(), deq_want)


def test_qmac_extremes_and_per_tensor_scale():
    """|acc| = K*127*128 at the int32 edge, and a one-element sw."""
    qx = torch.full((8, 2048), 127, dtype=torch.int8)
    qw = torch.full((2048, 8), -128, dtype=torch.int8)
    assert int(tops.qmac_i8(qx, qw)[0, 0]) == 2048 * 127 * (-128)
    sx = torch.full((8, 1), 0.5)
    sw = torch.tensor([0.25])
    out = tops.qmac_i8_deq(qx, sx, qw, sw)
    assert float(out[3, 5]) == 2048 * 127 * (-128) * 0.5 * 0.25


def test_qmac_wrappers_refuse_bad_operands():
    qx = torch.zeros((4, 8), dtype=torch.int8)
    qw = torch.zeros((8, 3), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        tops.qmac_i8(qx.float(), qw)
    with pytest.raises(ValueError, match=r"\[M, K\] x \[K, N\]"):
        tops.qmac_i8(qx, qw[:5])
    with pytest.raises(ValueError, match="do not fit"):
        tops.qmac_i8_deq(qx, torch.ones(3, 1), qw, torch.ones(3))
    with pytest.raises(TypeError, match="fp32"):
        tops.qmac_i8_deq(qx, torch.ones(4, 1, dtype=torch.float64), qw,
                         torch.ones(3))
    with pytest.raises(ValueError, match="131072"):
        tops.qmac_i8(torch.zeros((1, 131073), dtype=torch.int8),
                     torch.zeros((131073, 1), dtype=torch.int8))


def _x_w(shape_x, d_out, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape_x).astype(np.float32)
    x[..., 0, :] = 0.0                      # an all-zero row
    w = (rng.normal(size=(shape_x[-1], d_out)) * 0.2).astype(np.float32)
    return x, w


def _fp32_close(got, want):
    """fp32 products: the two libraries sum in different orders, so an
    output near zero after cancellation carries an error relative to the
    layer's scale, not to itself: rtol=1e-6 plus 1e-6 of the largest
    output."""
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["fxp8", "w4a8", "w8a8"])
@pytest.mark.parametrize("backend", ["xla", "pallas", "ref"])
def test_q_matmul_fp_weights(name, backend):
    """The evaluation forward (fp weights, quantized in the product)."""
    x, w = _x_w((3, 5, 24), 8, seed=len(name))
    jpol = jpolicy.get_policy(name).with_backend(backend)
    tpol = tpolicy.get_policy(name).with_backend(backend)
    want = np.asarray(jqmm.q_matmul(jnp.asarray(x), jnp.asarray(w), jpol))
    got = tqmm.q_matmul(_t(x), _t(w), tpol).numpy()
    if backend == "ref":
        _fp32_close(got, want)
    else:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("bits,name", [(8, "fxp8"), (4, "w4a8"), (8, "w8")])
def test_serve_quantized_qtensor_weights(bits, name):
    """The serving forward: packed QTensor weights.  Integer policies are
    bitwise; the weight-only ``w8`` dequantizes into an fp32 matmul."""
    x, w = _x_w((6, 32), 16, seed=bits)
    jw = jfxp.QTensor.quant(jnp.asarray(w), bits, channel_axis=1)
    tw = tfxp.QTensor.quant(_t(w), bits, channel_axis=1)
    jpol, tpol = jpolicy.get_policy(name), tpolicy.get_policy(name)
    want = np.asarray(jqmm.q_matmul(jnp.asarray(x), jw, jpol))
    got = tqmm.q_matmul(_t(x), tw, tpol).numpy()
    if tpol.quantized_a:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    else:
        _fp32_close(got, want)
    # a per-tensor scale rides the same path
    jw1 = jfxp.QTensor.quant(jnp.asarray(w), bits)
    tw1 = tfxp.QTensor.quant(_t(w), bits)
    _fp32_close(tqmm.q_matmul(_t(x), tw1, tpol).numpy(),
                np.asarray(jqmm.q_matmul(jnp.asarray(x), jw1, jpol)))


def test_q_matmul_fp32_and_unknown_backend():
    x, w = _x_w((4, 8), 3, seed=9)
    _fp32_close(tqmm.q_matmul(_t(x), _t(w)).numpy(),
                np.asarray(jqmm.q_matmul(jnp.asarray(x), jnp.asarray(w))))
    with pytest.raises(ValueError, match="unknown backend"):
        tqmm.q_matmul(_t(x), _t(w), tpolicy.FXP8.with_backend("tpu"))


# ---------------------------------------------------------------------------
# the STE backward of a quantized product (the reference's _qmm_bwd)
# ---------------------------------------------------------------------------


def _q_matmul_grads(x, w, g, name):
    jpol, tpol = jpolicy.get_policy(name), tpolicy.get_policy(name)
    jdx, jdw = jax.grad(lambda a, b: (jqmm.q_matmul(a, b, jpol)
                                      * jnp.asarray(g)).sum(),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    (tqmm.q_matmul(xt, wt, tpol) * _t(g)).sum().backward()
    return (np.asarray(jdx), np.asarray(jdw)), (xt.grad.numpy(),
                                                wt.grad.numpy())


@pytest.mark.parametrize("name", ["fxp8", "w4a8"])
@pytest.mark.parametrize("xshape", [(4, 8), (2, 3, 8)])
def test_q_matmul_ste_gradient_bitwise(name, xshape):
    """d sum(q_matmul(x, w)): dx = 1 @ w^T and dw = x^T @ 1 at the
    unquantized operands, bit for bit.  The operands are multiples of
    1/16 below 4 in magnitude, so every product and partial sum is exact
    and the two libraries' summation orders cannot differ in a bit (the
    random-cotangent test below covers the general case).  The port's
    product before the STE differentiated round() and reached only the
    absmax entries (4 of 32 nonzero dx at fxp8)."""
    rng = np.random.default_rng(len(name) + len(xshape))
    x = (rng.integers(-63, 64, size=xshape) / 16).astype(np.float32)
    w = (rng.integers(-63, 64, size=(8, 3)) / 16).astype(np.float32)
    g = np.ones(xshape[:-1] + (3,), np.float32)
    (jdx, jdw), (tdx, tdw) = _q_matmul_grads(x, w, g, name)
    np.testing.assert_array_equal(tdx.view(np.int32), jdx.view(np.int32))
    np.testing.assert_array_equal(tdw.view(np.int32), jdw.view(np.int32))
    assert np.count_nonzero(tdx) == tdx.size


@pytest.mark.parametrize("name", ["fxp8", "w4a8"])
def test_q_matmul_ste_gradient_random_cotangent(name):
    """With a random cotangent the two fp32 matmuls round their products
    and sums each in its library's order: rtol=1e-6 against the layer's
    scale (``_fp32_close``)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, 24)).astype(np.float32)
    w = rng.normal(size=(24, 6)).astype(np.float32)
    g = rng.normal(size=(5, 6)).astype(np.float32)
    (jdx, jdw), (tdx, tdw) = _q_matmul_grads(x, w, g, name)
    _fp32_close(tdx, jdx)
    _fp32_close(tdw, jdw)
