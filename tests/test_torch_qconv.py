"""Q-Conv of the PyTorch port against the JAX package.

On the CPU the port's ``qconv2d_i8`` takes its plain PyTorch version.
It is held bitwise against the reference oracle
(``repro.kernels.qconv.ref.qconv2d_i8``, run eagerly), and against the
Pallas kernel in interpret mode at the reference's own cross-backend bar
(rtol=1e-6, atol=1e-6: docs/kernels.md "Bit-exactness contract").  The
layers above it (``conv2d_apply``, ``qconv_block``, the conv Q net) are
held against ``repro.nn.conv`` and ``repro.rl.nets``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core import quantizer as jquant
from repro.kernels.qconv import ops as jops
from repro.kernels.qconv import ref as jref
from repro.nn import conv as jconv
from repro.rl import nets as jnets
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.core import policy as tpolicy
from repro_torch.core import quantizer as tquant
from repro_torch.kernels.qconv import ops as tops
from repro_torch.kernels.qconv import ref as tref
from repro_torch.nn import conv as tconv
from repro_torch.rl import nets as tnets

# (B, H, W, C, N, k, stride, padding): the keydoor stem at a small
# batch and width, odd sizes, VALID, even kernels, one channel
CASES = [
    (2, 32, 32, 12, 4, 3, 2, "SAME"),
    (2, 16, 16, 4, 8, 3, 2, "SAME"),
    (3, 9, 7, 5, 6, 3, 1, "SAME"),
    (2, 8, 8, 8, 3, 3, 2, "VALID"),
    (1, 5, 5, 3, 5, 2, 1, "VALID"),
    (2, 7, 11, 1, 4, 3, 2, "SAME"),
]


def _operands(case, seed):
    """Quantized operands the way the layer makes them: per-pixel
    activation scales and per-out-channel weight scales over normal
    draws, so outputs are O(1) as the reference's parity suite has
    them."""
    b, h, w, c, n, k, _, _ = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    sx = (np.maximum(np.abs(x).max(-1, keepdims=True), 1e-12)
          / 127.0).astype(np.float32)
    qx = np.clip(np.round(x / sx), -127, 127).astype(np.int8)
    wgt = (rng.normal(size=(k, k, c, n)) * 0.1).astype(np.float32)
    sw = (np.maximum(np.abs(wgt).max((0, 1, 2)), 1e-12) / 127.0
          ).astype(np.float32)
    qw = np.clip(np.round(wgt / sw), -127, 127).astype(np.int8)
    bias = (rng.normal(size=(n,)) * 0.01).astype(np.float32)
    return qx, sx, qw, sw, bias


def _run_both(case, seed, relu, kernel=False):
    ops = _operands(case, seed)
    kw = dict(stride=case[6], padding=case[7], fuse_relu=relu)
    if kernel:
        want = jops.qconv2d_i8(*map(jnp.asarray, ops), kernel=True, **kw)
    else:
        want = jref.qconv2d_i8(*map(jnp.asarray, ops), **kw)
    got = tops.qconv2d_i8(*map(torch.from_numpy, ops), **kw)
    return np.asarray(want), got.numpy(), ops, kw


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("relu", [False, True])
def test_plain_qconv_bitwise_to_oracle(case, relu):
    want, got, ops, kw = _run_both(case, seed=sum(case[:6]), relu=relu)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the port's own oracle walks the taps the same way
    own = tref.qconv2d_i8(*map(torch.from_numpy, ops), **kw).numpy()
    np.testing.assert_array_equal(own.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("case", CASES[:4])
def test_plain_qconv_vs_pallas_interpret(case):
    want, got, _, _ = _run_both(case, seed=7, relu=True, kernel=True)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_same_pads_are_asymmetric_for_stride_2():
    assert tref.same_pads(32, 3, 2) == jref.same_pads(32, 3, 2) == \
        (16, (0, 1))
    for size, k, s in [(7, 3, 2), (9, 2, 1), (5, 5, 3), (1, 3, 2)]:
        assert tref.same_pads(size, k, s) == jref.same_pads(size, k, s)
        assert tref.valid_out(size + 4, k, s) == \
            jref.valid_out(size + 4, k, s)


def test_qconv_refuses_bad_operands():
    qx, sx, qw, sw, b = map(torch.from_numpy, _operands(CASES[2], 0))
    with pytest.raises(TypeError, match="int8"):
        tops.qconv2d_i8(qx.float(), sx, qw, sw, b)
    with pytest.raises(ValueError, match="sx must be"):
        tops.qconv2d_i8(qx, sx[..., 0], qw, sw, b)
    with pytest.raises(ValueError, match="padding"):
        tops.qconv2d_i8(qx, sx, qw, sw, b, padding="FULL")


def _conv_params(seed, c_in=4, c_out=6, k=3):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(k, k, c_in, c_out)) * 0.3
                  ).astype(np.float32),
            "b": (rng.normal(size=(c_out,)) * 0.1).astype(np.float32)}


def _jtree(t):
    if isinstance(t, dict):
        return {k: _jtree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_jtree(v) for v in t]
    return jnp.asarray(t)


@pytest.mark.parametrize("name", ["fxp8", "w4a8", "fp32", "w8"])
@pytest.mark.parametrize("packed", [False, True])
def test_conv2d_apply_and_block(name, packed):
    """The integer path (fxp8, w4a8) is bitwise; the fp32 convolution
    (fp32, and w8's fp32 activations) holds at rtol=1e-6 plus 1e-6 of
    the largest output, since cuDNN/XLA sum the taps in their own
    order."""
    p = _conv_params(3)
    x = np.random.default_rng(4).normal(size=(2, 10, 8, 4)).astype(
        np.float32)
    jpol, tpol = jpolicy.get_policy(name), tpolicy.get_policy(name)
    jp, tp = _jtree(p), from_numpy_tree(p, "cpu")
    if packed and jpol.quantized_w:
        jp = jquant.quantize_params(jp, jpol)
        tp = tquant.quantize_params(tp, tpol)
    integer = tconv._use_integer_conv(tpol, tp["w"])
    assert integer == jconv._use_integer_conv(jpol, jp["w"])
    for stride, padding in [(2, "SAME"), (1, "SAME"), (2, "VALID")]:
        want = np.asarray(jconv.conv2d_apply(jp, jnp.asarray(x),
                                             stride=stride,
                                             padding=padding, policy=jpol))
        got = tconv.conv2d_apply(tp, torch.from_numpy(x), stride=stride,
                                 padding=padding, policy=tpol).numpy()
        _close(got, want, bitwise=integer)
    want = np.asarray(jconv.qconv_block(jp, jnp.asarray(x), policy=jpol))
    got = tconv.qconv_block(tp, torch.from_numpy(x), policy=tpol).numpy()
    _close(got, want, bitwise=integer)


def _close(got, want, bitwise):
    assert got.shape == want.shape
    if bitwise:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))


def test_conv_init_layout_and_scale():
    gen = torch.Generator().manual_seed(0)
    p = tconv.conv2d_init(gen, 12, 16, 3)
    assert p["w"].shape == (3, 3, 12, 16) and p["b"].shape == (16,)
    assert not p["b"].any()
    # He init over the HWIO fan-in axis (c_in), as the reference draws it
    assert abs(float(p["w"].std()) - (2.0 / 12) ** 0.5) < 0.05
    assert tnets.conv_flat_dim((32, 32, 12)) == \
        jnets.conv_flat_dim((32, 32, 12)) == 8 * 8 * 32


@pytest.mark.parametrize("name", ["fxp8", "w4a8"])
def test_conv_q_net_matches_reference(name):
    """The whole Q net at a small width, fp weights and packed weights:
    integer programs end to end, so the Q-values are bitwise."""
    import jax
    from repro.nn.module import unbox
    jp = jax.tree.map(np.asarray, unbox(jnets.conv_q_init(
        jax.random.PRNGKey(1), (32, 32, 6), 4, channels=(4, 8), hidden=16)))
    tp = from_numpy_tree(jp, "cpu")
    jp = _jtree(jp)
    obs = np.random.default_rng(5).normal(size=(3, 32, 32, 6)).astype(
        np.float32)
    jpol, tpol = jpolicy.get_policy(name), tpolicy.get_policy(name)
    bits = jpol.w_bits
    for pj, pt in [(jp, tp),
                   (jquant.quantize_params(jp, jpolicy.QuantPolicy(
                       w_bits=bits)),
                    tquant.quantize_params(tp, tpolicy.QuantPolicy(
                        w_bits=bits)))]:
        want = np.asarray(jnets.conv_q_apply(pj, jnp.asarray(obs), jpol))
        got = tnets.conv_q_apply(pt, torch.from_numpy(obs), tpol).numpy()
        _close(got, want, bitwise=True)


# ---------------------------------------------------------------------------
# the integer conv's STE backward (the reference's _qconv VJP)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fxp8", "w4a8"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[3]])
def test_qconv_ste_vjp_matches_reference(name, relu, case):
    """Gradients of sum(conv2d_apply(x) * g) with respect to x, w and b:
    the fp conv's VJP at the dequantized operands, within rtol=1e-6 of
    the layer's scale (both sides run an fp32 convolution backward, each
    in its library's order).  One image is all zeros and the bias is 0
    in one channel, so the fused ReLU meets exact ties, where
    ``jnp.maximum`` gives half the cotangent."""
    b, h, w_, c, n, k, stride, padding = case
    rng = np.random.default_rng(c + n)
    x = rng.normal(size=(b, h, w_, c)).astype(np.float32)
    x[-1] = 0.0
    p = {"w": (rng.normal(size=(k, k, c, n)) * 0.3).astype(np.float32),
         "b": (rng.normal(size=(n,)) * 0.1).astype(np.float32)}
    p["b"][0] = 0.0
    jpol, tpol = jpolicy.get_policy(name), tpolicy.get_policy(name)
    kw = dict(stride=stride, padding=padding, fuse_relu=relu)
    out_shape = np.asarray(jconv.conv2d_apply(
        {k_: jnp.asarray(v) for k_, v in p.items()}, jnp.asarray(x),
        policy=jpol, **kw)).shape
    g = rng.normal(size=out_shape).astype(np.float32)

    def jloss(xx, ww, bb):
        return (jconv.conv2d_apply({"w": ww, "b": bb}, xx, policy=jpol,
                                   **kw) * jnp.asarray(g)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(p["w"]), jnp.asarray(p["b"]))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(p["w"]).requires_grad_()
    bt = torch.from_numpy(p["b"]).requires_grad_()
    (tconv.conv2d_apply({"w": wt, "b": bt}, xt, policy=tpol, **kw)
     * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((xt.grad, wt.grad, bt.grad), want, strict=True):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(ref).max()))
    if relu:
        # the tie rule is reached: the zero image's outputs sit at 0
        assert bool((np.asarray(jconv.conv2d_apply(
            {k_: jnp.asarray(v) for k_, v in p.items()}, jnp.asarray(x),
            policy=jpol, **kw))[-1, ..., 0] == 0).all())
