"""V-ACT (CORDIC activations) of the PyTorch port against the JAX package.

The port's plain CORDIC functions are held bitwise against
``repro.core.vact`` (run eagerly on the CPU), ``activation`` under
``act_backend="cordic"`` bitwise with its requantization, and the
kernel wrappers' plain versions (what a CPU tensor takes) bitwise
against ``repro.kernels.vact.ref``.  Two bars are looser, each for its
reason:

* softmax at rtol=1e-6: the row sum runs in another order in each
  implementation (and, with atol the smallest normal fp32, because
  XLA on the CPU flushes subnormal quotients to zero where PyTorch
  keeps them: a row spanning 200 has entries of ~1e-38);
* the Pallas kernel in interpret mode at rtol=atol=1e-6: it scales by
  ``exp2`` where the reference (and the port) use ``ldexp``, one ulp
  apart at some inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core import vact as jvact
from repro.kernels.vact import ops as jops
from repro.kernels.vact import ref as jref
from repro_torch.core import policy as tpolicy
from repro_torch.core import vact as tvact
from repro_torch.kernels.vact import ops as tops
from repro_torch.kernels.vact import ref as tref

# ragged shapes: a row, a prime-sized tile, a 3-D tensor
SHAPES = [(1, 7), (13, 37), (3, 5, 11)]
EW_KINDS = ("relu", "sigmoid", "tanh")
# the clamp of 2^m (|x| >= ~88), zero, tiny, and saturated inputs
SPECIAL = [0.0, 1e-8, -1e-8, 1.0, -1.0, 30.0, -30.0, 100.0, -100.0,
           0.5, -0.5, 88.5, -88.5]
TINY = float(np.finfo(np.float32).tiny)


def _x(shape, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    flat = x.reshape(-1)
    k = min(len(SPECIAL), flat.size)
    flat[:k] = SPECIAL[:k]
    return x


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n", range(1, 25))
def test_schedule_and_gain_match(n):
    assert tvact.hyperbolic_schedule(n) == jvact.hyperbolic_schedule(n)
    sched = tvact.hyperbolic_schedule(n)
    assert tvact.cordic_gain(sched) == jvact.cordic_gain(sched)
    assert tvact._ATANH == jvact._ATANH and tvact.LN2 == jvact.LN2


@pytest.mark.parametrize("n", [6, 13])
@pytest.mark.parametrize("fn", ["cordic_exp", "cordic_sigmoid",
                                "cordic_tanh"])
def test_cordic_functions_bitwise(fn, n):
    x = _x((64, 96), seed=n)
    want = getattr(jvact, fn)(jnp.asarray(x), n)
    got = getattr(tvact, fn)(torch.from_numpy(x), n)
    _bits_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [6, 13])
def test_cordic_softmax_within_rtol(n):
    x = _x((32, 33), seed=100 + n)
    want = np.asarray(jvact.cordic_softmax(jnp.asarray(x), n))
    got = tvact.cordic_softmax(torch.from_numpy(x), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=TINY)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("kind", ["relu", "sigmoid", "tanh", "softmax"])
def test_activation_cordic_fxp8(kind):
    """The V-ACT datapath as the agent runs it: CORDIC at FxP8's 6
    iterations, then the per-tensor requantization (not for softmax)."""
    x = _x((17, 40), seed=7)
    jpol = jpolicy.FXP8.replace(act_backend="cordic")
    tpol = tpolicy.FXP8.replace(act_backend="cordic")
    want = np.asarray(jvact.activation(jnp.asarray(x), kind, jpol))
    got = tvact.activation(torch.from_numpy(x), kind, tpol).numpy()
    if kind == "softmax":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=TINY)
    else:
        _bits_equal(got, want)


def test_activation_softmax_on_another_axis():
    x = _x((6, 5, 4), seed=3)
    jpol = jpolicy.FXP8.replace(act_backend="cordic")
    tpol = tpolicy.FXP8.replace(act_backend="cordic")
    want = np.asarray(jvact.activation(jnp.asarray(x), "softmax", jpol,
                                       axis=1))
    got = tvact.activation(torch.from_numpy(x), "softmax", tpol,
                           axis=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=TINY)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", EW_KINDS)
@pytest.mark.parametrize("n", [6, 13])
def test_plain_vact_bitwise_to_oracle(shape, kind, n):
    x = _x(shape, seed=sum(shape) + n)
    want = jref.vact(jnp.asarray(x), kind, n)
    got = tops.vact(torch.from_numpy(x), kind, n)
    _bits_equal(got.numpy(), want)
    _bits_equal(tref.vact(torch.from_numpy(x), kind, n).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_softmax_to_oracle(shape):
    x = _x(shape, seed=sum(shape))
    want = np.asarray(jref.vact(jnp.asarray(x), "softmax", 13))
    got = tops.vact(torch.from_numpy(x), "softmax", 13).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=TINY)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", EW_KINDS)
def test_plain_vact_q8_bitwise_to_oracle(shape, kind):
    rng = np.random.default_rng(sum(shape))
    qx = rng.integers(-127, 128, shape).astype(np.int8)
    sx = np.float32(0.03)
    want = np.asarray(jref.vact_q8(jnp.asarray(qx), jnp.asarray(sx), kind,
                                   13))
    got = tops.vact_q8(torch.from_numpy(qx), torch.tensor(sx), kind, 13)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(13, 37), (3, 5, 11)])
def test_plain_vact_against_pallas_interpret(shape):
    """The Pallas kernel scales by exp2, the reference by ldexp: one ulp
    apart at n=13 (the reference's own kernel bar is 1e-6)."""
    x = _x(shape, seed=11)
    for kind in ("sigmoid", "tanh", "softmax"):
        want = np.asarray(jops.vact(jnp.asarray(x), kind, 13))
        got = tops.vact(torch.from_numpy(x), kind, 13).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # int8 codes at atol 1e-6 are equal codes
    qx = np.random.default_rng(12).integers(-127, 128, shape).astype(np.int8)
    for kind in EW_KINDS:
        want = np.asarray(jops.vact_q8(jnp.asarray(qx), jnp.float32(0.05),
                                       kind, 13))
        got = tops.vact_q8(torch.from_numpy(qx), torch.tensor(0.05), kind,
                           13).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 6, 13, 24])
def test_cordic_params_carry_the_plain_constants(n):
    """The constants the kernel receives are the plain version's fp32
    values, bit for bit."""
    p = tops.cordic_params(n)
    sched = tvact.hyperbolic_schedule(n)
    f32 = lambda v: np.float32(v).view(np.int32)
    assert p.n == n
    assert f32(p.inv_gain) == f32(1.0 / tvact.cordic_gain(sched))
    assert f32(p.ln2) == f32(tvact.LN2)
    for k, i in enumerate(sched):
        assert f32(p.shift[k]) == f32(2.0 ** (-i))
        assert f32(p.atanh[k]) == f32(tvact._ATANH[i - 1])


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="iterations"):
        tops.vact(x, "tanh", 25)
    with pytest.raises(KeyError):
        tops.vact(x, "gelu", 6)
    with pytest.raises(TypeError, match="int8"):
        tops.vact_q8(x, torch.tensor(0.1), "tanh", 6)
    with pytest.raises(ValueError, match="per-tensor"):
        tops.vact_q8(x.to(torch.int8), torch.ones(2), "tanh", 6)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tops.vact(x.to("meta"), "tanh", 6)


def test_cpu_wrappers_launch_nothing():
    before = (tops.vact_ew.launches, tops.vact_softmax.launches,
              tops.vact_q8.launches)
    x = torch.randn(5, 6)
    tops.vact(x, "sigmoid", 6)
    tops.vact(x, "softmax", 6)
    tops.vact_q8(x.to(torch.int8), torch.tensor(0.1), "relu", 6)
    assert (tops.vact_ew.launches, tops.vact_softmax.launches,
            tops.vact_q8.launches) == before


@pytest.mark.parametrize("gate", range(4))
@pytest.mark.parametrize("kind", EW_KINDS)
def test_cpu_wrapper_on_a_gate_slice_equals_a_contiguous_copy(gate, kind):
    """The LSTM's xla branch hands ``vact_ew`` column slices of its
    [B, 4H] gate tensor; the CPU wrapper gives the bits it gives on a
    contiguous copy of the slice, and the reference's on that copy."""
    h = 32
    gates = _x((16, 4 * h), seed=40 + gate)
    sl = torch.from_numpy(gates)[:, gate * h:(gate + 1) * h]
    assert not sl.is_contiguous()
    got = tops.vact_ew(sl, kind, 6)
    want = tops.vact_ew(sl.contiguous(), kind, 6)
    assert got.shape == sl.shape
    _bits_equal(got.numpy(), want.numpy())
    _bits_equal(got.numpy(), jref.vact(
        jnp.asarray(np.ascontiguousarray(gates[:, gate * h:(gate + 1) * h])),
        kind, 6))


ALL_CODES = np.arange(-128, 128, dtype=np.int32).astype(np.int8)


@pytest.mark.parametrize("scale", [1e-30, 0.003, 0.05, 3.0])
@pytest.mark.parametrize("kind", EW_KINDS)
@pytest.mark.parametrize("n", [6, 13])
def test_plain_vact_q8_every_code_bitwise_to_oracle(scale, kind, n):
    """The table the int8 kernel builds is the plain version at every
    code, -128 included (no quantizer emits it; an input may hold it),
    at a scale that flushes everything to 0, two of the agent's and one
    that saturates."""
    sx = np.float32(scale)
    want = np.asarray(jref.vact_q8(jnp.asarray(ALL_CODES), jnp.asarray(sx),
                                   kind, n))
    got = tops.vact_q8(torch.from_numpy(ALL_CODES), torch.tensor(sx), kind,
                       n)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cols", [1, 4, 32, 33, 1025])
def test_plain_softmax_row_lengths_to_oracle(cols):
    """The row lengths at the softmax kernels' bounds (one element, the
    agent's 4 actions, a warp, a warp and one, past one warp a row)."""
    x = _x((5, cols), seed=cols)
    want = np.asarray(jref.vact(jnp.asarray(x), "softmax", 6))
    got = tops.vact_softmax(torch.from_numpy(x), 6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=TINY)


@pytest.mark.parametrize("cols", [4, 33])
def test_cpu_softmax_on_a_row_strided_view_equals_a_contiguous_copy(cols):
    """The wrappers read a row-strided view in place on the card; on the
    CPU the plain version gives the bits of a contiguous copy."""
    base = torch.from_numpy(_x((16, cols + 7), seed=cols + 1))
    view = base[:, 3:3 + cols]
    assert not view.is_contiguous()
    got = tops.vact_softmax(view, 6)
    _bits_equal(got.numpy(), tops.vact_softmax(view.contiguous(), 6).numpy())
    assert got.is_contiguous() and got.shape == view.shape


# x = 4.2331 (fp32 bits 0x4087758e) and its fp32 neighbours: where the
# reference's eager CORDIC and its compiled one (``jax.jit`` of
# ``repro.kernels.vact.ref.vact``, and the Pallas kernel) differ, tanh
# 0.9995657 eager against 0.9995922 jitted at n = 6 (rel 2.6e-5), 1.3e-5
# at n = 7, 2.4e-7 at n = 13.  The port follows the eager program.
PINNED = np.array([0x4087758C, 0x4087758D, 0x4087758E, 0x4087758F,
                   0x40877590], np.uint32).view(np.float32)


@pytest.mark.parametrize("n", [6, 7, 13])
@pytest.mark.parametrize("kind", ["tanh", "sigmoid"])
def test_pinned_input_bitwise_to_the_eager_reference(kind, n):
    """tanh at x and sigmoid at 2x (the argument tanh hands it), for x
    and -x: the port's plain CORDIC and its kernel wrapper's plain
    version, bit for bit against the reference run eagerly."""
    x = np.concatenate([PINNED, -PINNED]).astype(np.float32)
    if kind == "sigmoid":
        x = (2.0 * x).astype(np.float32)
    jfn = jvact.cordic_tanh if kind == "tanh" else jvact.cordic_sigmoid
    tfn = tvact.cordic_tanh if kind == "tanh" else tvact.cordic_sigmoid
    want = np.asarray(jfn(jnp.asarray(x), n))
    _bits_equal(tfn(torch.from_numpy(x), n).numpy(), want)
    _bits_equal(tops.vact(torch.from_numpy(x), kind, n).numpy(), want)
