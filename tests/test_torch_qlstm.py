"""Q-LSTM of the PyTorch port against the JAX package.

On the CPU the port's ``qlstm_cell`` takes its plain PyTorch version.
It is held bitwise against the reference oracle
(``repro.kernels.qlstm.ref.qlstm_cell``, run eagerly) and against the
Pallas kernel in interpret mode at rtol=atol=1e-6 (the Pallas kernel
scales CORDIC's 2^m by ``exp2``, the oracle by ``ldexp``: one ulp apart
at some inputs).  The layer above it (``lstm_cell``, ``lstm_apply``) is
held against ``repro.nn.lstm`` in both quantized branches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core import quantizer as jquant
from repro.kernels.qlstm import ops as jops
from repro.kernels.qlstm import ref as jref
from repro.nn import lstm as jlstm
from repro.nn.module import unbox
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.core import policy as tpolicy
from repro_torch.core import quantizer as tquant
from repro_torch.kernels.qlstm import ops as tops
from repro_torch.kernels.qlstm import ref as tref
from repro_torch.nn import lstm as tlstm

# (B, Din, H): ragged batches at the paper's H = 32 and a narrow cell
CELLS = [(1, 8, 8), (5, 8, 8), (13, 8, 8), (1, 32, 32), (7, 32, 32),
         (13, 32, 32)]


def _cell_operands(b, d_in, h, seed):
    rng = np.random.default_rng(seed)
    qx = rng.integers(-127, 128, (b, d_in)).astype(np.int8)
    qh = rng.integers(-127, 128, (b, h)).astype(np.int8)
    qw = rng.integers(-127, 128, (d_in, 4 * h)).astype(np.int8)
    qu = rng.integers(-127, 128, (h, 4 * h)).astype(np.int8)
    sx = np.float32(rng.uniform(0.005, 0.02))
    sh = np.float32(rng.uniform(0.005, 0.02))
    sw = rng.uniform(1e-3, 4e-3, (1, 4 * h)).astype(np.float32)
    su = rng.uniform(1e-3, 4e-3, (1, 4 * h)).astype(np.float32)
    bias = (rng.normal(size=(4 * h,)) * 0.1).astype(np.float32)
    c = rng.normal(size=(b, h)).astype(np.float32)
    return qx, sx, qh, sh, qw, sw, qu, su, bias, c


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("b,d_in,h", CELLS)
@pytest.mark.parametrize("n", [6, 13])
def test_plain_cell_bitwise_to_oracle(b, d_in, h, n):
    ops = _cell_operands(b, d_in, h, seed=b * 100 + d_in + n)
    want_h, want_c = jref.qlstm_cell(*map(jnp.asarray, ops), n_iters=n)
    got_h, got_c = tops.qlstm_cell(*map(torch.as_tensor, ops), n_iters=n)
    _bits_equal(got_h.numpy(), want_h)
    _bits_equal(got_c.numpy(), want_c)
    own_h, own_c = tref.qlstm_cell(*map(torch.as_tensor, ops), n_iters=n)
    _bits_equal(own_h.numpy(), want_h)
    _bits_equal(own_c.numpy(), want_c)


@pytest.mark.parametrize("b,d_in,h", [(5, 8, 8), (13, 32, 32)])
def test_plain_cell_against_pallas_interpret(b, d_in, h):
    ops = _cell_operands(b, d_in, h, seed=b + h)
    want_h, want_c = jops.qlstm_cell(*map(jnp.asarray, ops), n_iters=13)
    got_h, got_c = tops.qlstm_cell(*map(torch.as_tensor, ops), n_iters=13)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=1e-6, atol=1e-6)


def test_cell_refuses_what_it_does_not_take():
    ops = [torch.as_tensor(a) for a in _cell_operands(3, 8, 8, seed=0)]
    with pytest.raises(TypeError, match="int8"):
        tops.qlstm_cell(ops[0].float(), *ops[1:])
    with pytest.raises(ValueError, match="shapes"):
        tops.qlstm_cell(ops[0], ops[1], ops[2][:, :4], *ops[3:])
    # a block's share of the stripe past its shared memory: the VMEM
    # guard's place (a block stages 8 units' columns over all of Din)
    with pytest.raises(ValueError, match="shared memory"):
        h, d_in = 8, 8192
        tops.qlstm_cell(torch.zeros((1, d_in), dtype=torch.int8),
                        torch.ones(()), torch.zeros((1, h), dtype=torch.int8),
                        torch.ones(()),
                        torch.zeros((d_in, 4 * h), dtype=torch.int8),
                        torch.ones(4 * h),
                        torch.zeros((h, 4 * h), dtype=torch.int8),
                        torch.ones(4 * h), torch.zeros(4 * h),
                        torch.zeros((1, h)))


def _layer(d_in, h, seed):
    jp = unbox(jlstm.lstm_init(jax.random.PRNGKey(seed), d_in, h))
    return jp, from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")


def _seq(b, s, d_in, seed):
    return np.random.default_rng(seed).normal(
        size=(b, s, d_in)).astype(np.float32)


CORDIC8 = (jpolicy.FXP8.replace(act_backend="cordic"),
           tpolicy.FXP8.replace(act_backend="cordic"))


def _ref_apply(jp, xs, jpol):
    """``repro.nn.lstm.lstm_apply`` with its ``lax.scan`` run op by op:
    compiled, XLA fuses the step's multiply-adds and rounds them
    otherwise than its own eager ops do."""
    with jax.disable_jit():
        return jlstm.lstm_apply(jp, jnp.asarray(xs), jpol)


def test_xla_branch_bitwise():
    """``lstm_cell`` from a nonzero state and a 4-step ``lstm_apply`` in
    the q_matmul + CORDIC activation branch (FxP8)."""
    jp, tp = _layer(16, 8, seed=1)
    xs = _seq(5, 4, 16, seed=2)
    rng = np.random.default_rng(3)
    h0 = rng.normal(size=(5, 8)).astype(np.float32)
    c0 = rng.normal(size=(5, 8)).astype(np.float32)
    want = jlstm.lstm_cell(jp, jnp.asarray(xs[:, 0]), jnp.asarray(h0),
                           jnp.asarray(c0), CORDIC8[0])
    got = tlstm.lstm_cell(tp, torch.from_numpy(xs[:, 0]),
                          torch.from_numpy(h0), torch.from_numpy(c0),
                          CORDIC8[1])
    for g, w in zip(got, want):
        _bits_equal(g.numpy(), w)
    want_hs, (want_h, want_c) = _ref_apply(jp, xs, CORDIC8[0])
    got_hs, (got_h, got_c) = tlstm.lstm_apply(tp, torch.from_numpy(xs),
                                              CORDIC8[1])
    _bits_equal(got_hs.numpy(), want_hs)
    _bits_equal(got_h.numpy(), want_h)
    _bits_equal(got_c.numpy(), want_c)


@pytest.mark.parametrize("pol", ["fp32", "w8_cordic"])
def test_fp_product_branches_match(pol):
    """fp32 products (FP32; w8's fake-quantized weights) sum in another
    order in torch and XLA: held at rtol=1e-5."""
    jpol, tpol = {
        "fp32": (jpolicy.FP32, tpolicy.FP32),
        "w8_cordic": (jpolicy.W8.replace(act_backend="cordic"),
                      tpolicy.W8.replace(act_backend="cordic"))}[pol]
    jp, tp = _layer(16, 8, seed=4)
    xs = _seq(3, 4, 16, seed=5)
    want_hs, _ = _ref_apply(jp, xs, jpol)
    got_hs, _ = tlstm.lstm_apply(tp, torch.from_numpy(xs), tpol)
    np.testing.assert_allclose(got_hs.numpy(), np.asarray(want_hs),
                               rtol=1e-5, atol=1e-6)


PALLAS = (jpolicy.FXP8.replace(backend="pallas", act_backend="cordic"),
          tpolicy.FXP8.replace(backend="pallas", act_backend="cordic"))


def test_pallas_branch_bitwise_with_the_oracle_cell(monkeypatch):
    """The fused branch over 4 steps, the reference's cell routed to its
    oracle: the per-tensor requantization and the cell are bitwise."""
    def oracle_cell(qx, sx, qh, sh, qw, sw, qu, su, b, c, *, n_iters=13,
                    interpret=None):
        return jref.qlstm_cell(qx, sx, qh, sh, qw, sw, qu, su, b, c,
                               n_iters)
    monkeypatch.setattr(jops, "qlstm_cell", oracle_cell)
    jp, tp = _layer(32, 32, seed=6)
    xs = _seq(7, 4, 32, seed=7)
    want_hs, (want_h, want_c) = _ref_apply(jp, xs, PALLAS[0])
    got_hs, (got_h, got_c) = tlstm.lstm_apply(tp, torch.from_numpy(xs),
                                              PALLAS[1])
    _bits_equal(got_hs.numpy(), want_hs)
    _bits_equal(got_h.numpy(), want_h)
    _bits_equal(got_c.numpy(), want_c)


def test_pallas_branch_against_pallas_interpret():
    """One step of the fused branch against the Pallas kernel itself."""
    jp, tp = _layer(32, 32, seed=8)
    xs = _seq(5, 1, 32, seed=9)
    h0 = np.random.default_rng(10).normal(size=(5, 32)).astype(np.float32)
    c0 = np.zeros((5, 32), np.float32)
    want = jlstm.lstm_cell(jp, jnp.asarray(xs[:, 0]), jnp.asarray(h0),
                           jnp.asarray(c0), PALLAS[0])
    got = tlstm.lstm_cell(tp, torch.from_numpy(xs[:, 0]),
                          torch.from_numpy(h0), torch.from_numpy(c0),
                          PALLAS[1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_pallas_branch_refuses_packed_weights():
    """The reference's fused branch calls ``quantize`` on a QTensor and
    fails with a TypeError; the port refuses the same input the same
    way."""
    jp, tp = _layer(8, 8, seed=11)
    x = np.zeros((2, 8), np.float32)
    z = np.zeros((2, 8), np.float32)
    with pytest.raises(TypeError):
        jlstm.lstm_cell(jquant.quantize_params(jp, jpolicy.FXP8),
                        jnp.asarray(x), jnp.asarray(z), jnp.asarray(z),
                        PALLAS[0])
    with pytest.raises(TypeError, match="QTensor"):
        tlstm.lstm_cell(tquant.quantize_params(tp, tpolicy.FXP8),
                        torch.from_numpy(x), torch.from_numpy(z),
                        torch.from_numpy(z), PALLAS[1])
