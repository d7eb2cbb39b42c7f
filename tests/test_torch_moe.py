"""The MoE layer of the PyTorch port against the JAX package, at small
widths: ``core.qmatmul.q_batched_matmul`` (forward and STE), Q-MAC's
batched product's plain version, ``nn.moe``'s dispatch, ``moe_apply``
and ``moe_aux_loss``.

The same numpy inputs go to both packages; the reference runs op by op
(``jax.disable_jit()``).  Tolerances:

* int8 codes, int32 accumulators, dispatch positions and masks, the
  experts chosen: bitwise / equal;
* the int8 product's fp32 output: bitwise (its epilogue is two
  correctly rounded multiplies in both packages);
* fp products (fp32, fake-quant, QTensor experts) and the STE's
  gradients: ``rtol=1e-6`` plus 1e-6 of the output's largest magnitude
  (``close``): each library sums a contraction in its own order;
* ``moe_apply`` under an int8 policy with ``one_library`` (the router's
  product and softmax, the gates' sum and the combine's sum computed by
  the port's ``core.exact`` in both): bitwise; at fp32 ``close`` with
  each library's own primitives.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qmatmul as jqmm
from repro.core.fxp import QTensor as JQTensor
from repro.nn import moe as jmoe
from repro_torch.core import qmatmul as tqmm
from repro_torch.core.fxp import QTensor
from repro_torch.kernels.qmac import ops as tops
from repro_torch.kernels.qmac import ref as tref
from repro_torch.nn import moe as tmoe
from test_torch_lm_layers import (bits_equal, close, one_library, policies,
                                  to_torch)

__all__ = ["one_library"]          # the fixture, imported for its tests

DN = (((2,), (1,)), ((0,), (0,)))


def _rng(seed):
    return np.random.default_rng(seed)


def _x_w(e, c, k, n, seed, empty_rows=(1,)):
    """x [E, C, K] with all-zero capacity rows (amax 0) at ``empty_rows``
    of every expert, w [E, K, N]."""
    rng = _rng(seed)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    for r in empty_rows:
        x[:, r] = 0.0
    w = (rng.standard_normal((e, k, n)) * 0.2).astype(np.float32)
    return x, w


# ---------------------------------------------------------------------------
# Q-MAC's batched product (plain version on the CPU)
# ---------------------------------------------------------------------------

def _codes(e, c, k, n, seed, qmax=127):
    rng = _rng(seed)
    qx = rng.integers(-127, 128, (e, c, k)).astype(np.int8)
    qw = rng.integers(-qmax, qmax + 1, (e, k, n)).astype(np.int8)
    sx = rng.uniform(1e-4, 0.02, (e, c, 1)).astype(np.float32)
    sw = rng.uniform(1e-4, 0.02, (e, 1, n)).astype(np.float32)
    return [torch.from_numpy(a) for a in (qx, sx, qw, sw)]


@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("e,c,k,n", [(4, 5, 64, 24), (3, 1, 17, 9),
                                     (8, 10, 128, 40), (2, 33, 300, 16)])
def test_batched_plain_equals_the_fused_product_expert_by_expert(
        e, c, k, n, qmax):
    qx, sx, qw, sw = _codes(e, c, k, n, e * c + k + n, qmax)
    got = tops.qmac_i8_deq_bmm(qx, sx, qw, sw)
    assert got.dtype == torch.float32 and got.shape == (e, c, n)
    for i in range(e):
        bits_equal(got[i], tops.qmac_i8_deq_plain(
            qx[i], sx[i], qw[i], sw[i]).numpy())
    bits_equal(got, tref.qmac_i8_deq_bmm(qx, sx, qw, sw).numpy())
    # the reference's _fwd_bmm body: int32 dot_general, then (acc*sx)*sw
    acc = jax.lax.dot_general(jnp.asarray(qx.numpy()),
                              jnp.asarray(qw.numpy()), DN,
                              preferred_element_type=jnp.int32)
    want = acc.astype(jnp.float32) * jnp.asarray(sx.numpy()) \
        * jnp.asarray(sw.numpy())
    bits_equal(got, np.asarray(want))


def test_batched_plain_at_one_expert_is_the_unbatched_product():
    qx, sx, qw, sw = _codes(1, 7, 2048, 128, 3)
    got = tops.qmac_i8_deq_bmm(qx, sx, qw, sw)
    bits_equal(got[0], tops.qmac_i8_deq(qx[0], sx[0], qw[0],
                                        sw[0, 0]).numpy())


def test_batched_wrapper_refuses_bad_operands():
    qx, sx, qw, sw = _codes(2, 3, 8, 5, 0)
    with pytest.raises(TypeError, match="int8"):
        tops.qmac_i8_deq_bmm(qx.float(), sx, qw, sw)
    with pytest.raises(ValueError, match=r"\[E, C, K\] x \[E, K, N\]"):
        tops.qmac_i8_deq_bmm(qx, sx, qw[:1], sw)
    with pytest.raises(ValueError, match=r"\[E, C, K\] x \[E, K, N\]"):
        tops.qmac_i8_deq_bmm(qx[0], sx, qw[0], sw)
    with pytest.raises(ValueError, match="do not fit"):
        tops.qmac_i8_deq_bmm(qx, sx, qw, sw[:, :, :2])
    with pytest.raises(TypeError, match="fp32"):
        tops.qmac_i8_deq_bmm(qx, sx.double(), qw, sw)
    with pytest.raises(ValueError, match="131072"):
        tops.qmac_i8_deq_bmm(torch.zeros((1, 1, 131073), dtype=torch.int8),
                             torch.ones(1, 1, 1),
                             torch.zeros((1, 131073, 1), dtype=torch.int8),
                             torch.ones(1, 1, 1))


# ---------------------------------------------------------------------------
# q_batched_matmul
# ---------------------------------------------------------------------------

def _record_bmm(monkeypatch):
    """Record the operands ``q_batched_matmul`` hands the batched
    kernel's wrapper."""
    seen = []
    orig = tqmm.qmac_ops.qmac_i8_deq_bmm

    def rec(qx, sx, qw, sw):
        seen.append((qx, sx, qw, sw))
        return orig(qx, sx, qw, sw)
    monkeypatch.setattr(tqmm.qmac_ops, "qmac_i8_deq_bmm", rec)
    return seen


def _ref_int8_program(x, w, pol):
    """The reference's ``_fwd_bmm`` int8 body, step by step: (qx, sx,
    qw, sw, int32 acc)."""
    qx, sx = jqmm.quantize_rowwise(jnp.asarray(x), pol.a_bits)
    qmax = 127.0 if pol.w_bits == 8 else 7.0
    amax = jnp.max(jnp.abs(jnp.asarray(w)), axis=1, keepdims=True)
    sw = jnp.maximum(amax, 1e-12) / qmax
    qw = jnp.clip(jnp.round(jnp.asarray(w) / sw), -qmax, qmax).astype(
        jnp.int8)
    acc = jax.lax.dot_general(qx, qw, DN, preferred_element_type=jnp.int32)
    return [np.asarray(a) for a in (qx, sx, qw, sw, acc)]


@pytest.mark.parametrize("name", ["w8a8", "w4a8"])
@pytest.mark.parametrize("e,c,k,n", [(4, 6, 32, 24), (16, 4, 64, 40),
                                     (3, 5, 17, 9)])
def test_q_batched_matmul_int8_codes_and_accumulators(monkeypatch, name,
                                                      e, c, k, n):
    """Every int8 code and scale the port hands the batched kernel, its
    int32 accumulators and the fp32 output equal the reference's bit for
    bit, with empty capacity rows (amax 0) in every expert."""
    jp, tp = policies(name)
    x, w = _x_w(e, c, k, n, e + c + k + n)
    seen = _record_bmm(monkeypatch)
    got = tqmm.q_batched_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                tp)
    with jax.disable_jit():
        want = jqmm.q_batched_matmul(jnp.asarray(x), jnp.asarray(w), jp)
    bits_equal(got, np.asarray(want))
    (qx, sx, qw, sw), = seen
    rqx, rsx, rqw, rsw, racc = _ref_int8_program(x, w, jp)
    for a, b in ((qx, rqx), (sx, rsx), (qw, rqw), (sw, rsw)):
        bits_equal(a, b)
    acc = torch.stack([tref.qmac_i8(qx[i], qw[i]) for i in range(e)])
    bits_equal(acc, racc)
    assert int(qx[:, 1].abs().max()) == 0


@pytest.mark.parametrize("name", ["fp32", "w8a8", "w4a8"])
def test_q_batched_matmul_fp_branches(name):
    """fp32 (no quantization) and the fake-quant branch at
    ``backend="ref"``: fp products, ``close``."""
    jp, tp = policies(name)
    if name != "fp32":
        jp, tp = jp.with_backend("ref"), tp.with_backend("ref")
    x, w = _x_w(5, 4, 48, 20, 11)
    got = tqmm.q_batched_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                tp)
    with jax.disable_jit():
        want = jqmm.q_batched_matmul(jnp.asarray(x), jnp.asarray(w), jp)
    close(got, want)


@pytest.mark.parametrize("name", ["fp32", "w8a8", "w4a8"])
@pytest.mark.parametrize("scale", ["per_expert", "layer_view"])
def test_q_batched_matmul_qtensor_experts(monkeypatch, name, scale):
    """QTensor experts are dequantized and run an fp product (with
    fake-quantized activations under an int8 policy), whether their
    scale is per (expert, out channel) ``[E, 1, N]`` or the reference's
    PTQ view ``[1, 1, N]`` of a layer; never the int8 kernel."""
    jp, tp = policies(name)
    x, w = _x_w(4, 5, 32, 12, 21)
    bits = 4 if name == "w4a8" else 8
    axes = (1,) if scale == "per_expert" else (0, 1)
    qmax = 7.0 if bits == 4 else 127.0
    s = (np.abs(w).max(axis=axes, keepdims=True) / np.float32(qmax)
         ).astype(np.float32)
    q = np.clip(np.round(w / s), -qmax, qmax).astype(np.int8)
    seen = _record_bmm(monkeypatch)
    got = tqmm.q_batched_matmul(
        torch.from_numpy(x), QTensor(torch.from_numpy(q),
                                     torch.from_numpy(s), bits), tp)
    with jax.disable_jit():
        want = jqmm.q_batched_matmul(
            jnp.asarray(x), JQTensor(jnp.asarray(q), jnp.asarray(s), bits),
            jp)
    close(got, want)
    assert seen == []


def _bmm_grads(x, w, g, name):
    jp, tp = policies(name)
    with jax.disable_jit():
        jdx, jdw = jax.grad(
            lambda a, b: jnp.sum(jqmm.q_batched_matmul(a, b, jp)
                                 * jnp.asarray(g)), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (tqmm.q_batched_matmul(xt, wt, tp) * torch.from_numpy(g)).sum(
        ).backward()
    return (np.asarray(jdx), np.asarray(jdw)), (xt.grad, wt.grad)


@pytest.mark.parametrize("name", ["w8a8", "w4a8"])
def test_q_batched_matmul_ste_gradients(name):
    """The STE: dx = g w^T and dw = x^T g per expert at the unquantized
    operands, against ``jax.grad`` of the reference (``close``)."""
    x, w = _x_w(3, 5, 24, 10, 31)
    g = _rng(32).standard_normal((3, 5, 10)).astype(np.float32)
    (jdx, jdw), (tdx, tdw) = _bmm_grads(x, w, g, name)
    close(tdx, jdx)
    close(tdw, jdw)
    assert np.count_nonzero(tdx[:, 0].numpy()) == tdx[:, 0].numel()


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["over_capacity", "idle_expert",
                                  "ragged", "all_one_expert"])
def test_dispatch_indices(case):
    """Positions and keep masks equal the reference's: assignments past
    an expert's capacity dropped, an expert with no assignment, T*k not
    a multiple of E, and every assignment on one expert."""
    rng = _rng(len(case))
    e, cap = 8, 4
    if case == "over_capacity":
        idx = rng.choice([0, 3, 5], size=40)
    elif case == "idle_expert":
        idx = rng.integers(0, 7, size=24)          # expert 7 idle
    elif case == "ragged":
        idx = rng.integers(0, e, size=3 * 7)
    else:
        e, cap, idx = 5, 6, np.full(13, 2)
    idx = idx.astype(np.int32)
    with jax.disable_jit():
        jpos, jkeep = jmoe._dispatch_indices(jnp.asarray(idx), e, cap)
    pos, keep = tmoe._dispatch_indices(torch.from_numpy(idx), e, cap)
    bits_equal(pos, np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if case == "over_capacity":
        assert not keep.all()
    if case == "idle_expert":
        assert not (torch.from_numpy(idx) == 7).any()


def test_top_k_orders_ties_by_expert_index():
    probs = np.full((3, 16), 1 / 16, np.float32)
    probs[1, 9] = 0.5
    probs[2, [3, 11]] = 0.25
    vals, idx = tmoe._top_k(torch.from_numpy(probs), 8)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    bits_equal(vals, np.asarray(jvals))


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

def _moe_params(d, f, e, seed, zero_router=False):
    rng = _rng(seed)
    p = {"router": {"w": (rng.standard_normal((d, e)) / np.sqrt(d)
                          ).astype(np.float32)},
         "w_gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)
                    ).astype(np.float32),
         "w_up": (rng.standard_normal((e, d, f)) / np.sqrt(d)
                  ).astype(np.float32),
         "w_down": (rng.standard_normal((e, f, d)) / np.sqrt(f)
                    ).astype(np.float32)}
    if zero_router:
        p["router"]["w"][:] = 0.0                 # every prob 1/E
    return p


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_port(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _moe_both(p, x, e, k, name, library, request, port_p=None,
              ref_p=None):
    if library == "one_library":
        request.getfixturevalue("one_library")
    jp, tp = policies(name)
    with jax.disable_jit():
        want = jmoe.moe_apply(ref_p or _to_jax(p), jnp.asarray(x), top_k=k,
                              policy=jp)
    got = tmoe.moe_apply(port_p or _to_port(p), torch.from_numpy(x),
                         top_k=k, policy=tp)
    return got, np.asarray(want)


@pytest.mark.parametrize("name,library", [("fp32", "own"),
                                          ("w8a8", "one_library"),
                                          ("w4a8", "one_library")])
@pytest.mark.parametrize("e,k", [(8, 2), (16, 8)])
def test_moe_apply(request, e, k, name, library):
    """Against the reference at E = 8, k = 2 and E = 16, k = 8 (T = 14:
    T*k not a multiple of E, some assignments over capacity at k = 2);
    the int8 policies bitwise under ``one_library``, fp32 ``close`` with
    each library's own primitives."""
    d, f = 32, 48
    p = _moe_params(d, f, e, e + k)
    x = _rng(e * k).standard_normal((2, 7, d)).astype(np.float32)
    got, want = _moe_both(p, x, e, k, name, library, request)
    assert got.shape == (2, 7, d) and got.dtype == torch.float32
    if name == "fp32":
        close(got, want)
    else:
        bits_equal(got, want)


@pytest.mark.parametrize("name", ["fp32", "w8a8"])
def test_moe_apply_routes_tied_probabilities_alike(request, name):
    """A zero router makes every probability 1/E: both packages send
    every token to experts 0..k-1 (the lower index first), and capacity
    then drops the same assignments."""
    d, f, e, k = 16, 24, 8, 2
    p = _moe_params(d, f, e, 5, zero_router=True)
    x = _rng(6).standard_normal((2, 9, d)).astype(np.float32)
    chosen = []
    orig = tmoe._dispatch_indices

    def rec(idx, n, cap):
        chosen.append(idx.clone())
        return orig(idx, n, cap)
    library = "own" if name == "fp32" else "one_library"
    mp = pytest.MonkeyPatch()
    mp.setattr(tmoe, "_dispatch_indices", rec)
    try:
        got, want = _moe_both(p, x, e, k, name, library, request)
    finally:
        mp.undo()
    np.testing.assert_array_equal(
        chosen[0].numpy(), np.tile(np.arange(k), 18))
    if name == "fp32":
        close(got, want)
    else:
        bits_equal(got, want)


@pytest.mark.parametrize("scale", ["per_expert", "layer_view"])
def test_moe_apply_with_qtensor_experts(request, scale):
    """QTensor experts with ``[E, 1, N]`` scales and with the reference's
    PTQ view ``[1, 1, N]`` of one layer (a ``[1, 1, 1, N]`` stack's
    ``scale[i]``), under w8a8: fake-quantized activations and an fp
    product with the dequantized experts in both (``close``)."""
    d, f, e, k = 16, 24, 8, 2
    p = _moe_params(d, f, e, 9)
    axes = (1,) if scale == "per_expert" else (0, 1)
    jq, tq = {}, {}
    for name in ("w_gate", "w_up", "w_down"):
        w = p[name]
        s = (np.abs(w).max(axis=axes, keepdims=True) / np.float32(127)
             ).astype(np.float32)
        q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
        jq[name] = JQTensor(jnp.asarray(q), jnp.asarray(s), 8)
        tq[name] = QTensor(torch.from_numpy(q), torch.from_numpy(s), 8)
    ref_p = {"router": _to_jax(p["router"]), **jq}
    port_p = {"router": _to_port(p["router"]), **tq}
    x = _rng(10).standard_normal((2, 6, d)).astype(np.float32)
    got, want = _moe_both(p, x, e, k, "w8a8", "own", request,
                          port_p=port_p, ref_p=ref_p)
    close(got, want)


def test_moe_apply_reads_nothing_back_to_the_host(monkeypatch):
    """No ``.item()`` or ``.tolist()`` in the layer: capacity is a
    Python int from static shapes, as in the reference's jitted layer."""
    def refuse(*_a, **_k):
        raise AssertionError("host read inside moe_apply")
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    p = _to_port(_moe_params(16, 24, 8, 12))
    out = tmoe.moe_apply(p, torch.ones(2, 5, 16), top_k=2,
                         policy=policies("w8a8")[1])
    assert out.shape == (2, 5, 16)


def test_moe_init_draws_the_reference_tree():
    """Paths, shapes and dtypes of the reference's ``moe_init``, and
    lecun statistics: each leaf's std within 10% of 1/sqrt(fan_in) in
    both (the router's 512 draws leave a few percent of noise)."""
    from repro.nn.module import unbox
    want = unbox(jmoe.moe_init(jax.random.PRNGKey(0), 64, 96, 8))
    got = tmoe.moe_init(torch.Generator().manual_seed(0), 64, 96, 8)
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got))
    for (_, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                         jax.tree.leaves(got)):
        assert tuple(b.shape) == a.shape and b.dtype == to_torch(a).dtype
        want_std = 1 / np.sqrt(a.shape[-2])
        assert abs(float(b.std()) / want_std - 1) < 0.1
        assert abs(float(np.std(a)) / want_std - 1) < 0.1


def test_moe_aux_loss():
    rng = _rng(41)
    logits = rng.standard_normal((30, 8)).astype(np.float32)
    gate = rng.integers(0, 8, (30, 2)).astype(np.int32)
    want = jmoe.moe_aux_loss(jnp.asarray(logits), jnp.asarray(gate), 8)
    got = tmoe.moe_aux_loss(torch.from_numpy(logits),
                            torch.from_numpy(gate), 8)
    close(got, np.asarray(want))
