"""The ssm and hybrid LMs' layers of the PyTorch port (the depthwise
causal conv, Mamba-2's SSD, the RG-LRU and its associative scan, the
Griffin recurrent block, and ``core.exact``'s cumsum, softplus and
SiLU) against the JAX package, at small widths.

The same numpy inputs and params go to both packages; the reference
runs op by op (``jax.disable_jit()``, which also runs its ``lax.scan``
and ``associative_scan`` eagerly).  Tolerances:

* under ``one_library`` (the reference's einsum, exp, cumsum, softplus,
  sigmoid, SiLU and depthwise conv computed by the port's, through fp64;
  see test_torch_lm_layers.py) every layer's output, state and int8
  code is bitwise, fp32 products excepted: ``jnp.dot`` and
  ``torch.matmul`` sum in another order, so an ``fp32`` policy's
  output is held within rtol 1e-6 plus 1e-5 of its largest magnitude;
* ``associative_scan`` bitwise against ``jax.lax.associative_scan`` with
  nothing patched (both are multiplies and adds in one order);
* each new ``core.exact`` function is the fp64 value rounded once: it
  equals numpy's fp64 result rounded to fp32.  JAX's own functions are
  not correctly rounded: over 6 N(0, 1) draws its softplus and SiLU
  land up to 3 ulps from that value (and flush subnormal results to
  zero), and its fp32 cumsum drifts by about an ulp per doubling of the
  length.  So each is held within those measured bounds of the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as jquant
from repro.core.fxp import QTensor as JQTensor
from repro.nn import conv as jconv
from repro.nn import rglru as jrglru
from repro.nn import ssm as jssm
from repro.nn.module import unbox
from repro_torch.core import exact
from repro_torch.core import quantizer as tquant
from repro_torch.core.fxp import QTensor
from repro_torch.nn import conv as tconv
from repro_torch.nn import rglru as trglru
from repro_torch.nn import ssm as tssm
from test_torch_lm_layers import (bits_equal, carry, close, one_library,
                                  policies, to_numpy, to_torch)

__all__ = ["one_library"]          # the fixture, imported for its tests


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _ulps(got, want):
    got = np.asarray(to_numpy(got) if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))


def _fp32_close(got, want):
    close(got, want, rtol=1e-6, scale=1e-5)


# ---------------------------------------------------------------------------
# core.exact
# ---------------------------------------------------------------------------

def _softplus64(x):
    return np.logaddexp(x.astype(np.float64), 0.0)


def _silu64(x):
    # x times the sigmoid rounded to fp32: the product is one fp32 multiply
    sig = (1.0 / (1.0 + np.exp(-x.astype(np.float64)))).astype(np.float32)
    return x * sig


@pytest.mark.parametrize("name,jfn,truth", [
    ("softplus", jax.nn.softplus, _softplus64),
    ("silu", jax.nn.silu, _silu64)])
def test_exact_unary(name, jfn, truth):
    x = np.concatenate([_normal((200000,), 70, 6.0), np.array(
        [0.0, -0.0, 20.0, -20.0, 30.0, -30.0, 1e-30, -1e-30, 80.0],
        np.float32)])
    got = getattr(exact, name)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    bits_equal(got, np.asarray(truth(x), np.float32))
    with jax.disable_jit():
        want = np.asarray(jfn(jnp.asarray(x)))
    normal = np.abs(want) >= np.finfo(np.float32).tiny
    assert _ulps(got, want)[normal].max() <= 3
    assert (_ulps(got, want) > 1).mean() < 0.05
    got16 = getattr(exact, name)(torch.from_numpy(x).to(torch.bfloat16))
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("length,ulps", [(8, 1), (128, 2)])
def test_exact_cumsum(length, ulps):
    """One-signed rows, as the SSD's ``dt * A`` are: the port's prefix
    sums are fp64 sums rounded once; JAX's fp32 sums within ``ulps``."""
    a = -np.abs(_normal((64, length), 71, 0.5))
    got = exact.cumsum(torch.from_numpy(a), -1)
    bits_equal(got, np.cumsum(a.astype(np.float64), -1).astype(np.float32))
    with jax.disable_jit():
        want = jnp.cumsum(jnp.asarray(a), axis=-1)
    assert _ulps(got, want).max() <= ulps
    bits_equal(exact.cumsum(torch.from_numpy(a.T.copy()), 0),
               np.ascontiguousarray(to_numpy(got).T))


# ---------------------------------------------------------------------------
# the depthwise causal conv
# ---------------------------------------------------------------------------

def _conv_weight(kind, seed):
    """(reference weight, port weight) for one layer: fp, a 2-D PTQ'd
    weight (a scale per channel), or a layer of a stacked [L, 4, C] PTQ'd
    weight (a scale per layer and channel, reduced over the taps)."""
    w = _normal((4, 24), seed, 0.5)
    if kind == "fp":
        return jnp.asarray(w), torch.from_numpy(w)
    if kind in ("w8", "w4"):
        q = JQTensor.quant(jnp.asarray(w), int(kind[1]), channel_axis=1)
        return q, QTensor(to_torch(q.qvalue), to_torch(q.scale), q.bits)
    stacked = np.stack([w, _normal((4, 24), seed + 1, 2.0)])
    q = jquant.quantize_params({"w": jnp.asarray(stacked)},
                               policies("w8a8")[0])["w"]
    return (JQTensor(q.qvalue[1], q.scale[1], q.bits),
            QTensor(to_torch(q.qvalue[1]), to_torch(q.scale[1]), q.bits))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["fp", "w8", "w4", "stacked_w8"])
def test_causal_conv1d(one_library, kind, dtype):
    """The full sequence and 5 decode steps from the prefill's raw tail,
    each output and state bitwise."""
    jw, tw = _conv_weight(kind, 72)
    b = _normal((24,), 73, 0.1)
    jp, tp = {"w": jw, "b": jnp.asarray(b)}, {"w": tw, "b":
                                               torch.from_numpy(b)}
    xs = jnp.asarray(_normal((2, 11, 24), 74)).astype(dtype)
    with jax.disable_jit():
        want = jconv.causal_conv1d_apply(jp, xs[:, :6])
        jstate = xs[:, 3:6].astype(jnp.float32)
        wsteps = []
        for t in range(6, 11):
            out, jstate = jconv.causal_conv1d_apply(jp, xs[:, t:t + 1],
                                                    jstate)
            wsteps.append((out, jstate))
    tx = to_torch(xs)
    got = tconv.causal_conv1d_apply(tp, tx[:, :6])
    bits_equal(got, want)
    tstate = tx[:, 3:6].to(torch.float32)
    for t, (wout, wst) in zip(range(6, 11), wsteps, strict=True):
        out, tstate = tconv.causal_conv1d_apply(tp, tx[:, t:t + 1], tstate)
        bits_equal(out, wout)
        bits_equal(tstate, wst)


def test_causal_conv1d_init():
    p = tconv.causal_conv1d_init(torch.Generator().manual_seed(0), 512)
    ref = unbox(jconv.causal_conv1d_init(jax.random.PRNGKey(0), 512))
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        k: (tuple(v.shape), torch.float32) for k, v in ref.items()}
    # he_init over the taps (fan-in 4): std sqrt(2 / 4)
    assert abs(float(p["w"].std()) / float(np.std(ref["w"])) - 1) < 0.05
    assert not p["b"].any()


# ---------------------------------------------------------------------------
# Mamba-2's SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(b, l, h, p, n, seed):
    X = _normal((b, l, h, p), seed)
    A = -np.abs(_normal((b, l, h), seed + 1, 1.5))
    Bm = _normal((b, l, 1, n), seed + 2)
    C = _normal((b, l, 1, n), seed + 3)
    return X, A, Bm, C


def test_segsum(one_library):
    x = -np.abs(_normal((2, 3, 4, 8), 75))
    with jax.disable_jit():
        want = jssm._segsum(jnp.asarray(x))
    got = tssm._segsum(torch.from_numpy(x))
    bits_equal(got, want)
    assert np.isneginf(to_numpy(got)[..., 0, 1]).all()


@pytest.mark.parametrize("l,chunk", [(16, 8), (8, 8), (16, 4)])
def test_ssd_chunked(one_library, l, chunk):
    """Chunk counts 2, 1 and 4; Y and the final state bitwise."""
    ins = _ssd_inputs(2, l, 4, 8, 16, 76)
    with jax.disable_jit():
        wy, wf = jssm.ssd_chunked(*map(jnp.asarray, ins), chunk)
    gy, gf = tssm.ssd_chunked(*map(torch.from_numpy, ins), chunk)
    bits_equal(gy, wy)
    bits_equal(gf, wf)


def test_prompt_must_be_whole_chunks():
    ins = _ssd_inputs(1, 12, 4, 8, 16, 77)
    with jax.disable_jit(), pytest.raises(AssertionError, match="12, 8"):
        jssm.ssd_chunked(*map(jnp.asarray, ins), 8)
    with pytest.raises(AssertionError, match="12, 8"):
        tssm.ssd_chunked(*map(torch.from_numpy, ins), 8)


SSM = dict(d_model=32, d_inner=64, head_dim=16, d_state=16, chunk=8)


def _ssm_params(seed):
    cfg = jssm.SSMConfig(**SSM)
    return cfg, tssm.SSMConfig(**SSM), unbox(
        jssm.ssm_init(jax.random.PRNGKey(seed), cfg))


def _agree(policy, got, want):
    if policy == "fp32":
        _fp32_close(got, want)
    else:
        bits_equal(got, want)


@pytest.mark.parametrize("policy", ["fp32", "w8a8"])
def test_ssm_apply(one_library, policy):
    """The full forward, the prefill (``return_state``) and 5 decode
    steps from its state, each output and state held."""
    jcfg, tcfg, ref = _ssm_params(78)
    jp, tp = policies(policy)
    jparams, tparams = jax.tree.map(jnp.asarray, ref), carry(ref)
    cdt = jp.compute_dtype
    u = jnp.asarray(_normal((2, 21, 32), 79)).astype(cdt)
    with jax.disable_jit():
        want = jssm.ssm_apply(jparams, u[:, :16], jcfg, jp)
        wpre, jstate = jssm.ssm_apply(jparams, u[:, :16], jcfg, jp,
                                      return_state=True)
        wsteps = []
        for t in range(16, 21):
            out, jstate = jssm.ssm_apply(jparams, u[:, t:t + 1], jcfg, jp,
                                         state=jstate)
            wsteps.append((out, jstate))
    tu = to_torch(u)
    got = tssm.ssm_apply(tparams, tu[:, :16], tcfg, tp)
    gpre, tstate = tssm.ssm_apply(tparams, tu[:, :16], tcfg, tp,
                                  return_state=True)
    _agree(policy, got, want)
    _agree(policy, gpre, wpre)
    for t, (wout, wst) in zip(range(16, 21), wsteps, strict=True):
        out, tstate = tssm.ssm_apply(tparams, tu[:, t:t + 1], tcfg, tp,
                                     state=tstate)
        _agree(policy, out, wout)
        for k in ("ssm", "conv"):
            _agree(policy, tstate[k], wst[k])


def test_ssm_init_tree_and_state():
    jcfg, tcfg, ref = _ssm_params(0)
    got = tssm.ssm_init(torch.Generator().manual_seed(0), tcfg)
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), ref)
    assert jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).replace("torch.", "")),
                        got, is_leaf=lambda x: isinstance(x, torch.Tensor)
                        ) == shapes
    a = torch.exp(got["A_log"])
    assert bool(((a >= 1) & (a < 16)).all())
    want = jssm.ssm_init_state(3, jcfg)
    for k, v in tssm.ssm_init_state(3, tcfg).items():
        bits_equal(v, want[k])


# ---------------------------------------------------------------------------
# the RG-LRU and the Griffin recurrent block
# ---------------------------------------------------------------------------

# lengths from 1 to 70: odd ones, powers of two and their neighbours
# (each new length compiles every eager primitive of the reference anew)
SCAN_LENGTHS = (1, 2, 3, 4, 5, 8, 16, 17, 32, 33, 64, 70)


@pytest.mark.parametrize("length", SCAN_LENGTHS)
def test_associative_scan(length):
    """The RG-LRU's combine on a [S] and a [2, S, 64] operand, bitwise
    with nothing patched (a -0.0 comes out +0.0 in both)."""
    rng = np.random.default_rng(length)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    for shape, axis in (((length,), 0), ((2, length, 64), 1)):
        a = rng.uniform(0.3, 1.0, shape).astype(np.float32)
        b = rng.standard_normal(shape).astype(np.float32)
        b.flat[0] = -0.0
        with jax.disable_jit():
            want = jax.lax.associative_scan(
                combine, (jnp.asarray(a), jnp.asarray(b)), axis=axis)
        got = trglru.associative_scan(
            trglru._combine, (torch.from_numpy(a), torch.from_numpy(b)),
            axis=axis)
        for g, w in zip(got, want, strict=True):
            bits_equal(g, w)


def _rec_params(seed, d=32, w=48):
    return unbox(jrglru.recurrent_block_init(jax.random.PRNGKey(seed), d, w))


@pytest.mark.parametrize("policy", ["fp32", "w8a8"])
def test_rglru_apply(one_library, policy):
    """The gates and the scan over 17 positions, then 4 decode steps from
    the scan's last state."""
    ref = _rec_params(80)["rglru"]
    jp, tp = policies(policy)
    jparams, tparams = jax.tree.map(jnp.asarray, ref), carry(ref)
    x = jnp.asarray(_normal((2, 21, 48), 81)).astype(jp.compute_dtype)
    with jax.disable_jit():
        wh, wlast = jrglru.rglru_apply(jparams, x[:, :17], jp)
        jstate = wlast
        wsteps = []
        for t in range(17, 21):
            out, jstate = jrglru.rglru_apply(jparams, x[:, t:t + 1], jp,
                                             jstate)
            wsteps.append((out, jstate))
    tx = to_torch(x)
    gh, tstate = trglru.rglru_apply(tparams, tx[:, :17], tp)
    _agree(policy, gh, wh)
    _agree(policy, tstate, wlast)
    for t, (wout, wst) in zip(range(17, 21), wsteps, strict=True):
        out, tstate = trglru.rglru_apply(tparams, tx[:, t:t + 1], tp,
                                         tstate)
        _agree(policy, out, wout)
        _agree(policy, tstate, wst)


@pytest.mark.parametrize("policy", ["fp32", "w8a8", "w4a8"])
def test_recurrent_block_apply(one_library, policy):
    """The block's full forward, then 4 decode steps from a state of the
    prompt's raw conv tail and RG-LRU state."""
    ref = _rec_params(82)
    jp, tp = policies(policy)
    jparams, tparams = jax.tree.map(jnp.asarray, ref), carry(ref)
    if jp.quantized_w:
        jparams = jquant.quantize_params(jparams, jp)
        tparams = tquant.quantize_params(tparams, tp)
    x = jnp.asarray(_normal((2, 20, 32), 83)).astype(jp.compute_dtype)
    with jax.disable_jit():
        want = jrglru.recurrent_block_apply(jparams, x[:, :16], jp)
        jstate = jrglru.recurrent_block_init_state(2, 48)
        wsteps = []
        for t in range(16, 20):
            out, jstate = jrglru.recurrent_block_apply(
                jparams, x[:, t:t + 1], jp, state=jstate)
            wsteps.append((out, jstate))
    tx = to_torch(x)
    _agree(policy, trglru.recurrent_block_apply(tparams, tx[:, :16], tp),
           want)
    tstate = trglru.recurrent_block_init_state(2, 48)
    for t, (wout, wst) in zip(range(16, 20), wsteps, strict=True):
        out, tstate = trglru.recurrent_block_apply(
            tparams, tx[:, t:t + 1], tp, state=tstate)
        _agree(policy, out, wout)
        for k in ("conv", "rglru"):
            _agree(policy, tstate[k], wst[k])


def test_recurrent_block_init_tree():
    ref = _rec_params(0)
    got = trglru.recurrent_block_init(torch.Generator().manual_seed(0), 32,
                                      48)
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    assert jax.tree.map(lambda t: tuple(t.shape), got, is_leaf=lambda x:
                        isinstance(x, torch.Tensor)) == shapes
    L = got["rglru"]["L"]
    assert bool(((L >= 2) & (L < 6)).all())
    want = jrglru.recurrent_block_init_state(3, 48)
    for k, v in trglru.recurrent_block_init_state(3, 48).items():
        bits_equal(v, want[k])
