"""The LM serving path of the PyTorch port (configs, PTQ, the dense
transformer's init, prefill and decode, sampling, ``launch/serve``)
against the JAX package, at the reduced configs.

Whole-model cases carry the reference's params into the port, run the
reference's prefill and 8 greedy decode steps op by op
(``jax.disable_jit()``), and feed the reference's tokens to the port's
decode steps, so every step's logits compare.  Tolerances:

* PTQ payloads and scales, and the greedy tokens: bitwise / equal;
* under ``one_library`` (the reference's einsum, softmax, rsqrt, sin,
  cos and SiLU sigmoid computed by the port's, through fp64; see
  test_torch_lm_layers.py)
  every int8-activation policy's logits are bitwise, fp32-compute
  (w8a8, w8a8kv8, w4a8) and bf16-compute (qforce8) alike;
* ``fp32``: logits within rtol 1e-6 plus 4e-6 of the logits' largest
  magnitude: its products are fp32 sums in another order in each
  library, and the error of 4 layers and 9 forwards lands on logits
  that cancel to near zero;
* ``bf16``: logits within 3e-2 of their largest magnitude (about 8 bf16
  ulps: each library rounds its bf16 products to bf16 from sums in
  another order), and the tokens equal wherever the reference's top
  two logits are further apart than that;
* ``fp32`` is also held with each library's own primitives
  (``test_each_librarys_own_fp32``), at the same bound.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.core import quantizer as jquant
from repro.launch import serve as jserve
from repro.models import encdec as jed
from repro.models import mamba as jmamba
from repro.models import recurrent as jrec
from repro.models import registry as jmodels
from repro.models import transformer as jtr
from repro.nn.module import unbox
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.core import qmatmul as tqm
from repro_torch.core import quantizer as tquant
from repro_torch.core.fxp import QTensor
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec as ted
from repro_torch.models import mamba as tmamba
from repro_torch.models import recurrent as trec
from repro_torch.models import registry as tmodels
from repro_torch.models import transformer as ttr
from repro_torch.tree import leaves_with_path
from test_torch_lm_layers import (bits_equal, carry, one_library, policies,
                                  to_torch)

__all__ = ["one_library"]          # the fixture, imported for its tests

ARCHS = sorted(jreg.ARCHS)
DENSE = [a for a in ARCHS if jreg.ARCHS[a].family == "dense"]
WHOLE = ["tinyllama-1.1b", "qwen2-72b", "chameleon-34b"]
B, S, STEPS = 2, 32, 8


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_counts_equal_the_reference(arch):
    jc, tc = jreg.get_arch(arch), treg.get_arch(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(
        jc.reduced())
    assert (tc.hd, tc.is_moe, tc.sub_quadratic) == (jc.hd, jc.is_moe,
                                                    jc.sub_quadratic)
    assert tbase.param_count(tc) == jbase.param_count(jc)
    assert tbase.active_param_count(tc) == jbase.active_param_count(jc)
    assert tbase.pad_vocab(tc.vocab) == jbase.pad_vocab(jc.vocab)
    for name, shape in jshapes.SHAPES.items():
        assert dataclasses.asdict(tshapes.SHAPES[name]) == \
            dataclasses.asdict(shape)
        assert tshapes.shape_applicable(tc, tshapes.SHAPES[name]) == \
            jshapes.shape_applicable(jc, shape)


def test_registry_names_and_unknown_arch():
    assert sorted(treg.ARCHS) == ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_arch("gpt-5")


@pytest.mark.parametrize("arch", ARCHS)
def test_model_for(arch):
    cfg = treg.get_arch(arch)
    ported = {"encdec": (ted, jed), "ssm": (tmamba, jmamba),
              "hybrid": (trec, jrec)}
    if cfg.family in ported:
        port, ref = ported[cfg.family]
        assert tmodels.model_for(cfg) is port
        assert jmodels.model_for(jreg.get_arch(arch)) is ref
        assert port.__name__.split(".")[-1] == ref.__name__.split(".")[-1]
        return
    assert tmodels.model_for(cfg) is ttr
    assert jmodels.model_for(jreg.get_arch(arch)) is jtr
    if cfg.is_moe:
        # the transformer's MoE blocks (test_torch_lm_moe.py holds them
        # against the reference)
        small = cfg.reduced()
        params = ttr.init(torch.Generator().manual_seed(0), small,
                          device="cpu")
        assert params["blocks"]["moe"]["w_gate"].shape == (
            small.n_layers, small.n_experts, small.d_model, small.d_ff)
        assert "mlp" not in params["blocks"]


# ---------------------------------------------------------------------------
# init and PTQ
# ---------------------------------------------------------------------------

@functools.cache
def _ref_params(arch, seed):
    cfg = jreg.get_arch(arch).reduced().replace(q_chunk=16)
    return unbox(jtr.init(jax.random.PRNGKey(seed), cfg))


def _ref_leaves(tree):
    """{path: array} with the port's path convention (a QTensor's
    payload and scale under ``#q`` and ``#s``)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, jquant.QTensor)):
        key = tuple(p.key for p in path)
        if isinstance(leaf, jquant.QTensor):
            out[key + ("#q",)] = np.asarray(leaf.qvalue)
            out[key + ("#s",)] = np.asarray(leaf.scale)
        else:
            out[key] = np.asarray(leaf)
    return out


def _port_leaves(tree):
    out = {}
    for path, leaf in leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, QTensor)):
        if isinstance(leaf, QTensor):
            out[path + ("#q",)] = leaf.qvalue
            out[path + ("#s",)] = leaf.scale
        else:
            out[path] = leaf
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_init_tree_and_statistics(arch):
    """The port's init has the reference's paths, shapes and dtypes, and
    each leaf's std within 5% of the reference's (the zeros and ones
    leaves exactly)."""
    cfg = treg.get_arch(arch).reduced()
    got = _port_leaves(ttr.init(torch.Generator().manual_seed(0), cfg,
                                device="cpu"))
    want = _ref_leaves(_ref_params(arch, 0))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].numpy()
        assert (g.shape, g.dtype) == (w.shape, w.dtype), key
        if w.std() == 0:
            np.testing.assert_array_equal(g, w)
        else:
            assert abs(g.std() / w.std() - 1) < 0.05, (key, g.std(), w.std())


@pytest.mark.parametrize("policy", ["w8a8", "w4a8", "w8"])
@pytest.mark.parametrize("arch", WHOLE)
def test_quantize_params_bitwise(arch, policy):
    """The stacked [L, in, out] branch (a scale per layer and channel),
    the 2-D ``emb`` and ``lm_head`` leaves, and everything left fp."""
    jp, tp = policies(policy)
    ref = _ref_params(arch, 1)
    want = _ref_leaves(jquant.quantize_params(ref, jp))
    got = _port_leaves(tquant.quantize_params(carry(ref), tp))
    assert sorted(got) == sorted(want)
    assert any(len(k) > 3 and k[-1] == "#s" and want[k].ndim == 3
               for k in want)
    for key in want:
        bits_equal(got[key], want[key])
    assert tquant.quantized_nbytes(tquant.quantize_params(carry(ref), tp)) \
        == jquant.quantized_nbytes(jquant.quantize_params(ref, jp))


# ---------------------------------------------------------------------------
# prefill + decode
# ---------------------------------------------------------------------------

def _setup(arch, policy, seed, weight_ptq=True):
    jc = jreg.get_arch(arch).reduced().replace(q_chunk=16)
    tc = treg.get_arch(arch).reduced().replace(q_chunk=16)
    jp, tp = policies(policy)
    jparams = _ref_params(arch, seed)
    tparams = carry(jparams)
    if weight_ptq and jp.quantized_w:
        jparams = jquant.quantize_params(jparams, jp)
        tparams = tquant.quantize_params(tparams, tp)
    tokens = np.random.default_rng(seed).integers(
        0, jc.vocab, (B, S)).astype(np.int32)
    return (jc, jp, jparams), (tc, tp, tparams), tokens


def _reference_run(ref, tokens):
    """The reference's prefill and ``STEPS`` greedy decode steps:
    (logits [STEPS + 1, B, V], tokens [STEPS + 1, B, 1])."""
    cfg, pol, params = ref
    with jax.disable_jit():
        logits, caches = jtr.prefill(params, jnp.asarray(tokens), cfg, pol,
                                     pol.kv_bits)
        caches = jserve.pad_caches(caches, STEPS)
        out_l, out_t = [logits], []
        for i in range(STEPS):
            tok = jnp.argmax(logits, -1, keepdims=True).astype(jnp.int32)
            out_t.append(tok)
            logits, caches = jtr.decode_step(
                params, tok, caches, jnp.asarray(S + i, jnp.int32), cfg,
                pol, pol.kv_bits)
            out_l.append(logits)
        out_t.append(jnp.argmax(logits, -1, keepdims=True).astype(
            jnp.int32))
    return (np.stack([np.asarray(x, np.float32) for x in out_l]),
            np.stack([np.asarray(t) for t in out_t]))


def _port_run(port, tokens, ref_tokens):
    """The port's prefill, then a decode step on each of the reference's
    tokens: (logits, its own greedy tokens), shaped as the reference's."""
    cfg, pol, params = port
    with torch.no_grad():
        logits, caches = ttr.prefill(params, torch.from_numpy(tokens), cfg,
                                     pol, pol.kv_bits)
        caches = tserve.pad_caches(caches, STEPS)
        out_l, out_t = [logits], []
        for i in range(STEPS):
            out_t.append(tserve.sample(logits, 0.0))
            logits, caches = ttr.decode_step(
                params, to_torch(ref_tokens[i]), caches, S + i, cfg, pol,
                pol.kv_bits)
            out_l.append(logits)
        out_t.append(tserve.sample(logits, 0.0))
    return (torch.stack(out_l).float().numpy(),
            torch.stack(out_t).numpy())


def _compare(policy, got_l, got_t, want_l, want_t):
    scale = float(np.abs(want_l).max())
    if policy == "bf16":
        tol = 3e-2 * scale
        np.testing.assert_allclose(got_l, want_l, rtol=0, atol=tol)
        top2 = np.sort(want_l, -1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 2 * tol
        np.testing.assert_array_equal(got_t[..., 0][clear],
                                      want_t[..., 0][clear])
        return
    np.testing.assert_array_equal(got_t, want_t)
    if policy == "fp32":
        np.testing.assert_allclose(got_l, want_l, rtol=1e-6,
                                   atol=4e-6 * scale)
    else:
        bits_equal(got_l, want_l)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", ["fp32", "w8a8", "w8a8kv8", "w4a8"])
@pytest.mark.parametrize("arch", WHOLE)
def test_prefill_and_greedy_decode(one_library, arch, policy, seed):
    ref, port, tokens = _setup(arch, policy, seed)
    want_l, want_t = _reference_run(ref, tokens)
    got_l, got_t = _port_run(port, tokens, want_t)
    assert got_t.dtype == want_t.dtype == np.int32
    _compare(policy, got_l, got_t, want_l, want_t)


@pytest.mark.parametrize("policy", ["bf16", "qforce8"])
@pytest.mark.parametrize("arch", WHOLE)
def test_prefill_and_greedy_decode_bf16(one_library, arch, policy):
    ref, port, tokens = _setup(arch, policy, 0)
    want_l, want_t = _reference_run(ref, tokens)
    got_l, got_t = _port_run(port, tokens, want_t)
    _compare(policy, got_l, got_t, want_l, want_t)


def test_fp_weights_under_an_int8_policy(one_library):
    """``weight_ptq=False``: the weights stay fp and every product
    quantizes them on the fly (the port's ``qmac_i8`` route)."""
    ref, port, tokens = _setup("tinyllama-1.1b", "w8a8kv8", 0,
                               weight_ptq=False)
    want_l, want_t = _reference_run(ref, tokens)
    got_l, got_t = _port_run(port, tokens, want_t)
    _compare("w8a8kv8", got_l, got_t, want_l, want_t)


@pytest.mark.parametrize("arch", WHOLE)
def test_each_librarys_own_fp32(arch):
    """fp32 with no primitive shared (each library's own einsum, exp,
    rsqrt, sin and cos): tokens equal, logits at fp32's stated bound.
    (Under an int8 policy each library's own last bits can land an
    activation on the other side of a rounding tie and move an int8
    code, so those policies are held under ``one_library``.)"""
    ref, port, tokens = _setup(arch, "fp32", 0)
    want_l, want_t = _reference_run(ref, tokens)
    got_l, got_t = _port_run(port, tokens, want_t)
    _compare("fp32", got_l, got_t, want_l, want_t)


def test_prefill_projects_only_the_last_position():
    """The head runs at M = batch: prefill's logits are the forward's
    last row, and a prefill launches 7 products a layer plus the head."""
    cfg = treg.get_arch("tinyllama-1.1b").reduced()
    pol = policies("w8a8kv8")[1]
    params = tquant.quantize_params(
        ttr.init(torch.Generator().manual_seed(0), cfg, device="cpu"), pol)
    tokens = torch.randint(0, cfg.vocab, (3, 10),
                           generator=torch.Generator().manual_seed(1))
    rows = []
    orig = tqm.qmac_ops.qmac_i8_deq

    def count(qx, *a):
        rows.append(qx.shape[0])
        return orig(qx, *a)
    tqm.qmac_ops.qmac_i8_deq = count
    try:
        with torch.no_grad():
            logits, _ = ttr.prefill(params, tokens, cfg, pol, 8)
            full = ttr.forward(params, tokens, cfg, pol)
    finally:
        tqm.qmac_ops.qmac_i8_deq = orig
    n = 7 * cfg.n_layers + 1
    assert rows[:n] == [30] * (n - 1) + [3]
    bits_equal(logits, full[:, -1].numpy())


# ---------------------------------------------------------------------------
# sampling, serve() and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_temperature_sampling_with_injected_gumbel_draws(temperature):
    logits = (np.random.default_rng(3).standard_normal((6, 256)) * 2
              ).astype(np.float32)
    key = jax.random.PRNGKey(11)
    for _ in range(5):
        key, sub = jax.random.split(key)
        want = np.asarray(jax.random.categorical(
            sub, jnp.asarray(logits) / temperature))
        g = np.asarray(jax.random.gumbel(sub, logits.shape))
        got = tserve.sample(torch.from_numpy(logits), temperature,
                            torch.from_numpy(g))
        np.testing.assert_array_equal(got[:, 0].numpy(), want)
    greedy = tserve.sample(torch.from_numpy(logits), 0.0)
    assert greedy.dtype == torch.int32
    np.testing.assert_array_equal(greedy[:, 0].numpy(), logits.argmax(-1))


def test_gumbel_draws():
    g = tserve.gumbel(torch.Generator().manual_seed(0), (20000,), "cpu")
    assert torch.isfinite(g).all()
    # a standard Gumbel: mean Euler's gamma, std pi / sqrt(6)
    assert abs(float(g.mean()) - 0.5772) < 0.03
    assert abs(float(g.std()) - 1.2825) < 0.03


@pytest.mark.parametrize("policy", ["w8a8kv8", "w4a8", "fp32"])
def test_serve_runs_and_is_reproducible(policy):
    kw = dict(policy_name=policy, batch=2, prompt_len=8, gen=4, seed=3,
              verbose=False, device="cpu")
    toks, times = tserve.serve("tinyllama-1.1b", **kw)
    again, _ = tserve.serve("tinyllama-1.1b", **kw)
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert torch.equal(toks, again)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    assert times["t_prefill"] > 0 and times["t_decode"] > 0
    hot, _ = tserve.serve("tinyllama-1.1b", **{**kw, "temperature": 1.0})
    assert hot.shape == (2, 4) and int(hot.max()) < 256


def test_serve_runs_on_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.serve("tinyllama-1.1b", verbose=False)


def test_cli_reaches_the_reduced_config(monkeypatch):
    """``--smoke`` is store_true with a default of True in both CLIs, so
    both serve the reduced config; ``python -m`` on the port runs it on
    the CPU and prints the reference's PTQ sizes."""
    seen = []
    monkeypatch.setattr(jserve, "serve", lambda *a, **kw: seen.append(a))
    monkeypatch.setattr(tserve, "serve", lambda *a, **kw: seen.append(a))
    jserve.main(["--arch", "tinyllama-1.1b"])
    tserve.main(["--arch", "tinyllama-1.1b", "--device", "cpu"])
    assert seen[0] == seen[1] == ("tinyllama-1.1b", True, "w8a8kv8", 4, 32,
                                  16, 0.0)
    cfg = jreg.get_arch("tinyllama-1.1b").reduced()
    stored, fp32 = jquant.quantized_nbytes(jquant.quantize_params(
        unbox(jtr.init(jax.random.PRNGKey(0), cfg)), policies("w8a8kv8")[0]))
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "tinyllama-1.1b", "--device", "cpu"], capture_output=True,
        text=True, check=True, timeout=120, env=env)
    lines = out.stdout.splitlines()
    assert lines[0] == (f"PTQ weights: {stored / 2**20:.1f} MiB (fp32 "
                        f"{fp32 / 2**20:.1f} MiB, {fp32 / stored:.2f}x "
                        "smaller)")
    assert lines[1].startswith("prefill: 4x32 tok")
    assert lines[2].startswith("decode:  4x15 tok")
    assert lines[3].startswith("sample output ids: [")
