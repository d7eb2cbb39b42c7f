"""The enc-dec family of the PyTorch port (whisper-large-v3: the
encoder, the decoder's whole-sequence pass, the loss's forward, prefill
with its self and cross caches, ``pad_caches`` and greedy decode,
``launch/serve``) against the JAX package, at the reduced config (4 + 4
layers, d_model 64, 4 heads over 2 KV heads, vocab 256).

The reference's params carry across by leaf path; its ``encode``,
``decode_train``, ``prefill`` and 8 greedy ``decode_step``s run op by op
(``jax.disable_jit()``), and the port's decode steps are fed the
reference's tokens, so every step's logits compare.  Tolerances, as in
test_torch_lm_serve.py:

* under ``one_library`` (the reference's einsum, softmax, rsqrt, sin,
  cos, exp, log, tanh, mean, var and power computed by the port's,
  through fp64; see test_torch_lm_layers.py) every int8 policy's
  encoder output, logits and caches are bitwise, and the greedy tokens
  equal;
* ``fp32``, with each library's own primitives: the tokens equal, the
  logits within rtol 1e-6 plus 4e-6 of the logits' largest magnitude
  (sums in another order, and each library's own last bits), the
  encoder output and fp caches within rtol 1e-6 plus 4e-6 of their
  largest magnitude.
"""
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

from repro.configs import registry as jreg
from repro.core import quantizer as jquant
from repro.launch import serve as jserve
from repro.models import encdec as jed
from repro.models import registry as jmodels
from repro.nn.module import unbox
from repro_torch.configs import registry as treg
from repro_torch.core import quantizer as tquant
from repro_torch.core.fxp import QTensor, is_qtensor
from repro_torch.kernels.qmac import ops as qmac_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec as ted
from repro_torch.models import registry as tmodels
from repro_torch.tree import leaves_with_path, map_with_path
from test_torch_lm_layers import (bits_equal, carry, one_library, policies,
                                  to_numpy, to_torch)

__all__ = ["one_library"]          # the fixture, imported for its tests

ARCH = "whisper-large-v3"
B, S, STEPS = 2, 32, 8
INT8 = ["w8a8", "w8a8kv8", "w4a8"]


def _cfgs():
    return (jreg.get_arch(ARCH).reduced().replace(q_chunk=16),
            treg.get_arch(ARCH).reduced().replace(q_chunk=16))


@functools.cache
def _ref_params(seed):
    return unbox(jed.init(jax.random.PRNGKey(seed), _cfgs()[0]))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S, 64)).astype(np.float32)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    return frames, tokens


def _setup(policy, seed):
    (jc, tc), (jp, tp) = _cfgs(), policies(policy)
    jparams = _ref_params(seed)
    tparams = carry(jparams)
    if jp.quantized_w:
        jparams = jquant.quantize_params(jparams, jp)
        tparams = tquant.quantize_params(tparams, tp)
    return (jc, jp, jparams), (tc, tp, tparams)


def _agree(policy, got, want, what):
    """Bitwise for an int8 policy; fp32 at rtol 1e-6 + 4e-6 of the
    largest magnitude."""
    if isinstance(got, torch.Tensor):
        got = to_numpy(got)
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if policy != "fp32" or got.dtype != np.float32:
        bits_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=4e-6 * float(np.abs(want).max()),
                                   err_msg=what)


def _cache_leaves(caches):
    return {p: to_numpy(t) for p, t in leaves_with_path(caches)}


def _ref_cache_leaves(caches):
    return {tuple(k.key for k in p): np.asarray(a) for p, a in
            jax.tree_util.tree_leaves_with_path(caches)}


# ---------------------------------------------------------------------------
# registry and init
# ---------------------------------------------------------------------------

def test_model_for_resolves_whisper():
    assert tmodels.model_for(treg.get_arch(ARCH)) is ted
    assert jmodels.model_for(jreg.get_arch(ARCH)) is jed


def test_init_tree_shapes_and_statistics():
    """The port's init has the reference's tree: its paths, shapes and
    dtypes (pinned here at the reduced config), each leaf's std within
    5% of the reference's and the ones and zeros leaves exact."""
    jc, tc = _cfgs()
    L, d, f, v = 4, 64, 128, 256
    attn = {"wq/w": (L, d, 64), "wk/w": (L, d, 32), "wv/w": (L, d, 32),
            "wo/w": (L, 64, d)}
    ln = {"scale": (L, d), "bias": (L, d)}
    mlp = {"w_in/w": (L, d, f), "w_in/b": (L, f), "w_out/w": (L, f, d),
           "w_out/b": (L, d)}

    def block(parts):
        return {f"{name}/{k}": s for name, leaves in parts.items()
                for k, s in leaves.items()}

    shapes = {"embed/emb": (v, d), "lm_head/w": (d, v),
              "ln_enc/scale": (d,), "ln_enc/bias": (d,),
              "ln_dec/scale": (d,), "ln_dec/bias": (d,)}
    shapes.update({f"enc_blocks/{k}": s for k, s in block(
        {"ln1": ln, "attn": attn, "ln2": ln, "mlp": mlp}).items()})
    shapes.update({f"dec_blocks/{k}": s for k, s in block(
        {"ln1": ln, "self": attn, "ln_x": ln, "cross": attn, "ln2": ln,
         "mlp": mlp}).items()})
    want = {"/".join(str(k.key) for k in p): np.asarray(a) for p, a in
            jax.tree_util.tree_leaves_with_path(_ref_params(0))}
    got = {"/".join(p): t.numpy() for p, t in leaves_with_path(
        ted.init(torch.Generator().manual_seed(0), tc, device="cpu"))}
    assert {k: a.shape for k, a in want.items()} == shapes
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), key
        if w.std() == 0:
            np.testing.assert_array_equal(g, w)
        else:
            assert abs(g.std() / w.std() - 1) < 0.05, (key, g.std(), w.std())


def test_init_caches():
    jc, tc = _cfgs()
    for kv_bits in (32, 8):
        want = _ref_cache_leaves(jed.init_caches(jc, 2, 12, kv_bits,
                                                 enc_len=7))
        got = _cache_leaves(ted.init_caches(tc, 2, 12, kv_bits, enc_len=7))
        assert sorted(got) == sorted(want)
        for key in want:
            bits_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _reference_run(ref, frames, tokens):
    """encode, decode_train, prefill and ``STEPS`` greedy decode steps:
    (encoder output, decode_train logits, prefill caches, logits [STEPS +
    1, B, V], tokens [STEPS + 1, B, 1])."""
    cfg, pol, params = ref
    with jax.disable_jit():
        enc = jed.encode(params, jnp.asarray(frames), cfg, pol)
        full = jed.decode_train(params, jnp.asarray(tokens), enc, cfg, pol)
        logits, caches = jed.prefill(
            params, {"frames": jnp.asarray(frames),
                     "tokens": jnp.asarray(tokens)}, cfg, pol, pol.kv_bits)
        primed = _ref_cache_leaves(caches)
        caches = jserve.pad_caches(caches, STEPS)
        out_l, out_t = [logits], []
        for i in range(STEPS):
            tok = jnp.argmax(logits, -1, keepdims=True).astype(jnp.int32)
            out_t.append(tok)
            logits, caches = jed.decode_step(
                params, tok, caches, jnp.asarray(S + i, jnp.int32), cfg,
                pol, pol.kv_bits)
            out_l.append(logits)
        out_t.append(jnp.argmax(logits, -1, keepdims=True).astype(
            jnp.int32))
    return (np.asarray(enc), np.asarray(full), primed,
            np.stack([np.asarray(x) for x in out_l]),
            np.stack([np.asarray(t) for t in out_t]))


def _port_run(port, frames, tokens, ref_tokens):
    cfg, pol, params = port
    with torch.no_grad():
        enc = ted.encode(params, torch.from_numpy(frames), cfg, pol)
        full = ted.decode_train(params, torch.from_numpy(tokens), enc, cfg,
                                pol)
        logits, caches = ted.prefill(
            params, {"frames": torch.from_numpy(frames),
                     "tokens": torch.from_numpy(tokens)}, cfg, pol,
            pol.kv_bits)
        primed = _cache_leaves(caches)
        caches = tserve.pad_caches(caches, STEPS)
        out_l, out_t = [logits], []
        for i in range(STEPS):
            out_t.append(tserve.sample(logits, 0.0))
            logits, caches = ted.decode_step(
                params, to_torch(ref_tokens[i]), caches, S + i, cfg, pol,
                pol.kv_bits)
            out_l.append(logits)
        out_t.append(tserve.sample(logits, 0.0))
    return (to_numpy(enc), to_numpy(full), primed,
            torch.stack(out_l).numpy(), torch.stack(out_t).numpy())


def _check_run(policy, seed):
    ref, port = _setup(policy, seed)
    frames, tokens = _inputs(seed)
    w_enc, w_full, w_cache, w_l, w_t = _reference_run(ref, frames, tokens)
    g_enc, g_full, g_cache, g_l, g_t = _port_run(port, frames, tokens, w_t)
    _agree(policy, g_enc, w_enc, "encoder output")
    _agree(policy, g_full, w_full, "decode_train logits")
    assert sorted(g_cache) == sorted(w_cache)
    for key in w_cache:
        _agree(policy, g_cache[key], w_cache[key], f"prefill cache {key}")
    assert g_t.dtype == w_t.dtype == np.int32
    np.testing.assert_array_equal(g_t, w_t)
    _agree(policy, g_l, w_l, "prefill and decode logits")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", INT8)
def test_prefill_and_greedy_decode(one_library, policy, seed):
    _check_run(policy, seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefill_and_greedy_decode_fp32(seed):
    """fp32 with each library's own primitives."""
    _check_run("fp32", seed)


@pytest.mark.parametrize("policy", ["fp32", "w8a8kv8"])
def test_loss_fn_forward(request, policy):
    """The loss's forward (encoder, decoder, the chunked CE); its CE's
    logsumexp is each library's own, so the loss is held at rtol 1e-6."""
    if policy != "fp32":
        request.getfixturevalue("one_library")
    ref, port = _setup(policy, 0)
    frames, tokens = _inputs(3)
    labels = np.random.default_rng(4).integers(0, 256, (B, S)).astype(
        np.int32)
    mask = (np.random.default_rng(5).random((B, S)) > 0.2).astype(
        np.float32)
    with jax.disable_jit():
        want = jed.loss_fn(ref[2], {k: jnp.asarray(v) for k, v in (
            ("frames", frames), ("tokens", tokens), ("labels", labels),
            ("mask", mask))}, ref[0], ref[1])
    with torch.no_grad():
        got = ted.loss_fn(port[2], {k: torch.from_numpy(v) for k, v in (
            ("frames", frames), ("tokens", tokens), ("labels", labels),
            ("mask", mask))}, port[0], port[1])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("policy", ["fp32", "w8a8kv8"])
def test_cross_cache_is_padded_and_attended_unmasked(request, policy):
    """``pad_caches`` pads the cross cache by the decode's slots with
    zeros too (bitwise the reference's), and decode's cross attention
    attends over them with no mask: a step against the padded cross
    cache gives other logits than one against the prompt-length cross
    cache, in both packages alike."""
    if policy != "fp32":
        request.getfixturevalue("one_library")
    (jc, jp, jparams), (tc, tp, tparams) = _setup(policy, 1)
    frames, tokens = _inputs(1)
    tok = tokens[:, :1]
    with jax.disable_jit():
        _, jcaches = jed.prefill(jparams, {"frames": jnp.asarray(frames),
                                           "tokens": jnp.asarray(tokens)},
                                 jc, jp, jp.kv_bits)
        jpad = jserve.pad_caches(jcaches, STEPS)
        jcut = {"self": jpad["self"], "cross": jcaches["cross"]}
        want = [np.asarray(jed.decode_step(
            jparams, jnp.asarray(tok), c, jnp.asarray(S, jnp.int32), jc, jp,
            jp.kv_bits)[0]) for c in (jpad, jcut)]
    with torch.no_grad():
        _, caches = ted.prefill(tparams, {"frames": torch.from_numpy(frames),
                                          "tokens": torch.from_numpy(tokens)},
                                tc, tp, tp.kv_bits)
        padded = tserve.pad_caches(caches, STEPS)
        for key, arr in _ref_cache_leaves(jpad).items():
            got = _cache_leaves(padded)[key]
            assert got.shape[2] == S + STEPS, key
            _agree(policy, got, arr, f"padded cache {key}")
            if key[0] == "cross":
                assert not got[:, :, S:].any(), key
        cut = {"self": {k: v.clone() for k, v in padded["self"].items()},
               "cross": caches["cross"]}
        got = [ted.decode_step(tparams, torch.from_numpy(tok), c, S, tc, tp,
                               tp.kv_bits)[0].numpy() for c in (padded, cut)]
    for g, w in zip(got, want, strict=True):
        _agree(policy, g, w, "decode logits")
    assert not np.array_equal(want[0], want[1])


def _count_products(monkeypatch):
    """Calls of Q-MAC's fused product (``qmac_i8_deq``) and of its int32
    product, counted at the wrappers ``q_matmul`` calls."""
    calls = {"qmac_i8_deq": 0, "qmac_i8": 0}
    for name in calls:
        orig = getattr(qmac_ops, name)

        def spy(*a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*a)
        monkeypatch.setattr(qmac_ops, name, spy)
    return calls


def per_forward(n_layers):
    """Fused products a whisper forward launches: a prefill 6 a layer in
    the encoder (q, k, v, o, w_in, w_out), 10 in the decoder (self q, k,
    v, o; cross q, k, v, o, the cross K/V projected once; w_in, w_out)
    and the head; a decode step 8 a layer (self 4, cross q and o, w_in,
    w_out) and the head."""
    return 16 * n_layers + 1, 8 * n_layers + 1


def _first_layers(params, n):
    """The params of the model cut to its first ``n`` layers."""
    def cut(_p, leaf):
        if isinstance(leaf, QTensor):
            return QTensor(leaf.qvalue[:n], leaf.scale[:n], leaf.bits)
        return leaf[:n]
    return {k: map_with_path(cut, v, is_leaf=is_qtensor)
            if k.endswith("_blocks") else v for k, v in params.items()}


@pytest.mark.parametrize("n_layers", [4, 2])
def test_launches_a_forward(monkeypatch, n_layers):
    """513 and 257 products at whisper's 32 + 32 layers; counted here at
    the reduced config's 4 + 4, and at 2 + 2 to show the count a layer;
    no int32 product (every weight is a PTQ'd QTensor)."""
    assert per_forward(32) == (513, 257)
    _, (tc, tp, tparams) = _setup("w8a8kv8", 0)
    tc = tc.replace(n_layers=n_layers)
    tparams = _first_layers(tparams, n_layers)
    frames, tokens = _inputs(0)
    calls = _count_products(monkeypatch)
    with torch.no_grad():
        logits, caches = ted.prefill(
            tparams, {"frames": torch.from_numpy(frames),
                      "tokens": torch.from_numpy(tokens)}, tc, tp, 8)
        prefill = dict(calls)
        caches = tserve.pad_caches(caches, 2)
        ted.decode_step(tparams, tserve.sample(logits, 0.0), caches, S, tc,
                        tp, 8)
    want_p, want_d = per_forward(n_layers)
    assert prefill == {"qmac_i8_deq": want_p, "qmac_i8": 0}
    assert calls == {"qmac_i8_deq": want_p + want_d, "qmac_i8": 0}


# ---------------------------------------------------------------------------
# serve() and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["w8a8kv8", "w4a8", "fp32"])
def test_serve_runs_and_is_reproducible(policy, monkeypatch):
    """Reproducible from its seed; the ``seed + 1`` generator draws the
    frames [batch, prompt_len, d_model] first, then the prompts."""
    kw = dict(policy_name=policy, batch=2, prompt_len=8, gen=4, seed=3,
              verbose=False, device="cpu")
    seen = []
    prefill = ted.prefill
    monkeypatch.setattr(ted, "prefill",
                        lambda p, b, *a: seen.append(b) or prefill(p, b, *a))
    toks, times = tserve.serve(ARCH, **kw)
    again, _ = tserve.serve(ARCH, **kw)
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert torch.equal(toks, again)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    assert times["t_prefill"] > 0 and times["t_decode"] > 0
    g = torch.Generator().manual_seed(4)
    frames = torch.randn((2, 8, 64), generator=g)
    prompts = torch.randint(0, 256, (2, 8), generator=g).to(torch.int32)
    assert torch.equal(seen[0]["frames"], frames)
    assert torch.equal(seen[0]["tokens"], prompts)
    hot, _ = tserve.serve(ARCH, **{**kw, "temperature": 1.0})
    assert hot.shape == (2, 4) and int(hot.max()) < 256


def test_cli_reaches_the_reduced_config(monkeypatch):
    """Both CLIs serve whisper's reduced config; ``python -m`` on the
    port runs it on the CPU and prints the reference's PTQ sizes."""
    seen = []
    monkeypatch.setattr(jserve, "serve", lambda *a, **kw: seen.append(a))
    monkeypatch.setattr(tserve, "serve", lambda *a, **kw: seen.append(a))
    jserve.main(["--arch", ARCH])
    tserve.main(["--arch", ARCH, "--device", "cpu"])
    assert seen[0] == seen[1] == (ARCH, True, "w8a8kv8", 4, 32, 16, 0.0)
    stored, fp32 = jquant.quantized_nbytes(jquant.quantize_params(
        unbox(jed.init(jax.random.PRNGKey(0), jreg.get_arch(ARCH).reduced())),
        policies("w8a8kv8")[0]))
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu"], capture_output=True, text=True, check=True,
        timeout=120, env=env)
    lines = out.stdout.splitlines()
    assert lines[0] == (f"PTQ weights: {stored / 2**20:.1f} MiB (fp32 "
                        f"{fp32 / 2**20:.1f} MiB, {fp32 / stored:.2f}x "
                        "smaller)")
    assert lines[1].startswith("prefill: 4x32 tok")
    assert lines[2].startswith("decode:  4x15 tok")
    assert lines[3].startswith("sample output ids: [")
