"""The ssm and hybrid LM families of the PyTorch port served (mamba2-2.7b
and recurrentgemma-9b: init, the loss's forward, ``init_caches``,
prefill, ``pad_caches`` and greedy decode, ``launch/serve``) against the
JAX package, at the reduced configs: mamba at 4 layers, SSD chunk 8;
recurrentgemma at one (R, R, A) super-block plus an R tail, local window
8 (d_model 64, vocab 256).

The reference's params carry across by leaf path; its ``prefill`` and 8
greedy ``decode_step``s run op by op (``jax.disable_jit()``, which runs
its ``lax.scan``s and ``associative_scan`` eagerly), and the port's
decode steps are fed the reference's tokens, so every step's logits
compare.  Tolerances, as in test_torch_lm_serve.py:

* under ``one_library`` (the reference's library primitives computed by
  the port's, through fp64; see test_torch_lm_layers.py) every
  int8-activation policy's logits and prefill caches are bitwise
  (fp32-compute w8a8, w8a8kv8 and w4a8 at seeds 0-2, bf16-compute
  qforce8), and the greedy tokens equal;
* ``fp32``: logits within rtol 1e-6 plus 4e-6 of the logits' largest
  magnitude (fp32 products summed in another order), tokens equal; for
  mamba plus 1e-5: its decays are ``exp`` of ``dt * A`` with ``|A|`` up
  to 16 and of their sums over a chunk, which carry a product's last
  bit into the state many times over (the reference against itself,
  its primitives' last bits changed by ``one_library``, moves a decode
  step's logits by 2.07e-5 at seed 2, 5.5e-6 of their largest
  magnitude);
* ``bf16``: logits within 3e-2 of their largest magnitude, tokens equal
  where the reference's top two logits are further apart than that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import quantizer as jquant
from repro.launch import serve as jserve
from repro.models import mamba as jmamba
from repro.models import recurrent as jrec
from repro.models import registry as jmodels
from repro.nn.module import unbox
from repro_torch.configs import registry as treg
from repro_torch.core import quantizer as tquant
from repro_torch.kernels.qmac import ops as qmac_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import mamba as tmamba
from repro_torch.models import recurrent as trec
from repro_torch.models import registry as tmodels
from repro_torch.tree import leaves_with_path
from test_torch_lm_layers import (bits_equal, carry, one_library, policies,
                                  to_numpy, to_torch)
from test_torch_lm_serve import _compare

__all__ = ["one_library"]          # the fixture, imported for its tests

MODELS = {"mamba2-2.7b": (jmamba, tmamba),
          "recurrentgemma-9b": (jrec, trec)}
ARCHS = sorted(MODELS)
B, S, STEPS = 2, 32, 8
INT8 = ["w8a8", "w8a8kv8", "w4a8"]


def _cfgs(arch):
    return (jreg.get_arch(arch).reduced().replace(q_chunk=16),
            treg.get_arch(arch).reduced().replace(q_chunk=16))


@pytest.fixture(scope="module")
def ref_params():
    """The reference's params of each arch at seeds 0-2, drawn before a
    test patches the reference's primitives (``one_library``: the
    init's ``jnp.log`` under ``vmap`` cannot call back to the port)."""
    out = {}
    for arch in ARCHS:
        init = jax.jit(lambda key, _a=arch: unbox(MODELS[_a][0].init(
            key, _cfgs(_a)[0])))
        for seed in (0, 1, 2):
            out[arch, seed] = init(jax.random.PRNGKey(seed))
    return out


def _setup(ref_params, arch, policy, seed):
    (jc, tc), (jp, tp) = _cfgs(arch), policies(policy)
    jparams = ref_params[arch, seed]
    tparams = carry(jparams)
    if jp.quantized_w:
        jparams = jquant.quantize_params(jparams, jp)
        tparams = tquant.quantize_params(tparams, tp)
    tokens = np.random.default_rng(seed).integers(
        0, jc.vocab, (B, S)).astype(np.int32)
    return (jc, jp, jparams), (tc, tp, tparams), tokens


def _ref_leaves(tree):
    """{path: array} with the port's path convention (a list position as
    its index)."""
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
            np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(tree):
    """{path: array}, copied (a decode step updates the caches in
    place)."""
    return {p: np.array(to_numpy(t)) for p, t in leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# registry, init and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_for_resolves(arch):
    assert tmodels.model_for(treg.get_arch(arch)) is MODELS[arch][1]
    assert jmodels.model_for(jreg.get_arch(arch)) is MODELS[arch][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_and_statistics(ref_params, arch):
    """The port's init has the reference's paths, shapes and dtypes;
    every leaf of 4,096 values or more its std within 5% of the
    reference's, the zeros and ones leaves exact, and the log-uniform
    ``A_log`` and uniform ``L`` in the reference's ranges."""
    tc = _cfgs(arch)[1]
    want = _ref_leaves(ref_params[arch, 0])
    got = _port_leaves(MODELS[arch][1].init(torch.Generator().manual_seed(0),
                                            tc, device="cpu"))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), key
        if w.std() == 0:
            np.testing.assert_array_equal(g, w)
        elif w.size >= 4096:
            assert abs(g.std() / w.std() - 1) < 0.05, (key, g.std(), w.std())
        if key[-1] == "A_log":
            assert g.min() >= 0 and g.max() < np.log(16.0), key
        if key[-1] == "L":
            assert g.min() >= 2 and g.max() < 6, key


@pytest.mark.parametrize("max_len", [6, 40])
@pytest.mark.parametrize("kv_bits", [32, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches(arch, kv_bits, max_len):
    """recurrentgemma's A caches are rings once max_len passes the window
    (8); its R and mamba's states are constant-size."""
    (jc, tc), (jm, tm) = _cfgs(arch), MODELS[arch]
    want = _ref_leaves(jm.init_caches(jc, 2, max_len, kv_bits))
    got = _port_leaves(tm.init_caches(tc, 2, max_len, kv_bits))
    assert sorted(got) == sorted(want)
    for key in want:
        bits_equal(got[key], want[key])
    ring = any(k[-1] == "pos" for k in want)
    assert ring == (arch == "recurrentgemma-9b" and max_len > 8)


# ---------------------------------------------------------------------------
# prefill + greedy decode
# ---------------------------------------------------------------------------

def _reference_run(arch, ref, tokens):
    """The reference's prefill and ``STEPS`` greedy decode steps:
    (prefill caches, logits [STEPS + 1, B, V], tokens [STEPS + 1, B, 1])."""
    model = MODELS[arch][0]
    cfg, pol, params = ref
    with jax.disable_jit():
        logits, caches = model.prefill(params, jnp.asarray(tokens), cfg, pol,
                                       pol.kv_bits)
        primed = _ref_leaves(caches)
        caches = jserve.pad_caches(caches, STEPS)
        out_l, out_t = [logits], []
        for i in range(STEPS):
            tok = jnp.argmax(logits, -1, keepdims=True).astype(jnp.int32)
            out_t.append(tok)
            logits, caches = model.decode_step(
                params, tok, caches, jnp.asarray(S + i, jnp.int32), cfg,
                pol, pol.kv_bits)
            out_l.append(logits)
        out_t.append(jnp.argmax(logits, -1, keepdims=True).astype(
            jnp.int32))
    return (primed, np.stack([np.asarray(x, np.float32) for x in out_l]),
            np.stack([np.asarray(t) for t in out_t]))


def _port_run(arch, port, tokens, ref_tokens):
    """The port's prefill, then a decode step on each of the reference's
    tokens."""
    model = MODELS[arch][1]
    cfg, pol, params = port
    with torch.no_grad():
        logits, caches = model.prefill(params, torch.from_numpy(tokens), cfg,
                                       pol, pol.kv_bits)
        primed = _port_leaves(caches)
        caches = tserve.pad_caches(caches, STEPS)
        out_l, out_t = [logits], []
        for i in range(STEPS):
            out_t.append(tserve.sample(logits, 0.0))
            logits, caches = model.decode_step(
                params, to_torch(ref_tokens[i]), caches, S + i, cfg, pol,
                pol.kv_bits)
            out_l.append(logits)
        out_t.append(tserve.sample(logits, 0.0))
    return (primed, torch.stack(out_l).float().numpy(),
            torch.stack(out_t).numpy())


def _check_run(ref_params, arch, policy, seed):
    ref, port, tokens = _setup(ref_params, arch, policy, seed)
    w_cache, w_l, w_t = _reference_run(arch, ref, tokens)
    g_cache, g_l, g_t = _port_run(arch, port, tokens, w_t)
    assert g_t.dtype == w_t.dtype == np.int32
    if policy == "fp32" and arch == "mamba2-2.7b":
        np.testing.assert_array_equal(g_t, w_t)
        np.testing.assert_allclose(g_l, w_l, rtol=1e-6,
                                   atol=1e-5 * float(np.abs(w_l).max()))
    else:
        _compare(policy, g_l, g_t, w_l, w_t)
    assert sorted(g_cache) == sorted(w_cache)
    if policy in INT8 or policy == "qforce8":
        for key in w_cache:
            bits_equal(g_cache[key], w_cache[key])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", INT8 + ["fp32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode(ref_params, one_library, arch, policy,
                                   seed):
    _check_run(ref_params, arch, policy, seed)


@pytest.mark.parametrize("policy", ["bf16", "qforce8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_bf16(ref_params, one_library, arch,
                                        policy):
    _check_run(ref_params, arch, policy, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_forward(ref_params, one_library, arch):
    """The loss's forward under w8a8kv8 (the CE's logsumexp is each
    library's own, so the loss is held at rtol 1e-6)."""
    ref, port, tokens = _setup(ref_params, arch, "w8a8kv8", 0)
    # remat is a compile knob (the port has none): without it the
    # reference's forward runs op by op, untraced
    ref = (ref[0].replace(remat=False),) + ref[1:]
    labels = np.random.default_rng(4).integers(0, 256, (B, S)).astype(
        np.int32)
    with jax.disable_jit():
        want = MODELS[arch][0].loss_fn(
            ref[2], {"tokens": jnp.asarray(tokens),
                     "labels": jnp.asarray(labels)}, ref[0], ref[1])
    with torch.no_grad():
        got = MODELS[arch][1].loss_fn(
            port[2], {"tokens": torch.from_numpy(tokens),
                      "labels": torch.from_numpy(labels)}, port[0], port[1])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the fused products a forward launches
# ---------------------------------------------------------------------------

def per_forward(cfg):
    """Fused products a forward (a prefill, or a decode step) launches:
    mamba 2 a layer (in_proj, out_proj); recurrentgemma 8 an R layer
    (lin_y, lin_x, w_r, w_i, lin_out, gate, up, down) and 7 an A layer
    (q, k, v, o, gate, up, down); the head once."""
    if cfg.family == "ssm":
        return 2 * cfg.n_layers + 1
    pat = cfg.block_pattern
    n_r = sum(pat[i % len(pat)] == "R" for i in range(cfg.n_layers))
    return 8 * n_r + 7 * (cfg.n_layers - n_r) + 1


@pytest.mark.parametrize("arch,n_layers", [
    ("mamba2-2.7b", 2), ("mamba2-2.7b", 4),
    ("recurrentgemma-9b", 3), ("recurrentgemma-9b", 4)])
def test_launches_a_forward(monkeypatch, arch, n_layers):
    """129 and 293 products a forward at the published depths (64
    layers; 26 R and 12 A layers); counted here at reduced widths, at
    two depths each (recurrentgemma: one super-block, then one with an R
    tail); no int32 product (every weight is a PTQ'd QTensor)."""
    assert per_forward(treg.get_arch("mamba2-2.7b")) == 129
    assert per_forward(treg.get_arch("recurrentgemma-9b")) == 293
    cfg = _cfgs(arch)[1].replace(n_layers=n_layers)
    pol = policies("w8a8kv8")[1]
    model = MODELS[arch][1]
    params = tquant.quantize_params(
        model.init(torch.Generator().manual_seed(0), cfg, device="cpu"), pol)
    tokens = torch.randint(0, 256, (B, 16),
                           generator=torch.Generator().manual_seed(1))
    calls = {"qmac_i8_deq": 0, "qmac_i8": 0}
    for name in calls:
        orig = getattr(qmac_ops, name)

        def spy(*a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*a)
        monkeypatch.setattr(qmac_ops, name, spy)
    with torch.no_grad():
        logits, caches = model.prefill(params, tokens, cfg, pol, 8)
        prefill = dict(calls)
        caches = tserve.pad_caches(caches, 2)
        model.decode_step(params, tserve.sample(logits, 0.0), caches, 16,
                          cfg, pol, 8)
    n = per_forward(cfg)
    assert prefill == {"qmac_i8_deq": n, "qmac_i8": 0}
    assert calls == {"qmac_i8_deq": 2 * n, "qmac_i8": 0}


# ---------------------------------------------------------------------------
# serve() and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["w8a8kv8", "w4a8", "fp32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_and_is_reproducible(arch, policy):
    kw = dict(policy_name=policy, batch=2, prompt_len=16, gen=4, seed=3,
              verbose=False, device="cpu")
    toks, times = tserve.serve(arch, **kw)
    again, _ = tserve.serve(arch, **kw)
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert torch.equal(toks, again)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    assert times["t_prefill"] > 0 and times["t_decode"] > 0
    hot, _ = tserve.serve(arch, **{**kw, "temperature": 1.0})
    assert hot.shape == (2, 4) and int(hot.max()) < 256


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_reaches_the_reduced_config(arch, monkeypatch, capsys):
    """Both CLIs serve the reduced config; the port's ``main`` runs it on
    the CPU and prints the reference's PTQ sizes (``python -m`` is held
    in test_torch_lm_serve.py)."""
    seen = []
    monkeypatch.setattr(jserve, "serve", lambda *a, **kw: seen.append(a))
    monkeypatch.setattr(tserve, "serve", lambda *a, **kw: seen.append(a))
    jserve.main(["--arch", arch])
    tserve.main(["--arch", arch, "--device", "cpu"])
    assert seen[0] == seen[1] == (arch, True, "w8a8kv8", 4, 32, 16, 0.0)
    monkeypatch.undo()
    stored, fp32 = jquant.quantized_nbytes(jquant.quantize_params(
        unbox(MODELS[arch][0].init(jax.random.PRNGKey(0),
                                   jreg.get_arch(arch).reduced())),
        policies("w8a8kv8")[0]))
    capsys.readouterr()
    tserve.main(["--arch", arch, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == (f"PTQ weights: {stored / 2**20:.1f} MiB (fp32 "
                        f"{fp32 / 2**20:.1f} MiB, {fp32 / stored:.2f}x "
                        "smaller)")
    assert lines[1].startswith("prefill: 4x32 tok")
    assert lines[2].startswith("decode:  4x15 tok")
    assert lines[3].startswith("sample output ids: [")
