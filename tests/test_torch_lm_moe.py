"""MoE serving of the PyTorch port (the transformer's MoE blocks, the
layer walk's check, ``launch/serve`` with ``weight_ptq=False``) against
the JAX package, at the reduced qwen3-moe-30b-a3b and mixtral-8x22b
(mixtral's window 8 puts its KV cache in a ring).

Whole-model cases carry the reference's fp32 params into the port, run
the reference's prefill and 8 greedy decode steps op by op
(``jax.disable_jit()``) and the port's on the reference's tokens, as
test_torch_lm_serve.py does.  With ``weight_ptq=False`` every product
quantizes its fp weight at each call: attention and the head through
Q-MAC's int32 route, the experts through the batched fused route.
Tolerances:

* the int8 policies (w8a8kv8, w4a8): logits bitwise and tokens equal
  under ``one_library`` (test_torch_lm_layers.py: the reference's
  library primitives, the MoE router's product, the gates' and the
  combine's sums computed by the port's, through fp64);
* fp32: tokens equal, logits within rtol 1e-6 plus 4e-6 of their largest
  magnitude (each library's fp32 products sum in its own order).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import quantizer as jquant
from repro.launch import serve as jserve
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.configs import registry as treg
from repro_torch.core import exact
from repro_torch.core import qmatmul as tqm
from repro_torch.core.fxp import QTensor
from repro_torch.launch import serve as tserve
from repro_torch.models import mamba as tmamba
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as ttr
from test_torch_lm_layers import bits_equal, carry, one_library, policies
from test_torch_lm_serve import (_compare, _port_leaves, _port_run,
                                 _ref_leaves, _ref_params, _reference_run,
                                 _setup)

__all__ = ["one_library"]          # the fixture, imported for its tests

MOE = ["qwen3-moe-30b-a3b", "mixtral-8x22b"]


@pytest.mark.parametrize("arch", MOE)
def test_init_tree_and_statistics(arch):
    """The port's MoE init has the reference's paths, shapes and dtypes
    (``moe/router/w`` [L, d, E], the expert stacks [L, E, d, f]) and each
    leaf's std within 10% of the reference's (the zeros and ones leaves
    exactly)."""
    cfg = treg.get_arch(arch).reduced()
    got = _port_leaves(ttr.init(torch.Generator().manual_seed(0), cfg,
                                device="cpu"))
    want = _ref_leaves(_ref_params(arch, 0))
    assert sorted(got) == sorted(want)
    assert want[("blocks", "moe", "w_gate")].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    for key, w in want.items():
        g = got[key].numpy()
        assert (g.shape, g.dtype) == (w.shape, w.dtype), key
        if w.std() == 0:
            np.testing.assert_array_equal(g, w)
        else:
            assert abs(g.std() / w.std() - 1) < 0.1, (key, g.std(), w.std())


@pytest.mark.parametrize("arch", MOE)
def test_carried_weights_are_the_reference_bits(arch):
    """``from_numpy_tree`` carries the router, the 4-D expert stacks and
    a reference QTensor whose PTQ scale is ``[1, 1, 1, N]`` unchanged."""
    ref = _ref_params(arch, 1)
    bits_equal(carry(ref)["blocks"]["moe"]["w_up"],
               np.asarray(ref["blocks"]["moe"]["w_up"]))
    ptq = jquant.quantize_params(ref, policies("w8a8kv8")[0])
    got = _port_leaves(from_numpy_tree(jax.tree.map(np.asarray, ptq), "cpu"))
    want = _ref_leaves(ptq)
    assert sorted(got) == sorted(want)
    for key in want:
        bits_equal(got[key], want[key])
    scale = got[("blocks", "moe", "w_down", "#s")]
    assert scale.shape == (1, 1, 1, want[("blocks", "moe", "w_down",
                                          "#q")].shape[-1])
    assert got[("blocks", "moe", "router", "w", "#s")].shape[0] == \
        treg.get_arch(arch).reduced().n_layers


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", ["fp32", "w8a8kv8", "w4a8"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_greedy_decode(one_library, arch, policy, seed):
    """``weight_ptq=False``, the reference's MoE serving path: prefill
    logits and every decode step's logits and greedy tokens."""
    ref, port, tokens = _setup(arch, policy, seed, weight_ptq=False)
    want_l, want_t = _reference_run(ref, tokens)
    got_l, got_t = _port_run(port, tokens, want_t)
    assert got_t.dtype == want_t.dtype == np.int32
    _compare(policy, got_l, got_t, want_l, want_t)


@pytest.mark.parametrize("arch", MOE)
def test_each_librarys_own_fp32(arch):
    ref, port, tokens = _setup(arch, "fp32", 0, weight_ptq=False)
    want_l, want_t = _reference_run(ref, tokens)
    got_l, got_t = _port_run(port, tokens, want_t)
    _compare("fp32", got_l, got_t, want_l, want_t)


def _count_products(monkeypatch):
    """Calls of the port's product routes: Q-MAC's int32 product, its
    fused product, its batched fused product, and the router's fp64
    einsum."""
    calls = {"qmac_i8": 0, "qmac_i8_deq": 0, "qmac_i8_deq_bmm": 0,
             "einsum": 0}
    for name in ("qmac_i8", "qmac_i8_deq", "qmac_i8_deq_bmm"):
        orig = getattr(tqm.qmac_ops, name)

        def counted(*a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*a)
        monkeypatch.setattr(tqm.qmac_ops, name, counted)
    orig_einsum = exact.einsum

    def einsum(*a, **k):
        calls["einsum"] += 1
        return orig_einsum(*a, **k)
    monkeypatch.setattr(exact, "einsum", einsum)
    return calls


@pytest.mark.parametrize("arch", MOE)
def test_a_forward_runs_three_batched_and_four_int32_products_a_layer(
        monkeypatch, arch):
    """With fp weights under w8a8kv8 a prefill (and a decode step) runs,
    each layer, the experts as 3 batched products and attention's q, k,
    v, o as 4 int32 ones, plus the head; no fused 2-D product."""
    cfg = treg.get_arch(arch).reduced()
    pol = policies("w8a8kv8")[1]
    params = ttr.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    calls = _count_products(monkeypatch)
    with torch.no_grad():
        logits, caches = ttr.prefill(params, tokens, cfg, pol, 8)
        assert calls["qmac_i8_deq_bmm"] == 3 * cfg.n_layers
        assert calls["qmac_i8"] == 4 * cfg.n_layers + 1
        assert calls["qmac_i8_deq"] == 0
        caches = tserve.pad_caches(caches, 1)
        for k in calls:
            calls[k] = 0
        ttr.decode_step(params, tserve.sample(logits, 0.0), caches, 12, cfg,
                        pol, 8)
    assert calls["qmac_i8_deq_bmm"] == 3 * cfg.n_layers
    assert calls["qmac_i8"] == 4 * cfg.n_layers + 1
    assert calls["qmac_i8_deq"] == 0


@pytest.mark.parametrize("arch", MOE)
def test_ptq_moe_serving_raises_in_both_packages(monkeypatch, arch):
    """The reference's PTQ gives the 4-D expert stacks a ``[1, 1, 1, N]``
    scale, which its layer scan refuses; the port's layer walk refuses
    the same tree with a ``ValueError`` naming the leaf, before any
    product (none of the product routes is reached)."""
    with pytest.raises(ValueError, match="leading axis sizes"):
        jserve.serve(arch, policy_name="w8a8kv8", batch=2, prompt_len=8,
                     gen=3, verbose=False)
    calls = _count_products(monkeypatch)
    for name in ("_fwd_quantized", "_serve_quantized", "_fp_dot",
                 "_fwd_bmm"):
        monkeypatch.setattr(tqm, name, lambda *a, _n=name: calls.update(
            {_n: 1}))
    with pytest.raises(ValueError, match=r"moe/w_down\.scale .*\(1, 1, 1, "):
        tserve.serve(arch, policy_name="w8a8kv8", batch=2, prompt_len=8,
                     gen=3, verbose=False, device="cpu")
    assert not any(calls.values()), calls


def test_layer_walk_refuses_a_stack_that_does_not_lead_with_the_layers():
    """``transformer.layers`` checks arrays, QTensor payloads and scales
    alike, and is the walk of the dense, ssm and hybrid families too
    (recurrentgemma's stacked super-blocks included)."""
    cfg = treg.get_arch("tinyllama-1.1b").reduced()
    params = ttr.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    blocks = params["blocks"]
    assert len(ttr.layers(blocks, cfg.n_layers)) == cfg.n_layers
    w = blocks["mlp"]["w_up"]["w"]
    blocks["mlp"]["w_up"]["w"] = QTensor(w.to(torch.int8),
                                         torch.ones(1, 1, w.shape[-1]))
    with pytest.raises(ValueError, match=r"mlp/w_up/w\.scale"):
        ttr.layers(blocks, cfg.n_layers)
    blocks["mlp"]["w_up"]["w"] = w[:1]
    with pytest.raises(ValueError, match=r"mlp/w_up/w of shape \(1, "):
        ttr.forward(params, torch.zeros((1, 4), dtype=torch.int32), cfg)
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    for model, arch in ((tmamba, "mamba2-2.7b"),
                        (trec, "recurrentgemma-9b")):
        cfg = treg.get_arch(arch).reduced()
        p = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        stack = "supers" if model is trec else "blocks"
        leaf = p[stack]
        while isinstance(leaf, dict):
            key = sorted(leaf)[0]
            parent, leaf = leaf, leaf[key]
        parent[key] = torch.cat([leaf, leaf[:1]])     # one layer too many
        with pytest.raises(ValueError, match="does not lead with"):
            model.prefill(p, tokens, cfg, policies("w8a8kv8")[1], 8)


@pytest.mark.parametrize("policy", ["w8a8kv8", "w4a8", "fp32"])
def test_serve_without_ptq_runs_and_is_reproducible(policy):
    kw = dict(policy_name=policy, batch=2, prompt_len=8, gen=4, seed=3,
              weight_ptq=False, verbose=False, device="cpu")
    toks, times = tserve.serve("qwen3-moe-30b-a3b", **kw)
    again, _ = tserve.serve("qwen3-moe-30b-a3b", **kw)
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert torch.equal(toks, again)
    assert 0 <= int(toks.min()) and int(toks.max()) < 256
    assert times["t_prefill"] > 0 and times["t_decode"] > 0

