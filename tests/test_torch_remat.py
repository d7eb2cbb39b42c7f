"""Rematerialisation in the port (``repro_torch.nn.remat``): every LM
family's training step under ``cfg.remat`` against the same step with
remat off, bitwise; the bytes a forward keeps for its backward, counted
with ``torch.autograd.graph.saved_tensors_hooks``; the two remats that
do not depend on the flag (``chunked_ce``'s chunks, attention's
q-chunks); the serving steps, whose traces remat leaves alone; the mesh
context a recompute sees; and the op recorder's live-byte peak, which
the dry run's memory forecast reads.

The step against the JAX package's is held in test_torch_lm_train*.py,
which run the config default (remat on); here one case holds
``chunked_ce``'s checkpointed chunks against the reference's.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import pad_vocab
from repro_torch.configs.registry import get_arch
from repro_torch.core.policy import get_policy
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import steps as tsteps
from repro_torch.models import common, recurrent
from repro_torch.models.registry import model_for
from repro_torch.nn import attention, remat
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, tree_unflatten

POLICY = get_policy("w8a8")
B, S = 2, 32
FAMILIES = {"dense": "tinyllama-1.1b", "moe": "qwen3-moe-30b-a3b",
            "encdec": "whisper-large-v3", "ssm": "mamba2-2.7b",
            "hybrid": "recurrentgemma-9b"}
QMAC = ("qmac_i8", "qmac_i8_deq_bmm")
ADAMW = tsteps.adamw_update


def _case(arch, remat_on, seq=S, batch=B):
    """A reduced config with ``remat`` set, its params (seed 0) and a
    batch drawn with numpy (seed 1)."""
    cfg = get_arch(arch).reduced().replace(remat=remat_on)
    rng = np.random.RandomState(1)
    base = torch.from_numpy(
        rng.randint(0, cfg.vocab, (batch, seq + 1)).astype(np.int32))
    data = {"tokens": base[:, :-1], "labels": base[:, 1:]}
    if cfg.is_encdec:
        data["frames"] = torch.from_numpy(
            rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32))
    params = model_for(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    return cfg, params, data


def _recomputed_products(cfg):
    """The Q-MAC calls a rematerialised step runs again in its backward:
    every checkpointed layer's products (7 int8 a dense layer; 4 int8
    and 3 batched an MoE layer; 6 an encoder and 10 a decoder layer; 2
    an SSD block; 8 an R and 7 an A layer of each super-block, the tail
    not).  At ``S`` the loss is one chunk and the head is not run
    again."""
    n = cfg.n_layers
    if cfg.is_moe:
        return {"qmac_i8": 4 * n, "qmac_i8_deq_bmm": 3 * n}
    if cfg.is_encdec:
        return {"qmac_i8": 16 * n, "qmac_i8_deq_bmm": 0}
    if cfg.family == "ssm":
        return {"qmac_i8": 2 * n, "qmac_i8_deq_bmm": 0}
    if cfg.family == "hybrid":
        pat, n_super, _ = recurrent._layout(cfg)
        per = sum(8 if k == "R" else 7 for k in pat)
        return {"qmac_i8": per * n_super, "qmac_i8_deq_bmm": 0}
    return {"qmac_i8": 7 * n, "qmac_i8_deq_bmm": 0}


def _traced_step(monkeypatch, arch, remat_on):
    """One ``make_train_step`` step under a costing recorder: (its
    gradient as ``adamw_update`` got it, its output, its Program)."""
    cfg, params, data = _case(arch, remat_on)
    grads, out = [], []
    monkeypatch.setattr(tsteps, "adamw_update", lambda g, *a, **kw: (
        grads.append(g), ADAMW(g, *a, **kw))[1])
    step = tsteps.make_train_step(cfg, None, POLICY)
    prog = H.trace(lambda *a: out.append(step(*a)) or out[-1],
                   (params, adamw_init(params), data))
    return cfg, grads[0], out[0], prog


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_step_is_bitwise_the_plain_step(monkeypatch, family):
    """Loss, every gradient leaf, the new params and AdamW's moments
    bitwise equal with remat on and off; the rematerialised step runs
    each checkpointed layer's products again, and nothing else more."""
    arch = FAMILIES[family]
    _, g_off, out_off, prog_off = _traced_step(monkeypatch, arch, False)
    cfg, g_on, out_on, prog_on = _traced_step(monkeypatch, arch, True)
    assert _bitwise(g_on, g_off)
    assert _bitwise(out_on[:2], out_off[:2])
    for k in ("loss", "grad_norm"):
        assert torch.equal(out_on[2][k], out_off[2][k])
    off = H.op_histogram(prog_off, QMAC)
    on = H.op_histogram(prog_on, QMAC)
    again = _recomputed_products(cfg)
    assert on == {k: off[k] + again[k] for k in QMAC}
    assert again["qmac_i8"] > 0


def _saved_bytes(fn, exclude=()):
    """Bytes of the distinct storages ``fn`` saves for its backward (a
    ``saved_tensors_hooks`` pack hook sees each), those of ``exclude``
    (the parameters) left out."""
    skip = {t.untyped_storage()._cdata for t in exclude}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in skip:
            seen[st._cdata] = st.nbytes()
        return t

    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        fn()
    return sum(seen.values())


def _loss_saved_bytes(arch, remat_on):
    cfg, params, data = _case(arch, remat_on)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    return cfg, _saved_bytes(lambda: model_for(cfg).loss_fn(
        tree_unflatten(params, leaves), data, cfg, POLICY), leaves)


def _tail_saved_bytes(cfg):
    """What the hybrid's tail layers (not rematerialised, in the
    reference as here) keep for their backward."""
    _, _, tail = recurrent._layout(cfg)
    params = recurrent.init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    x = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    pos = torch.arange(S)[None].expand(B, S)
    total = 0
    for kind, p in zip(tail, params.get("tail", [])):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
        xs = x.clone().requires_grad_(True)
        total += _saved_bytes(lambda: recurrent._sub_apply(
            tree_unflatten(p, leaves), xs, kind, cfg, POLICY, pos), leaves)
    return total


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_keeps_only_the_layer_inputs(family):
    """The bytes a loss forward saves for its backward.  With remat, once
    the part no remat covers is taken off, at most each checkpointed
    layer's fp32 input; without remat, the same layers keep at least
    ten times that.  The part no remat covers (``margin``): the
    unchunked head and CE, which the reference keeps too, at most two
    fp32 logits tensors and eight hidden-sized tensors counted at fp64;
    the embedding's token ids; and the hybrid's tail layers, measured."""
    arch = FAMILIES[family]
    cfg, on = _loss_saved_bytes(arch, True)
    _, off = _loss_saved_bytes(arch, False)
    n_ckpt = cfg.n_layers
    if cfg.family == "hybrid":
        n_ckpt = recurrent._layout(cfg)[1]
    layer_in = B * S * cfg.d_model * 4
    margin = (2 * B * S * pad_vocab(cfg.vocab) * 4
              + 8 * B * S * cfg.d_model * 8 + B * S * 4)
    if cfg.family == "hybrid":
        margin += _tail_saved_bytes(cfg)
    assert on - margin <= n_ckpt * layer_in
    assert off - margin >= 10 * n_ckpt * layer_in


def _head(w):
    return lambda h: common.logits_from_hidden(h, w, None, POLICY,
                                               n_valid=200)


def _grads_and_saved(fn, inputs):
    """(fn's outputs, the gradients of their sum wrt ``inputs``, the
    shapes of the tensors saved for the backward)."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    xs = [t.detach().requires_grad_(True) for t in inputs]
    with torch.enable_grad():
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn(*xs)
        grads = torch.autograd.grad(out.sum(), xs)
    return out.detach(), grads, shapes


def _unchecked(monkeypatch, module):
    monkeypatch.setattr(module, "checkpoint", lambda fn: fn)


def test_chunked_ce_chunks_are_rematerialised(monkeypatch):
    """``chunked_ce`` over 4 chunks: the loss and its gradients bitwise
    the same chunks without the checkpoint, and no logits kept for the
    backward (not a chunk's, not the whole [B, S, V]); without the
    checkpoint each chunk's are kept."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((B, S, 64), generator=g)
    w = torch.randn((64, 256), generator=g) * 0.1
    labels = torch.randint(0, 200, (B, S), generator=g)

    def loss(x, w):
        return common.chunked_ce(_head(w), x, labels, chunk=8)

    got = _grads_and_saved(loss, [x, w])
    _unchecked(monkeypatch, common)
    want = _grads_and_saved(loss, [x, w])
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert not [s for s in got[2] if s and s[-1] == 256]
    assert (B, 8, 256) in want[2]


def test_chunked_ce_matches_the_reference():
    """``chunked_ce`` over 4 chunks (an fp head) against the reference's
    rematerialised scan: the loss at rtol 1e-6 and the gradients within
    1e-6 of their largest magnitude."""
    import jax
    import jax.numpy as jnp

    from repro.models import common as jcommon

    rng = np.random.RandomState(4)
    x = rng.standard_normal((B, S, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 48)) * 0.3).astype(np.float32)
    labels = rng.randint(0, 48, (B, S)).astype(np.int32)
    want, (gx, gw) = jax.value_and_grad(
        lambda x, w: jcommon.chunked_ce(lambda h: h @ w, x, labels, chunk=8),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    lab = torch.from_numpy(labels)
    got, grads, _ = _grads_and_saved(
        lambda x, w: common.chunked_ce(lambda h: h @ w, x, lab, chunk=8),
        [torch.from_numpy(x), torch.from_numpy(w)])
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    for a, b in zip(grads, (gx, gw)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()


def test_attention_chunks_are_rematerialised(monkeypatch):
    """``attend_full`` over 4 q-chunks under autograd: the output and its
    gradients bitwise the same chunks without the checkpoint, and no
    chunk's [B, H, q_chunk, T] scores or weights kept for the backward;
    without the checkpoint they are."""
    g = torch.Generator().manual_seed(5)
    H_, Hk, D = 4, 2, 16
    q = torch.randn((B, S, H_, D), generator=g)
    k = torch.randn((B, S, Hk, D), generator=g)
    v = torch.randn((B, S, Hk, D), generator=g)
    pos = torch.arange(S)[None].expand(B, S)

    def attend(q, k, v):
        return attention.attend_full(q, k, v, pos, pos, causal=True,
                                     window=None, q_chunk=8)

    got = _grads_and_saved(attend, [q, k, v])
    _unchecked(monkeypatch, attention)
    want = _grads_and_saved(attend, [q, k, v])
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert (B, H_, 8, S) not in got[2]
    assert (B, H_, 8, S) in want[2]


def test_long_sequence_step_is_bitwise(monkeypatch):
    """TinyLlama reduced at 1 x 2,048 tokens, where the loss takes two CE
    chunks of 1,024 and attention four q-chunks of 512: the step with
    every remat (the layers', the CE chunks', the attention chunks')
    bitwise the step with none, and the head run again a chunk.

    Under PyTorch's deterministic mode: at 2,048 x 64 the CPU's
    ``index_put_`` that sums the embedding's gradient runs in parallel
    with atomic adds, and its bits change from run to run with remat or
    without (the card's is sort-based)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        _long_sequence_step(monkeypatch)
    finally:
        torch.use_deterministic_algorithms(was)


def _long_sequence_step(monkeypatch):
    cfg, params, data = _case("tinyllama-1.1b", True, seq=2048, batch=1)
    plain = cfg.replace(remat=False)

    def step(c):
        grads = []
        monkeypatch.setattr(tsteps, "adamw_update", lambda g, *a, **kw: (
            grads.append(g), ADAMW(g, *a, **kw))[1])
        out = []
        prog = H.trace(lambda *a: out.append(
            tsteps.make_train_step(c, None, POLICY)(*a)) or out[-1],
            (params, adamw_init(params), data))
        return grads[0], out[0], H.op_histogram(prog, QMAC)["qmac_i8"]

    g_on, out_on, n_on = step(cfg)
    _unchecked(monkeypatch, common)
    _unchecked(monkeypatch, attention)
    g_off, out_off, n_off = step(plain)
    assert _bitwise(g_on, g_off) and _bitwise(out_on, out_off)
    assert n_off == 7 * cfg.n_layers + 2
    assert n_on == n_off + 7 * cfg.n_layers + 2


@pytest.mark.parametrize("arch,seq", [("tinyllama-1.1b", 1024),
                                      ("whisper-large-v3", S)])
def test_serving_traces_ignore_remat(arch, seq):
    """The prefill step (under ``no_grad``; whisper's runs ``encode``,
    TinyLlama's at 1,024 tokens attends in two q-chunks) records the same
    ops with remat on and off."""
    progs = []
    for on in (True, False):
        cfg, params, data = _case(arch, on, seq=seq, batch=1)
        data.pop("labels")
        step = tsteps.make_prefill_step(cfg, None, POLICY, 8)
        progs.append(H.trace(step, (params, data)))
    a, b = progs
    assert [r[:5] for r in a.ops] == [r[:5] for r in b.ops]
    assert H.op_histogram(a, QMAC)["qmac_i8"] > 0


def test_recompute_sees_the_forwards_mesh_context():
    """On the card autograd recomputes on a thread of its own, which has
    no mesh context: the recompute runs under the context its forward
    saw (here the backward runs outside it)."""
    seen = []

    def body(x):
        seen.append((tsh.current_mesh(), tsh.across_slots()))
        return x.sin().sin()

    mesh = tsh.MeshShape(("data", "model"), (4, 1))
    x = torch.randn(8, requires_grad=True)
    with torch.enable_grad():
        with tsh.mesh_rules(mesh):
            y = remat.checkpoint(body)(x)
        torch.autograd.grad(y.sum(), x)
    assert seen == [(mesh, True)] * 2
    assert tsh.current_mesh() is None
    with torch.no_grad():
        remat.checkpoint(body)(x)
    assert len(seen) == 3


def test_recorder_peak_sees_what_remat_frees():
    """The op recorder's live-byte peak over forward and backward of 8
    layers ``h = sin(h) * cos(h)`` on N fp64 values: without remat each
    layer keeps its input, its sine and its cosine (24 at least live at
    the backward's start); with remat each keeps its input alone, and the
    backward holds one layer's recomputed sine and cosine and three
    gradients at most at a time (and two fp64 scalars: the sum and its
    gradient)."""
    n, L = 4096, 8
    x0 = torch.randn(n, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(6))

    def layer(h):
        return torch.sin(h) * torch.cos(h)

    def run(fn):
        def f(x):
            x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                h = x
                for _ in range(L):
                    h = fn(h)
                return torch.autograd.grad(h.sum(), x)[0]
        return H.memory_stats(H.trace(f, (x0,)))["temp_size_in_bytes"]

    plain, rematted = run(layer), run(remat.checkpoint(layer))
    size = n * 8
    assert plain >= 3 * L * size
    assert rematted <= (L + 5) * size + 16
