"""Decoder-only LM family: dense (qwen2/stablelm/phi3/tinyllama/
chameleon) and MoE (mixtral, qwen3-moe) — port of
``repro.models.transformer``.  Every product routes through q_matmul
(on a CUDA tensor, Q-MAC), the experts' through q_batched_matmul
(Q-MAC's batched kernel).

Block params are stacked ``[L, ...]`` as in the reference, and the
layers are walked in a Python loop over the stacked leaves in place of
its ``lax.scan`` (:func:`layers`): a layer's weights are views ``w[i]``
(a QTensor's ``qvalue[i]``, ``scale[i]``), taken by one ``unbind`` a
leaf.  Like the scan, the walk refuses a tree whose stacked leaves do
not all lead with the layer count.  Under ``cfg.remat`` (every config's
default) the training forward checkpoints each block's body
(``nn.remat.checkpoint``, the reference's ``jax.checkpoint`` with
nothing saveable): the backward recomputes it from the block's input.
``cfg.scan_layers`` is a compile knob and changes nothing here.  The
reference's ``distributed.sharding.constrain`` layout hints stand at
its sites; on a rank's plain tensors they return their input.

A laid-out step (``distributed.sharding.layout``; the dense family)
holds this rank's blocks of the params as ``make_shardings`` lays them
out, and computes on them as the reference's partitioned program does:
each layer's weights are gathered over the data axes inside its
(rematerialised) body, so the recompute gathers them again and each
gradient is reduce-scattered over the slots; the attention runs on the
rank's heads and the MLP on its ``d_ff`` columns (column-parallel in,
row-parallel out), the embedding and the head are vocab-parallel, and
under ``cfg.seq_shard`` the residual stream holds the rank's piece of
the sequence, gathered before each sub-block and reduce-scattered after
it (the reference's ``constrain`` sites).  The serving steps run the
same block body (:func:`_block`) on the PTQ'd blocks: a prefill under
the FSDP+TP rules (its weights gathered over the data axes, packed; its
residual stream split along the sequence under ``cfg.seq_shard``), a
decode step under the serve rules (nothing over the data axes, one
token and no sequence split), each on its block of the KV cache
(``nn.attention.kv_split``); their logits are this rank's rows, whole
over the vocabulary (the head's columns gathered over the model axis,
as sampling reads them).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, pad_vocab
from repro_torch.core.fxp import QTensor, is_qtensor
from repro_torch.core.policy import QuantPolicy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (Layout, constrain, gather_over,
                                              layout)
from repro_torch.models.common import (chunked_ce, logits_from_hidden,
                                       stack_axes, stack_init)
from repro_torch.nn.attention import (AttnConfig, attention_apply,
                                      attention_axes, attention_decode,
                                      attention_init, init_cache,
                                      model_summed)
from repro_torch.nn.linear import (embedding_apply, embedding_axes,
                                   embedding_init, linear_axes, linear_init)
from repro_torch.nn.mlp import swiglu_apply, swiglu_axes, swiglu_init
from repro_torch.nn.moe import moe_apply, moe_axes, moe_init
from repro_torch.nn.norm import rmsnorm_apply, rmsnorm_axes, rmsnorm_init
from repro_torch.nn.remat import checkpoint
from repro_torch.tree import leaves_with_path, map_with_path, path_str

Tensor = torch.Tensor


def attn_config(cfg: ArchConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, causal=True,
        window=cfg.window, rope=cfg.rope, rope_theta=cfg.rope_theta,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        q_chunk=cfg.q_chunk)


def _block_init(gen, cfg: ArchConfig, dtype):
    p = {
        "ln1": rmsnorm_init(gen, cfg.d_model, dtype),
        "attn": attention_init(gen, attn_config(cfg), dtype),
        "ln2": rmsnorm_init(gen, cfg.d_model, dtype),
    }
    if cfg.is_moe:
        p["moe"] = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                            dtype)
    else:
        p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def _ffn(p, h, cfg: ArchConfig, policy, scatter: Optional[int] = None):
    """The block's FFN: the experts (MoE) or the SwiGLU MLP."""
    if cfg.is_moe:
        return moe_apply(p["moe"], h, top_k=cfg.top_k, policy=policy,
                         capacity_factor=cfg.capacity_factor, act=cfg.act)
    return swiglu_apply(p["mlp"], h, policy, act=cfg.act, scatter=scatter)


def _seq(lay: Optional[Layout]) -> Optional[int]:
    """The dimension a laid-out step splits the residual stream along
    over the model axis (sequence parallelism), else None."""
    return 1 if lay is not None and lay.split("seq") else None


def _seq_norms(seq: Optional[int], *names: str):
    """The paths of the norm scales ``names`` where each model rank reads
    them for its own piece of the sequence (sequence parallelism,
    ``seq`` its dimension): their gradients are its partials, summed
    over the model axis."""
    return [(n, "scale") for n in names] if seq else []


def _whole(h: Tensor, lay: Optional[Layout], seq: Optional[int]) -> Tensor:
    """``h`` whole over the sequence, as the attention and the FFN read
    it: the reference's layout hint, or on a laid-out step
    :meth:`Layout.enter`."""
    if lay is None:
        return constrain(h, ("batch", None, None))
    return lay.enter(h, seq)


def _block(p, x, cfg: ArchConfig, policy, lay: Optional[Layout],
           seq: Optional[int], attend):
    """One block: ``x + attention``, then ``+ FFN``, each on the normed
    stream; ``attend(p_attn, h)`` gives the attention's output and its
    cache (or None).  The reference's layout: the residual stream over
    "seq" (sequence parallelism, dimension ``seq``), gathered before
    the attention and the FFN.  On a laid-out step ``p`` is this rank's
    blocks of the layer, gathered over the data axes first; the
    attention and the MLP split over the model axis, their row-parallel
    sums reduce-scattered along ``seq``."""
    if lay is not None:
        p = lay.gather(p, _block_axes(cfg), _seq_norms(seq, "ln1", "ln2") + [
            ("attn",) + path for path in model_summed(attn_config(cfg), lay)])
    x = constrain(x, ("batch", "seq", None))
    a, cache = attend(p["attn"], _whole(rmsnorm_apply(p["ln1"], x), lay,
                                        seq))
    x = x + constrain(a, ("batch", "seq", None))
    # no name holds the attention's output past the sum: it is freed
    # before the FFN runs
    del a
    h = _whole(rmsnorm_apply(p["ln2"], x), lay, seq)
    return x + constrain(_ffn(p, h, cfg, policy, seq),
                         ("batch", "seq", None)), cache


def _block_apply(p, x, cfg: ArchConfig, policy, positions,
                 lay: Optional[Layout] = None):
    """The training/scoring block (:func:`_block`)."""
    acfg = attn_config(cfg)
    seq = _seq(lay)
    return _block(p, x, cfg, policy, lay, seq, lambda pa, h: (
        attention_apply(pa, h, acfg, policy, positions=positions,
                        scatter=seq), None))[0]


def _block_prefill(p, x, cfg, policy, positions, kv_bits,
                   lay: Optional[Layout] = None):
    """The prefill block (:func:`_block`): its output and its KV cache
    (on a laid-out step, this rank's block of it)."""
    acfg = attn_config(cfg)
    seq = _seq(lay)
    return _block(p, x, cfg, policy, lay, seq, lambda pa, h: attention_apply(
        pa, h, acfg, policy, positions=positions, return_cache=True,
        kv_bits=kv_bits, scatter=seq))


def _block_decode(p, x, cfg, policy, cache, index, kv_bits,
                  lay: Optional[Layout] = None):
    """The decode block (:func:`_block`): one token, no sequence split;
    the cache (this rank's block of it) updated in place."""
    acfg = attn_config(cfg)
    return _block(p, x, cfg, policy, lay, None, lambda pa, h:
                  attention_decode(pa, h, acfg, cache, index, policy,
                                   kv_bits=kv_bits))


def _unbind(leaf):
    """A stacked leaf's ``n`` layer views, from one ``unbind``."""
    if isinstance(leaf, QTensor):
        return [QTensor(q, s, leaf.bits) for q, s in
                zip(leaf.qvalue.unbind(0), leaf.scale.unbind(0))]
    return leaf.unbind(0)


def layers(blocks, n: int):
    """The ``n`` layers' params in order, each a view of every stacked
    leaf (``blocks[...][i]``).  Each leaf is split by one ``unbind``,
    whose backward stacks the layers' gradients once; indexing it a
    layer at a time would give each layer's gradient as a zero-filled
    copy of the whole stack, summed over the layers.

    Checks first, before any layer runs, that every stacked tensor leads
    with ``n``: arrays, QTensor payloads and scales alike.  The
    reference's ``lax.scan`` over the stack refuses a leaf that does not
    (a per-tensor or ``[1, 1, 1, N]`` scale, say), and so does this walk,
    with a ``ValueError`` naming the leaf, where indexing would hand
    layer 0 a broadcast view and fail at layer 1."""
    for path, leaf in leaves_with_path(blocks, is_leaf=is_qtensor):
        parts = ((".qvalue", leaf.qvalue), (".scale", leaf.scale)) \
            if isinstance(leaf, QTensor) else (("", leaf),)
        for part, t in parts:
            if t.ndim == 0 or t.shape[0] != n:
                raise ValueError(
                    f"stacked leaf {path_str(path)}{part} of shape "
                    f"{tuple(t.shape)} does not lead with the {n} layers "
                    "the walk scans")
    views = {path: _unbind(leaf)
             for path, leaf in leaves_with_path(blocks, is_leaf=is_qtensor)}
    return [map_with_path(lambda path, _l, i=i: views[path][i], blocks,
                          is_leaf=is_qtensor) for i in range(n)]


# ---------------------------------------------------------------------------
# model init / forward
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device: DeviceLike = None):
    """Random weights drawn from the CPU generator ``gen``, placed on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    v_pad = pad_vocab(cfg.vocab)
    params = {
        "embed": embedding_init(gen, v_pad, cfg.d_model, dtype=dtype,
                                device=dev),
        "blocks": stack_init(lambda g: _block_init(g, cfg, dtype), gen,
                             cfg.n_layers, dev),
        "ln_f": rmsnorm_init(gen, cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, cfg.d_model, v_pad, bias=False,
                                        dtype=dtype, device=dev)
    return params


def _block_axes(cfg: ArchConfig):
    """The logical axes of one layer's params (no layer axis)."""
    block = {"ln1": rmsnorm_axes(), "attn": attention_axes(attn_config(cfg)),
             "ln2": rmsnorm_axes()}
    if cfg.is_moe:
        block["moe"] = moe_axes()
    else:
        block["mlp"] = swiglu_axes()
    return block


def param_axes(cfg: ArchConfig):
    """The reference's logical axes of :func:`init`'s tree (its boxed
    init's ``axes_of``)."""
    axes = {"embed": embedding_axes(("vocab", "d_model")),
            "blocks": stack_axes(_block_axes(cfg)), "ln_f": rmsnorm_axes()}
    if not cfg.tie_embeddings:
        axes["lm_head"] = linear_axes(("d_model", "vocab"), False)
    return axes


def _head(params, x, cfg, policy):
    tie = params["embed"] if cfg.tie_embeddings else None
    head = None if cfg.tie_embeddings else params["lm_head"]["w"]
    axes = None if cfg.tie_embeddings else \
        linear_axes(("d_model", "vocab"), False)["w"]
    return logits_from_hidden(x, head, tie, policy, n_valid=cfg.vocab,
                              axes=axes)


def _embed(params, tokens, policy, scatter: Optional[int] = None):
    x = embedding_apply(params["embed"], tokens, policy,
                        embedding_axes(("vocab", "d_model"))["emb"], scatter)
    return x.to(policy.compute_dtype if policy else torch.float32)


def _positions(tokens: Tensor) -> Tensor:
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None].expand(B, S)


def _gather_top(params, cfg: ArchConfig, lay: Optional[Layout]):
    """On a laid-out step, ``params`` with the leaves outside the layer
    stack (embedding, final norm, head) gathered over the data axes in
    one buffer a dtype; the stack stays this rank's blocks, gathered a
    layer at a time inside :func:`_block`.  Else ``params`` as they
    are."""
    if lay is None:
        return params
    if cfg.is_moe or cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: the laid-out step takes an untied "
                         "dense decoder")
    axes = param_axes(cfg)
    top = lay.gather({k: v for k, v in params.items() if k != "blocks"},
                     {k: v for k, v in axes.items() if k != "blocks"},
                     _seq_norms(_seq(lay), "ln_f"))
    return dict(top, blocks=params["blocks"])


def _served_logits(params, x: Tensor, cfg: ArchConfig, policy,
                   lay: Optional[Layout]) -> Tensor:
    """The head's logits of ``x``, whole over the vocabulary: on a
    laid-out step the vocab-parallel head's columns gathered over the
    model axis, as sampling reads them."""
    logits = _head(params, x, cfg, policy)
    vocab = lay.split("vocab") if lay is not None else ()
    if not vocab:
        return logits
    return torch.cat(gather_over(logits.contiguous(), lay.mesh, vocab),
                     dim=-1)


def forward(params, tokens: Tensor, cfg: ArchConfig,
            policy: Optional[QuantPolicy] = None,
            return_hidden: bool = False,
            lay: Optional[Layout] = None) -> Tensor:
    """Training/scoring forward: tokens [B, S] -> fp32 logits [B, S, V].
    Under ``cfg.remat`` each block is rematerialised in the backward.
    ``lay``: a laid-out step's layout, under which ``params`` come from
    :func:`_gather_top` and the logits are this rank's vocab columns."""
    seq = _seq(lay)
    blocks = layers(params["blocks"], cfg.n_layers)
    x = _embed(params, tokens, policy, seq)
    body = functools.partial(_block_apply, cfg=cfg, policy=policy,
                             positions=_positions(tokens), lay=lay)
    if cfg.remat:
        body = checkpoint(body)
    for p in blocks:
        x = body(p, x)
    x = rmsnorm_apply(params["ln_f"], x)
    if lay is not None:
        x = lay.enter(x, seq)
    if return_hidden:
        return x
    return _head(params, x, cfg, policy)


def loss_fn(params, batch, cfg: ArchConfig,
            policy: Optional[QuantPolicy] = None) -> Tensor:
    """Mean next-token CE of ``batch``; on a laid-out step, of this
    rank's rows from its blocks of the params (the same on each model
    rank), the head and the loss vocab-parallel."""
    lay = layout()
    params = _gather_top(params, cfg, lay)
    x = forward(params, batch["tokens"], cfg, policy, return_hidden=True,
                lay=lay)
    vocab = lay.split("vocab") if lay is not None else ()
    return chunked_ce(lambda h: _head(params, h, cfg, policy), x,
                      batch["labels"], batch.get("mask"),
                      vocab=(lay.mesh, vocab) if vocab else None)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                kv_bits: int = 32, dtype=torch.float32, device="cpu"):
    """Stacked per-layer KV caches [L, ...].  Sliding-window archs get
    ring buffers of min(window, max_len) slots."""
    cap = max_len if cfg.window is None else min(cfg.window, max_len)
    ring = cfg.window is not None and cap < max_len
    one = init_cache(batch, cap, cfg.n_kv_heads, cfg.hd, kv_bits, dtype,
                     ring=ring, device=device)
    return {k: v[None].expand((cfg.n_layers,) + v.shape).contiguous()
            for k, v in one.items()}


def stack_caches(caches):
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def prefill(params, tokens: Tensor, cfg: ArchConfig,
            policy: Optional[QuantPolicy] = None, kv_bits: int = 32):
    """Prefill: (last-position logits [B, V], stacked caches).  On a
    laid-out step (``sharding.layout``): this rank's rows, from its
    blocks of the PTQ'd params, and its blocks of the caches; under
    ``cfg.seq_shard`` the last position comes from the model rank
    holding the sequence's last piece."""
    lay = layout()
    params = _gather_top(params, cfg, lay)
    seq = _seq(lay)
    blocks = layers(params["blocks"], cfg.n_layers)
    x = _embed(params, tokens, policy, seq)
    positions = _positions(tokens)
    caches = []
    for p in blocks:
        x, cache = _block_prefill(p, x, cfg, policy, positions, kv_bits,
                                  lay)
        caches.append(cache)
    x = lay.enter(x[:, -1:], seq)[:, -1:] if seq else x[:, -1:]
    x = rmsnorm_apply(params["ln_f"], x)
    return _served_logits(params, x, cfg, policy, lay)[:, 0], \
        stack_caches(caches)


def decode_step(params, token: Tensor, caches, index: int,
                cfg: ArchConfig, policy: Optional[QuantPolicy] = None,
                kv_bits: int = 32):
    """One decode step: token [B, 1] -> (logits [B, V], caches).  Each
    layer's cache is a view of the stacked one, updated in place.  On a
    laid-out step (``sharding.layout``): this rank's rows from its
    blocks of the params and of the caches."""
    lay = layout()
    params = _gather_top(params, cfg, lay)
    blocks = layers(params["blocks"], cfg.n_layers)
    x = _embed(params, token, policy)
    for i, p in enumerate(blocks):
        x, _ = _block_decode(p, x, cfg, policy,
                             {k: v[i] for k, v in caches.items()}, index,
                             kv_bits, lay)
    x = rmsnorm_apply(params["ln_f"], x)
    return _served_logits(params, x, cfg, policy, lay)[:, 0], caches
