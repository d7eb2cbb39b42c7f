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
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, pad_vocab
from repro_torch.core.fxp import QTensor, is_qtensor
from repro_torch.core.policy import QuantPolicy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import constrain
from repro_torch.models.common import (chunked_ce, logits_from_hidden,
                                       stack_axes, stack_init)
from repro_torch.nn.attention import (AttnConfig, attention_apply,
                                      attention_axes, attention_decode,
                                      attention_init, init_cache)
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


def _ffn(p, h, cfg: ArchConfig, policy):
    """The block's FFN: the experts (MoE) or the SwiGLU MLP."""
    if cfg.is_moe:
        return moe_apply(p["moe"], h, top_k=cfg.top_k, policy=policy,
                         capacity_factor=cfg.capacity_factor, act=cfg.act)
    return swiglu_apply(p["mlp"], h, policy, act=cfg.act)


def _block_apply(p, x, cfg: ArchConfig, policy, positions):
    # the reference's layout: the residual stream over "seq" (sequence
    # parallelism), gathered before the attention and the FFN
    x = constrain(x, ("batch", "seq", None))
    h = rmsnorm_apply(p["ln1"], x)
    h = constrain(h, ("batch", None, None))
    a = attention_apply(p["attn"], h, attn_config(cfg), policy,
                        positions=positions)
    x = x + constrain(a, ("batch", "seq", None))
    h = rmsnorm_apply(p["ln2"], x)
    h = constrain(h, ("batch", None, None))
    return x + constrain(_ffn(p, h, cfg, policy), ("batch", "seq", None))


def _block_prefill(p, x, cfg, policy, positions, kv_bits):
    h = rmsnorm_apply(p["ln1"], x)
    a, cache = attention_apply(p["attn"], h, attn_config(cfg), policy,
                               positions=positions, return_cache=True,
                               kv_bits=kv_bits)
    x = x + a
    h = rmsnorm_apply(p["ln2"], x)
    return x + _ffn(p, h, cfg, policy), cache


def _block_decode(p, x, cfg, policy, cache, index, kv_bits):
    h = rmsnorm_apply(p["ln1"], x)
    a, cache = attention_decode(p["attn"], h, attn_config(cfg), cache,
                                index, policy, kv_bits=kv_bits)
    x = x + a
    h = rmsnorm_apply(p["ln2"], x)
    return x + _ffn(p, h, cfg, policy), cache


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


def param_axes(cfg: ArchConfig):
    """The reference's logical axes of :func:`init`'s tree (its boxed
    init's ``axes_of``)."""
    block = {"ln1": rmsnorm_axes(), "attn": attention_axes(attn_config(cfg)),
             "ln2": rmsnorm_axes()}
    if cfg.is_moe:
        block["moe"] = moe_axes()
    else:
        block["mlp"] = swiglu_axes()
    axes = {"embed": embedding_axes(("vocab", "d_model")),
            "blocks": stack_axes(block), "ln_f": rmsnorm_axes()}
    if not cfg.tie_embeddings:
        axes["lm_head"] = linear_axes(("d_model", "vocab"), False)
    return axes


def _head(params, x, cfg, policy):
    tie = params["embed"] if cfg.tie_embeddings else None
    head = None if cfg.tie_embeddings else params["lm_head"]["w"]
    return logits_from_hidden(x, head, tie, policy, n_valid=cfg.vocab)


def _embed(params, tokens, policy):
    x = embedding_apply(params["embed"], tokens, policy)
    return x.to(policy.compute_dtype if policy else torch.float32)


def _positions(tokens: Tensor) -> Tensor:
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None].expand(B, S)


def forward(params, tokens: Tensor, cfg: ArchConfig,
            policy: Optional[QuantPolicy] = None,
            return_hidden: bool = False) -> Tensor:
    """Training/scoring forward: tokens [B, S] -> fp32 logits [B, S, V].
    Under ``cfg.remat`` each block is rematerialised in the backward."""
    blocks = layers(params["blocks"], cfg.n_layers)
    x = _embed(params, tokens, policy)
    body = functools.partial(_block_apply, cfg=cfg, policy=policy,
                             positions=_positions(tokens))
    if cfg.remat:
        body = checkpoint(body)
    for p in blocks:
        x = body(p, x)
    x = rmsnorm_apply(params["ln_f"], x)
    if return_hidden:
        return x
    return _head(params, x, cfg, policy)


def loss_fn(params, batch, cfg: ArchConfig,
            policy: Optional[QuantPolicy] = None) -> Tensor:
    x = forward(params, batch["tokens"], cfg, policy, return_hidden=True)
    return chunked_ce(lambda h: _head(params, h, cfg, policy), x,
                      batch["labels"], batch.get("mask"))


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
    """Prefill: (last-position logits [B, V], stacked caches)."""
    blocks = layers(params["blocks"], cfg.n_layers)
    x = _embed(params, tokens, policy)
    positions = _positions(tokens)
    caches = []
    for p in blocks:
        x, cache = _block_prefill(p, x, cfg, policy, positions, kv_bits)
        caches.append(cache)
    x = rmsnorm_apply(params["ln_f"], x[:, -1:])
    return _head(params, x, cfg, policy)[:, 0], stack_caches(caches)


def decode_step(params, token: Tensor, caches, index: int,
                cfg: ArchConfig, policy: Optional[QuantPolicy] = None,
                kv_bits: int = 32):
    """One decode step: token [B, 1] -> (logits [B, V], caches).  Each
    layer's cache is a view of the stacked one, updated in place."""
    blocks = layers(params["blocks"], cfg.n_layers)
    x = _embed(params, token, policy)
    for i, p in enumerate(blocks):
        x, _ = _block_decode(p, x, cfg, policy,
                             {k: v[i] for k, v in caches.items()}, index,
                             kv_bits)
    x = rmsnorm_apply(params["ln_f"], x)
    return _head(params, x, cfg, policy)[:, 0], caches
