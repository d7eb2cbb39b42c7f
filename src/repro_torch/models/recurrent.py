"""RecurrentGemma-style hybrid LM: (R, R, A) super-blocks (port of
``repro.models.recurrent``).

R = RG-LRU recurrent block, A = local (sliding-window) MQA attention;
each followed by a GeGLU MLP (``swiglu_apply(..., act="gelu")``).  The
repeating pattern's params are stacked ``[n_super, ...]`` under
``supers`` and walked in a Python loop; the remainder layers (38 = 12 x
3 + 2) are the ``tail`` list, as in the reference.  Under ``cfg.remat``
the training forward rematerialises each super-block, not the tail.
Every product routes through q_matmul (on a CUDA tensor, Q-MAC).

Serving caches: an R layer keeps its conv tail (the raw pre-conv input)
and its RG-LRU state, written in place by a decode step; an A layer
keeps a KV cache.  Prefill returns the KV caches at prompt length (not
rings) and ``launch.serve.pad_caches`` grows them; ``init_caches`` builds
a ring when ``min(local_window, max_len) < max_len``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, pad_vocab
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.vact import activation
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import chunked_ce, stack_axes, stack_init
from repro_torch.models.transformer import (_embed, _head, _positions,
                                            layers, stack_caches)
from repro_torch.nn.attention import (AttnConfig, attention_apply,
                                      attention_axes, attention_decode,
                                      attention_init, init_cache)
from repro_torch.nn.conv import causal_conv1d_apply
from repro_torch.nn.linear import (embedding_axes, embedding_init,
                                   linear_apply, linear_axes, linear_init)
from repro_torch.nn.mlp import swiglu_apply, swiglu_axes, swiglu_init
from repro_torch.nn.norm import rmsnorm_apply, rmsnorm_axes, rmsnorm_init
from repro_torch.nn.remat import checkpoint
from repro_torch.nn.rglru import (recurrent_block_apply,
                                  recurrent_block_axes,
                                  recurrent_block_init,
                                  recurrent_block_init_state, rglru_apply)
from repro_torch.tree import tree_map

Tensor = torch.Tensor


def attn_config(cfg: ArchConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, causal=True,
        window=cfg.local_window, rope=True, rope_theta=cfg.rope_theta,
        q_chunk=cfg.q_chunk)


def _layout(cfg: ArchConfig):
    pat = cfg.block_pattern or ("R",)
    n_super = cfg.n_layers // len(pat)
    tail = tuple(pat[i] for i in range(cfg.n_layers % len(pat)))
    return pat, n_super, tail


def _sub_init(gen, kind: str, cfg: ArchConfig, dtype):
    p = {"ln1": rmsnorm_init(gen, cfg.d_model, dtype),
         "ln2": rmsnorm_init(gen, cfg.d_model, dtype),
         "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype)}
    if kind == "R":
        p["rec"] = recurrent_block_init(gen, cfg.d_model, cfg.lru_width,
                                        dtype=dtype)
    else:
        p["attn"] = attention_init(gen, attn_config(cfg), dtype)
    return p


def _super_init(gen, cfg: ArchConfig, dtype):
    pat, _, _ = _layout(cfg)
    return {f"b{i}_{kind}": _sub_init(gen, kind, cfg, dtype)
            for i, kind in enumerate(pat)}


def _sub_apply(p, x, kind, cfg, policy, positions):
    h = rmsnorm_apply(p["ln1"], x)
    if kind == "R":
        x = x + recurrent_block_apply(p["rec"], h, policy)
    else:
        x = x + attention_apply(p["attn"], h, attn_config(cfg), policy,
                                positions=positions)
    h = rmsnorm_apply(p["ln2"], x)
    return x + swiglu_apply(p["mlp"], h, policy, act=cfg.act)


def _sub_decode(p, x, kind, cfg, policy, cache, index, kv_bits):
    """One layer's decode step; its cache is updated in place."""
    h = rmsnorm_apply(p["ln1"], x)
    if kind == "R":
        out, new = recurrent_block_apply(p["rec"], h, policy, state=cache)
        for k, v in new.items():
            cache[k].copy_(v)
    else:
        out, _ = attention_decode(p["attn"], h, attn_config(cfg), cache,
                                  index, policy, kv_bits=kv_bits)
    x = x + out
    h = rmsnorm_apply(p["ln2"], x)
    return x + swiglu_apply(p["mlp"], h, policy, act=cfg.act)


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device: DeviceLike = None):
    """Random weights drawn from the CPU generator ``gen``, placed on
    ``device`` (default: the card)."""
    pat, n_super, tail = _layout(cfg)
    dev = resolve_device(device)
    v_pad = pad_vocab(cfg.vocab)
    params = {
        "embed": embedding_init(gen, v_pad, cfg.d_model, dtype=dtype,
                                device=dev),
        "supers": stack_init(lambda g: _super_init(g, cfg, dtype), gen,
                             n_super, dev),
        "ln_f": rmsnorm_init(gen, cfg.d_model, dtype, dev),
        "lm_head": linear_init(gen, cfg.d_model, v_pad, bias=False,
                               dtype=dtype, device=dev),
    }
    if tail:
        params["tail"] = [tree_map(lambda t: t.to(dev),
                                   _sub_init(gen, kind, cfg, dtype))
                          for kind in tail]
    return params


def _sub_axes(kind: str, cfg: ArchConfig):
    p = {"ln1": rmsnorm_axes(), "ln2": rmsnorm_axes(),
         "mlp": swiglu_axes()}
    if kind == "R":
        p["rec"] = recurrent_block_axes()
    else:
        p["attn"] = attention_axes(attn_config(cfg))
    return p


def param_axes(cfg: ArchConfig):
    """The reference's logical axes of :func:`init`'s tree: the
    super-blocks stacked, the tail's layers not."""
    pat, _, tail = _layout(cfg)
    axes = {
        "embed": embedding_axes(("vocab", "d_model")),
        "supers": stack_axes({f"b{i}_{kind}": _sub_axes(kind, cfg)
                              for i, kind in enumerate(pat)}),
        "ln_f": rmsnorm_axes(),
        "lm_head": linear_axes(("d_model", "vocab"), False),
    }
    if tail:
        axes["tail"] = [_sub_axes(kind, cfg) for kind in tail]
    return axes


def _layers(params, cfg):
    """[(kind, params)] of every layer in order: each super-block's
    pattern, then the tail (the stacked super-blocks checked by
    ``transformer.layers`` before any layer runs)."""
    pat, n_super, tail = _layout(cfg)
    walk = [(kind, sp[f"b{i}_{kind}"])
            for sp in layers(params["supers"], n_super)
            for i, kind in enumerate(pat)]
    return walk + list(zip(tail, params.get("tail", []), strict=True))


def forward(params, tokens: Tensor, cfg: ArchConfig,
            policy: Optional[QuantPolicy] = None,
            return_hidden: bool = False) -> Tensor:
    """Training/scoring forward: tokens [B, S] -> fp32 logits [B, S, V].
    Under ``cfg.remat`` each super-block (the pattern's layers) is
    rematerialised in the backward; the tail's layers are not, as in the
    reference."""
    pat, n_super, tail = _layout(cfg)
    x = _embed(params, tokens, policy)
    positions = _positions(tokens)

    def super_body(sp, h):
        for i, kind in enumerate(pat):
            h = _sub_apply(sp[f"b{i}_{kind}"], h, kind, cfg, policy,
                           positions)
        return h

    if cfg.remat:
        super_body = checkpoint(super_body)
    for sp in layers(params["supers"], n_super):
        x = super_body(sp, x)
    for kind, p in zip(tail, params.get("tail", []), strict=True):
        x = _sub_apply(p, x, kind, cfg, policy, positions)
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

def _sub_cache(kind, cfg, batch, max_len, kv_bits, dtype, device):
    if kind == "R":
        return recurrent_block_init_state(batch, cfg.lru_width,
                                          device=device)
    cap = min(cfg.local_window, max_len)
    return init_cache(batch, cap, cfg.n_kv_heads, cfg.hd, kv_bits, dtype,
                      ring=cap < max_len, device=device)


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                kv_bits: int = 32, dtype=torch.float32, device="cpu"):
    pat, n_super, tail = _layout(cfg)
    caches = {"supers": {
        f"b{i}_{kind}": tree_map(
            lambda v: v[None].expand((n_super,) + v.shape).contiguous(),
            _sub_cache(kind, cfg, batch, max_len, kv_bits, dtype, device))
        for i, kind in enumerate(pat)}}
    if tail:
        caches["tail"] = [_sub_cache(kind, cfg, batch, max_len, kv_bits,
                                     dtype, device) for kind in tail]
    return caches


def _sub_prefill(p, x, kind, cfg, policy, positions, kv_bits):
    """One layer of the prefill: (its output, its cache).  An R layer
    keeps the raw (pre-conv) tail of ``lin_x``'s output as its conv
    state and the scan's last state; an A layer its KV cache at prompt
    length."""
    S = x.shape[1]
    h = rmsnorm_apply(p["ln1"], x)
    if kind == "R":
        rec = p["rec"]
        gate = activation(linear_apply(rec["lin_y"], h, policy), "gelu",
                          policy)
        u = linear_apply(rec["lin_x"], h, policy)
        u_conv = causal_conv1d_apply(rec["conv"], u)
        hs, last = rglru_apply(rec["rglru"], u_conv, policy)
        out = linear_apply(rec["lin_out"], hs * gate, policy)
        w = rec["conv"]["w"].shape[0] - 1
        cache = {"conv": u[:, S - w:S].to(torch.float32), "rglru": last}
    else:
        out, cache = attention_apply(p["attn"], h, attn_config(cfg), policy,
                                     positions=positions, return_cache=True,
                                     kv_bits=kv_bits)
    x = x + out
    h = rmsnorm_apply(p["ln2"], x)
    return x + swiglu_apply(p["mlp"], h, policy, act=cfg.act), cache


def prefill(params, tokens: Tensor, cfg: ArchConfig,
            policy: Optional[QuantPolicy] = None, kv_bits: int = 32):
    """Prefill: (last-position logits [B, V], caches)."""
    pat, n_super, tail = _layout(cfg)
    x = _embed(params, tokens, policy)
    positions = _positions(tokens)
    per_layer = []
    for kind, p in _layers(params, cfg):
        x, cache = _sub_prefill(p, x, kind, cfg, policy, positions, kv_bits)
        per_layer.append(cache)
    n = n_super * len(pat)
    caches = {"supers": {
        f"b{i}_{kind}": stack_caches(per_layer[i:n:len(pat)])
        for i, kind in enumerate(pat)}}
    if tail:
        caches["tail"] = per_layer[n:]
    x = rmsnorm_apply(params["ln_f"], x[:, -1:])
    return _head(params, x, cfg, policy)[:, 0], caches


def _layer_caches(caches, cfg):
    """Every layer's cache in ``_layers``' order: views of the stacked
    super-block caches, then the tail's."""
    pat, n_super, _ = _layout(cfg)
    for s in range(n_super):
        for i, kind in enumerate(pat):
            yield {k: v[s] for k, v in caches["supers"][f"b{i}_{kind}"]
                   .items()}
    yield from caches.get("tail", [])


def decode_step(params, token: Tensor, caches, index: int,
                cfg: ArchConfig, policy: Optional[QuantPolicy] = None,
                kv_bits: int = 32):
    """One decode step: token [B, 1] -> (logits [B, V], caches), every
    layer's cache updated in place."""
    x = _embed(params, token, policy)
    for (kind, p), cache in zip(_layers(params, cfg),
                                _layer_caches(caches, cfg), strict=True):
        x = _sub_decode(p, x, kind, cfg, policy, cache, index, kv_bits)
    x = rmsnorm_apply(params["ln_f"], x)
    return _head(params, x, cfg, policy)[:, 0], caches
