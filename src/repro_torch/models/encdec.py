"""Whisper-style encoder-decoder backbone, LayerNorm + GELU (port of
``repro.models.encdec``).  Every product routes through q_matmul (on a
CUDA tensor, Q-MAC).

The audio frontend is a stub, as in the reference: the encoder takes
frame embeddings ``[B, S_enc, d_model]``.  Positions are sinusoidal
(any length).  Block params are stacked ``[L, ...]`` (``enc_blocks``,
``dec_blocks``) and walked in a Python loop, as
``models.transformer`` walks its blocks; under ``cfg.remat`` the
training forward rematerialises each encoder block and each decoder
block in the backward.

Reproduced from the reference, as it behaves:

* ``prefill``'s cross attention runs on the fp K/V projected from
  ``enc_out``, while the cross *cache* it returns is written at
  ``kv_bits``: under ``w8a8kv8`` the prefill's cross attention is fp and
  decode's reads int8.  The reference projects each layer's cross K/V
  twice (and a query of ``enc_out`` it drops); here they are projected
  once and used for both, with the same values;
* ``launch.serve.pad_caches`` pads the cross cache by the decode's
  slots too, and decode's cross attention attends over them unmasked;
* ``decode_step`` reads its position row from a table as long as the
  self cache, after casting the embedding to the policy's compute
  dtype.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, pad_vocab
from repro_torch.core.policy import QuantPolicy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import (chunked_ce, logits_from_hidden,
                                       sinusoidal_positions, stack_axes,
                                       stack_init)
from repro_torch.models.transformer import layers, stack_caches
from repro_torch.nn.attention import (AttnConfig, attention_apply,
                                      attention_axes, attention_decode,
                                      attention_init, cache_update,
                                      init_cache, project_kv)
from repro_torch.nn.linear import (embedding_apply, embedding_axes,
                                   embedding_init, linear_axes, linear_init)
from repro_torch.nn.mlp import mlp_apply, mlp_axes, mlp_init
from repro_torch.nn.norm import (layernorm_apply, layernorm_axes,
                                 layernorm_init)
from repro_torch.nn.remat import checkpoint

Tensor = torch.Tensor


def _acfg(cfg: ArchConfig, causal: bool, cross: bool = False):
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, causal=causal,
        rope=False, cross=cross, q_chunk=cfg.q_chunk)


def _enc_block_init(gen, cfg: ArchConfig, dtype):
    return {
        "ln1": layernorm_init(gen, cfg.d_model, dtype),
        "attn": attention_init(gen, _acfg(cfg, causal=False), dtype),
        "ln2": layernorm_init(gen, cfg.d_model, dtype),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
    }


def _dec_block_init(gen, cfg: ArchConfig, dtype):
    return {
        "ln1": layernorm_init(gen, cfg.d_model, dtype),
        "self": attention_init(gen, _acfg(cfg, causal=True), dtype),
        "ln_x": layernorm_init(gen, cfg.d_model, dtype),
        "cross": attention_init(gen, _acfg(cfg, causal=False, cross=True),
                                dtype),
        "ln2": layernorm_init(gen, cfg.d_model, dtype),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
    }


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device: DeviceLike = None):
    """Random weights drawn from the CPU generator ``gen``, placed on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    v_pad = pad_vocab(cfg.vocab)
    return {
        "embed": embedding_init(gen, v_pad, cfg.d_model, dtype=dtype,
                                device=dev),
        "enc_blocks": stack_init(lambda g: _enc_block_init(g, cfg, dtype),
                                 gen, cfg.n_layers, dev),
        "dec_blocks": stack_init(lambda g: _dec_block_init(g, cfg, dtype),
                                 gen, cfg.n_layers, dev),
        "ln_enc": layernorm_init(gen, cfg.d_model, dtype, dev),
        "ln_dec": layernorm_init(gen, cfg.d_model, dtype, dev),
        "lm_head": linear_init(gen, cfg.d_model, v_pad, bias=False,
                               dtype=dtype, device=dev),
    }


def param_axes(cfg: ArchConfig):
    """The reference's logical axes of :func:`init`'s tree."""
    enc = {"ln1": layernorm_axes(),
           "attn": attention_axes(_acfg(cfg, causal=False)),
           "ln2": layernorm_axes(), "mlp": mlp_axes()}
    dec = {"ln1": layernorm_axes(),
           "self": attention_axes(_acfg(cfg, causal=True)),
           "ln_x": layernorm_axes(),
           "cross": attention_axes(_acfg(cfg, causal=False, cross=True)),
           "ln2": layernorm_axes(), "mlp": mlp_axes()}
    return {"embed": embedding_axes(("vocab", "d_model")),
            "enc_blocks": stack_axes(enc), "dec_blocks": stack_axes(dec),
            "ln_enc": layernorm_axes(), "ln_dec": layernorm_axes(),
            "lm_head": linear_axes(("d_model", "vocab"), False)}


@functools.lru_cache(maxsize=16)
def _positions(length: int, d_model: int, device: torch.device) -> Tensor:
    """The position table, built once a length and device (the same
    values every call: a decode step builds none)."""
    return sinusoidal_positions(length, d_model, device)


def _head(params, x, cfg, policy):
    return logits_from_hidden(x, params["lm_head"]["w"], None, policy,
                              n_valid=cfg.vocab)


def _mlp(p, h, cfg, policy):
    return mlp_apply(p["mlp"], layernorm_apply(p["ln2"], h), policy,
                     act=cfg.act)


def encode(params, frames: Tensor, cfg: ArchConfig,
           policy: Optional[QuantPolicy] = None) -> Tensor:
    """frames: [B, S, d_model] (stub frontend embeddings)."""
    S = frames.shape[1]
    x = frames + _positions(S, cfg.d_model, frames.device)[None].to(
        frames.dtype)
    acfg = _acfg(cfg, causal=False)

    def body(p, h):
        h = h + attention_apply(p["attn"], layernorm_apply(p["ln1"], h),
                                acfg, policy)
        return h + _mlp(p, h, cfg, policy)

    if cfg.remat:
        body = checkpoint(body)
    for p in layers(params["enc_blocks"], cfg.n_layers):
        x = body(p, x)
    return layernorm_apply(params["ln_enc"], x)


def _embed_tokens(params, tokens: Tensor, dtype, cfg: ArchConfig):
    x = embedding_apply(params["embed"], tokens).to(dtype)
    S = tokens.shape[1]
    return x + _positions(S, cfg.d_model, x.device)[None].to(x.dtype)


def decode_train(params, tokens: Tensor, enc_out: Tensor, cfg: ArchConfig,
                 policy: Optional[QuantPolicy] = None,
                 return_hidden: bool = False) -> Tensor:
    """The decoder over whole token sequences [B, S] against ``enc_out``:
    fp32 logits [B, S, V] (or the final hidden state)."""
    blocks = layers(params["dec_blocks"], cfg.n_layers)
    x = _embed_tokens(params, tokens, enc_out.dtype, cfg)
    self_cfg, cross_cfg = _acfg(cfg, True), _acfg(cfg, False, True)

    def body(p, h):
        h = h + attention_apply(p["self"], layernorm_apply(p["ln1"], h),
                                self_cfg, policy)
        h = h + attention_apply(p["cross"], layernorm_apply(p["ln_x"], h),
                                cross_cfg, policy, encoder_out=enc_out)
        return h + _mlp(p, h, cfg, policy)

    if cfg.remat:
        body = checkpoint(body)
    for p in blocks:
        x = body(p, x)
    x = layernorm_apply(params["ln_dec"], x)
    if return_hidden:
        return x
    return _head(params, x, cfg, policy)


def loss_fn(params, batch, cfg: ArchConfig,
            policy: Optional[QuantPolicy] = None) -> Tensor:
    enc_out = encode(params, batch["frames"], cfg, policy)
    x = decode_train(params, batch["tokens"], enc_out, cfg, policy,
                     return_hidden=True)
    return chunked_ce(lambda h: _head(params, h, cfg, policy), x,
                      batch["labels"], batch.get("mask"))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                kv_bits: int = 32, dtype=torch.float32,
                enc_len: Optional[int] = None, device="cpu"):
    """Stacked [L, ...] self caches of ``max_len`` slots and cross caches
    of ``enc_len`` (default ``max_len``)."""
    enc_len = enc_len or max_len
    one = {
        "self": init_cache(batch, max_len, cfg.n_kv_heads, cfg.hd, kv_bits,
                           dtype, device=device),
        "cross": init_cache(batch, enc_len, cfg.n_kv_heads, cfg.hd,
                            kv_bits, dtype, device=device),
    }
    return {name: {k: v[None].expand((cfg.n_layers,) + v.shape).contiguous()
                   for k, v in c.items()} for name, c in one.items()}


def prefill(params, batch, cfg: ArchConfig,
            policy: Optional[QuantPolicy] = None, kv_bits: int = 32):
    """Encode the frames, build each layer's cross cache from the
    encoder's output and prime the self caches with the prompt tokens:
    (last-position logits [B, V], {"self": caches, "cross": caches})."""
    frames, tokens = batch["frames"], batch["tokens"]
    blocks = layers(params["dec_blocks"], cfg.n_layers)
    enc_out = encode(params, frames, cfg, policy)
    B, T = tokens.shape[0], enc_out.shape[1]
    x = _embed_tokens(params, tokens, enc_out.dtype, cfg)
    self_cfg, cross_cfg = _acfg(cfg, True), _acfg(cfg, False, True)
    self_caches, cross_caches = [], []
    for p in blocks:
        a, self_c = attention_apply(p["self"],
                                    layernorm_apply(p["ln1"], x), self_cfg,
                                    policy, return_cache=True,
                                    kv_bits=kv_bits)
        x = x + a
        ck, cv = project_kv(p["cross"], enc_out, cross_cfg, policy)
        cross_c = cache_update(
            init_cache(B, T, cfg.n_kv_heads, cfg.hd, kv_bits, enc_out.dtype,
                       device=enc_out.device), ck, cv, 0, kv_bits)
        x = x + attention_apply(p["cross"], layernorm_apply(p["ln_x"], x),
                                cross_cfg, policy, encoder_out=enc_out,
                                kv=(ck, cv))
        x = x + _mlp(p, x, cfg, policy)
        self_caches.append(self_c)
        cross_caches.append(cross_c)
    x = layernorm_apply(params["ln_dec"], x[:, -1:])
    return _head(params, x, cfg, policy)[:, 0], {
        "self": stack_caches(self_caches),
        "cross": stack_caches(cross_caches)}


def decode_step(params, token: Tensor, caches, index: int,
                cfg: ArchConfig, policy: Optional[QuantPolicy] = None,
                kv_bits: int = 32):
    """One decode step: token [B, 1] -> (logits [B, V], caches).  Each
    layer's self cache is a view of the stacked one, updated in place;
    the cross caches are read only."""
    blocks = layers(params["dec_blocks"], cfg.n_layers)
    x = embedding_apply(params["embed"], token).to(
        policy.compute_dtype if policy else torch.float32)
    s_max = caches["self"]["k"].shape[2]
    # lax.dynamic_slice_in_dim's row, its start clamped into the table
    row = min(max(int(index), 0), s_max - 1)
    table = _positions(s_max, cfg.d_model, x.device)
    x = x + table[row:row + 1][None].to(x.dtype)
    self_cfg, cross_cfg = _acfg(cfg, True), _acfg(cfg, False, True)
    for i, p in enumerate(blocks):
        a, _ = attention_decode(
            p["self"], layernorm_apply(p["ln1"], x), self_cfg,
            {k: v[i] for k, v in caches["self"].items()}, index, policy,
            kv_bits=kv_bits)
        x = x + a
        c, _ = attention_decode(
            p["cross"], layernorm_apply(p["ln_x"], x), cross_cfg, None,
            index, policy,
            cross_cache={k: v[i] for k, v in caches["cross"].items()},
            kv_bits=kv_bits)
        x = x + c
        x = x + _mlp(p, x, cfg, policy)
    x = layernorm_apply(params["ln_dec"], x)
    return _head(params, x, cfg, policy)[:, 0], caches
