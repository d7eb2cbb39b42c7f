"""Mamba2 LM, an attention-free stack of SSD blocks (port of
``repro.models.mamba``).  Every product routes through q_matmul (on a
CUDA tensor, Q-MAC): ``in_proj`` and ``out_proj`` in each block, then
the head.

Block params are stacked ``[L, ...]`` and walked in a Python loop, as
``models.transformer`` walks its blocks; under ``cfg.remat`` the
training forward rematerialises each SSD block in the backward.  The
serving caches are each layer's recurrent state, stacked: the SSD
state ``[L, B, H, P, N]`` and the raw pre-conv ``xBC`` tail ``[L, B,
W-1, C]``; a decode step writes each layer's new state into them in
place.  A prefill's prompt must be a whole number of SSD chunks
(``cfg.ssm_chunk``), as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, pad_vocab
from repro_torch.core.policy import QuantPolicy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import chunked_ce, stack_axes, stack_init
from repro_torch.models.transformer import (_embed, _head, layers,
                                            stack_caches)
from repro_torch.nn.linear import (embedding_axes, embedding_init,
                                   linear_axes, linear_init)
from repro_torch.nn.norm import rmsnorm_apply, rmsnorm_axes, rmsnorm_init
from repro_torch.nn.remat import checkpoint
from repro_torch.nn.ssm import (SSMConfig, ssm_apply, ssm_axes, ssm_init,
                                ssm_init_state)

Tensor = torch.Tensor


def ssm_config(cfg: ArchConfig) -> SSMConfig:
    return SSMConfig(
        d_model=cfg.d_model, d_inner=cfg.ssm_expand * cfg.d_model,
        head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state,
        n_groups=1, chunk=cfg.ssm_chunk)


def _block_init(gen, cfg: ArchConfig, dtype):
    return {
        "ln": rmsnorm_init(gen, cfg.d_model, dtype),
        "ssm": ssm_init(gen, ssm_config(cfg), dtype),
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
        "blocks": stack_init(lambda g: _block_init(g, cfg, dtype), gen,
                             cfg.n_layers, dev),
        "ln_f": rmsnorm_init(gen, cfg.d_model, dtype, dev),
        "lm_head": linear_init(gen, cfg.d_model, v_pad, bias=False,
                               dtype=dtype, device=dev),
    }


def param_axes(cfg: ArchConfig):
    """The reference's logical axes of :func:`init`'s tree."""
    del cfg
    return {"embed": embedding_axes(("vocab", "d_model")),
            "blocks": stack_axes({"ln": rmsnorm_axes(), "ssm": ssm_axes()}),
            "ln_f": rmsnorm_axes(),
            "lm_head": linear_axes(("d_model", "vocab"), False)}


def forward(params, tokens: Tensor, cfg: ArchConfig,
            policy: Optional[QuantPolicy] = None,
            return_hidden: bool = False) -> Tensor:
    """Training/scoring forward: tokens [B, S] -> fp32 logits [B, S, V]."""
    scfg = ssm_config(cfg)
    blocks = layers(params["blocks"], cfg.n_layers)
    x = _embed(params, tokens, policy)

    def body(p, h):
        return h + ssm_apply(p["ssm"], rmsnorm_apply(p["ln"], h), scfg,
                             policy)

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
    """Constant-size recurrent state per layer (no KV growth)."""
    del max_len, kv_bits, dtype
    one = ssm_init_state(batch, ssm_config(cfg), device)
    return {k: v[None].expand((cfg.n_layers,) + v.shape).contiguous()
            for k, v in one.items()}


def prefill(params, tokens: Tensor, cfg: ArchConfig,
            policy: Optional[QuantPolicy] = None, kv_bits: int = 32):
    """Prefill through the chunked SSD: (last-position logits [B, V],
    each layer's final state, stacked)."""
    del kv_bits
    scfg = ssm_config(cfg)
    blocks = layers(params["blocks"], cfg.n_layers)
    x = _embed(params, tokens, policy)
    states = []
    for p in blocks:
        out, state = ssm_apply(p["ssm"], rmsnorm_apply(p["ln"], x), scfg,
                               policy, return_state=True)
        x = x + out
        states.append(state)
    x = rmsnorm_apply(params["ln_f"], x[:, -1:])
    return _head(params, x, cfg, policy)[:, 0], stack_caches(states)


def decode_step(params, token: Tensor, caches, index: int,
                cfg: ArchConfig, policy: Optional[QuantPolicy] = None,
                kv_bits: int = 32):
    """One decode step: token [B, 1] -> (logits [B, V], caches), each
    layer's state written into the stacked caches in place."""
    del index, kv_bits
    scfg = ssm_config(cfg)
    blocks = layers(params["blocks"], cfg.n_layers)
    x = _embed(params, token, policy)
    for i, p in enumerate(blocks):
        state = {k: v[i] for k, v in caches.items()}
        out, new = ssm_apply(p["ssm"], rmsnorm_apply(p["ln"], x), scfg,
                             policy, state=state)
        x = x + out
        for k, v in new.items():
            state[k].copy_(v)
    x = rmsnorm_apply(params["ln_f"], x)
    return _head(params, x, cfg, policy)[:, 0], caches
