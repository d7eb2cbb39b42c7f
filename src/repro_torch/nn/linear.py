"""Quantized linear / embedding layers — every product goes via
q_matmul (port of ``repro.nn.linear``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fxp import QTensor
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qmatmul import q_matmul
from repro_torch.nn.module import lecun_init, normal_init, zeros_init


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = True, init=None, dtype=torch.float32,
                device="cpu"):
    """``{"w": [d_in, d_out], "b": [d_out]}``."""
    p = {"w": (init or lecun_init())(gen, (d_in, d_out), dtype, device)}
    if bias:
        p["b"] = zeros_init()(gen, (d_out,), dtype, device)
    return p


def linear_axes(axes, bias: bool = True):
    """The logical axes of :func:`linear_init`'s tree: ``w`` over
    ``axes``, ``b`` over their last."""
    p = {"w": axes}
    if bias:
        p["b"] = (axes[-1],) if axes else None
    return p


def linear_apply(p, x: torch.Tensor, policy: Optional[QuantPolicy] = None):
    y = q_matmul(x, p["w"], policy)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def embedding_init(gen: torch.Generator, vocab: int, d_model: int, *,
                   init=None, dtype=torch.float32, device="cpu"):
    """``{"emb": [vocab, d_model]}``."""
    return {"emb": (init or normal_init(0.02))(gen, (vocab, d_model),
                                                dtype, device)}


def embedding_axes(axes):
    """The logical axes of :func:`embedding_init`'s tree."""
    return {"emb": axes}


def embedding_apply(p, ids: torch.Tensor,
                    policy: Optional[QuantPolicy] = None):
    """Token lookup; a QTensor table is gathered, then dequantized (one
    byte a gathered element is read)."""
    emb = p["emb"]
    if isinstance(emb, QTensor):
        rows = emb.qvalue[ids]
        return rows.to(torch.float32) * emb.scale    # [1, d] or [1, 1]
    return emb[ids]


def embedding_attend(p, x: torch.Tensor,
                     policy: Optional[QuantPolicy] = None):
    """Tied LM head: logits = x @ emb^T."""
    emb = p["emb"]
    if isinstance(emb, QTensor):
        emb = emb.deq(x.dtype)
    return q_matmul(x, emb.transpose(0, 1), policy)
