"""Quantized linear / embedding layers — every product goes via
q_matmul (port of ``repro.nn.linear``).

On a laid-out step (``distributed.sharding.layout``) a layer given its
weight's logical axes reads the rules for them: a weight whose output
axis lies over the model axis is column-parallel (this rank's columns),
one whose input axis does is row-parallel (the contraction split, the
output summed); an embedding table split over its vocabulary looks up
the rank's rows and sums the ranks' lookups.  The caller hands a
column-parallel layer an input the model peers share
(``Layout.enter``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.fxp import QTensor
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qmatmul import Split, q_matmul
from repro_torch.distributed.sharding import axes_index, layout, summed
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


def product_split(axes: Optional[Sequence[Optional[str]]],
                  scatter: Optional[int] = None) -> Optional[Split]:
    """The :class:`Split` of a product whose weight has the logical
    ``axes`` (``[d_in, d_out]``) on a laid-out step: row-parallel where
    ``d_in`` lies over the model axis (its sum reduce-scattered along
    ``scatter`` when given), column-parallel where ``d_out`` does; None
    off a laid-out step and for a weight whole on every model rank."""
    lay = layout()
    if lay is None or axes is None:
        return None
    k, n = lay.split(axes[-2]), lay.split(axes[-1])
    if not (k or n):
        return None
    return Split(lay.mesh, k, n, scatter if k else None)


def linear_apply(p, x: torch.Tensor, policy: Optional[QuantPolicy] = None,
                 axes: Optional[Sequence[Optional[str]]] = None,
                 scatter: Optional[int] = None):
    """``x @ w (+ b)``; ``axes``: the weight's logical axes, read on a
    laid-out step (:func:`product_split`)."""
    y = q_matmul(x, p["w"], policy, product_split(axes, scatter))
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
                    policy: Optional[QuantPolicy] = None,
                    axes: Optional[Sequence[Optional[str]]] = None,
                    scatter: Optional[int] = None):
    """Token lookup; a QTensor table is gathered, then dequantized (one
    byte a gathered element is read).  On a laid-out step whose table
    (logical ``axes``) is split over its vocabulary: the rank's rows
    (a packed table's dequantized), zero for an id another rank holds,
    summed over the model axis (one term nonzero, so exact), or
    reduce-scattered along ``scatter``."""
    emb = p["emb"]
    packed = isinstance(emb, QTensor)
    table = emb.qvalue if packed else emb
    lay = layout()
    over = lay.split(axes[0]) if lay is not None and axes else ()
    if not over:
        rows = table[ids]
        # a packed table's rows dequantized: its scale is [1, d] or [1, 1]
        return rows.to(torch.float32) * emb.scale if packed else rows
    n = table.shape[0]
    local = ids.long() - axes_index(lay.mesh, over) * n
    own = (local >= 0) & (local < n)
    rows = table[torch.where(own, local, 0)]
    if packed:
        rows = rows.to(torch.float32) * emb.scale
    rows = torch.where(own[..., None], rows, rows.new_zeros(()))
    return summed(rows, lay.mesh, over, scatter)


def embedding_attend(p, x: torch.Tensor,
                     policy: Optional[QuantPolicy] = None):
    """Tied LM head: logits = x @ emb^T."""
    emb = p["emb"]
    if isinstance(emb, QTensor):
        emb = emb.deq(x.dtype)
    return q_matmul(x, emb.transpose(0, 1), policy)
