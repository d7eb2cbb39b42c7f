"""Shared model plumbing: stacked layer init and axes, the LM head,
losses (port of ``repro.models.common``).

The reference's ``distributed.sharding.constrain`` layout hints stand
at its sites; on a rank's plain tensors they return their input.

On a laid-out step the head is column-parallel over the padded
vocabulary and the loss vocab-parallel (``vocab``: the mesh and the
model axes the logits' columns lie over): a row's max is a ``pmax``,
its sum of exponentials a sum over the model axis in rank order, and
the label's logit comes from the rank that holds its column.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import exact
from repro_torch.core.fxp import div_scalar
from repro_torch.core.qmatmul import q_matmul
from repro_torch.distributed.sharding import (axes_index, constrain, pmax,
                                              summed)
from repro_torch.nn.linear import embedding_attend, product_split
from repro_torch.nn.module import is_axes
from repro_torch.nn.remat import checkpoint
from repro_torch.tree import leaves_with_path, map_with_path, tree_map

Tensor = torch.Tensor


def stack_init(block_init_fn: Callable, gen: torch.Generator, n: int,
               device="cpu"):
    """``n`` blocks drawn one after another from ``gen`` on the CPU, each
    block's leaves placed on ``device`` as it is drawn (the host holds
    one block at a time), then each leaf stacked on a leading layer axis
    ``[n, ...]``."""
    skeleton, by_path = None, {}
    for _ in range(n):
        block = block_init_fn(gen)
        skeleton = skeleton or tree_map(lambda _x: 0, block)
        for path, leaf in leaves_with_path(block):
            by_path.setdefault(path, []).append(leaf.to(device))
        del block
    return map_with_path(lambda path, _x: torch.stack(by_path.pop(path)),
                         skeleton)


def stack_axes(block_axes):
    """A block's axes tree with the leading ``"layers"`` axis that
    :func:`stack_init` gives every leaf."""
    return tree_map(lambda a: ("layers",) + tuple(a), block_axes,
                    is_leaf=is_axes)


def _lse_and_label(logits: Tensor, labels: Tensor, vocab=None):
    """Each row's logsumexp and its label's logit (fp32 logits).  With
    ``vocab`` (mesh, axes) the logits are this rank's columns of the
    rows: the max over the ranks, the sum of ``exp(x - max)`` through
    fp64 (``core.exact``) summed over them in rank order, the label's
    logit from its owner."""
    if vocab is None:
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return lse, lab
    mesh, axes = vocab
    with torch.no_grad():
        m = pmax(logits.amax(dim=-1), mesh, axes)
    e = exact.total(exact.exp(logits - m[..., None]))[..., 0]
    lse = m + exact.log(summed(e, mesh, axes))
    n = logits.shape[-1]
    local = labels.long() - axes_index(mesh, axes) * n
    own = (local >= 0) & (local < n)
    lab = torch.gather(logits, -1, torch.where(own, local, 0)[..., None])
    lab = torch.where(own, lab[..., 0], lab.new_zeros(()))
    return lse, summed(lab, mesh, axes)


def cross_entropy(logits: Tensor, labels: Tensor,
                  mask: Optional[Tensor] = None, vocab=None) -> Tensor:
    """Mean next-token CE: logsumexp minus the label logit."""
    logits = logits.to(torch.float32)
    lse, lab = _lse_and_label(logits, labels, vocab)
    nll = lse - lab
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp_min(mask.sum(), 1)
    return nll.mean()


def chunked_ce(head_fn: Callable, x: Tensor, labels: Tensor,
               mask: Optional[Tensor] = None, chunk: int = 1024,
               vocab=None) -> Tensor:
    """Head + CE a token chunk at a time, so the [B, S, vocab] logits are
    never whole; the sums run over the chunks in order, as the
    reference's scan carries them.  Each chunk's head, logsumexp and
    label gather are rematerialised (the reference's ``@jax.checkpoint``
    on its scan body, whatever ``cfg.remat`` says): the backward
    recomputes a chunk's logits, so at most one chunk's are live.
    ``vocab``: ``head_fn`` gives this rank's columns (a laid-out step's
    vocab-parallel loss)."""
    B, S, _ = x.shape
    x = constrain(x, ("batch", None, None))        # gather seq under SP
    if chunk is None or S <= chunk or S % chunk != 0:
        return cross_entropy(head_fn(x), labels, mask, vocab)

    @checkpoint
    def body(x_c, l_c, m_c):
        logits = head_fn(x_c).to(torch.float32)
        lse, lab = _lse_and_label(logits, l_c, vocab)
        return ((lse - lab) * m_c).sum(), m_c.sum()

    tot = x.new_zeros((), dtype=torch.float32)
    cnt = x.new_zeros((), dtype=torch.float32)
    for i in range(0, S, chunk):
        m_c = mask[:, i:i + chunk] if mask is not None \
            else x.new_ones((B, chunk), dtype=torch.float32)
        nll, n = body(x[:, i:i + chunk], labels[:, i:i + chunk], m_c)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp_min(cnt, 1)


def sinusoidal_positions(length: int, d_model: int,
                         device="cpu") -> Tensor:
    """Whisper-style sinusoidal position embeddings [length, d_model]:
    the reference's expression, its ``log``, ``exp``, ``sin`` and ``cos``
    through fp64 (``core.exact``), so every device builds the same
    table."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=device)[None, :]
    log_base = exact.log(dim.new_full((), 10000.0))
    inv = exact.exp(-dim * div_scalar(log_base, d_model // 2 - 1))
    ang = pos * inv
    return torch.cat([exact.sin(ang), exact.cos(ang)], dim=-1)


def logits_from_hidden(x: Tensor, head, tie_emb, policy,
                       n_valid: Optional[int] = None,
                       axes=None) -> Tensor:
    """Final projection to fp32 logits; padded vocab columns (see
    ``configs.base.pad_vocab``) get -1e9.  ``axes``: the head's logical
    axes, read on a laid-out step (column-parallel over the vocabulary:
    the logits of this rank's columns)."""
    x = constrain(x, ("batch", None, None))
    split = product_split(axes) if tie_emb is None else None
    if tie_emb is not None:
        logits = embedding_attend(tie_emb, x, policy)
    else:
        logits = q_matmul(x, head, policy, split)
    logits = logits.to(torch.float32)
    n = logits.shape[-1]
    first = axes_index(split.mesh, split.n) * n if split is not None else 0
    if n_valid is not None and n_valid < first + n:
        cols = torch.arange(n, device=logits.device)
        if first:
            cols = cols + first
        logits = logits + torch.where(cols < n_valid, 0.0, -1e9)
    return constrain(logits, ("batch", None, "vocab"))
