"""Shared model plumbing: stacked layer init and axes, the LM head,
losses (port of ``repro.models.common``).

The reference's ``distributed.sharding.constrain`` layout hints stand
at its sites; on a rank's plain tensors they return their input.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import exact
from repro_torch.core.fxp import div_scalar
from repro_torch.core.qmatmul import q_matmul
from repro_torch.distributed.sharding import constrain
from repro_torch.nn.linear import embedding_attend
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


def cross_entropy(logits: Tensor, labels: Tensor,
                  mask: Optional[Tensor] = None) -> Tensor:
    """Mean next-token CE: logsumexp minus the label logit."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - lab
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp_min(mask.sum(), 1)
    return nll.mean()


def chunked_ce(head_fn: Callable, x: Tensor, labels: Tensor,
               mask: Optional[Tensor] = None, chunk: int = 1024) -> Tensor:
    """Head + CE a token chunk at a time, so the [B, S, vocab] logits are
    never whole; the sums run over the chunks in order, as the
    reference's scan carries them.  Each chunk's head, logsumexp and
    label gather are rematerialised (the reference's ``@jax.checkpoint``
    on its scan body, whatever ``cfg.remat`` says): the backward
    recomputes a chunk's logits, so at most one chunk's are live."""
    B, S, _ = x.shape
    x = constrain(x, ("batch", None, None))        # gather seq under SP
    if chunk is None or S <= chunk or S % chunk != 0:
        return cross_entropy(head_fn(x), labels, mask)

    @checkpoint
    def body(x_c, l_c, m_c):
        logits = head_fn(x_c).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1, l_c[..., None].long())[..., 0]
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
                       n_valid: Optional[int] = None) -> Tensor:
    """Final projection to fp32 logits; padded vocab columns (see
    ``configs.base.pad_vocab``) get -1e9."""
    x = constrain(x, ("batch", None, None))
    if tie_emb is not None:
        logits = embedding_attend(tie_emb, x, policy)
    else:
        logits = q_matmul(x, head, policy)
    logits = logits.to(torch.float32)
    if n_valid is not None and n_valid < logits.shape[-1]:
        cols = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits + torch.where(cols < n_valid, 0.0, -1e9)
    return constrain(logits, ("batch", None, "vocab"))
