"""Rotary position embeddings (RoPE), decode-offset aware (port of
``repro.nn.rotary``)."""
from __future__ import annotations

import functools

import torch

from repro_torch.core import exact

Tensor = torch.Tensor


def rope_freqs(head_dim: int, theta: float = 10000.0) -> Tensor:
    """``[head_dim / 2]`` inverse frequencies, fp32, on the CPU."""
    e = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return 1.0 / torch.pow(theta, e)


@functools.lru_cache(maxsize=64)
def _freqs_on(head_dim: int, theta: float, device: torch.device) -> Tensor:
    """The CPU's frequencies, copied once to ``device``: every device
    rotates by the same frequencies, and a decode step makes no host to
    device copy (one from pageable memory waits for the stream)."""
    return rope_freqs(head_dim, theta).to(device)


def apply_rope(x: Tensor, positions: Tensor,
               theta: float = 10000.0) -> Tensor:
    """x: [B, S, H, D]; positions: [B, S] int absolute positions."""
    inv = _freqs_on(x.shape[-1], float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * inv       # [B,S,D/2]
    sin = exact.sin(ang)[:, :, None, :]
    cos = exact.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
