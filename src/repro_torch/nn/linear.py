"""Quantized linear layer — every product goes via q_matmul (port of
``repro.nn.linear``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qmatmul import q_matmul
from repro_torch.nn.module import lecun_init, zeros_init


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = True, init=None, dtype=torch.float32,
                device="cpu"):
    """``{"w": [d_in, d_out], "b": [d_out]}``."""
    p = {"w": (init or lecun_init())(gen, (d_in, d_out), dtype, device)}
    if bias:
        p["b"] = zeros_init()(gen, (d_out,), dtype, device)
    return p


def linear_apply(p, x: torch.Tensor, policy: Optional[QuantPolicy] = None):
    y = q_matmul(x, p["w"], policy)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y
