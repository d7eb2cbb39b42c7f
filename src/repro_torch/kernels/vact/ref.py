"""Oracle for the V-ACT kernels (port of ``repro.kernels.vact.ref``): the
core CORDIC math itself, from ``repro_torch.core.vact``."""
from __future__ import annotations

import torch

from repro_torch.core.vact import (cordic_sigmoid, cordic_softmax,
                                   cordic_tanh)

Tensor = torch.Tensor


def vact(x: Tensor, kind: str, n_iters: int) -> Tensor:
    if kind == "relu":
        return torch.where((x > 0) | torch.isnan(x), x, torch.zeros_like(x))
    if kind == "sigmoid":
        return cordic_sigmoid(x, n_iters)
    if kind == "tanh":
        return cordic_tanh(x, n_iters)
    if kind == "softmax":
        return cordic_softmax(x, n_iters, axis=-1)
    raise KeyError(kind)


def vact_q8(qx: Tensor, sx: Tensor, kind: str, n_iters: int) -> Tensor:
    """Fused int8-in / int8-out oracle.

    Output scale is static: sigmoid/tanh land in [-1, 1] so one LSB is
    1/127 — the paper's 'V-ACT emits FxP directly' datapath."""
    x = qx.to(torch.float32) * sx
    y = vact(x, kind, n_iters)
    return torch.clamp(torch.round(y * 127.0), -127, 127).to(torch.int8)
