"""Activations under a QuantPolicy (port of ``repro.core.vact``, native
path).

With quantized activations the output is fake-quantized per tensor —
V-ACT's fused requantize stage.  The per-tensor scale sees every row of
the tensor, so a padded serving bucket must be padded exactly as the
reference pads it.  The CORDIC path (``act_backend="cordic"``) arrives
with the V-ACT kernels.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.fxp import fake_quant
from repro_torch.core.policy import QuantPolicy

Tensor = torch.Tensor

_NATIVE = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu
    "silu": F.silu,
    "identity": lambda x: x,
}

# activation kinds V-ACT implements in hardware
VACT_KINDS = ("relu", "sigmoid", "tanh", "softmax")


def activation(x: Tensor, kind: str, policy: Optional[QuantPolicy] = None,
               axis: int = -1) -> Tensor:
    """Evaluate an activation, then requantize when the policy
    quantizes activations (softmax excepted)."""
    if policy is not None and policy.act_backend == "cordic" \
            and kind in VACT_KINDS and kind != "relu":
        raise NotImplementedError(
            "CORDIC activations (act_backend='cordic') arrive with the "
            "V-ACT kernels in the HRL slice of the port")
    if kind == "softmax":
        out = torch.softmax(x, dim=axis)
    else:
        out = _NATIVE[kind](x)
    if policy is not None and policy.quantized_a and kind != "softmax":
        out = fake_quant(out, policy.a_bits)
    return out.to(x.dtype)
