"""Dense FFN blocks: SwiGLU (llama family) and the plain two-layer MLP
(GELU for whisper) — port of ``repro.nn.mlp``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.core.vact import activation
from repro_torch.distributed.sharding import layout
from repro_torch.nn.linear import linear_apply, linear_axes, linear_init


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32, device="cpu"):
    return {
        "w_gate": linear_init(gen, d_model, d_ff, bias=False, dtype=dtype,
                              device=device),
        "w_up": linear_init(gen, d_model, d_ff, bias=False, dtype=dtype,
                            device=device),
        "w_down": linear_init(gen, d_ff, d_model, bias=False, dtype=dtype,
                              device=device),
    }


def swiglu_axes():
    """The logical axes of :func:`swiglu_init`'s tree."""
    return {"w_gate": linear_axes(("d_model", "d_ff"), bias=False),
            "w_up": linear_axes(("d_model", "d_ff"), bias=False),
            "w_down": linear_axes(("d_ff", "d_model"), bias=False)}


def swiglu_apply(p, x: torch.Tensor, policy: Optional[QuantPolicy] = None,
                 act: str = "silu", scatter: Optional[int] = None):
    """On a laid-out step: ``w_gate`` and ``w_up`` column-parallel over
    ``d_ff``, the gate's requantization grid over every rank's columns,
    ``w_down`` row-parallel (its sum reduce-scattered along
    ``scatter`` when given)."""
    ax = swiglu_axes()
    lay = layout()
    g = linear_apply(p["w_gate"], x, policy, ax["w_gate"]["w"])
    u = linear_apply(p["w_up"], x, policy, ax["w_up"]["w"])
    h = activation(g, act, policy,
                   split=lay.split("d_ff") if lay is not None else ())
    h = h * u
    return linear_apply(p["w_down"], h, policy, ax["w_down"]["w"], scatter)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             bias: bool = True, dtype=torch.float32, device="cpu"):
    return {
        "w_in": linear_init(gen, d_model, d_ff, bias=bias, dtype=dtype,
                            device=device),
        "w_out": linear_init(gen, d_ff, d_model, bias=bias, dtype=dtype,
                             device=device),
    }


def mlp_axes(bias: bool = True):
    """The logical axes of :func:`mlp_init`'s tree."""
    return {"w_in": linear_axes(("d_model", "d_ff"), bias),
            "w_out": linear_axes(("d_ff", "d_model"), bias)}


def mlp_apply(p, x: torch.Tensor, policy: Optional[QuantPolicy] = None,
              act: str = "gelu"):
    h = activation(linear_apply(p["w_in"], x, policy), act, policy)
    return linear_apply(p["w_out"], h, policy)
