"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427),
port of ``repro.nn.rglru``.

Real-gated linear recurrent unit:
    r_t = sigmoid(W_r x_t)            (recurrence gate)
    i_t = sigmoid(W_i x_t)            (input gate)
    a_t = a ^ (c * r_t)               (per-channel learned decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence path scans the linear recurrence with
:func:`associative_scan`, the odd/even recursion of
``jax.lax.associative_scan`` on tensor slices (about log2(S) levels), so
every element is combined in the reference's order and rounds as it
does; a sequential loop would round otherwise.  Decode is one step.

The surrounding recurrent block is: linear_in -> causal conv1d ->
RG-LRU -> (gated by a GELU branch) -> linear_out, every product through
q_matmul (on a CUDA tensor, Q-MAC).  The gates' sigmoid, the softplus,
the ``exp`` and the ``sqrt`` run through fp64 (``core.exact``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import exact
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qmatmul import q_matmul
from repro_torch.core.vact import activation
from repro_torch.nn.conv import (causal_conv1d_apply, causal_conv1d_axes,
                                 causal_conv1d_init)
from repro_torch.nn.linear import linear_apply, linear_axes, linear_init
from repro_torch.nn.module import uniform

Tensor = torch.Tensor

_C = 8.0


def rglru_init(gen: torch.Generator, width: int, dtype=torch.float32,
               device="cpu"):
    return {
        "w_r": linear_init(gen, width, width, bias=True, dtype=dtype,
                           device=device),
        "w_i": linear_init(gen, width, width, bias=True, dtype=dtype,
                           device=device),
        # Lambda parametrized so a = sigmoid(L) starts near 0.9-0.999
        "L": uniform(gen, (width,), 2.0, 6.0, device),
    }


def rglru_axes():
    """The logical axes of :func:`rglru_init`'s tree."""
    return {"w_r": linear_axes(("d_inner", "d_inner"), True),
            "w_i": linear_axes(("d_inner", "d_inner"), True),
            "L": ("d_inner",)}


def _gates(p, x: Tensor, policy):
    f32 = torch.float32
    r = exact.sigmoid(q_matmul(x, p["w_r"]["w"], policy) + p["w_r"]["b"])
    i = exact.sigmoid(q_matmul(x, p["w_i"]["w"], policy) + p["w_i"]["b"])
    log_a_base = -_C * exact.softplus(p["L"].to(f32))
    log_a = log_a_base * r.to(f32)                      # [B,S,W]
    a = exact.exp(log_a)
    # sqrt(1 - a^2) with the Griffin stability clamp
    mult = exact.sqrt(torch.clamp(1.0 - exact.exp(2.0 * log_a), 1e-12, 1.0))
    gated_x = x.to(f32) * i.to(f32) * mult
    return a, gated_x


def _index(axis: int, s: slice):
    return (slice(None),) * axis + (s,)


def _interleave(a: Tensor, b: Tensor, axis: int) -> Tensor:
    """``a`` at the even and ``b`` at the odd positions of ``axis``, as
    the reference interleaves them: two zero-padded arrays added, so a
    -0.0 comes out +0.0."""
    n = a.shape[axis] + b.shape[axis]
    shape = a.shape[:axis] + (n,) + a.shape[axis + 1:]
    out = a.new_empty(shape)
    out[_index(axis, slice(0, None, 2))] = a
    out[_index(axis, slice(1, None, 2))] = b
    return out + 0.0 if out.is_floating_point() else out


def associative_scan(fn: Callable, elems: Sequence[Tensor],
                     axis: int = 0):
    """Inclusive scan of the tuple ``elems`` along ``axis`` under the
    associative ``fn(left, right) -> tuple``, pairing elements as
    ``jax.lax.associative_scan`` does (not reversed)."""
    axis = axis % elems[0].ndim

    def sl(t, start, stop=None, step=None):
        return t[_index(axis, slice(start, stop, step))]

    def scan(elems):
        num = elems[0].shape[axis]
        if num < 2:
            return list(elems)
        reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems),
                     tuple(sl(e, 1, None, 2) for e in elems))
        odd = scan(reduced)
        if num % 2 == 0:
            even = fn(tuple(sl(e, 0, -1) for e in odd),
                      tuple(sl(e, 2, None, 2) for e in elems))
        else:
            even = fn(tuple(odd), tuple(sl(e, 2, None, 2) for e in elems))
        even = [torch.cat([sl(e, 0, 1), r], dim=axis)
                for e, r in zip(elems, even, strict=True)]
        return [_interleave(e, o, axis)
                for e, o in zip(even, odd, strict=True)]

    return tuple(scan(tuple(elems)))


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def rglru_apply(p, x: Tensor, policy: Optional[QuantPolicy] = None,
                state: Optional[Tensor] = None):
    """x: [B, S, W].  With state [B, W]: one decode step (S == 1)."""
    a, b = _gates(p, x, policy)
    if state is not None:
        h = a[:, 0] * state + b[:, 0]
        return h[:, None, :].to(x.dtype), h
    # associative scan over the linear recurrence h = a h_prev + b
    _, h_s = associative_scan(_combine, (a, b), axis=1)
    return h_s.to(x.dtype), h_s[:, -1]


def recurrent_block_init(gen: torch.Generator, d_model: int, width: int,
                         conv_width: int = 4, dtype=torch.float32,
                         device="cpu"):
    kw = dict(bias=False, dtype=dtype, device=device)
    return {
        "lin_x": linear_init(gen, d_model, width, **kw),
        "lin_y": linear_init(gen, d_model, width, **kw),
        "conv": causal_conv1d_init(gen, width, conv_width, dtype, device),
        "rglru": rglru_init(gen, width, dtype, device),
        "lin_out": linear_init(gen, width, d_model, **kw),
    }


def recurrent_block_axes():
    """The logical axes of :func:`recurrent_block_init`'s tree."""
    return {"lin_x": linear_axes(("d_model", "d_inner"), False),
            "lin_y": linear_axes(("d_model", "d_inner"), False),
            "conv": causal_conv1d_axes(),
            "rglru": rglru_axes(),
            "lin_out": linear_axes(("d_inner", "d_model"), False)}


def recurrent_block_apply(p, x: Tensor,
                          policy: Optional[QuantPolicy] = None,
                          state: Optional[dict] = None):
    """Griffin recurrent block.  state: {"conv": ..., "rglru": ...}."""
    gate = activation(linear_apply(p["lin_y"], x, policy), "gelu", policy)
    u = linear_apply(p["lin_x"], x, policy)
    if state is not None:
        u, conv_state = causal_conv1d_apply(p["conv"], u, state["conv"])
        h, rg_state = rglru_apply(p["rglru"], u, policy, state["rglru"])
        out = linear_apply(p["lin_out"], h * gate, policy)
        return out, {"conv": conv_state, "rglru": rg_state}
    u = causal_conv1d_apply(p["conv"], u)
    h, _ = rglru_apply(p["rglru"], u, policy)
    return linear_apply(p["lin_out"], h * gate, policy)


def recurrent_block_init_state(batch: int, width: int, conv_width: int = 4,
                               device="cpu"):
    return {
        "conv": torch.zeros((batch, conv_width - 1, width),
                            dtype=torch.float32, device=device),
        "rglru": torch.zeros((batch, width), dtype=torch.float32,
                             device=device),
    }
