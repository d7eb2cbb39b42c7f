"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro.nn.moe``, its global-view path).

Tokens pick their top-k experts; a position within each expert's
capacity buffer comes from a stable sort of the assignments by expert
id, and assignments past capacity are dropped (GShard capacity-factor
semantics).  The experts run as three batched products
(``core.qmatmul.q_batched_matmul``: on a CUDA tensor under an int8
policy, Q-MAC's batched kernel, one launch a product).

What would part the card from the CPU, or the port from the reference,
is taken exactly:

* the router's product and softmax go through ``core.exact`` (fp64,
  rounded once): its logits choose the experts, and an ulp before a
  discrete choice is a different result;
* top-k is a stable descending sort, so among equal probabilities the
  lower expert index comes first, as ``jax.lax.top_k`` orders them
  (``torch.topk`` promises no order on ties);
* the gates' renormalisation and the combine's sum over k are fp64 sums
  (``exact.total``), the same on every device;
* dispatch is integer work: a stable argsort, counts, offsets.  Only the
  scratch slot ``capacity``, where every dropped assignment is written,
  sees repeated indices, and it is sliced off.

``capacity`` is a Python int from static shapes, and nothing here reads
a tensor back to the host.  Under ``distributed.sharding.mesh_rules``
with more than one rank, ``moe_apply`` takes ``nn.moe_shard``'s
dispatch (expert parallelism, or tensor parallelism within each
expert), each rank routing its own rows at its own capacity, as the
reference's does on more than one device; one rank runs the global
path below.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import exact
from repro_torch.core.fxp import as_dense
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qmatmul import q_batched_matmul
from repro_torch.core.vact import activation
from repro_torch.distributed.sharding import (constrain, current_mesh,
                                              mesh_shape)
from repro_torch.nn.attention import _softmax
from repro_torch.nn.linear import linear_axes, linear_init
from repro_torch.nn.module import lecun_init

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype=torch.float32, device="cpu"):
    """``{"router": {"w": [d_model, E]}, "w_gate", "w_up": [E, d_model,
    d_ff], "w_down": [E, d_ff, d_model]}``, drawn in the reference's
    order."""
    init = lecun_init()
    return {
        "router": linear_init(gen, d_model, n_experts, bias=False,
                              dtype=dtype, device=device),
        "w_gate": init(gen, (n_experts, d_model, d_ff), dtype, device),
        "w_up": init(gen, (n_experts, d_model, d_ff), dtype, device),
        "w_down": init(gen, (n_experts, d_ff, d_model), dtype, device),
    }


def moe_axes():
    """The logical axes of :func:`moe_init`'s tree: the rules put
    ``"experts"`` (expert parallelism) or ``"d_ff_expert"`` (tensor
    parallelism within each expert) on the model axis."""
    return {
        "router": linear_axes(("d_model", None), False),
        "w_gate": ("experts", "d_model", "d_ff_expert"),
        "w_up": ("experts", "d_model", "d_ff_expert"),
        "w_down": ("experts", "d_ff_expert", "d_model"),
    }


def _segments(expert_idx: Tensor, n_experts: int):
    """(stable order by expert, counts [E], position of each assignment
    within its expert [Tk] int32) of the expert ids ``expert_idx``."""
    e = expert_idx.to(torch.int64)
    tk = e.shape[0]
    order = torch.argsort(e, stable=True)
    # counts by scatter-add (torch.bincount on the card reads the max
    # back to the host)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=e.device)
    counts.scatter_add_(0, e, torch.ones_like(e))
    starts = torch.cumsum(counts, 0) - counts               # [E]
    ranks = torch.arange(tk, device=e.device) - starts[e[order]]
    pos = torch.empty_like(ranks)
    pos[order] = ranks
    return order, counts, pos.to(torch.int32)


def _dispatch_indices(expert_idx: Tensor, n_experts: int, capacity: int):
    """Position of each (token, slot) inside its expert's buffer.

    expert_idx: [Tk] int.  Returns (pos [Tk] int32, keep-mask [Tk])."""
    _, _, pos = _segments(expert_idx, n_experts)
    return pos, pos < capacity


def _top_k(probs: Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, the lower
    index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p, x: Tensor, *, top_k: int,
              policy: Optional[QuantPolicy] = None,
              capacity_factor: float = 1.25, act: str = "silu") -> Tensor:
    """x: [B, S, d_model] -> [B, S, d_model]."""
    B, S, D = x.shape
    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    E = w_gate.shape[0]
    T = B * S

    # more than one rank in the mesh -> the explicit dispatch over the
    # model axis (EP or TP-within-expert)
    from repro_torch.nn import moe_shard
    mesh = current_mesh()
    if mesh is not None and mesh_shape(mesh).size > 1 and \
            moe_shard.shardable(x, mesh, E):
        return moe_shard.moe_shard_map(
            x, p["router"]["w"], w_gate, w_up, w_down, mesh,
            top_k=top_k, capacity_factor=capacity_factor, policy=policy,
            act=act)

    xf = x.reshape(T, D)

    # --- routing (fp32, through fp64: it chooses the experts) ---------
    router_w = as_dense(p["router"]["w"])
    logits = exact.einsum("td,de->te", xf, router_w, dtype=torch.float32)
    probs = _softmax(logits)
    gate_vals, gate_idx = _top_k(probs, top_k)              # [T, k]
    gate_vals = gate_vals / exact.total(gate_vals)

    # --- dispatch ------------------------------------------------------
    capacity = int(math.ceil(T * top_k / E * capacity_factor))
    capacity = max(capacity, 4)
    e_flat = gate_idx.reshape(-1)                           # [Tk]
    w_flat = gate_vals.reshape(-1)
    pos, keep = _dispatch_indices(e_flat, E, capacity)
    # dropped assignments go to a scratch slot (capacity), sliced off
    pos_c = torch.where(keep, pos, capacity).to(torch.int64)
    x_rep = torch.repeat_interleave(xf, top_k, dim=0)       # [Tk, D]
    x_rep = constrain(x_rep, ("batch", None))
    buf = x.new_zeros((E, capacity + 1, D))
    buf = constrain(buf, ("experts", "batch", None))
    buf[e_flat, pos_c] = x_rep
    buf = constrain(buf, ("experts", "batch", None))
    buf = buf[:, :capacity]

    # --- expert FFN (batched quantized products) -----------------------
    g = q_batched_matmul(buf, w_gate, policy)
    u = q_batched_matmul(buf, w_up, policy)
    h = activation(g, act, policy) * u
    h = constrain(h, ("experts", "batch", None))
    out_buf = q_batched_matmul(h, w_down, policy)           # [E, C, D]
    out_buf = constrain(out_buf, ("experts", "batch", None))

    # --- combine -------------------------------------------------------
    gathered = out_buf[e_flat, torch.clamp_max(pos_c, capacity - 1)]
    gathered = constrain(gathered, ("batch", None))
    gathered = torch.where(keep[:, None], gathered, 0.0)
    weighted = gathered * w_flat[:, None].to(gathered.dtype)
    out = exact.total(weighted.reshape(T, top_k, D), dim=1)[:, 0]
    return out.reshape(B, S, D).to(x.dtype)


def moe_aux_loss(logits: Tensor, gate_idx: Tensor,
                 n_experts: int) -> Tensor:
    """Switch-style load-balancing auxiliary loss."""
    probs = torch.softmax(logits, -1)
    me = probs.mean(0)
    one_hot = torch.nn.functional.one_hot(gate_idx[:, 0].long(),
                                          n_experts).to(probs.dtype)
    ce = one_hot.mean(0)
    return n_experts * torch.sum(me * ce)
