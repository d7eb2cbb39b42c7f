"""The MoE dispatch over a mesh: expert parallelism (EP) and tensor
parallelism within each expert (TPE), with the data movement written
out (port of ``repro.nn.moe_shard``).

Each rank holds its data slot's rows and routes and dispatches its own
tokens, at its own capacity (``ceil(T_slot * k / E * factor)``, at
least 4), as each slot of the reference's ``shard_map`` does; its
capacity buffers are then exchanged over the mesh's "model" axis:

  EP  (E % model == 0, qwen3-moe): rank ``j`` runs experts
      ``[j E/m, (j + 1) E/m)`` over the ``m * C`` slots its model peers
      sent it, and sends each peer's slots back (the reference's two
      tiled ``all_to_all`` exchanges);
  TPE (E < model, mixtral): every rank runs every expert on its own
      ``d_ff / m`` slice, and the partial outputs are summed over the
      peers (the reference's ``psum``), so the ``w_down`` product
      quantizes ``h`` a row over the rank's slice.

Params are replicated on every rank, so the reference's FSDP gather of
the expert weights is the identity: each rank takes its experts (EP)
or its ``d_ff`` slice (TPE) from the whole tensors.  The exchanges are
slot-ordered all-gathers: the ``all_to_all`` is a gather and a slice,
exact (gloo has no ``all_to_all``), and the ``psum`` adds the gathered
parts in peer order, never through a backend's ``all_reduce``.

Gradients follow the reference's ``shard_map`` transpose: the output's
cotangent is divided by the model axis's size (the output is
replicated over it), the exchanges' cotangents travel back the same
way, and each input replicated over the model axis (the rows, the
router, the expert weights) gets the sum of its peers' cotangents, so
every rank ends with its slot's gradient.  The caller sums over the
data slots.  Routing goes through ``core.exact``, as ``nn.moe``'s does.
The body runs under ``sharding.manual``: each activation's
requantization grid is the rank's own, as in the reference's body.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import exact
from repro_torch.core.fxp import QTensor, as_dense, div_scalar
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qmatmul import q_batched_matmul
from repro_torch.core.vact import activation
from repro_torch.distributed.sharding import (axis_index, gather_over,
                                              manual, mesh_shape,
                                              ordered_sum)
from repro_torch.nn.attention import _softmax
from repro_torch.nn.moe import _segments, _top_k

Tensor = torch.Tensor
MODEL = ("model",)


class _GatherModel(torch.autograd.Function):
    """Every model peer's ``x``, stacked in peer order; its backward
    gives each peer the sum, in peer order, of the cotangents every
    rank holds for that peer's part."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh) -> Tensor:
        ctx.mesh = mesh
        return torch.stack(gather_over(x, mesh, MODEL))

    @staticmethod
    def backward(ctx, g: Tensor):
        j = axis_index(ctx.mesh, "model")
        parts = gather_over(g.contiguous(), ctx.mesh, MODEL)
        return ordered_sum([p[j] for p in parts]), None


class _ReplicatedIn(torch.autograd.Function):
    """The identity on an input replicated over the model axis; its
    cotangent is summed over the peers."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh) -> Tensor:
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        return ordered_sum(gather_over(g.contiguous(), ctx.mesh, MODEL,
                                       "all-reduce")), None


class _ReplicatedOut(torch.autograd.Function):
    """The identity on an output replicated over ``m`` model peers; its
    cotangent is divided by ``m``."""

    @staticmethod
    def forward(ctx, x: Tensor, m: int) -> Tensor:
        ctx.m = m
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        return div_scalar(g, ctx.m), None


def _local_dispatch(x_rep: Tensor, e_flat: Tensor, n_experts: int,
                    capacity: int):
    """Group this slot's (token, k) pairs by expert id, as a gather:
    slot (e, c) takes the sorted assignment ``starts[e] + c``.

    x_rep: [Tk, D] -> (buf [E, C, D], pos_c [Tk], keep [Tk])."""
    tk = e_flat.shape[0]
    order, counts, pos = _segments(e_flat, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    keep = pos < capacity
    pos_c = torch.where(keep, pos, capacity).to(torch.int64)
    cols = torch.arange(capacity, device=e_flat.device)
    slot = starts[:, None] + cols[None]                     # [E, C]
    valid = cols[None] < counts[:, None]                    # [E, C]
    token = order[torch.clamp(slot, 0, tk - 1)]             # [E, C]
    buf = x_rep[token] * valid[..., None].to(x_rep.dtype)
    return buf, pos_c, keep


def _expert_ffn(buf, w_gate, w_up, w_down, policy, act):
    g = q_batched_matmul(buf, w_gate, policy)
    u = q_batched_matmul(buf, w_up, policy)
    h = activation(g, act, policy) * u
    return q_batched_matmul(h, w_down, policy)


def moe_shard_map(x: Tensor, router_w, w_gate, w_up, w_down, mesh, *,
                  top_k: int, capacity_factor: float,
                  policy: Optional[QuantPolicy], act: str) -> Tensor:
    """x: [B_slot, S, D], this rank's rows of the batch -> [B_slot, S,
    D].  The weights are the whole (replicated) tensors, fp or
    QTensor."""
    with manual():
        return _dispatch(x, router_w, w_gate, w_up, w_down, mesh,
                         top_k=top_k, capacity_factor=capacity_factor,
                         policy=policy, act=act)


def _dispatch(x, router_w, w_gate, w_up, w_down, mesh, *, top_k,
              capacity_factor, policy, act):
    b_loc, S, D = x.shape
    E = w_gate.shape[0]
    m = mesh_shape(mesh).shape.get("model", 1)
    ep = E % m == 0 and E >= m and m > 1
    cap = max(int(math.ceil(b_loc * S * top_k / E * capacity_factor)), 4)
    j = axis_index(mesh, "model") if m > 1 else 0

    cdt = policy.compute_dtype if policy else torch.float32
    if isinstance(w_gate, QTensor):      # PTQ int8 weights loaded
        router_w = as_dense(router_w, torch.float32)
        w_gate, w_up, w_down = (as_dense(t, cdt)
                                for t in (w_gate, w_up, w_down))
    x, router_w, w_gate, w_up, w_down = (
        _ReplicatedIn.apply(t, mesh)
        for t in (x, as_dense(router_w), w_gate, w_up, w_down))
    # this rank's share of the expert weights
    if ep:
        e_loc = E // m
        w_gate, w_up, w_down = (w[j * e_loc:(j + 1) * e_loc]
                                for w in (w_gate, w_up, w_down))
    else:
        d_ff = w_gate.shape[2]
        if d_ff % m:
            raise ValueError(f"d_ff_expert {d_ff} does not divide over the "
                             f"{m} ranks of the model axis")
        f = d_ff // m
        w_gate, w_up = (w[:, :, j * f:(j + 1) * f] for w in (w_gate, w_up))
        w_down = w_down[:, j * f:(j + 1) * f]

    # routing: fp32 through fp64, local (replicated over "model")
    xf = x.reshape(-1, D)
    logits = exact.einsum("td,de->te", xf, router_w, dtype=torch.float32)
    probs = _softmax(logits)
    gate_vals, gate_idx = _top_k(probs, top_k)
    gate_vals = gate_vals / exact.total(gate_vals)
    e_flat = gate_idx.reshape(-1)
    w_flat = gate_vals.reshape(-1)
    x_rep = torch.repeat_interleave(xf, top_k, dim=0)

    buf, pos_c, keep = _local_dispatch(x_rep, e_flat, E, cap)

    if ep:
        # [E, C, D] --(split experts, concat slots)--> [E/m, mC, D]
        parts = _GatherModel.apply(buf, mesh)
        buf = torch.cat([parts[i, j * e_loc:(j + 1) * e_loc]
                         for i in range(m)], dim=1)
        out_buf = _expert_ffn(buf, w_gate, w_up, w_down, policy, act)
        # [E/m, mC, D] --(split slots, concat experts)--> [E, C, D]
        parts = _GatherModel.apply(out_buf, mesh)
        out_buf = torch.cat([parts[k, :, j * cap:(j + 1) * cap]
                             for k in range(m)], dim=0)
    else:
        # TPE: partial d_model products over the d_ff slices, summed
        out_buf = _expert_ffn(buf, w_gate, w_up, w_down, policy, act)
        out_buf = ordered_sum(list(_GatherModel.apply(out_buf, mesh)))

    gathered = out_buf[e_flat, torch.clamp_max(pos_c, cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    weighted = gathered * w_flat[:, None].to(gathered.dtype)
    out = exact.total(weighted.reshape(-1, top_k, D), dim=1)[:, 0]
    out = _ReplicatedOut.apply(out, m)
    return out.reshape(b_loc, S, D).to(x.dtype)


def shardable(x: Tensor, mesh, n_experts: int) -> bool:
    """Can this call take the mesh's dispatch?  ``x`` holds the rank's
    own rows (``data.place`` has already refused a batch that does not
    divide over the data axes), so any mesh with a model axis can."""
    del x, n_experts
    return mesh is not None and "model" in mesh_shape(mesh).axis_names
