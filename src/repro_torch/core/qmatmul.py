"""q_matmul: every dense product of the port goes through here (port of
``repro.core.qmatmul``).

Backends, as in the reference:

  * ``ref``           fake-quantized operands, fp matmul (golden semantics);
  * ``xla``/``pallas`` at <= 8-bit weights and activations, the integer
                      program: per-row int8 activations x per-out-channel
                      int8 weights, exact int32 accumulation, dequant in
                      the order ``(acc * sx) * sw``.

On a CUDA tensor the integer product runs in the Q-MAC kernel whichever
of ``xla``/``pallas`` is named; on a CPU tensor in its plain PyTorch
version.  fp weights (the evaluation/training forward) take the int32
kernel and dequantize after it, as the reference's lines do; a packed
``QTensor`` weight (serving) takes the fused-epilogue kernel.  The two
round identically, so served and evaluated actions agree bit for bit.

A quantized product with fp weights differentiates as the reference's
``_qmm`` does: the forward is the quantized program, the backward the
straight-through estimator ``dx = g @ w^T``, ``dw = x^T @ g`` in the
compute dtype at the *unquantized* operands (plain PyTorch; the
reference's backward is an fp ``dot_general``, not a kernel).

On a laid-out step (``distributed.sharding.layout``) a product may be
split over the model axis (:class:`Split`).  Column-parallel (the
output's columns split): the rank's columns, bit for bit the unsplit
product's.  Row-parallel (the contraction split): a row's activation
scale and a weight column's scale are maxima over the model axis
(``pmax``), so the codes are the unsplit ones; the int32 accumulators
are summed over the model axis before the dequant, exactly, so the
output is the unsplit one bit for bit (with ``scatter``, only this
rank's piece of it along that dimension: sequence parallelism).  The
fp and fake-quantized branches sum their fp partials in rank order.  A
packed (``QTensor``) weight splits the same two ways, its blocks cut
from the whole weight's codes and per-column scales: column-parallel
through the fused kernel, row-parallel through the int32 kernel with
the accumulators summed over the model axis before the dequant.

``q_batched_matmul`` is MoE's per-expert product, ``x [E, C, K] @ w [E,
K, N]``.  Its int8 program (per-row activation codes, per-(expert,
out-channel) weight codes quantized at each call, exact int32
accumulation, ``(acc * sx) * sw``) runs on a CUDA tensor in Q-MAC's
batched kernel, one launch a product; the fake-quant and ``QTensor``
branches are fp products, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.fxp import (QTensor, div_scalar, fake_quant,
                                  fake_quant_rowwise, fxp_dtype, fxp_qmax,
                                  quantize)
from repro_torch.core.policy import QuantPolicy
from repro_torch.distributed.sharding import (axes_index, gather_over, pmax,
                                              psum_pieces, psum_scatter,
                                              summed)
from repro_torch.kernels.qmac import ops as qmac_ops

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Split:
    """A product's operands laid over a mesh: ``k`` the axes its
    contraction is split over (row-parallel: ``x``'s last dimension and
    ``w``'s first), ``n`` those its output columns are split over
    (column-parallel), ``scatter`` the output dimension a row-parallel
    product's sum is reduce-scattered along (sequence parallelism)."""

    mesh: object
    k: Tuple[str, ...] = ()
    n: Tuple[str, ...] = ()
    scatter: Optional[int] = None


def quantize_rowwise(x: Tensor, bits: int, split: Optional[Split] = None):
    """Per-row (last-axis) symmetric quantization for activations:
    (int codes, fp32 scale [..., 1]).  A row split over ``split.k``
    takes its absmax over the peers there."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    if split is not None and split.k:
        amax = pmax(amax, split.mesh, split.k)
    scale = div_scalar(torch.clamp_min(amax.to(torch.float32), 1e-12),
                       fxp_qmax(bits))
    q = torch.clamp(torch.round(x / scale.to(x.dtype)),
                    -fxp_qmax(bits), fxp_qmax(bits))
    return q.to(fxp_dtype(bits)), scale


def _fp_dot(x: Tensor, w: Tensor, dtype) -> Tensor:
    return torch.matmul(x.to(dtype), w.to(dtype))


def _rows(t: Tensor) -> Tensor:
    """Leading axes folded into one row axis, contiguous for a kernel."""
    return t.reshape(-1, t.shape[-1]).contiguous()


def _weight_scale(w: Tensor, bits: int, per_channel: bool,
                  split: Split) -> Tensor:
    """``absmax_scale`` of a split weight ``[K, N]``: a column's absmax
    (per channel) over the peers its rows are split over, the tensor's
    (per tensor) over every peer of its blocks."""
    amax = w.abs().amax(dim=0 if per_channel else (0, 1), keepdim=True)
    over = split.k if per_channel else split.k + split.n
    if over:
        amax = pmax(amax, split.mesh, over)
    return div_scalar(torch.clamp_min(amax, 1e-12), fxp_qmax(bits))


def _fake_quant_operands(policy: QuantPolicy, x: Tensor, w: Tensor,
                         split: Optional[Split]):
    w_ch = 1 if policy.per_channel else None
    if split is None:
        xq = fake_quant_rowwise(x, policy.a_bits) \
            if policy.quantized_a else x
        wq = fake_quant(w, policy.w_bits, w_ch) if policy.quantized_w else w
        return xq, wq
    xq = fake_quant(x, policy.a_bits, scale=quantize_rowwise(
        x, policy.a_bits, split)[1].to(x.dtype)) \
        if policy.quantized_a else x
    wq = fake_quant(w, policy.w_bits, w_ch, scale=_weight_scale(
        w, policy.w_bits, policy.per_channel, split)) \
        if policy.quantized_w else w
    return xq, wq


def _reduced(y: Tensor, split: Optional[Split]) -> Tensor:
    """A row-parallel product's partials summed over ``split.k`` (or
    reduce-scattered along ``split.scatter``); as it is otherwise."""
    if split is None or not split.k:
        return y
    if split.scatter is None:
        return psum_pieces(y, split.mesh, split.k)
    return psum_scatter(y, split.mesh, split.k, split.scatter)


def _fwd_quantized(policy: QuantPolicy, x: Tensor, w: Tensor,
                   split: Optional[Split] = None) -> Tensor:
    """Quantized forward product with fp weights (this rank's blocks of
    a ``split`` product)."""
    cdt = policy.compute_dtype
    w_ch = 1 if policy.per_channel else None
    if policy.backend not in ("ref", "xla", "pallas"):
        raise ValueError(f"unknown backend {policy.backend!r}")
    # the integer path only at <= 8 bits under xla/pallas: 16-bit
    # products could overflow the int32 accumulator
    if policy.backend != "ref" and policy.quantized_a \
            and policy.quantized_w and policy.a_bits <= 8 \
            and policy.w_bits <= 8:
        qx, sx = quantize_rowwise(x, policy.a_bits, split)
        if split is None:
            qw, sw = quantize(w, policy.w_bits, channel_axis=w_ch)
        else:
            qw, sw = quantize(w, policy.w_bits, channel_axis=w_ch,
                              scale=_weight_scale(w, policy.w_bits,
                                                  policy.per_channel, split))
        acc = qmac_ops.qmac_i8(_rows(qx), qw.contiguous())
        acc = _reduced(acc.reshape(x.shape[:-1] + (w.shape[-1],)), split)
        if split is not None and split.k and split.scatter is not None:
            d, n = split.scatter, acc.shape[split.scatter]
            sx = sx.narrow(d, axes_index(split.mesh, split.k) * n, n)
        sw_bc = sw.reshape((1,) * (acc.ndim - 1) + (-1,)) \
            if policy.per_channel else sw.reshape((1,) * acc.ndim)
        return (acc.to(torch.float32) * sx * sw_bc).to(cdt)
    xq, wq = _fake_quant_operands(policy, x, w, split)
    return _reduced(_fp_dot(xq, wq, cdt), split)


class _QMM(torch.autograd.Function):
    """The quantized forward with the STE backward (``_qmm_bwd``); a
    scattered row-parallel product gathers its output's cotangent along
    the scattered dimension first."""

    @staticmethod
    def forward(ctx, policy: QuantPolicy, x: Tensor, w: Tensor,
                split: Optional[Split]):
        ctx.policy, ctx.split = policy, split
        ctx.save_for_backward(x, w)
        return _fwd_quantized(policy, x, w, split)

    @staticmethod
    def backward(ctx, g: Tensor):
        x, w = ctx.saved_tensors
        cdt = ctx.policy.compute_dtype
        split = ctx.split
        if split is not None and split.k and split.scatter is not None:
            g = torch.cat(gather_over(g.contiguous(), split.mesh, split.k),
                          dim=split.scatter)
        g = g.to(cdt)
        dx = dw = None
        if ctx.needs_input_grad[1]:
            # contract g's last axis with w's last axis
            dx = torch.matmul(g, w.to(cdt).transpose(0, 1)).to(x.dtype)
        if ctx.needs_input_grad[2]:
            # contract every batch axis of x with g's
            dw = torch.matmul(_rows(x.to(cdt)).transpose(0, 1),
                              g.reshape(-1, g.shape[-1])).to(w.dtype)
        return None, dx, dw, None


def _serve_quantized(policy: QuantPolicy, x: Tensor, w: QTensor,
                     split: Optional[Split] = None) -> Tensor:
    """Forward with a pre-quantized (QTensor) weight: the serving path.
    ``split``: this rank's block of the packed weight, a block of the
    whole weight's codes and scales (never quantized on its own).
    Column-parallel, the rank's columns through the fused kernel (``x``
    is whole, so its row scales are the unsplit ones).  Row-parallel,
    the fused kernel cannot serve: the row scales are maxima over the
    model axis, the rank's int32 accumulator (``qmac_i8``) is summed
    over it exactly, and only then dequantized, ``(acc * sx) * sw``, as
    the fused epilogue rounds it (dequantized partials would sum to
    other fp32 values)."""
    cdt = policy.compute_dtype
    if policy.quantized_a and w.bits <= 8 and policy.a_bits <= 8:
        qx, sx = quantize_rowwise(x, policy.a_bits, split)
        if split is None or not split.k:
            out = qmac_ops.qmac_i8_deq(_rows(qx), _rows(sx),
                                       w.qvalue.contiguous(),
                                       w.scale.reshape(-1).contiguous())
            return out.reshape(x.shape[:-1] + (w.shape[-1],)).to(cdt)
        acc = qmac_ops.qmac_i8(_rows(qx), w.qvalue.contiguous())
        acc = _reduced(acc.reshape(x.shape[:-1] + (w.shape[-1],)), split)
        if split.scatter is not None:
            d, n = split.scatter, acc.shape[split.scatter]
            sx = sx.narrow(d, axes_index(split.mesh, split.k) * n, n)
        sw = w.scale.reshape((1,) * (acc.ndim - 1) + (-1,))
        return (acc.to(torch.float32) * sx * sw).to(cdt)
    y = _fp_dot(x, w.deq(cdt), cdt)
    if split is None or not split.k:
        return y
    return summed(y, split.mesh, split.k, split.scatter)


def q_matmul(x: Tensor, w: Union[Tensor, QTensor],
             policy: Optional[QuantPolicy] = None,
             split: Optional[Split] = None) -> Tensor:
    """Contract ``x``'s last axis with ``w``'s first axis under
    ``policy`` (w is ``[d_in, d_out]``); ``split``: the operands are
    this rank's blocks of a product laid over a mesh."""
    if policy is None:
        policy = QuantPolicy()
    if isinstance(w, QTensor):
        return _serve_quantized(policy, x, w, split)
    if not (policy.quantized_w or policy.quantized_a):
        y = _fp_dot(x, w, policy.compute_dtype)
        if split is None or not split.k:
            return y
        return summed(y, split.mesh, split.k, split.scatter)
    return _QMM.apply(policy, x, w, split)


# ---------------------------------------------------------------------------
# batched (per-expert) variant for MoE: x [E, C, K] @ w [E, K, N]
# ---------------------------------------------------------------------------

def _fwd_bmm(policy: QuantPolicy, x: Tensor, w: Tensor) -> Tensor:
    """The reference's ``_fwd_bmm``: the int8 program at <= 8 bits under
    ``xla``/``pallas``, else fake-quantized operands and an fp product."""
    cdt = policy.compute_dtype
    if (policy.quantized_a and policy.quantized_w
            and policy.a_bits <= 8 and policy.w_bits <= 8
            and policy.backend in ("xla", "pallas")):
        qmax = fxp_qmax(policy.w_bits)
        qx, sx = quantize_rowwise(x, policy.a_bits)          # [E, C, 1]
        # per-(expert, out-channel) weight scales
        amax = w.abs().amax(dim=1, keepdim=True)              # [E, 1, N]
        sw = div_scalar(torch.clamp_min(amax, 1e-12), qmax)
        qw = torch.clamp(torch.round(w / sw), -qmax, qmax).to(
            fxp_dtype(policy.w_bits))
        out = qmac_ops.qmac_i8_deq_bmm(qx.contiguous(), sx.contiguous(),
                                       qw.contiguous(),
                                       sw.to(torch.float32).contiguous())
        return out.to(cdt)
    xq = fake_quant_rowwise(x, policy.a_bits) if policy.quantized_a else x
    wq = fake_quant(w, policy.w_bits, 2) if policy.quantized_w else w
    return torch.matmul(xq.to(cdt), wq.to(cdt))


class _QBMM(torch.autograd.Function):
    """The batched quantized forward with the STE backward
    (``_qbmm_bwd``)."""

    @staticmethod
    def forward(ctx, policy: QuantPolicy, x: Tensor, w: Tensor):
        ctx.policy = policy
        ctx.save_for_backward(x, w)
        return _fwd_bmm(policy, x, w)

    @staticmethod
    def backward(ctx, g: Tensor):
        x, w = ctx.saved_tensors
        cdt = ctx.policy.compute_dtype
        g = g.to(cdt)
        dx = dw = None
        if ctx.needs_input_grad[1]:                  # g[E,C,N] w^T -> [E,C,K]
            dx = torch.matmul(g, w.to(cdt).transpose(1, 2)).to(x.dtype)
        if ctx.needs_input_grad[2]:                  # x^T g -> [E,K,N]
            dw = torch.matmul(x.to(cdt).transpose(1, 2), g).to(w.dtype)
        return None, dx, dw


def q_batched_matmul(x: Tensor, w: Union[Tensor, QTensor],
                     policy: Optional[QuantPolicy] = None) -> Tensor:
    """Per-expert contraction: x [E, C, K] @ w [E, K, N] -> [E, C, N]."""
    if policy is None:
        policy = QuantPolicy()
    cdt = policy.compute_dtype
    if isinstance(w, QTensor):
        # serving: the per-expert weights dequantized into the compute
        # dtype, then an fp product (activations fake-quantized)
        wf = w.deq(cdt)
        if policy.quantized_a:
            return _fwd_bmm(policy.replace(w_bits=32), x, wf)
        return torch.matmul(x.to(cdt), wf)
    if not (policy.quantized_w or policy.quantized_a):
        return torch.matmul(x.to(cdt), w.to(cdt))
    return _QBMM.apply(policy, x, w)
