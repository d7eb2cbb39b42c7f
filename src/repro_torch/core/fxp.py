"""Adaptive fixed-point (AdFxP) quantization (port of ``repro.core.fxp``).

Symmetric abs-max quantization, fake quantization and ``QTensor``, on
exactly the reference's grids: the scale is ``max(absmax, 1e-12) /
qmax`` and codes are ``clip(round(x / scale))`` with round-half-to-even
(``torch.round`` and ``jnp.round`` agree).  Dividing by the scale, not
multiplying by its inverse, is part of the contract.

``fake_quant`` and ``fake_quant_rowwise`` pass their gradient straight
through (identity backward), as the reference's ``custom_vjp`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

# int dtype and symmetric max magnitude per FxP precision; 4-bit codes
# live in an int8 container (two per byte when stored, see pack_nibbles)
_FXP_SPECS = {
    4: (torch.int8, 7.0),
    8: (torch.int8, 127.0),
    16: (torch.int16, 32767.0),
    32: (torch.int32, 2147483647.0),
}


def fxp_dtype(bits: int) -> torch.dtype:
    return _FXP_SPECS[bits][0]


def fxp_qmax(bits: int) -> float:
    return _FXP_SPECS[bits][1]


def div_scalar(x: Tensor, divisor: float) -> Tensor:
    """``x / divisor``, correctly rounded on every device.  PyTorch's
    CUDA division by a Python number multiplies by its reciprocal, one
    ulp off the quotient for some ``x`` (and so off the reference's
    scales); a 0-dim tensor on ``x``'s device divides."""
    return x / x.new_full((), divisor)


def _reduce_axes(x_ndim: int, channel_axis: Optional[int]) -> Tuple[int, ...]:
    """Axes reduced for a scale: all (per-tensor) or all but one."""
    if channel_axis is None:
        return tuple(range(x_ndim))
    channel_axis = channel_axis % x_ndim
    return tuple(i for i in range(x_ndim) if i != channel_axis)


def absmax_scale(x: Tensor, bits: int, channel_axis: Optional[int] = None,
                 eps: float = 1e-12) -> Tensor:
    """Symmetric AdFxP scale: one LSB = absmax / qmax (keepdims)."""
    axes = _reduce_axes(x.ndim, channel_axis)
    amax = x.abs().amax(dim=axes, keepdim=True) if axes else x.abs()
    return div_scalar(torch.clamp_min(amax, eps), fxp_qmax(bits))


def quantize(x: Tensor, bits: int, channel_axis: Optional[int] = None,
             scale: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Symmetric quantization to intN.  Returns (q, scale)."""
    if bits == 32:
        return x, torch.ones((1,) * x.ndim, dtype=x.dtype, device=x.device)
    if scale is None:
        scale = absmax_scale(x, bits, channel_axis)
    dt, qmax = _FXP_SPECS[bits]
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(dt)
    return q, scale


def dequantize(q: Tensor, scale: Tensor, dtype=torch.float32) -> Tensor:
    return q.to(dtype) * scale.to(dtype)


def quantize_eq1(w: Tensor, n: int = 8) -> Tuple[Tensor, Tensor]:
    """The paper's Eq. (1) uniform affine quantizer,
    ``Q_n(W) = round(W * 2^n / (|min(W, 0)| + |max(W, 0)|))``: an affine
    grid of 2^n steps across the observed span, clipped to
    ``[-2^n, 2^n]``.  Returns (q, scale), ``scale = span / 2^n``, q as
    floats."""
    zero = w.new_zeros(())
    lo = torch.abs(torch.minimum(w.min(), zero))
    hi = torch.abs(torch.maximum(w.max(), zero))
    span = torch.clamp_min(lo + hi, 1e-12)
    scale = div_scalar(span, 2.0 ** n)
    q = torch.clamp(torch.round(w / scale), -(2.0 ** n), 2.0 ** n)
    return q, scale


def _fake_quant_fwd(x: Tensor, bits: int, channel_axis: Optional[int],
                    scale: Optional[Tensor] = None) -> Tensor:
    q, s = quantize(x, bits, channel_axis, scale)
    return dequantize(q, s, x.dtype)


def _fake_quant_rowwise_fwd(x: Tensor, bits: int) -> Tensor:
    amax = x.abs().amax(dim=-1, keepdim=True)
    qmax = fxp_qmax(bits)
    scale = div_scalar(torch.clamp_min(amax, 1e-12), qmax)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return (q * scale).to(x.dtype)


class _StraightThrough(torch.autograd.Function):
    """``fwd(x, *args)`` forward, identity backward (the STE)."""

    @staticmethod
    def forward(ctx, fwd, x, *args):
        return fwd(x, *args)

    @staticmethod
    def backward(ctx, g):
        return (None, g) + (None,) * (len(ctx.needs_input_grad) - 2)


def fake_quant(x: Tensor, bits: int, channel_axis: Optional[int] = None,
               scale: Optional[Tensor] = None) -> Tensor:
    """Quantize-dequantize on the ``quantize`` grid (of ``scale`` where
    given), with a straight-through gradient."""
    if bits == 32:
        return x
    return _StraightThrough.apply(_fake_quant_fwd, x, bits, channel_axis,
                                  scale)


def fake_quant_rowwise(x: Tensor, bits: int) -> Tensor:
    """Per-row (last-axis scale) fake quantization, on the grid of
    ``qmatmul.quantize_rowwise``, with a straight-through gradient."""
    if bits == 32:
        return x
    return _StraightThrough.apply(_fake_quant_rowwise_fwd, x, bits)


@dataclasses.dataclass
class QTensor:
    """int payload + broadcastable fp32 scale.  ``deq()`` restores fp."""

    qvalue: Tensor
    scale: Tensor
    bits: int = 8

    @property
    def shape(self):
        return self.qvalue.shape

    @property
    def dtype(self):
        return self.qvalue.dtype

    @property
    def ndim(self):
        return self.qvalue.ndim

    @property
    def device(self):
        return self.qvalue.device

    def deq(self, dtype=torch.float32) -> Tensor:
        return dequantize(self.qvalue, self.scale, dtype)

    def to(self, device) -> "QTensor":
        return QTensor(self.qvalue.to(device), self.scale.to(device),
                       self.bits)

    @classmethod
    def quant(cls, x: Tensor, bits: int = 8,
              channel_axis: Optional[int] = None) -> "QTensor":
        q, s = quantize(x, bits, channel_axis)
        return cls(q, s, bits)


def is_qtensor(x) -> bool:
    return isinstance(x, QTensor)


def pack_nibbles(q: Tensor) -> Tensor:
    """int4 codes (int8 container, values in [-8, 7]) -> flat uint8, two
    codes per byte, low nibble first; an odd count pads a zero nibble."""
    flat = q.reshape(-1).to(torch.int8)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    lo = (flat[0::2] & 0x0F).to(torch.uint8)
    hi = (flat[1::2] & 0x0F).to(torch.uint8)
    return lo | (hi << 4)


def unpack_nibbles(packed: Tensor, size: int) -> Tensor:
    """Inverse of :func:`pack_nibbles`: ``size`` sign-extended codes."""
    lo = (packed & 0x0F).to(torch.int8)
    hi = ((packed >> 4) & 0x0F).to(torch.int8)
    both = torch.stack([lo, hi], dim=1).reshape(-1)[:size]
    return torch.where(both >= 8, both - 16, both).to(torch.int8)


def nbytes_of(x) -> int:
    """Byte footprint (a QTensor counts payload + scale)."""
    if isinstance(x, QTensor):
        return nbytes_of(x.qvalue) + nbytes_of(x.scale)
    return x.numel() * x.element_size()


def as_dense(w, dtype=None) -> Tensor:
    """Plain-tensor view of a maybe-QTensor weight (dequantize if needed)."""
    if isinstance(w, QTensor):
        return w.deq(dtype or torch.float32)
    return w.to(dtype) if dtype is not None else w
