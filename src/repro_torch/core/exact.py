"""The LM layers' reductions and transcendental functions, computed in
fp64 and rounded once to the working dtype.

In fp32 the card and the CPU sum a contraction in another order, and
their ``rsqrt``, ``exp``, ``log``, ``sin``, ``cos``, ``tanh`` and ``pow``
differ in the last bit.
Under an int8 policy every activation is quantized again after each
layer, and at full width (rows of 2,048-5,632 values) an ulp lands some
value on the other side of a rounding tie in nearly every quantization:
the two devices' int8 codes then part and the difference grows layer
by layer.  Through fp64 each result is the correctly rounded one on
both devices (the fp64 sums and functions differ by a few fp64 ulps,
which move the rounded value only when it lies within that of a
rounding boundary), so the card computes the CPU's plain program bit
for bit.  Each function costs two dtype conversions beside its op.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.fxp import div_scalar

Tensor = torch.Tensor


def einsum(spec: str, *ops: Tensor, dtype=None) -> Tensor:
    """``torch.einsum`` of the operands widened to fp64, rounded to
    ``dtype`` (default: the operands' promoted dtype, as ``jnp.einsum``
    gives it)."""
    out = torch.einsum(spec, *(o.to(torch.float64) for o in ops))
    if dtype is None:
        dtype = functools.reduce(torch.promote_types,
                                 (o.dtype for o in ops))
    return out.to(dtype)


def _unary(fn):
    def f(x: Tensor) -> Tensor:
        return fn(x.to(torch.float64)).to(x.dtype)
    f.__name__ = fn.__name__
    f.__doc__ = f"``torch.{fn.__name__}`` through fp64."
    return f


rsqrt = _unary(torch.rsqrt)
exp = _unary(torch.exp)
log = _unary(torch.log)
sin = _unary(torch.sin)
cos = _unary(torch.cos)
sigmoid = _unary(torch.sigmoid)
tanh = _unary(torch.tanh)
# PyTorch's vectorized fp32 sqrt on the CPU is not correctly rounded (it
# misses by an ulp in about 0.6% of [0, 1)); the fp64 root rounded to
# fp32 is, as a CUDA sqrtf is
sqrt = _unary(torch.sqrt)


def silu(x: Tensor) -> Tensor:
    """``jax.nn.silu``'s ``x * sigmoid(x)``, the sigmoid through fp64."""
    return x * sigmoid(x)


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)``, through fp64 (not
    ``F.softplus``, whose ``threshold`` branch is another function)."""
    xd = x.to(torch.float64)
    return torch.logaddexp(xd, xd.new_zeros(())).to(x.dtype)


def cumsum(x: Tensor, dim: int = -1) -> Tensor:
    """``jnp.cumsum`` along ``dim`` through fp64: every prefix sum rounded
    once (in fp32 neither library fixes an order)."""
    return torch.cumsum(x.to(torch.float64), dim=dim).to(x.dtype)


def pow(x: Tensor, e: float) -> Tensor:  # noqa: A001 (torch.pow's name)
    """``torch.pow`` of ``x`` to the scalar ``e`` through fp64."""
    return torch.pow(x.to(torch.float64), e).to(x.dtype)


def total(x: Tensor, dim: int = -1) -> Tensor:
    """The sum over ``dim`` (kept) through fp64."""
    return x.to(torch.float64).sum(dim=dim, keepdim=True).to(x.dtype)


def mean(x: Tensor, dim: int = -1) -> Tensor:
    """``jnp.mean`` over ``dim`` (kept): the sum through fp64, rounded
    once, divided by the count in ``x``'s dtype."""
    return div_scalar(total(x, dim), x.shape[dim])


def var(x: Tensor, dim: int = -1) -> Tensor:
    """``jnp.var`` over ``dim`` (kept, biased): the mean of the squared
    deviations from ``mean(x)``, the deviations and their squares in
    ``x``'s dtype, as the reference forms them."""
    c = x - mean(x, dim)
    return mean(c * c, dim)
