"""RMSNorm / LayerNorm, fp32 statistics (port of ``repro.nn.norm``)."""
from __future__ import annotations

import torch

from repro_torch.core import exact
from repro_torch.core.fxp import div_scalar
from repro_torch.nn.module import ones_init, zeros_init

Tensor = torch.Tensor


def rmsnorm_init(gen: torch.Generator, d: int, dtype=torch.float32,
                 device="cpu"):
    return {"scale": ones_init()(gen, (d,), dtype, device)}


def rmsnorm_axes():
    """The logical axes of :func:`rmsnorm_init`'s tree."""
    return {"scale": (None,)}


def rmsnorm_apply(p, x: Tensor, eps: float = 1e-6) -> Tensor:
    """The sum of squares and the ``rsqrt`` are fp32 (through fp64, see
    ``core.exact``), as the reference's dot with
    ``preferred_element_type=f32`` forms them; the normalization
    multiplies stay in the input dtype."""
    dt = x.dtype
    ss = exact.einsum("...d,...d->...", x, x, dtype=torch.float32)[..., None]
    inv = exact.rsqrt(div_scalar(ss, x.shape[-1]) + eps)
    return x * inv.to(dt) * p["scale"].to(dt)


def layernorm_init(gen: torch.Generator, d: int, dtype=torch.float32,
                   device="cpu"):
    return {"scale": ones_init()(gen, (d,), dtype, device),
            "bias": zeros_init()(gen, (d,), dtype, device)}


def layernorm_axes():
    """The logical axes of :func:`layernorm_init`'s tree."""
    return {"scale": (None,), "bias": (None,)}


def layernorm_apply(p, x: Tensor, eps: float = 1e-5) -> Tensor:
    """The reference's program: fp32 mean and (biased) variance, the
    mean of the squared deviations as ``jnp.var`` forms it, then
    ``(xf - mu) * (var + eps) ** -0.5 * scale + bias``; the two sums
    and the power through fp64, each rounded once (``core.exact``)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = exact.mean(xf)
    var = exact.var(xf)
    out = (xf - mu) * exact.pow(var + eps, -0.5)
    return (out * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(dt)
