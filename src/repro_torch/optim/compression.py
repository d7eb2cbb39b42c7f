"""Quantized gradient collectives with error feedback (port of
``repro.optim.compression``).

The paper cuts learner->actor weight sync to int8 (Q-Actor); the same
trick applies to the data-parallel gradient mean: ship int8 payloads
plus one fp32 scale per tensor, and keep a local error-feedback buffer
so the quantization bias does not accumulate (``e_{t+1} = g_t + e_t -
deq(q_t)``).

Two wire strategies:

* ``gather``: all-gather the int8 (int16 above 8 bits) payloads and sum
  them on each rank in slot order; the wire payload is genuinely 8-bit.
* ``psum``: quantize, then sum the codes in an int32 container (exact,
  no overflow up to 2^23 summands).

The reference names a mesh axis (``axis_name``); the port takes the
mesh whose data axes the mean runs over.  The sums are the slot-ordered
gathers of :mod:`repro_torch.distributed.sharding`, and every division
is a correctly rounded one (``core.fxp.div_scalar``), so the result is
the same on every backend and device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.fxp import div_scalar, fxp_qmax
from repro_torch.distributed.sharding import (data_axis_size, gather_slots,
                                              pmax, psum)

Tensor = torch.Tensor


def shared_codes(corr: Tensor, mesh, bits: int) -> Tuple[Tensor, Tensor]:
    """``(codes, scale)``: the slots' shared scale (the max over the
    slots of each one's absmax, over ``qmax``) and this slot's codes of
    ``corr`` on it, ``clip(round(corr / scale))`` as fp32."""
    qmax = fxp_qmax(bits)
    amax = pmax(corr.abs().max(), mesh)
    scale = div_scalar(torch.clamp_min(amax, 1e-12), qmax)
    q = torch.clamp(torch.round(corr / scale), -qmax, qmax)
    return q, scale


def compressed_psum_mean(g: Tensor, mesh, bits: int = 8,
                         error: Optional[Tensor] = None,
                         strategy: str = "gather") -> Tuple[Tensor, Tensor]:
    """Mean of ``g`` over the mesh's data slots with ``bits``-wide
    payloads: (mean fp32, new error buffer).  ``error`` is this slot's
    error-feedback buffer (zeros on step 0 when None); ``bits >= 32``
    is the exact fp32 mean."""
    n = data_axis_size(mesh)
    g32 = g.to(torch.float32)
    if bits >= 32:
        mean = div_scalar(psum(g32, mesh), float(n))
        return mean, (error if error is not None else torch.zeros_like(g32))

    if error is None:
        error = torch.zeros_like(g32)
    corr = g32 + error
    q, scale = shared_codes(corr, mesh, bits)

    if strategy == "gather":
        payload = q.to(torch.int8 if bits <= 8 else torch.int16)
        total = None
        for part in gather_slots(payload, mesh):
            part = part.to(torch.float32)
            total = part if total is None else total + part
    else:  # "psum"
        total = psum(q.to(torch.int32), mesh).to(torch.float32)

    mean = div_scalar(total * scale, float(n))
    new_error = corr - q * scale          # local residual
    return mean, new_error


def compression_ratio(bits: int, n: int, strategy: str = "gather") -> float:
    """Wire-bytes ratio against an fp32 ring all-reduce (analytic)."""
    full = 2 * 4.0 * (n - 1) / n            # reduce-scatter + all-gather
    if bits >= 32:
        return 1.0
    if strategy == "gather":
        comp = (bits / 8.0) * (n - 1)       # all-gather of full payload
    else:
        comp = 2 * 4.0 * (n - 1) / n        # int32 container: no win
    return comp / full
