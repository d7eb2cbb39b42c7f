"""Oracle for the Q-MAC kernel (port of ``repro.kernels.qmac.ref``).

Computes the contraction a different way from the plain version in
``ops.py`` (broadcast-multiply and sum in int64 instead of an fp64
matmul); both are exact, so they must agree bit for bit.  Meant for
test-sized operands: it materializes ``[M, K, N]``.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def qmac_i8(qx: Tensor, qw: Tensor) -> Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N] oracle."""
    prod = qx.to(torch.int64)[:, :, None] * qw.to(torch.int64)[None]
    return prod.sum(dim=1).to(torch.int32)


def qmac_i8_deq(qx: Tensor, sx: Tensor, qw: Tensor, sw: Tensor) -> Tensor:
    """Fused dequantize oracle: (qx . qw) * sx * sw -> fp32.

    sx: [M, 1] per-row scales; sw: [1, N] (or [1, 1]) per-channel scales.
    """
    return qmac_i8(qx, qw).to(torch.float32) * sx * sw


def qmac_i8_deq_bmm(qx: Tensor, sx: Tensor, qw: Tensor,
                    sw: Tensor) -> Tensor:
    """Batched fused oracle, expert by expert: [E, C, K] x [E, K, N] ->
    fp32 [E, C, N] (sx [E, C, 1], sw [E, 1, N])."""
    return torch.stack([qmac_i8_deq(qx[i], sx[i], qw[i], sw[i])
                        for i in range(qx.shape[0])])
