"""Oracle for the fused Q-LSTM cell (port of ``repro.kernels.qlstm.ref``).

Computes the two integer gate products by broadcast-multiply and sum in
int64 (the plain version in ``ops.py`` embeds them in an fp64 matmul);
both are exact, so the two agree bit for bit.  Meant for test-sized
operands: it materializes ``[B, K, 4H]``.
"""
from __future__ import annotations

import torch

from repro_torch.core.vact import cordic_sigmoid, cordic_tanh

Tensor = torch.Tensor


def _dot_i32(q: Tensor, w: Tensor) -> Tensor:
    prod = q.to(torch.int64)[:, :, None] * w.to(torch.int64)[None]
    return prod.sum(dim=1).to(torch.int32)


def qlstm_cell(qx, sx, qh, sh, qw, sw, qu, su, b, c, n_iters: int):
    """One quantized LSTM step (paper Sec. III: Q-LSTM block).

    qx:[B,Din]i8  qh:[B,H]i8  qw:[Din,4H]i8  qu:[H,4H]i8
    sx/sh: scalars; sw/su: [1,4H] per-channel; b: [4H]; c: [B,H] fp32.
    Gate order i|f|g|o.  Returns (h', c') fp32.
    """
    acc_x = _dot_i32(qx, qw)
    acc_h = _dot_i32(qh, qu)
    gates = (acc_x.to(torch.float32) * sx * sw
             + acc_h.to(torch.float32) * sh * su + b)
    H = c.shape[-1]
    i = cordic_sigmoid(gates[:, 0 * H:1 * H], n_iters)
    f = cordic_sigmoid(gates[:, 1 * H:2 * H], n_iters)
    g = cordic_tanh(gates[:, 2 * H:3 * H], n_iters)
    o = cordic_sigmoid(gates[:, 3 * H:4 * H], n_iters)
    c_new = f * c + i * g
    h_new = cordic_tanh(c_new, n_iters) * o
    return h_new, c_new
