"""Q-LSTM layer: quantized gate products + V-ACT activations (port of
``repro.nn.lstm``, forward only).

Three execution paths, as in the reference:
  * policy backend "ref"/"xla": ``q_matmul`` gates + ``activation``,
  * policy backend "pallas" at 8/8 bits: the fused Q-LSTM cell
    (``repro_torch.kernels.qlstm``: the Hopper kernel on a CUDA tensor,
    its plain version on a CPU tensor) with per-tensor activation
    scales,
  * fp32 policy: plain LSTM (the E2HRL FxP32 baseline).

The two quantized branches are different programs (per-row against
per-tensor activation scales), as they are in the reference.  The fused
branch quantizes fp weights itself and, like the reference, refuses
packed ``QTensor`` weights with a ``TypeError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.fxp import QTensor, quantize
from repro_torch.core.policy import QuantPolicy, cordic_iterations
from repro_torch.core.qmatmul import q_matmul, quantize_rowwise
from repro_torch.core.vact import activation
from repro_torch.kernels.qlstm import ops as qlstm_ops
from repro_torch.nn.module import lecun_init, zeros_init

Tensor = torch.Tensor


def lstm_init(gen: torch.Generator, d_in: int, d_hidden: int,
              dtype=torch.float32, device="cpu"):
    """``{"w_x": [d_in, 4H], "w_h": [H, 4H], "b": [4H]}``, gates i|f|g|o."""
    return {
        "w_x": lecun_init()(gen, (d_in, 4 * d_hidden), dtype, device),
        "w_h": lecun_init()(gen, (d_hidden, 4 * d_hidden), dtype, device),
        "b": zeros_init()(gen, (4 * d_hidden,), dtype, device),
    }


def _fused_cell(p, x: Tensor, h: Tensor, c: Tensor, policy: QuantPolicy):
    """The reference's pallas branch: per-tensor activation codes on the
    grid of the largest per-row scale, per-column weight codes."""
    if isinstance(p["w_x"], QTensor) or isinstance(p["w_h"], QTensor):
        raise TypeError(
            "the fused Q-LSTM cell quantizes fp weights itself; packed "
            "QTensor weights are refused, as the reference refuses them")
    _, sx_arr = quantize_rowwise(x, 8)
    _, sh_arr = quantize_rowwise(h, 8)
    sx = torch.amax(sx_arr)
    sh = torch.amax(sh_arr)
    qx = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    qh = torch.clamp(torch.round(h / sh), -127, 127).to(torch.int8)
    qw, sw = quantize(p["w_x"], 8, channel_axis=1)
    qu, su = quantize(p["w_h"], 8, channel_axis=1)
    return qlstm_ops.qlstm_cell(
        qx.contiguous(), sx, qh.contiguous(), sh, qw.contiguous(),
        sw.reshape(1, -1), qu.contiguous(), su.reshape(1, -1), p["b"], c,
        n_iters=cordic_iterations(policy))


def lstm_cell(p, x: Tensor, h: Tensor, c: Tensor,
              policy: Optional[QuantPolicy] = None):
    """One step.  x: [B, Din]; h, c: [B, H] -> (h', c')."""
    H = h.shape[-1]
    if (policy is not None and policy.backend == "pallas"
            and policy.w_bits == 8 and policy.a_bits == 8):
        return _fused_cell(p, x, h, c, policy)
    gates = (q_matmul(x, p["w_x"], policy)
             + q_matmul(h, p["w_h"], policy) + p["b"])
    i = activation(gates[..., 0 * H:1 * H], "sigmoid", policy)
    f = activation(gates[..., 1 * H:2 * H], "sigmoid", policy)
    g = activation(gates[..., 2 * H:3 * H], "tanh", policy)
    o = activation(gates[..., 3 * H:4 * H], "sigmoid", policy)
    c_new = f * c + i * g
    h_new = activation(c_new, "tanh", policy) * o
    return h_new, c_new


def lstm_apply(p, xs: Tensor, policy: Optional[QuantPolicy] = None,
               state: Optional[Tuple[Tensor, Tensor]] = None):
    """xs: [B, S, Din] -> (hs [B, S, H], (h_T, c_T)).  A Python loop over
    S takes the place of the reference's ``lax.scan``."""
    B, S, _ = xs.shape
    H = p["b"].shape[-1] // 4
    if state is None:
        h = torch.zeros((B, H), dtype=xs.dtype, device=xs.device)
        c = torch.zeros((B, H), dtype=torch.float32, device=xs.device)
    else:
        h, c = state
    hs = []
    for t in range(S):
        h, c = lstm_cell(p, xs[:, t], h, c, policy)
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c)
