"""Tree-level PTQ of parameter trees (port of ``repro.core.quantizer``)."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.fxp import (QTensor, div_scalar, fxp_dtype,
                                  fxp_qmax, is_qtensor, quantize)
from repro_torch.core.policy import QuantPolicy
from repro_torch.tree import leaves_with_path, map_with_path

# parameter leaf names that hold matmul weights (nn/ layers call their
# matmul weights "w" and their embedding tables "emb")
_WEIGHT_KEYS = ("w", "w_in", "w_out", "w_gate", "w_up", "w_down",
                "wq", "wk", "wv", "wo", "w_x", "w_h", "emb")


def default_weight_predicate(path, leaf) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    return bool(path) and str(path[-1]) in _WEIGHT_KEYS


def quantize_params(params, policy: QuantPolicy,
                    predicate: Optional[Callable] = None):
    """PTQ: replace matmul weights with QTensors (int payload + scales).

    Per-channel scales sit on the last axis.  Exactly-3D stacked weights
    ``[L, in, out]`` keep a scale per (layer, channel); 4D conv kernels
    (HWIO) take the plain per-out-channel branch, the grid the conv
    forward's fake-quant uses, so packed conv weights dequantize
    bit-identically to the evaluation grid.
    """
    if predicate is None:
        predicate = default_weight_predicate
    if not policy.quantized_w:
        return params
    bits = policy.w_bits

    def convert(path, leaf):
        if not predicate(path, leaf):
            return leaf
        if policy.per_channel and leaf.ndim == 3:
            amax = leaf.abs().amax(dim=-2, keepdim=True)
            scale = div_scalar(torch.clamp_min(amax, 1e-12),
                               fxp_qmax(bits))
            q = torch.clamp(torch.round(leaf / scale), -fxp_qmax(bits),
                            fxp_qmax(bits)).to(fxp_dtype(bits))
            return QTensor(q, scale, bits)
        ch = (leaf.ndim - 1) if policy.per_channel else None
        q, s = quantize(leaf, bits, channel_axis=ch)
        return QTensor(q, s, bits)

    return map_with_path(convert, params,
                         is_leaf=is_qtensor)


def dequantize_params(params):
    """Inverse of quantize_params (lossy)."""
    return map_with_path(
        lambda _p, l: l.deq() if isinstance(l, QTensor) else l, params,
        is_leaf=is_qtensor)


def quantized_nbytes(params) -> Tuple[int, int]:
    """(bytes as stored, bytes if everything were fp32).

    Sub-byte aware: a QTensor narrower than its int container counts at
    its packed width (two int4 codes per byte, see ``pack_nibbles``).
    """
    stored = 0
    fp32 = 0
    for _, leaf in leaves_with_path(
            params, is_leaf=is_qtensor):
        if isinstance(leaf, QTensor):
            container_bits = leaf.qvalue.element_size() * 8
            payload_bits = min(int(leaf.bits), container_bits)
            stored += (leaf.qvalue.numel() * payload_bits + 7) // 8
            stored += leaf.scale.numel() * leaf.scale.element_size()
            fp32 += leaf.qvalue.numel() * 4
        else:
            stored += leaf.numel() * leaf.element_size()
            fp32 += leaf.numel() * 4
    return stored, fp32


class EmaCalibrator:
    """Running abs-max EMA for static activation scales (QAT helper):
    the first update takes the abs-max, later ones
    ``momentum * state + (1 - momentum) * amax``."""

    def __init__(self, momentum: float = 0.99):
        self.momentum = momentum

    def init(self, device="cpu") -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=device)

    def update(self, state: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        amax = torch.abs(x).amax()
        return torch.where(state == 0, amax,
                           self.momentum * state
                           + (1 - self.momentum) * amax)
