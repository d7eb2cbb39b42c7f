"""Quantized 2D convolution, the RL agent's vision stem, and the
depthwise causal 1D convolution of the ssm and hybrid LMs (port of
``repro.nn.conv``).

At <= 8-bit activations and weights the conv runs as the integer Q-Conv
program (``repro_torch.kernels.qconv``): per-pixel int8 activations on
``fake_quant_rowwise``'s grid against per-out-channel int8 filters on
``fake_quant(..., channel_axis=3)``'s grid, with a fused dequant + bias
(+ ReLU) epilogue.  Packed ``QTensor`` weights go straight to the
kernel; fp weights are quantized first, onto the same grid, so serving
and evaluation agree bit for bit.  Wider policies fall back to
fake-quantized operands on an fp32 convolution.

The causal conv is a 4-tap fp32 product on the (dequantized) weight,
as in the reference; its tap sums run through fp64 and round once
(``core.exact``), so the card and the CPU agree bit for bit.

The integer conv with fp weights differentiates as the reference's
``_qconv`` does: the backward is the fp convolution's VJP at the
dequantized operands the integer program saw (plain PyTorch).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import exact
from repro_torch.core.fxp import QTensor, as_dense, dequantize, \
    fake_quant, fake_quant_rowwise, quantize
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qmatmul import quantize_rowwise
from repro_torch.core.vact import activation
from repro_torch.kernels.qconv import ops as qconv_ops
from repro_torch.nn.module import he_init, zeros_init


def conv2d_init(gen: torch.Generator, c_in: int, c_out: int, kernel: int,
                dtype=torch.float32, device="cpu"):
    """``{"w": [k, k, c_in, c_out] (HWIO), "b": [c_out]}``."""
    return {
        "w": he_init()(gen, (kernel, kernel, c_in, c_out), dtype, device),
        "b": zeros_init()(gen, (c_out,), dtype, device),
    }


def _raw_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
              padding: str) -> torch.Tensor:
    """fp NHWC/HWIO convolution with TF-style padding: SAME pads are
    applied explicitly because they are asymmetric for stride 2
    (32 -> 16 pads (0, 1)), which ``F.conv2d(padding=...)`` cannot say."""
    kh, kw = w.shape[0], w.shape[1]
    _, _, pt, pb, plf, prt = qconv_ops.out_geometry(
        x.shape[1], x.shape[2], kh, kw, stride, padding)
    xn = F.pad(x.permute(0, 3, 1, 2), (plf, prt, pt, pb))
    out = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride, padding=0)
    return out.permute(0, 2, 3, 1)


def _use_integer_conv(policy: Optional[QuantPolicy], w) -> bool:
    """True when the conv can run as the integer program: quantized
    activations at <= 8 bits against int8-representable weights, on a
    backend with an integer lowering (``ref`` keeps fake-quant)."""
    if policy is None or not policy.quantized_a or policy.a_bits > 8:
        return False
    if policy.backend not in ("xla", "pallas"):
        return False
    if isinstance(w, QTensor):
        return w.bits <= 8
    return policy.quantized_w and policy.w_bits <= 8


def _qconv_fwd(policy: QuantPolicy, stride: int, padding: str,
               fuse_relu: bool, x, w, b):
    """The integer conv with fp weights, quantized onto the grids the
    packed serving path uses.  Returns the output and the quantized
    operands with their scales (the STE's residuals, dequantized only
    if a backward runs)."""
    qw, sw = quantize(w, policy.w_bits, channel_axis=3)
    qx, sx = quantize_rowwise(x, policy.a_bits)
    out = qconv_ops.qconv2d_i8(
        qx.contiguous(), sx.contiguous(), qw.contiguous(), sw.reshape(-1),
        b.to(torch.float32), stride=stride, padding=padding,
        fuse_relu=fuse_relu)
    return out, (qx, sx, qw, sw)


class _QConv(torch.autograd.Function):
    """The integer conv forward; the backward is the VJP of the fp conv
    (+ bias, + ReLU) at the dequantized operands."""

    @staticmethod
    def forward(ctx, policy, stride, padding, fuse_relu, x, w, b):
        out, (qx, sx, qw, sw) = _qconv_fwd(policy, stride, padding,
                                           fuse_relu, x, w, b)
        ctx.conf = (stride, padding, fuse_relu, x.dtype, w.dtype)
        ctx.save_for_backward(qx, sx, qw, sw, b)
        return out

    @staticmethod
    def backward(ctx, g):
        qx, sx, qw, sw, b = ctx.saved_tensors
        stride, padding, fuse_relu, x_dtype, w_dtype = ctx.conf
        x_dq, w_dq = dequantize(qx, sx, x_dtype), dequantize(qw, sw, w_dtype)
        with torch.enable_grad():
            xr = x_dq.to(torch.float32).detach().requires_grad_()
            wr = w_dq.to(torch.float32).detach().requires_grad_()
            out = _raw_conv(xr, wr, stride, padding)
            g = g.to(torch.float32)
            if fuse_relu:
                # jnp.maximum's derivative: 1 above, 1/2 at a tie, 0 below
                z = out.detach() + b.to(torch.float32)
                g = g * ((z > 0).to(g.dtype) + 0.5 * (z == 0).to(g.dtype))
            dx, dw = torch.autograd.grad(out, (xr, wr), g)
        db = g.sum(dim=(0, 1, 2))
        return (None, None, None, None, dx.to(x_dtype), dw.to(w_dtype),
                db.to(b.dtype))


def conv2d_apply(p, x: torch.Tensor, *, stride: int = 1,
                 padding: str = "SAME",
                 policy: Optional[QuantPolicy] = None,
                 fuse_relu: bool = False) -> torch.Tensor:
    """x: [B, H, W, C] -> [B, H', W', C']."""
    if _use_integer_conv(policy, p["w"]):
        if isinstance(p["w"], QTensor):
            qx, sx = quantize_rowwise(x, policy.a_bits)
            return qconv_ops.qconv2d_i8(
                qx.contiguous(), sx.contiguous(), p["w"].qvalue.contiguous(),
                p["w"].scale.reshape(-1), p["b"].to(torch.float32),
                stride=stride, padding=padding, fuse_relu=fuse_relu)
        return _QConv.apply(policy, stride, padding, fuse_relu, x,
                            as_dense(p["w"]), p["b"])
    w = as_dense(p["w"])
    if policy is not None and policy.quantized_w \
            and not isinstance(p["w"], QTensor):
        w = fake_quant(w, policy.w_bits, channel_axis=3)
    if policy is not None and policy.quantized_a:
        x = fake_quant_rowwise(x, policy.a_bits)
    cdt = policy.compute_dtype if policy else torch.float32
    out = _raw_conv(x.to(cdt), w.to(cdt), stride, padding)
    out = out + p["b"].to(out.dtype)
    return torch.clamp_min(out, 0.0) if fuse_relu else out


def qconv_block(p, x: torch.Tensor, *, stride: int = 2,
                policy: Optional[QuantPolicy] = None) -> torch.Tensor:
    """The paper's Q-Conv block: stride-2 conv (replaces pooling) + ReLU.

    On the integer path the ReLU rides in the kernel epilogue and only
    the requantization runs outside; elsewhere the ReLU goes through
    ``activation``.  Both orders give the same values elementwise."""
    if _use_integer_conv(policy, p["w"]):
        out = conv2d_apply(p, x, stride=stride, policy=policy,
                           fuse_relu=True)
        return activation(out, "identity", policy)
    return activation(conv2d_apply(p, x, stride=stride, policy=policy),
                      "relu", policy)


def causal_conv1d_init(gen: torch.Generator, channels: int, width: int = 4,
                       dtype=torch.float32, device="cpu"):
    """``{"w": [width, channels], "b": [channels]}`` (depthwise taps)."""
    return {
        "w": he_init()(gen, (width, channels), dtype, device),
        "b": zeros_init()(gen, (channels,), dtype, device),
    }


def causal_conv1d_axes():
    """The logical axes of :func:`causal_conv1d_init`'s tree."""
    return {"w": (None, "d_inner"), "b": ("d_inner",)}


def causal_conv1d_apply(p, x: torch.Tensor, state=None):
    """Depthwise causal conv.  x: [B, S, C].

    With ``state`` ([B, width-1, C], the trailing inputs) this performs
    one decode step (S == 1) and returns (out, new_state).  Each output
    is the fp32 sum of its ``width`` taps (through fp64, rounded once)
    plus the bias in fp32."""
    w, b = as_dense(p["w"]), p["b"]
    width = w.shape[0]
    wf = w.to(torch.float32)
    if state is not None:
        dt = torch.promote_types(state.dtype, x.dtype)
        window = torch.cat([state.to(dt), x.to(dt)], dim=1)  # [B, width, C]
        out = exact.einsum("bwc,wc->bc", window.to(torch.float32), wf) + b
        return out[:, None, :].to(x.dtype), window[:, 1:]
    pad = F.pad(x, (0, 0, width - 1, 0))
    taps = pad.to(torch.float32).unfold(1, width, 1)      # [B, S, C, width]
    out = exact.einsum("bscw,wc->bsc", taps, wf)
    return (out + b).to(x.dtype)
