"""Q-Conv wrapper: launch the Hopper implicit-GEMM kernel on a CUDA
tensor, take the plain PyTorch version on a CPU tensor.

``qconv2d_i8`` answers to ``repro.kernels.qconv.ops.qconv2d_i8``: the
same integer program (per-pixel int8 activations against per-out-channel
int8 filters, exact int32 channel dots, fp32 tap carry in kh-major
order, fused ``* sw + b`` and optional ReLU).  There is no fallback: a
CUDA tensor launches ``csrc/qconv.cu`` or raises, and
``qconv2d_i8.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.qconv.ref import same_pads, valid_out

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("qconv")
    fn = lib.qforce_qconv_i8
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _I, _P, _P] + [_I] * 13
    fn.restype = _I
    return fn


def out_geometry(h: int, w: int, kh: int, kw: int, stride: int,
                 padding: str):
    """(Ho, Wo, pad_top, pad_bottom, pad_left, pad_right)."""
    if padding == "SAME":
        ho, (pt, pb) = same_pads(h, kh, stride)
        wo, (plf, prt) = same_pads(w, kw, stride)
        return ho, wo, pt, pb, plf, prt
    if padding == "VALID":
        return valid_out(h, kh, stride), valid_out(w, kw, stride), 0, 0, 0, 0
    raise ValueError(f"unsupported padding {padding!r}")


def qconv2d_i8_plain(qx: Tensor, sx: Tensor, qw: Tensor, sw: Tensor,
                     b: Tensor, *, stride: int = 1, padding: str = "SAME",
                     fuse_relu: bool = False) -> Tensor:
    """The kernel's integer program in PyTorch, tap by tap.

    Each tap's channel dot is an fp64 matmul (exact for any C an int32
    accumulator allows), rounded to fp32 as the kernel's int->float
    conversion rounds; the tap carry is a separate multiply and add, so
    no fused multiply-add changes a bit."""
    bsz, h, w, c = qx.shape
    kh, kw, _, n = qw.shape
    ho, wo, pt, pb, plf, prt = out_geometry(h, w, kh, kw, stride, padding)
    qxp = F.pad(qx, (0, 0, plf, prt, pt, pb))
    sxp = F.pad(sx.to(torch.float32), (0, 0, plf, prt, pt, pb))
    wt = qw.to(torch.float64).reshape(kh * kw, c, n)
    acc = torch.zeros((bsz, ho, wo, n), dtype=torch.float32,
                      device=qx.device)
    for di in range(kh):
        for dj in range(kw):
            rows = slice(di, di + (ho - 1) * stride + 1, stride)
            cols = slice(dj, dj + (wo - 1) * stride + 1, stride)
            xt = qxp[:, rows, cols, :].to(torch.float64)
            d = torch.matmul(xt, wt[di * kw + dj]).to(torch.float32)
            acc = torch.add(acc, torch.mul(d, sxp[:, rows, cols, :]))
    out = torch.add(torch.mul(acc, sw.to(torch.float32).reshape(1, 1, 1, -1)),
                    b.to(torch.float32).reshape(1, 1, 1, -1))
    return torch.clamp_min(out, 0.0) if fuse_relu else out


def qconv2d_i8(qx: Tensor, sx: Tensor, qw: Tensor, sw: Tensor, b: Tensor,
               *, stride: int = 1, padding: str = "SAME",
               fuse_relu: bool = False) -> Tensor:
    """Integer Q-Conv with fused dequant + bias (+ ReLU) epilogue.

    Dtype contract: int8 operands, exact int32 channel accumulation,
    fp32 output.  Shapes:

      qx [B, H, W, C] int8      per-pixel quantized activations (NHWC)
      sx [B, H, W, 1] fp32      their per-pixel (rowwise) scales
      qw [KH, KW, C, N] int8    per-out-channel quantized filters (HWIO)
      sw fp32, size 1 or N      the weight scales
      b  [N] fp32               bias
      -> [B, H', W', N] fp32

    ``padding`` is "SAME" (TF-style, asymmetric for stride 2) or "VALID".
    """
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError(f"Q-Conv takes int8 operands, got {qx.dtype} / "
                        f"{qw.dtype}")
    if qx.ndim != 4 or qw.ndim != 4 or qx.shape[3] != qw.shape[2]:
        raise ValueError(f"Q-Conv takes NHWC x HWIO, got "
                         f"{tuple(qx.shape)} x {tuple(qw.shape)}")
    bsz, h, w, c = qx.shape
    kh, kw, _, n = qw.shape
    if tuple(sx.shape) != (bsz, h, w, 1) or sx.dtype != torch.float32:
        raise ValueError(f"sx must be fp32 [{bsz}, {h}, {w}, 1], got "
                         f"{sx.dtype} {tuple(sx.shape)}")
    if sw.numel() not in (1, n) or b.numel() != n:
        raise ValueError(f"sw {tuple(sw.shape)} / b {tuple(b.shape)} do "
                         f"not fit N={n}")
    if any(t.device != qx.device for t in (sx, qw, sw, b)):
        raise ValueError("Q-Conv operands must share one device")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    ho, wo, pt, _, plf, _ = out_geometry(h, w, kh, kw, stride, padding)
    if qx.device.type == "cpu":
        return qconv2d_i8_plain(qx, sx, qw, sw, b, stride=stride,
                                padding=padding, fuse_relu=fuse_relu)
    if qx.device.type != "cuda":
        raise ValueError(f"Q-Conv runs on cpu or cuda, not {qx.device}")
    sw = sw.to(torch.float32).reshape(-1)
    b = b.to(torch.float32).reshape(-1)
    for t in (qx, sx, qw, sw, b):
        if not t.is_contiguous():
            raise ValueError("qconv2d_i8: operands must be contiguous")
    out = torch.empty((bsz, ho, wo, n), dtype=torch.float32,
                      device=qx.device)
    if out.numel() == 0:
        return out
    dev = qx.device
    code = _lib()(dev.index if dev.index is not None else 0,
                  torch.cuda.current_stream(dev).cuda_stream,
                  qx.data_ptr(), sx.data_ptr(), qw.data_ptr(),
                  sw.data_ptr(), 0 if sw.numel() == 1 else 1, b.data_ptr(),
                  out.data_ptr(), bsz, h, w, c, kh, kw, n, stride, pt, plf,
                  ho, wo, int(fuse_relu))
    _build.check(code, "qconv")
    qconv2d_i8.launches += 1
    return out


qconv2d_i8.launches = 0
