"""Q-MAC wrappers: launch the Hopper kernel on a CUDA tensor, take the
plain PyTorch version on a CPU tensor.

``qmac_i8`` (int32 out) and ``qmac_i8_deq`` (fused dequant epilogue,
fp32 out) answer to ``repro.kernels.qmac.ops``.  There is no fallback:
a CUDA tensor launches ``csrc/qmac.cu`` or raises.  Each wrapper counts
its kernel launches in a plain integer attribute (``qmac_i8.launches``)
so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("qmac")
    fn = lib.qforce_qmac_i8
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I]
    fn.restype = _I
    return fn


# ---------------------------------------------------------------------------
# plain versions: the same integer program in PyTorch.  torch's CUDA
# matmul has no int32 kernel, so the integer dot is embedded in fp64,
# which holds every int8 product and every partial sum exactly
# (|acc| <= K*127*128 < 2^53), on the CPU and on the card alike.
# ---------------------------------------------------------------------------

def qmac_i8_plain(qx: Tensor, qw: Tensor) -> Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N], exact."""
    return torch.matmul(qx.to(torch.float64),
                        qw.to(torch.float64)).to(torch.int32)


def qmac_i8_deq_plain(qx: Tensor, sx: Tensor, qw: Tensor,
                      sw: Tensor) -> Tensor:
    """(qx . qw) * sx * sw -> fp32, rounded in the reference's order."""
    acc = qmac_i8_plain(qx, qw).to(torch.float32)
    return acc * sx.reshape(-1, 1) * sw.reshape(1, -1)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_operands(qx: Tensor, qw: Tensor):
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError(f"Q-MAC takes int8 operands, got {qx.dtype} x "
                        f"{qw.dtype}")
    if qx.ndim != 2 or qw.ndim != 2 or qx.shape[1] != qw.shape[0]:
        raise ValueError(f"Q-MAC takes [M, K] x [K, N], got "
                         f"{tuple(qx.shape)} x {tuple(qw.shape)}")
    if qx.device != qw.device:
        raise ValueError(f"operands on {qx.device} and {qw.device}")
    if qx.shape[1] > 131072:
        raise ValueError(f"K={qx.shape[1]} > 131072 can overflow the "
                         "int32 accumulator")
    if qx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"Q-MAC runs on cpu or cuda, not {qx.device}")
    return qx.shape[0], qx.shape[1], qw.shape[1]


def _check_cuda(name: str, *ts: Tensor):
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _launch(qx, qw, sx, sw, sw_stride, out, m, n, k, deq):
    dev = qx.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _lib()(dev.index if dev.index is not None else 0, stream,
                  qx.data_ptr(), qw.data_ptr(),
                  sx.data_ptr() if sx is not None else None,
                  sw.data_ptr() if sw is not None else None, sw_stride,
                  out.data_ptr(), m, n, k, deq)
    _build.check(code, "qmac")


def qmac_i8(qx: Tensor, qw: Tensor) -> Tensor:
    """Q-MAC int8 matmul: int8 [M, K] x int8 [K, N] -> int32 [M, N].

    Dtype contract: int8 operands, exact int32 accumulation, int32 out.
    """
    m, k, n = _check_operands(qx, qw)
    if qx.device.type == "cpu":
        return qmac_i8_plain(qx, qw)
    _check_cuda("qmac_i8", qx, qw)
    out = torch.empty((m, n), dtype=torch.int32, device=qx.device)
    if out.numel() == 0:
        return out.zero_()
    _launch(qx, qw, None, None, 0, out, m, n, k, 0)
    qmac_i8.launches += 1
    return out


def qmac_i8_deq(qx: Tensor, sx: Tensor, qw: Tensor, sw: Tensor) -> Tensor:
    """Fused dequantizing Q-MAC: (qx . qw) * sx * sw -> fp32 [M, N].

    Dtype contract: int8 operands, int32 accumulation, fp32 epilogue
    ``(acc * sx) * sw``.  sx: [M, 1] (or [M]) fp32 per-row scales; sw:
    fp32 with N per-channel scales or one per-tensor scale.
    """
    m, k, n = _check_operands(qx, qw)
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError("Q-MAC scales must be fp32")
    if sx.numel() != m or sw.numel() not in (1, n):
        raise ValueError(f"scales sx {tuple(sx.shape)} / sw "
                         f"{tuple(sw.shape)} do not fit [{m}, {n}]")
    if sx.device != qx.device or sw.device != qx.device:
        raise ValueError("scales must live on the operands' device")
    if qx.device.type == "cpu":
        return qmac_i8_deq_plain(qx, sx, qw, sw)
    _check_cuda("qmac_i8_deq", qx, qw, sx, sw)
    out = torch.empty((m, n), dtype=torch.float32, device=qx.device)
    if out.numel() == 0:
        return out.zero_()
    _launch(qx, qw, sx, sw, 0 if sw.numel() == 1 else 1, out, m, n, k, 1)
    qmac_i8_deq.launches += 1
    return out


qmac_i8.launches = 0
qmac_i8_deq.launches = 0
