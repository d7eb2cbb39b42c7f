"""V-ACT wrappers: launch the Hopper kernels on a CUDA tensor, take the
plain PyTorch version on a CPU tensor.

``vact`` and ``vact_q8`` answer to ``repro.kernels.vact.ops`` on any
shape: the input is flattened (elementwise kinds) or folded to
``[rows, last axis]`` (softmax), and the kernels mask their own tails,
so nothing is padded.  ``vact`` dispatches to ``vact_ew`` (relu,
sigmoid, tanh) or ``vact_softmax``.  There is no fallback: a CUDA tensor
launches ``csrc/vact.cu`` or raises.  Each wrapper counts its launches
in a plain integer attribute (``vact_ew.launches``).

The CORDIC constants cross to the kernel already rounded to fp32 by the
same Python expressions the plain version uses (``CordicParams``), so
the card and the CPU compute with the same bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.vact import (_ATANH, _MAX_ITERS, LN2, cordic_gain,
                                   hyperbolic_schedule)
from repro_torch.kernels import _build
from repro_torch.kernels.vact import ref as _ref

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# relu, sigmoid, tanh as the kernel's template index
EW_KINDS = {"relu": 0, "sigmoid": 1, "tanh": 2}


class CordicParams(ctypes.Structure):
    """``qforce::CordicParams`` of ``csrc/cordic.cuh``, passed by value."""

    _fields_ = [("n", ctypes.c_int), ("inv_gain", ctypes.c_float),
                ("ln2", ctypes.c_float),
                ("shift", ctypes.c_float * _MAX_ITERS),
                ("atanh", ctypes.c_float * _MAX_ITERS)]


@functools.cache
def cordic_params(n_iters: int) -> CordicParams:
    """The schedule's constants as the plain version rounds them: the
    float64 value cast to fp32 (ctypes' c_float rounds to nearest)."""
    if not 1 <= n_iters <= _MAX_ITERS:
        raise ValueError(f"CORDIC takes 1..{_MAX_ITERS} iterations, got "
                         f"{n_iters}")
    sched = hyperbolic_schedule(n_iters)
    p = CordicParams()
    p.n = n_iters
    p.inv_gain = 1.0 / cordic_gain(sched)
    p.ln2 = LN2
    for k, i in enumerate(sched):
        p.shift[k] = 2.0 ** (-i)
        p.atanh[k] = _ATANH[i - 1]
    return p


@functools.cache
def _lib():
    lib = _build.load("vact")
    lib.qforce_vact_ew.argtypes = [_I, _P, _P, _P, _L, _I, CordicParams]
    lib.qforce_vact_ew_q8.argtypes = [_I, _P, _P, _P, _P, _L, _I,
                                      CordicParams]
    lib.qforce_vact_softmax.argtypes = [_I, _P, _P, _P, _I, _I,
                                        CordicParams]
    for fn in (lib.qforce_vact_ew, lib.qforce_vact_ew_q8,
               lib.qforce_vact_softmax):
        fn.restype = _I
    return lib


def _stream(dev: torch.device):
    return (dev.index if dev.index is not None else 0,
            torch.cuda.current_stream(dev).cuda_stream)


def _on_cuda(name: str, *ts: Tensor) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors that
    the kernel takes; raises on anything else."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on {sorted(map(str, devs))}")
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    return True


# ---------------------------------------------------------------------------
# plain versions: the reference's CORDIC, op by op in PyTorch
# ---------------------------------------------------------------------------

def vact_ew_plain(x: Tensor, kind: str, n_iters: int) -> Tensor:
    return _ref.vact(x.to(torch.float32), kind, n_iters)


def vact_softmax_plain(x: Tensor, n_iters: int) -> Tensor:
    return _ref.vact(x.to(torch.float32), "softmax", n_iters)


def vact_q8_plain(qx: Tensor, sx: Tensor, kind: str, n_iters: int) -> Tensor:
    return _ref.vact_q8(qx, sx.to(torch.float32).reshape(()), kind, n_iters)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def vact_ew(x: Tensor, kind: str, n_iters: int) -> Tensor:
    """Elementwise V-ACT (relu, sigmoid, tanh) by ``n_iters``-round
    CORDIC on any shape: fp32 in (cast), fp32 out."""
    if kind not in EW_KINDS:
        raise KeyError(kind)
    params = cordic_params(n_iters)
    if not _on_cuda("vact_ew", x):
        return vact_ew_plain(x, kind, n_iters)
    xc = x.to(torch.float32).contiguous()
    out = torch.empty_like(xc)
    if out.numel() == 0:
        return out
    code = _lib().qforce_vact_ew(*_stream(x.device), xc.data_ptr(),
                                 out.data_ptr(), xc.numel(),
                                 EW_KINDS[kind], params)
    _build.check(code, "vact_ew")
    vact_ew.launches += 1
    return out


def vact_softmax(x: Tensor, n_iters: int) -> Tensor:
    """Softmax over the last axis with CORDIC exp: fp32 out."""
    params = cordic_params(n_iters)
    if not _on_cuda("vact_softmax", x):
        return vact_softmax_plain(x, n_iters)
    if x.ndim == 0:
        raise ValueError("vact_softmax needs at least one axis")
    xc = x.to(torch.float32).contiguous()
    out = torch.empty_like(xc)
    if out.numel() == 0:
        return out
    n = xc.shape[-1]
    m = xc.numel() // n
    if m >= 2 ** 31:
        raise ValueError(f"vact_softmax: {m} rows exceed the int grid")
    code = _lib().qforce_vact_softmax(*_stream(x.device), xc.data_ptr(),
                                      out.data_ptr(), m, n, params)
    _build.check(code, "vact_softmax")
    vact_softmax.launches += 1
    return out


def vact(x: Tensor, kind: str, n_iters: int) -> Tensor:
    """V-ACT CORDIC activation on any-shaped fp input (softmax over the
    last axis).  fp32 compute, fp32 out, shape kept."""
    if kind == "softmax":
        return vact_softmax(x, n_iters)
    return vact_ew(x, kind, n_iters)


def vact_q8(qx: Tensor, sx: Tensor, kind: str, n_iters: int) -> Tensor:
    """Fused int8 -> int8 V-ACT activation (requantizing).

    Dtype contract: qx int8 with a per-tensor fp32 scale ``sx`` (one
    element); dequant, CORDIC ``kind`` and requant on the fixed 1/127
    grid (round half to even) in one pass; int8 out, shape kept."""
    if kind not in EW_KINDS:
        raise KeyError(kind)
    if qx.dtype != torch.int8:
        raise TypeError(f"vact_q8 takes int8, got {qx.dtype}")
    if sx.numel() != 1:
        raise ValueError(f"vact_q8 takes one per-tensor scale, got "
                         f"{tuple(sx.shape)}")
    params = cordic_params(n_iters)
    if not _on_cuda("vact_q8", qx, sx):
        return vact_q8_plain(qx, sx, kind, n_iters)
    qc = qx.contiguous()
    s = sx.to(torch.float32).reshape(1).contiguous()
    out = torch.empty_like(qc)
    if out.numel() == 0:
        return out
    code = _lib().qforce_vact_ew_q8(*_stream(qx.device), qc.data_ptr(),
                                    s.data_ptr(), out.data_ptr(),
                                    qc.numel(), EW_KINDS[kind], params)
    _build.check(code, "vact_ew_q8")
    vact_q8.launches += 1
    return out


vact_ew.launches = 0
vact_softmax.launches = 0
vact_q8.launches = 0
