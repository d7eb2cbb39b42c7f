"""Q-LSTM wrapper: launch the fused Hopper cell on CUDA tensors, take the
plain PyTorch version on CPU tensors.

``qlstm_cell`` answers to ``repro.kernels.qlstm.ops.qlstm_cell``: one
quantized LSTM step with int8 input/hidden codes and per-tensor scales,
int8 gate weights with per-column scales, CORDIC gates and fp32
(h', c') out.  The kernel masks the batch and hidden edges itself (the
reference pads the batch to a multiple of 8), and the reference's VMEM
budget becomes the card's shared-memory limit per block.
:func:`cell_plan` cuts the step into blocks of batch rows by hidden
units, and the launcher accepts only that plan.  There is no fallback:
a CUDA tensor launches ``csrc/qlstm.cu`` or raises, and
``qlstm_cell.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch import record
from repro_torch.core.vact import cordic_sigmoid, cordic_tanh
from repro_torch.kernels import _build
from repro_torch.kernels.qlstm import ref as _ref
from repro_torch.kernels.qmac.ops import qmac_i8_plain
from repro_torch.kernels.vact.ops import CordicParams, cordic_params

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int

# shared memory a block may use on Hopper (227 KB of the SM's 256 KB)
SMEM_BUDGET_BYTES = 232448
# a block's most batch rows and hidden units (csrc/qlstm.cu: kMaxRows,
# kMaxUnits): four lanes a (row, unit), so 8 units of one row are a warp
MAX_ROWS = 8
UNITS = 8
# about one block per SM of an H100 (132): the most rows a block while
# the grid keeps at least this many blocks
TARGET_BLOCKS = 128


def _pitch(k: int) -> int:
    """csrc/qlstm.cu's row pitch: whole words, an odd number of them."""
    return 4 * (((k + 3) // 4) | 1)


def smem_bytes(d_in: int, hidden: int, rows: int, units: int) -> int:
    """Shared memory a block takes (csrc/qlstm.cu ``Layout``): its
    units' four gate columns of the int8 stripe, transposed to
    [4 * units, Din + H], and its rows of x and h codes."""
    return (4 * units + rows) * (_pitch(d_in) + _pitch(hidden))


@dataclasses.dataclass(frozen=True)
class CellPlan:
    """One Q-LSTM launch: blocks of ``rows`` batch rows by ``units``
    hidden units over a ``row_groups`` x ``unit_groups`` grid,
    ``threads`` a block (four lanes a (row, unit)), ``smem`` bytes of
    shared memory a block."""

    rows: int
    units: int
    threads: int
    row_groups: int
    unit_groups: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.row_groups * self.unit_groups


@functools.lru_cache(maxsize=256)
def cell_plan(batch: int, d_in: int, hidden: int) -> CellPlan:
    """Cut one step over (batch-row groups) x (hidden-unit groups).

    A block takes ``min(H, UNITS)`` units and the most rows (8, 4, 2 or
    1) that keep the grid at ``TARGET_BLOCKS`` blocks or more, else one
    row.  A footprint past one block's shared memory raises a
    ValueError (the wrapper never falls back to the plain version)."""
    if batch < 1 or hidden < 1 or d_in < 0:
        raise ValueError(f"cell_plan takes B, H >= 1 and Din >= 0, got "
                         f"{(batch, d_in, hidden)}")
    units = min(hidden, UNITS)
    unit_groups = _cdiv(hidden, units)
    if unit_groups > 65535:
        raise ValueError(f"H={hidden} needs more than 65535 unit groups")
    rows = next((r for r in (MAX_ROWS, 4, 2)
                 if _cdiv(batch, r) * unit_groups >= TARGET_BLOCKS), 1)
    smem = smem_bytes(d_in, hidden, rows, units)
    if smem > SMEM_BUDGET_BYTES:
        raise ValueError(
            f"qlstm needs {smem} B of shared memory a block for "
            f"Din={d_in}, H={hidden} (> {SMEM_BUDGET_BYTES}); tile Din or "
            "fall back to qmac+vact")
    return CellPlan(rows, units, 32 * _cdiv(4 * rows * units, 32),
                    _cdiv(batch, rows), unit_groups, smem)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.cache
def _lib():
    lib = _build.load("qlstm")
    fn = lib.qforce_qlstm_cell
    fn.argtypes = [_I] + [_P] * 13 + [_I] * 7 + [CordicParams]
    fn.restype = _I
    return fn


def qlstm_cell_plain(qx, sx, qh, sh, qw, sw, qu, su, b, c, n_iters: int):
    """The fused cell, op by op: exact int32 gate products (embedded in
    fp64), the reference's epilogue order, CORDIC gates."""
    acc_x = qmac_i8_plain(qx, qw).to(torch.float32)
    acc_h = qmac_i8_plain(qh, qu).to(torch.float32)
    gates = (acc_x * sx.reshape(()) * sw.reshape(1, -1)
             + acc_h * sh.reshape(()) * su.reshape(1, -1) + b.reshape(1, -1))
    H = c.shape[-1]
    i = cordic_sigmoid(gates[:, 0 * H:1 * H], n_iters)
    f = cordic_sigmoid(gates[:, 1 * H:2 * H], n_iters)
    g = cordic_tanh(gates[:, 2 * H:3 * H], n_iters)
    o = cordic_sigmoid(gates[:, 3 * H:4 * H], n_iters)
    c_new = f * c + i * g
    return cordic_tanh(c_new, n_iters) * o, c_new


def _int_ops(qx, sx, qh, sh, qw, sw, qu, su, *_, **__) -> int:
    """``2 B (Din + H) 4H``, the integer operations a recorder charges a
    call."""
    return 2 * (qx.shape[0] * qw.numel() + qh.shape[0] * qu.numel())


@record.kernel("qlstm_cell", _int_ops)
def qlstm_cell(qx, sx, qh, sh, qw, sw, qu, su, b, c, *,
               n_iters: int = 13):
    """Fused quantized LSTM cell step (one timestep).

    Dtype contract: int8 input/hidden (qx [B, Din], qh [B, H]) with
    per-tensor fp32 scales (one element each), int8 gate weights
    (qw [Din, 4H], qu [H, 4H]) with per-column fp32 scales (4H each),
    fp32 bias b [4H] and cell state c [B, H]; int32 MACs, CORDIC gate
    nonlinearities (``n_iters`` rounds), fp32 (h', c') out.  A block's
    share of the stripe (:func:`cell_plan`) must fit its shared memory
    (checked).
    """
    if any(t.dtype != torch.int8 for t in (qx, qh, qw, qu)):
        raise TypeError("qlstm_cell takes int8 qx, qh, qw, qu")
    if qx.ndim != 2 or c.ndim != 2:
        raise ValueError(f"qlstm_cell takes qx [B, Din] and c [B, H], got "
                         f"{tuple(qx.shape)} and {tuple(c.shape)}")
    B, Din = qx.shape
    H = c.shape[-1]
    if (tuple(qh.shape) != (B, H) or tuple(qw.shape) != (Din, 4 * H)
            or tuple(qu.shape) != (H, 4 * H) or c.shape[0] != B):
        raise ValueError(
            f"qlstm_cell shapes do not fit B={B}, Din={Din}, H={H}: qh "
            f"{tuple(qh.shape)}, qw {tuple(qw.shape)}, qu {tuple(qu.shape)}")
    if sx.numel() != 1 or sh.numel() != 1:
        raise ValueError("sx and sh are per-tensor scales (one element)")
    if sw.numel() != 4 * H or su.numel() != 4 * H or b.numel() != 4 * H:
        raise ValueError(f"sw, su and b need 4H={4 * H} elements")
    plan = cell_plan(B, Din, H) if B and H else None
    params = cordic_params(n_iters)
    ts = (qx, sx, qh, sh, qw, sw, qu, su, b, c)
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"qlstm_cell operands on {sorted(map(str, devs))}")
    dev = qx.device
    f32 = [t.to(torch.float32) for t in (sx, sh, sw, su, b, c)]
    if dev.type == "cpu":
        fsx, fsh, fsw, fsu, fb, fc = f32
        return qlstm_cell_plain(qx, fsx, qh, fsh, qw, fsw, qu, fsu, fb, fc,
                                n_iters)
    if dev.type != "cuda":
        raise ValueError(f"qlstm_cell runs on cpu or cuda, not {dev}")
    fsx, fsh, fsw, fsu, fb, fc = (t.contiguous() for t in f32)
    for t in (qx, qh, qw, qu):
        if not t.is_contiguous():
            raise ValueError("qlstm_cell: operands must be contiguous")
    h_out = torch.empty((B, H), dtype=torch.float32, device=dev)
    c_out = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B == 0 or H == 0:
        return h_out, c_out
    code = _lib()(dev.index if dev.index is not None else 0,
                  torch.cuda.current_stream(dev).cuda_stream,
                  qx.data_ptr(), fsx.data_ptr(), qh.data_ptr(),
                  fsh.data_ptr(), qw.data_ptr(), fsw.data_ptr(),
                  qu.data_ptr(), fsu.data_ptr(), fb.data_ptr(),
                  fc.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
                  B, Din, H, plan.rows, plan.units, plan.threads, plan.smem,
                  params)
    _build.check(code, "qlstm")
    qlstm_cell.launches += 1
    return h_out, c_out


qlstm_cell.launches = 0

# the oracles, re-exported for tests, as the reference's ops do
ref_qlstm_cell = _ref.qlstm_cell
