"""Q-MAC wrappers: launch the Hopper kernel on a CUDA tensor, take the
plain PyTorch version on a CPU tensor.

``qmac_i8`` (int32 out) and ``qmac_i8_deq`` (fused dequant epilogue,
fp32 out) answer to ``repro.kernels.qmac.ops``.  ``qmac_i8_deq_bmm`` is
the fused product batched over an expert axis, MoE's expert FFN (the
reference's ``core.qmatmul._fwd_bmm``, an XLA product there): the same
kernel with the experts folded into its grid, one launch a product.
There is no fallback: a CUDA tensor launches ``csrc/qmac.cu`` or
raises.  Each wrapper counts its kernel launches in a plain integer
attribute (``qmac_i8.launches``) so a run can show that its path went
through the kernel.  On a ``meta`` tensor (the dry run's trace,
``launch.steps.lower_cell``) a wrapper checks its operands as on the
card and returns an empty ``meta`` output of the kernel's shape and
dtype: it launches nothing and counts nothing.  Under an op recorder
(``repro_torch.record``) each call is one record of its kernel with
``2 M N K`` integer operations (times the experts), whichever the
device.

The kernel splits K across blocks and reduces the slices inside the
same launch (see the source's note).  :func:`split_plan` picks the
split; the int32 workspace and the per-tile counters it needs are
allocated once per (device, stream) and grown when a larger shape needs
them, so a call stays one ctypes call and one launch with no PyTorch op
beside the output's ``torch.empty``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch import record
from repro_torch.kernels import _build
from repro_torch.kernels.qmac import ref as _ref

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int

# the kernel's output tile and K chunk (qmac.cu: kBM, kBN, kKC); the
# launcher refuses a workspace too small for its own tile
TILE_M, TILE_N, CHUNK_K = 32, 16, 128
# a split is worth its reduction only when the card would be empty
# without it: aim for about one block per SM of an H100 (132)
TARGET_BLOCKS = 132
# slices shorter than one 128-byte chunk cost more in the reduction than
# they save; more than 64 slices make the last block's sum the longest
# step
MIN_SLICE = CHUNK_K
MAX_SPLITS = 64
MAX_K = 131072          # |acc| <= K * 127 * 128 stays inside int32


@functools.cache
def _lib():
    fn = _build.load("qmac").qforce_qmac_i8
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                   _I, _P, ctypes.c_longlong, _P, _I]
    fn.restype = _I
    return fn


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How one product is cut: ``splits`` slices of K of ``slice`` bytes
    (the last one shorter) over ``tiles`` output tiles (of every expert
    of a batched product)."""

    splits: int
    slice: int
    tiles: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def workspace(self) -> int:
        """int32 partials the reduction needs (0 without a split)."""
        return self.blocks * TILE_M * TILE_N if self.splits > 1 else 0


@functools.lru_cache(maxsize=256)
def split_plan(m: int, k: int, n: int, batch: int = 1) -> SplitPlan:
    """Cut K so that ``batch * ceil(M/32) * ceil(N/16) * splits`` reaches
    about ``TARGET_BLOCKS``; no split where the tiles alone fill the card
    or K is shorter than two chunks.  Every slice but the last is a
    multiple of 16 bytes, so the kernel's 16-byte loads never straddle
    two.  ``batch`` experts share the grid's row axis, which holds at
    most 65535 row tiles."""
    if min(m, n, batch) < 1 or k < 0:
        raise ValueError(f"split_plan takes M, N, batch >= 1 and K >= 0, "
                         f"got {(m, k, n, batch)}")
    if batch * _cdiv(m, TILE_M) > 65535:
        raise ValueError(f"{batch} x M={m} needs more than 65535 row tiles")
    tiles = batch * _cdiv(m, TILE_M) * _cdiv(n, TILE_N)
    want = min(_cdiv(TARGET_BLOCKS, tiles), MAX_SPLITS)
    if want <= 1 or k < 2 * MIN_SLICE:
        return SplitPlan(1, k, tiles)
    sl = max(MIN_SLICE, _cdiv(_cdiv(k, want), 16) * 16)
    splits = _cdiv(k, sl)
    return SplitPlan(splits, sl if splits > 1 else k, tiles)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# (device index, stream handle) -> (int32 workspace, int32 counters)
_workspaces: dict = {}


def _workspace(dev: torch.device, stream: int, plan: SplitPlan):
    """The split's scratch on this device and stream, grown on demand.
    Counters start at 0 and every launch leaves them at 0; a second
    stream gets its own, so two launches never share a counter."""
    key = (dev.index, stream)
    ws, cnt = _workspaces.get(key, (None, None))
    if ws is None or ws.numel() < plan.workspace or cnt.numel() < plan.tiles:
        need_ws = max(plan.workspace, 0 if ws is None else ws.numel())
        need_cnt = max(plan.tiles, 0 if cnt is None else cnt.numel())
        ws = torch.empty(need_ws, dtype=torch.int32, device=dev)
        cnt = torch.zeros(need_cnt, dtype=torch.int32, device=dev)
        _workspaces[key] = (ws, cnt)
    return ws, cnt


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


def qmac_i8_deq_bmm_plain(qx: Tensor, sx: Tensor, qw: Tensor,
                          sw: Tensor) -> Tensor:
    """Expert by expert, int8 [E, C, K] x int8 [E, K, N] -> fp32 [E, C, N]
    = ``(acc * sx) * sw``, ``_fwd_bmm``'s int8 body (sx [E, C, 1], sw
    [E, 1, N])."""
    e, c, n = qx.shape[0], qx.shape[1], qw.shape[2]
    acc = torch.matmul(qx.to(torch.float64), qw.to(torch.float64)).to(
        torch.int32).to(torch.float32)
    return acc * sx.reshape(e, c, 1) * sw.reshape(e, 1, n)


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
    if qx.shape[1] > MAX_K:
        raise ValueError(f"K={qx.shape[1]} > {MAX_K} can overflow the "
                         "int32 accumulator")
    if qx.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"Q-MAC runs on cpu, cuda or meta, not "
                         f"{qx.device}")
    return qx.shape[0], qx.shape[1], qw.shape[1]


def _int_ops(qx: Tensor, qw: Tensor) -> int:
    """``2 M N K`` of ``[M, K] x [K, N]`` (``[E, C, K] x [E, K, N]``:
    times E), the integer operations a recorder charges a call."""
    return 2 * qx.numel() * qw.shape[-1]


def _check_cuda(name: str, *ts: Tensor):
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _launch(qx, qw, sx, sw, sw_stride, out, m, n, k, deq, batch=1):
    dev = qx.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = split_plan(m, k, n, batch)
    ws = cnt = None
    if plan.splits > 1:
        ws, cnt = _workspace(dev, stream, plan)
    code = _lib()(dev.index if dev.index is not None else 0, stream,
                  qx.data_ptr(), qw.data_ptr(),
                  sx.data_ptr() if sx is not None else None,
                  sw.data_ptr() if sw is not None else None, sw_stride,
                  out.data_ptr(), m, n, k, batch, deq, plan.splits,
                  plan.slice,
                  ws.data_ptr() if ws is not None else None,
                  ws.numel() if ws is not None else 0,
                  cnt.data_ptr() if cnt is not None else None,
                  cnt.numel() if cnt is not None else 0)
    _build.check(code, "qmac")


@record.kernel("qmac_i8", _int_ops)
def qmac_i8(qx: Tensor, qw: Tensor) -> Tensor:
    """Q-MAC int8 matmul: int8 [M, K] x int8 [K, N] -> int32 [M, N].

    Dtype contract: int8 operands, exact int32 accumulation, int32 out.
    """
    m, k, n = _check_operands(qx, qw)
    if qx.device.type == "meta":
        return torch.empty((m, n), dtype=torch.int32, device="meta")
    if qx.device.type == "cpu":
        return qmac_i8_plain(qx, qw)
    _check_cuda("qmac_i8", qx, qw)
    out = torch.empty((m, n), dtype=torch.int32, device=qx.device)
    if out.numel() == 0:
        return out.zero_()
    _launch(qx, qw, None, None, 0, out, m, n, k, 0)
    qmac_i8.launches += 1
    return out


@record.kernel("qmac_i8_deq", lambda qx, sx, qw, sw: _int_ops(qx, qw))
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
    if qx.device.type == "meta":
        return torch.empty((m, n), dtype=torch.float32, device="meta")
    if qx.device.type == "cpu":
        return qmac_i8_deq_plain(qx, sx, qw, sw)
    _check_cuda("qmac_i8_deq", qx, qw, sx, sw)
    out = torch.empty((m, n), dtype=torch.float32, device=qx.device)
    if out.numel() == 0:
        return out.zero_()
    _launch(qx, qw, sx, sw, 0 if sw.numel() == 1 else 1, out, m, n, k, 1)
    qmac_i8_deq.launches += 1
    return out


@record.kernel("qmac_i8_deq_bmm",
               lambda qx, sx, qw, sw: _int_ops(qx, qw))
def qmac_i8_deq_bmm(qx: Tensor, sx: Tensor, qw: Tensor,
                    sw: Tensor) -> Tensor:
    """Fused dequantizing Q-MAC over experts: for each e,
    ``(qx[e] . qw[e]) * sx[e] * sw[e]`` -> fp32 [E, C, N], one launch.

    Dtype contract: int8 qx [E, C, K] and qw [E, K, N], exact int32
    accumulation, fp32 epilogue ``(acc * sx) * sw``; sx [E, C, 1] fp32
    per-row scales, sw [E, 1, N] fp32 per-(expert, out-channel) scales.
    w4 codes ride in the int8 container.
    """
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError(f"Q-MAC takes int8 operands, got {qx.dtype} x "
                        f"{qw.dtype}")
    if qx.ndim != 3 or qw.ndim != 3 or qx.shape[0] != qw.shape[0] \
            or qx.shape[2] != qw.shape[1]:
        raise ValueError(f"batched Q-MAC takes [E, C, K] x [E, K, N], got "
                         f"{tuple(qx.shape)} x {tuple(qw.shape)}")
    e, c, k = qx.shape
    n = qw.shape[2]
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError("Q-MAC scales must be fp32")
    if sx.numel() != e * c or sw.numel() != e * n:
        raise ValueError(f"scales sx {tuple(sx.shape)} / sw "
                         f"{tuple(sw.shape)} do not fit [{e}, {c}, {n}]")
    if len({qx.device, qw.device, sx.device, sw.device}) != 1:
        raise ValueError("operands and scales must share one device")
    if k > MAX_K:
        raise ValueError(f"K={k} > {MAX_K} can overflow the int32 "
                         "accumulator")
    if qx.device.type == "meta":
        return torch.empty((e, c, n), dtype=torch.float32, device="meta")
    if qx.device.type == "cpu":
        return qmac_i8_deq_bmm_plain(qx, sx, qw, sw)
    if qx.device.type != "cuda":
        raise ValueError(f"Q-MAC runs on cpu, cuda or meta, not "
                         f"{qx.device}")
    _check_cuda("qmac_i8_deq_bmm", qx, qw, sx, sw)
    out = torch.empty((e, c, n), dtype=torch.float32, device=qx.device)
    if out.numel() == 0:
        return out.zero_()
    _launch(qx, qw, sx, sw, 1, out, c, n, k, 1, batch=e)
    qmac_i8_deq_bmm.launches += 1
    return out


qmac_i8.launches = 0
qmac_i8_deq.launches = 0
qmac_i8_deq_bmm.launches = 0

# the oracles, re-exported for tests, as the reference's ops do
ref_qmac_i8 = _ref.qmac_i8
ref_qmac_i8_deq = _ref.qmac_i8_deq
