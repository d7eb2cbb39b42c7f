"""V-ACT wrappers: launch the Hopper kernels on a CUDA tensor, take the
plain PyTorch version on a CPU tensor.

``vact`` and ``vact_q8`` answer to ``repro.kernels.vact.ops`` on any
shape: the input is flattened (``vact_q8``) or read in place as strided
``[rows, last axis]`` rows (``vact_ew``: see :func:`ew_operand`;
softmax: :func:`softmax_operand`), and the kernels mask their own
tails, so nothing is padded.  Outputs are fresh contiguous tensors
of the input's shape (on the card, ``vact_q8`` on an input off 16-byte
alignment returns a view into a buffer 16 bytes longer, at the input's
offset within 16 bytes).  ``vact`` dispatches to ``vact_ew`` (relu,
sigmoid, tanh) or ``vact_softmax``.  There is no fallback: a CUDA tensor
launches ``csrc/vact.cu`` or raises.  Each wrapper counts its launches
in a plain integer attribute (``vact_ew.launches``).

The CORDIC constants cross to the kernel already rounded to fp32 by the
same Python expressions the plain version uses (``CordicParams``), so
the card and the CPU compute with the same bits.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch import record
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

# vact_ew's launch (csrc/vact.cu: kMaxEwThreads): threads a block at
# most, and the grid's cap, past which it strides (16 resident blocks on
# each of an H100's 132 SMs)
EW_MAX_THREADS = 256
SMS = 132
EW_MAX_BLOCKS = 16 * SMS

# vact_ew_q8's launch (csrc/vact.cu: kQ8Threads): one thread a code of
# the 256-entry table, 16-byte chunks; the table (32 KB, a copy of each
# entry in every bank) leaves room for six blocks on an SM's 228 KB of
# shared memory (a wave of Q8_WAVE blocks).  Past one wave a thread takes
# Q8_ITEMS chunks (tools/kernel_probe.py q8), and past the grid's cap
# the grid strides
Q8_THREADS = 256
Q8_CHUNK = 16
Q8_WAVE = 6 * SMS
Q8_ITEMS = 4
Q8_MAX_BLOCKS = 16 * Q8_WAVE

# vact_softmax's two kernels (csrc/vact.cu), by the row length they
# take: rows kernel up to a warp's lanes, block kernel past that,
# staging up to what 227 KB of shared memory holds beside its 32-float
# reduction scratch
SOFTMAX_REGIMES = {"rows": 0, "block": 1}
SOFTMAX_ROWS_MAX = 32
SMEM_LIMIT = 232448
SOFTMAX_SCRATCH = 32 * 4
SOFTMAX_STAGE_MAX = (SMEM_LIMIT - SOFTMAX_SCRATCH) // 4
SOFTMAX_MAX_THREADS = 1024
SOFTMAX_MAX_COLS = 1 << 30


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
    lib.qforce_vact_ew.argtypes = [_I, _P, _P, _P, _L, _L, _L, _I, _I, _I,
                                   CordicParams]
    lib.qforce_vact_ew_q8.argtypes = [_I, _P, _P, _P, _P, _L, _I, _I, _I,
                                      CordicParams]
    lib.qforce_vact_softmax.argtypes = [_I, _P, _P, _P, _L, _L, _L, _I, _I,
                                        _I, _I, _I, CordicParams]
    for fn in (lib.qforce_vact_ew, lib.qforce_vact_ew_q8,
               lib.qforce_vact_softmax):
        fn.restype = _I
    return lib


def ew_operand(shape, strides):
    """How ``vact_ew``'s kernel reads a non-empty tensor of ``shape`` and
    ``strides`` (in elements) without a copy: ``(rows, cols, ld)``, rows
    of ``cols`` unit-stride elements ``ld`` apart, or None where it needs
    a contiguous copy.

    A contiguous tensor is one row of all its elements.  Otherwise the
    last axis must be unit-stride (or of size 1) and the leading axes
    must fold into one row stride (each one's stride the next one's
    times its size; axes of size 1 are ignored), as the LSTM's column
    slices of its [B, 4H] gate tensor do."""
    n = math.prod(shape)
    expect = 1
    for size, st in zip(reversed(shape), reversed(strides)):
        if size != 1 and st != expect:
            break
        expect *= size
    else:
        return 1, n, n
    cols = shape[-1]
    if cols != 1 and strides[-1] != 1:
        return None
    lead = [(s, st) for s, st in zip(shape[:-1], strides[:-1]) if s != 1]
    for (_, outer), (size, inner) in zip(lead, lead[1:]):
        if outer != inner * size:
            return None
    return math.prod(s for s, _ in lead), cols, lead[-1][1]


@dataclasses.dataclass(frozen=True)
class EwPlan:
    """One ``vact_ew`` launch: ``threads`` a block, ``blocks`` blocks,
    one element a thread."""

    threads: int
    blocks: int


@functools.lru_cache(maxsize=256)
def ew_plan(n: int) -> EwPlan:
    """Size ``vact_ew``'s launch over ``n`` elements.

    One element a thread: a thread's time is its chain of dependent
    CORDIC steps, and a second chain in the same thread lengthens it
    (``tools/kernel_probe.py ew``).  The threads a block are the threads
    wanted over 132 SMs, rounded up to a warp, at most
    ``EW_MAX_THREADS``, so a small tensor spreads over many SMs; past
    ``EW_MAX_BLOCKS`` the grid strides."""
    if n < 1:
        raise ValueError(f"ew_plan takes at least one element, got {n}")
    threads = min(EW_MAX_THREADS, 32 * _cdiv(_cdiv(n, SMS), 32))
    return EwPlan(threads, min(_cdiv(n, threads), EW_MAX_BLOCKS))


def softmax_operand(shape, strides):
    """How ``vact_softmax``'s kernels read a non-empty tensor of
    ``shape`` and ``strides`` (in elements) without a copy: ``(rows,
    cols, ld)``, rows of the last axis (``cols`` unit-stride elements)
    ``ld`` apart, or None where it needs a contiguous copy.

    A softmax row is the last axis, so a contiguous tensor is
    ``numel / cols`` rows at ``ld = cols`` (not :func:`ew_operand`'s one
    row); any other view is read at the row stride :func:`ew_operand`
    folds its leading axes into, and refused where it refuses."""
    op = ew_operand(shape, strides)
    if op is not None and op[0] == 1:       # contiguous
        return op[1] // shape[-1], shape[-1], shape[-1]
    return op


@dataclasses.dataclass(frozen=True)
class SoftmaxPlan:
    """One ``vact_softmax`` launch: the kernel (``regime``: "rows" or
    "block"), ``lanes`` a row (rows kernel), ``threads`` a block,
    ``blocks``, and the elements of a row the block kernel stages in
    shared memory (``staged``; the rest of a longer row is read
    again)."""

    regime: str
    lanes: int
    threads: int
    blocks: int
    staged: int = 0

    @property
    def smem(self) -> int:
        """Bytes of shared memory a block uses, its scratch included."""
        return 4 * self.staged + (SOFTMAX_SCRATCH if self.regime == "block"
                                  else 0)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=256)
def softmax_plan(rows: int, cols: int) -> SoftmaxPlan:
    """Choose and size ``vact_softmax``'s kernel for ``rows`` rows of
    ``cols``.

    * ``cols <= 32``: the rows kernel, ``next_pow2(cols)`` lanes a row,
      so [512, 4] runs 8 rows a warp; the warps spread over the SMs in
      small blocks as :func:`ew_plan` spreads threads.
    * longer rows: the block kernel, one block a row (strided past the
      grid's cap) of ``next_pow2(cols / 32)`` threads (32-1024: one warp
      up to 1024 elements), the row staged in shared memory up to
      ``SOFTMAX_STAGE_MAX`` floats; a longer row's tail is read again
      from device memory."""
    if rows < 1 or cols < 1:
        raise ValueError(f"softmax_plan takes rows and cols >= 1, got "
                         f"{rows}, {cols}")
    if cols > SOFTMAX_MAX_COLS:
        raise ValueError(f"vact_softmax takes rows of at most "
                         f"{SOFTMAX_MAX_COLS} elements, got {cols}")
    if cols <= SOFTMAX_ROWS_MAX:
        lanes = _next_pow2(cols)
        spread = ew_plan(_cdiv(rows, 32 // lanes) * 32)
        return SoftmaxPlan("rows", lanes, spread.threads, spread.blocks)
    threads = min(SOFTMAX_MAX_THREADS, max(32, _next_pow2(_cdiv(cols, 32))))
    return SoftmaxPlan("block", 0, threads, min(rows, EW_MAX_BLOCKS),
                       min(cols, SOFTMAX_STAGE_MAX))


@dataclasses.dataclass(frozen=True)
class Q8Plan:
    """One ``vact_ew_q8`` launch: ``threads`` a block (one a code),
    ``blocks``, and ``items`` 16-byte chunks a thread."""

    threads: int
    blocks: int
    items: int


@functools.lru_cache(maxsize=256)
def q8_plan(n: int) -> Q8Plan:
    """Size ``vact_ew_q8``'s launch over ``n`` int8 elements.

    Each block builds the 256-code table (one CORDIC a thread, what an
    element cost before) and then streams 16-byte chunks.  Up to one
    wave of resident blocks a thread takes one chunk; past it a thread
    takes ``Q8_ITEMS``, so each table is built for 16 KB of stream (at
    2^26 elements one chunk a thread was 40% slower, and 2, 8 or 16 a
    few percent, ``tools/kernel_probe.py q8``); past ``Q8_MAX_BLOCKS``
    the grid strides."""
    if n < 1:
        raise ValueError(f"q8_plan takes at least one element, got {n}")
    chunks = _cdiv(n, Q8_CHUNK)
    items = 1 if chunks <= Q8_THREADS * Q8_WAVE else Q8_ITEMS
    blocks = min(_cdiv(chunks, Q8_THREADS * items), Q8_MAX_BLOCKS)
    return Q8Plan(Q8_THREADS, blocks, _cdiv(chunks, Q8_THREADS * blocks))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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

@record.kernel("vact_ew")
def vact_ew(x: Tensor, kind: str, n_iters: int) -> Tensor:
    """Elementwise V-ACT (relu, sigmoid, tanh) by ``n_iters``-round
    CORDIC on any shape: fp32 in (cast), fp32 out, contiguous.  A view
    that :func:`ew_operand` accepts is read in place; anything else is
    made contiguous first."""
    if kind not in EW_KINDS:
        raise KeyError(kind)
    params = cordic_params(n_iters)
    if not _on_cuda("vact_ew", x):
        return vact_ew_plain(x, kind, n_iters)
    xf = x.to(torch.float32)
    out = torch.empty(xf.shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    op = ew_operand(tuple(xf.shape), xf.stride())
    if op is None:
        xf = xf.contiguous()
        op = (1, xf.numel(), xf.numel())
    rows, cols, ld = op
    plan = ew_plan(rows * cols)
    code = _lib().qforce_vact_ew(*_stream(x.device), xf.data_ptr(),
                                 out.data_ptr(), rows, cols, ld,
                                 EW_KINDS[kind], plan.threads, plan.blocks,
                                 params)
    _build.check(code, "vact_ew")
    vact_ew.launches += 1
    return out


@record.kernel("vact_softmax")
def vact_softmax(x: Tensor, n_iters: int) -> Tensor:
    """Softmax over the last axis with CORDIC exp: fp32 out, contiguous.
    A view that :func:`softmax_operand` accepts is read in place;
    anything else is made contiguous first.  The kernel follows
    :func:`softmax_plan`."""
    params = cordic_params(n_iters)
    if not _on_cuda("vact_softmax", x):
        return vact_softmax_plain(x, n_iters)
    if x.ndim == 0:
        raise ValueError("vact_softmax needs at least one axis")
    xf = x.to(torch.float32)
    out = torch.empty(xf.shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    op = softmax_operand(tuple(xf.shape), xf.stride())
    if op is None:
        xf = xf.contiguous()
        op = softmax_operand(tuple(xf.shape), xf.stride())
    rows, cols, ld = op
    plan = softmax_plan(rows, cols)
    code = _lib().qforce_vact_softmax(
        *_stream(x.device), xf.data_ptr(), out.data_ptr(), rows, cols, ld,
        SOFTMAX_REGIMES[plan.regime], plan.lanes, plan.threads,
        plan.blocks, plan.staged, params)
    _build.check(code, "vact_softmax")
    vact_softmax.launches += 1
    return out


def vact(x: Tensor, kind: str, n_iters: int) -> Tensor:
    """V-ACT CORDIC activation on any-shaped fp input (softmax over the
    last axis).  fp32 compute, fp32 out, shape kept."""
    if kind == "softmax":
        return vact_softmax(x, n_iters)
    return vact_ew(x, kind, n_iters)


@record.kernel("vact_ew_q8")
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
    n = qc.numel()
    if n == 0:
        return torch.empty_like(qc)
    # the output at the input's offset within 16 bytes, so both stream
    # in the same aligned 16-byte chunks: a fresh tensor for an aligned
    # input, a view into a longer buffer for one off alignment
    if qc.data_ptr() % Q8_CHUNK == 0:
        out = torch.empty_like(qc)
    else:
        buf = torch.empty(n + Q8_CHUNK, dtype=torch.int8, device=qx.device)
        pad = (qc.data_ptr() - buf.data_ptr()) % Q8_CHUNK
        out = buf[pad:pad + n].view(qc.shape)
    plan = q8_plan(n)
    code = _lib().qforce_vact_ew_q8(*_stream(qx.device), qc.data_ptr(),
                                    s.data_ptr(), out.data_ptr(), n,
                                    EW_KINDS[kind], plan.threads,
                                    plan.blocks, params)
    _build.check(code, "vact_ew_q8")
    vact_q8.launches += 1
    return out


vact_ew.launches = 0
vact_softmax.launches = 0
vact_q8.launches = 0

# the oracles, re-exported for tests, as the reference's ops do
ref_vact = _ref.vact
ref_vact_q8 = _ref.vact_q8
