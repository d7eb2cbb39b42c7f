"""Q-Conv wrapper: launch the Hopper implicit-GEMM kernel on a CUDA
tensor, take the plain PyTorch version on a CPU tensor.

``qconv2d_i8`` answers to ``repro.kernels.qconv.ops.qconv2d_i8``: the
same integer program (per-pixel int8 activations against per-out-channel
int8 filters, exact int32 channel dots, fp32 tap carry in kh-major
order, fused ``* sw + b`` and optional ReLU).  There is no fallback: a
CUDA tensor launches ``csrc/qconv.cu`` or raises, and
``qconv2d_i8.launches`` counts the launches.

Each block of the kernel stages a band of input rows once and computes
R output rows of one image from shared memory; :func:`band_plan` picks
R, the tile of output channels, the threads and the shared memory, and
refuses a shape whose single output row does not fit a block.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch import record
from repro_torch.kernels import _build
from repro_torch.kernels.qconv import ref as _ref
from repro_torch.kernels.qconv.ref import same_pads, valid_out

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int


# a block's shared memory on an H100 (227 KB), and the kernel's most
# threads a block (qconv.cu: kSmemLimit, kMaxThreads)
SMEM_LIMIT = 232448
MAX_THREADS = 256
# about two blocks per SM of an H100 (132 SMs), so one block's staging
# overlaps another's taps
TARGET_BLOCKS = 256
# at least this many threads a block, so a small band still stages its
# weights with enough loads in flight
MIN_THREADS = 128
# at most this many (pixel, 4-channel group) items a block: four a
# thread, so a wider band does not leave the card with too few blocks
MAX_ITEMS = 4 * MAX_THREADS
# the widest N tile: 64 channels, 16 groups of four
MAX_N_TILE = 64


@functools.cache
def _lib():
    fn = _build.load("qconv").qforce_qconv_i8
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _I, _P, _P] + [_I] * 17
    fn.restype = _I
    return fn


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(in_rows: int, w: int, c: int, kh: int, kw: int,
               n_tile: int) -> int:
    """qconv.cu's ``Layout``: the band's input bytes at C padded to a
    multiple of 4 (+16 for the aligned copy's shift), its fp32 scales
    (+16), and the N tile's weights at an odd count of 32-bit words a
    column (``w_pitch``), each region rounded to 16 bytes."""
    c4 = _round_up(c, 4)
    pitch = (c4 // 4) | 1
    return (_round_up(in_rows * w * c4 + 16, 16)
            + _round_up(in_rows * w * 4 + 16, 16)
            + _round_up(kh * kw * _round_up(n_tile, 4) * pitch * 4, 16))


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """One Q-Conv launch: ``blocks`` blocks of ``rows`` output rows of one
    image by ``n_tile`` output channels, ``threads`` a block, ``smem``
    bytes of shared memory over ``in_rows`` staged input rows at most.
    The launcher refuses any ``smem`` other than its own layout's."""

    rows: int
    n_tile: int
    threads: int
    smem: int
    in_rows: int
    blocks: int


@functools.lru_cache(maxsize=256)
def band_plan(batch: int, h: int, w: int, c: int, kh: int, kw: int, n: int,
              stride: int, padding: str) -> BandPlan:
    """Size Q-Conv's blocks for an input [batch, h, w, c] and filters
    [kh, kw, c, n].

    The N tile is all of N (rounded up to 4) up to 64 channels.  R is the
    most output rows a band can have while the grid keeps at least
    ``TARGET_BLOCKS`` blocks, a block at most ``MAX_ITEMS`` (pixel,
    4-channel) items and its shared memory fits ``SMEM_LIMIT``; where no
    R keeps that many blocks, R = 1.  Where one row does not fit, the N
    tile halves down to 4 channels; past that the shape is refused with
    a ValueError (the wrapper never falls back to the plain version)."""
    ho, wo, *_ = out_geometry(h, w, kh, kw, stride, padding)
    if min(batch, ho, wo, n) < 1 or c < 0:
        raise ValueError(f"band_plan: empty conv x[{batch},{h},{w},{c}] "
                         f"w[{kh},{kw},{c},{n}]")
    n_tile = min(_round_up(n, 4), MAX_N_TILE)
    while True:
        def fit(r):
            in_rows = min(h, (r - 1) * stride + kh)
            return in_rows, smem_bytes(in_rows, w, c, kh, kw, n_tile)

        groups = -(-n_tile // 4)
        n_tiles = -(-n // n_tile)
        rows = 1
        for r in range(ho, 1, -1):
            if (batch * -(-ho // r) * n_tiles >= TARGET_BLOCKS
                    and r * wo * groups <= MAX_ITEMS
                    and fit(r)[1] <= SMEM_LIMIT):
                rows = r
                break
        in_rows, smem = fit(rows)
        if smem <= SMEM_LIMIT:
            items = rows * wo * groups
            threads = min(MAX_THREADS, max(MIN_THREADS,
                                           _round_up(items, 32)))
            return BandPlan(rows, n_tile, threads, smem, in_rows,
                            batch * -(-ho // rows) * n_tiles)
        if n_tile == 4:
            raise ValueError(
                f"Q-Conv: one output row of x[{batch},{h},{w},{c}] with "
                f"w[{kh},{kw},{c},{n}] needs {smem} bytes of shared "
                f"memory, more than the {SMEM_LIMIT} a block can have")
        n_tile = max(4, _round_up(n_tile // 2, 4))


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


def _int_ops(qx: Tensor, sx: Tensor, qw: Tensor, sw: Tensor, b: Tensor, *,
             stride: int = 1, padding: str = "SAME", **_) -> int:
    """``2 * B * H' * W' * KH * KW * C * N``, the integer operations a
    recorder charges a call."""
    ho, wo = out_geometry(qx.shape[1], qx.shape[2], qw.shape[0],
                          qw.shape[1], stride, padding)[:2]
    return 2 * qx.shape[0] * ho * wo * qw.numel()


@record.kernel("qconv_i8_taps", _int_ops)
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
    plan = band_plan(bsz, h, w, c, kh, kw, n, stride, padding)
    dev = qx.device
    code = _lib()(
        dev.index if dev.index is not None else 0,
        torch.cuda.current_stream(dev).cuda_stream, qx.data_ptr(),
        sx.data_ptr(), qw.data_ptr(), sw.data_ptr(),
        0 if sw.numel() == 1 else 1, b.data_ptr(), out.data_ptr(), bsz, h,
        w, c, kh, kw, n, stride, pt, plf, ho, wo, int(fuse_relu), plan.rows,
        plan.n_tile, plan.threads, plan.smem)
    _build.check(code, "qconv")
    qconv2d_i8.launches += 1
    return out


qconv2d_i8.launches = 0

# the oracles, re-exported for tests, as the reference's ops do
ref_qconv2d_i8 = _ref.qconv2d_i8
