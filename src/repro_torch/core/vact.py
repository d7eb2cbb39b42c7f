"""V-ACT: CORDIC-based activation functions (port of ``repro.core.vact``).

The paper's reconfigurable hyperbolic-CORDIC datapath, on the
reference's decomposition and schedule:

    e^x      = 2^m * (cosh r + sinh r),  m = floor(x/ln2), r = x - m ln2
    sigmoid  = 1 / (1 + e^{-|x|})  (mirrored for x < 0)
    tanh     = 2 sigmoid(2x) - 1
    softmax  = e^{x - max} / sum e^{x - max}

The plain functions here round exactly like the reference's: every
constant is the reference's float64 value cast to fp32, every division
is a true division (``div_scalar`` on the card, where PyTorch would
multiply by a Python number's reciprocal), and ``2^m`` is built from its
exponent bits, so the scaling is one correctly rounded multiply, as
``jnp.ldexp`` is.  ``activation(..., act_backend="cordic")`` takes the
V-ACT kernel (``repro_torch.kernels.vact``) on a CUDA tensor and these
functions on a CPU tensor.

With quantized activations the output is then fake-quantized per tensor
(softmax excepted) — V-ACT's fused requantize stage.  The per-tensor
scale sees every row, so a padded serving bucket must be padded exactly
as the reference pads it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import exact
from repro_torch.core.fxp import div_scalar, fake_quant, fxp_qmax
from repro_torch.core.policy import QuantPolicy, cordic_iterations
from repro_torch.distributed.sharding import across_slots, current_mesh, pmax

Tensor = torch.Tensor

LN2 = math.log(2.0)

# Hyperbolic CORDIC convergence requires repeating iterations 4, 13, 40...
_REPEAT = (4, 13, 40)
_MAX_ITERS = 24


def hyperbolic_schedule(n_iters: int) -> Sequence[int]:
    """Shift indices i (starting at 1) with the standard repeats."""
    seq = []
    i = 1
    while len(seq) < n_iters:
        seq.append(i)
        if i in _REPEAT and (len(seq) < n_iters):
            seq.append(i)           # repeated iteration
        i += 1
    return tuple(seq[:n_iters])


def cordic_gain(schedule: Sequence[int]) -> float:
    g = 1.0
    for i in schedule:
        g *= math.sqrt(1.0 - 2.0 ** (-2 * i))
    return g


_ATANH = tuple(math.atanh(2.0 ** (-i)) for i in range(1, _MAX_ITERS + 2))


def _const(like: Tensor, v: float) -> Tensor:
    """``v`` rounded to fp32 as a 0-dim tensor on ``like``'s device."""
    return like.new_full((), v, dtype=torch.float32)


def cordic_sinh_cosh(z: Tensor, n_iters: int) -> Tuple[Tensor, Tensor]:
    """Vectorized hyperbolic CORDIC (rotation mode): (sinh z, cosh z).

    Valid for |z| <= sum(atanh(2^-i)) ~= 1.1182 over the schedule; the
    exp() range reduction guarantees z in [0, ln2).  Every step rounds
    like the reference's ``x + d * y * shift`` (sign, power of two, one
    add), one op at a time."""
    sched = hyperbolic_schedule(n_iters)
    x = torch.full_like(z, 1.0 / cordic_gain(sched))
    y = torch.zeros_like(z)
    zz = z
    for i in sched:
        pos = zz >= 0
        shift = 2.0 ** (-i)
        dy = torch.where(pos, y, -y) * shift
        dx = torch.where(pos, x, -x) * shift
        x, y = x + dy, y + dx
        e = _const(zz, _ATANH[i - 1])
        zz = torch.where(pos, zz - e, zz + e)
    return y, x


def pow2(m: Tensor) -> Tensor:
    """2^m as fp32 for int m in [-126, 127], built from exponent bits
    (exact; ``torch.ldexp`` goes through ``pow``)."""
    return ((m.to(torch.int32) + 127) << 23).view(torch.float32)


def cordic_exp(x: Tensor, n_iters: int) -> Tensor:
    """e^x via range reduction + hyperbolic CORDIC.

    m = floor(x / ln2) is a shift count on the FPGA; r in [0, ln2)."""
    x = x.to(torch.float32)
    m = torch.floor(div_scalar(x, LN2))
    r = x - m * _const(x, LN2)
    s, c = cordic_sinh_cosh(r, n_iters)
    e_r = s + c
    # clamp the exponent so 2^m stays finite in fp32
    return e_r * pow2(torch.clamp(m, -126, 126))


def cordic_sigmoid(x: Tensor, n_iters: int) -> Tensor:
    e = cordic_exp(-torch.abs(x), n_iters)          # e^{-|x|} in (0, 1]
    one = _const(e, 1.0)
    pos = one / (one + e)                            # for x >= 0
    return torch.where(x >= 0, pos, one - pos)


def cordic_tanh(x: Tensor, n_iters: int) -> Tensor:
    return 2.0 * cordic_sigmoid(2.0 * x, n_iters) - 1.0


def cordic_softmax(x: Tensor, n_iters: int, axis: int = -1) -> Tensor:
    m = torch.amax(x, dim=axis, keepdim=True)
    e = cordic_exp(x - m, n_iters)
    return e / torch.sum(e, dim=axis, keepdim=True)


def _gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu`` (``approximate=True``), its expression op by op:
    ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))`` with
    ``c = sqrt(2/pi)`` and 0.044715 rounded to ``x``'s dtype and the tanh
    through fp64; the cube is ``x * x * x``, as XLA multiplies out
    ``x ** 3``."""
    c = x.new_full((), math.sqrt(2.0 / math.pi))
    inner = c * (x + x.new_full((), 0.044715) * (x * x * x))
    return x * (0.5 * (1.0 + exact.tanh(inner)))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_NATIVE = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": _gelu,
    "silu": exact.silu,
    "identity": lambda x: x,
}

# activation kinds V-ACT implements in hardware
VACT_KINDS = ("relu", "sigmoid", "tanh", "softmax")


def activation(x: Tensor, kind: str, policy: Optional[QuantPolicy] = None,
               axis: int = -1) -> Tensor:
    """Evaluate an activation under the policy's act_backend, then
    requantize when the policy quantizes activations (softmax
    excepted)."""
    if policy is None or policy.act_backend == "native" \
            or kind not in VACT_KINDS:
        if kind == "softmax":
            out = torch.softmax(x, dim=axis)
        else:
            out = _NATIVE[kind](x)
    elif kind == "relu":
        out = torch.relu(x)      # ReLU is a mux on the FPGA too
    else:
        # imported here: kernels.vact.ops imports this module
        from repro_torch.kernels.vact import ops as vact_ops
        n = cordic_iterations(policy)
        if kind == "softmax":
            out = vact_ops.vact(x.movedim(axis, -1), kind, n)
            out = out.movedim(-1, axis)
        else:
            out = vact_ops.vact(x, kind, n)
    if policy is not None and policy.quantized_a and kind != "softmax":
        out = _requantize(out, policy.a_bits)
    return out.to(x.dtype)


def _requantize(x: Tensor, bits: int) -> Tensor:
    """``fake_quant`` on the tensor-wide grid.  Where the ranks of a mesh
    each hold their rows of the batch, the grid's absmax is the whole
    batch's (the max over the data slots), as the reference's global
    program takes it; inside a per-slot body (``sharding.manual``) and
    off a mesh it is the tensor's own."""
    if not across_slots():
        return fake_quant(x, bits)
    amax = pmax(x.abs().amax(), current_mesh())
    scale = div_scalar(torch.clamp_min(amax, 1e-12), fxp_qmax(bits))
    return fake_quant(x, bits, scale=scale.reshape((1,) * x.ndim))
