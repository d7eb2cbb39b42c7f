"""QuantPolicy: the framework-wide precision dial (port of
``repro.core.policy``).

The same twelve presets under the same names and backend strings, so a
policy named in checkpoint metadata means the same thing in both
packages.  ``compute_dtype`` is a torch dtype here.  The backend names
keep the reference's meaning for ``"ref"`` (fake-quant products); for
``"xla"`` and ``"pallas"`` the port runs the integer product through
the Q-MAC / Q-Conv kernels on a CUDA tensor, whichever of the two is
named.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-role bit-widths + backend selection (bits == 32: no
    quantization for that role)."""

    name: str = "fp32"
    w_bits: int = 32              # weight matmul operand
    a_bits: int = 32              # activation matmul operand
    kv_bits: int = 32             # KV / recurrent-state cache payload
    grad_bits: int = 32           # DP gradient all-reduce payload
    comm_bits: int = 32           # learner->actor weight sync payload
    backend: str = "xla"          # one of {"ref", "xla", "pallas"}
    act_backend: str = "native"   # one of {"native", "cordic"}
    per_channel: bool = True      # per-out-channel weight scales
    compute_dtype: torch.dtype = torch.float32
    # CORDIC iteration count override (None -> 3*bits/8 + 1 heuristic)
    cordic_iters: Optional[int] = None

    @property
    def quantized_w(self) -> bool:
        return self.w_bits < 32

    @property
    def quantized_a(self) -> bool:
        return self.a_bits < 32

    def with_backend(self, backend: str) -> "QuantPolicy":
        return dataclasses.replace(self, backend=backend)

    def replace(self, **kw) -> "QuantPolicy":
        return dataclasses.replace(self, **kw)


FP32 = QuantPolicy(name="fp32")
FXP8 = QuantPolicy(name="fxp8", w_bits=8, a_bits=8, kv_bits=8, comm_bits=8)
FXP16 = QuantPolicy(name="fxp16", w_bits=16, a_bits=16, kv_bits=16,
                    comm_bits=16)
FXP32 = QuantPolicy(name="fxp32")
W8A8 = QuantPolicy(name="w8a8", w_bits=8, a_bits=8)
W8 = QuantPolicy(name="w8", w_bits=8)
W8A8KV8 = QuantPolicy(name="w8a8kv8", w_bits=8, a_bits=8, kv_bits=8)
W4 = QuantPolicy(name="w4", w_bits=4)
W4A8 = QuantPolicy(name="w4a8", w_bits=4, a_bits=8)
BF16 = QuantPolicy(name="bf16", compute_dtype=torch.bfloat16)
W8A8_BF16 = QuantPolicy(name="w8a8_bf16", w_bits=8, a_bits=8,
                        compute_dtype=torch.bfloat16)
QFORCE8 = QuantPolicy(name="qforce8", w_bits=8, a_bits=8, kv_bits=8,
                      comm_bits=8, compute_dtype=torch.bfloat16)

PRESETS = {p.name: p for p in
           [FP32, FXP8, FXP16, FXP32, W8A8, W8, W8A8KV8, W4, W4A8,
            BF16, W8A8_BF16, QFORCE8]}


def get_policy(name: str) -> QuantPolicy:
    if name not in PRESETS:
        raise KeyError(f"unknown quant policy '{name}' "
                       f"(available: {sorted(PRESETS)})")
    return PRESETS[name]


def cordic_iterations(policy: QuantPolicy, bits: Optional[int] = None) -> int:
    """Hybrid CORDIC converges in (3n/8 + 1) cycles, floored at 6."""
    if policy.cordic_iters is not None:
        return policy.cordic_iters
    b = bits if bits is not None else max(policy.a_bits, 8)
    return max(3 * b // 8 + 1, 6)
