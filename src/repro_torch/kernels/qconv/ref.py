"""Oracle for the Q-Conv kernel (port of ``repro.kernels.qconv.ref``),
plus the SAME/VALID output-size arithmetic the wrappers share.

Computes each tap's channel contraction by broadcast-multiply and sum
in fp32, which holds every int8 product and channel partial sum exactly
for C <= 1040; only the fp32 tap accumulation is order-sensitive, and it
walks the taps in the kernel's kh-major order.  Meant for test-sized
operands.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def same_pads(size: int, k: int, stride: int):
    """SAME output size and (lo, hi) pads for one spatial dim (stride 2
    over an even size pads (0, 1): asymmetric)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, (total // 2, total - total // 2)


def valid_out(size: int, k: int, stride: int) -> int:
    return (size - k) // stride + 1


def qconv2d_i8(qx: Tensor, sx: Tensor, qw: Tensor, sw: Tensor, b: Tensor,
               *, stride: int = 1, padding: str = "SAME",
               fuse_relu: bool = False) -> Tensor:
    """qx [B,H,W,C] int8, sx [B,H,W,1] fp32, qw [KH,KW,C,N] int8, sw
    broadcastable to [N] fp32, b [N] fp32 -> [B,H',W',N] fp32."""
    bsz, h, w, _ = qx.shape
    kh, kw, _, n = qw.shape
    if padding == "SAME":
        ho, (pt, pb) = same_pads(h, kh, stride)
        wo, (plf, prt) = same_pads(w, kw, stride)
        qx = F.pad(qx, (0, 0, plf, prt, pt, pb))
        sx = F.pad(sx, (0, 0, plf, prt, pt, pb))
    elif padding == "VALID":
        ho, wo = valid_out(h, kh, stride), valid_out(w, kw, stride)
    else:
        raise ValueError(f"unsupported padding {padding!r}")
    acc = torch.zeros((bsz, ho, wo, n), dtype=torch.float32,
                      device=qx.device)
    for di in range(kh):
        for dj in range(kw):
            xt = qx[:, di:di + (ho - 1) * stride + 1:stride,
                    dj:dj + (wo - 1) * stride + 1:stride, :]
            st = sx[:, di:di + (ho - 1) * stride + 1:stride,
                    dj:dj + (wo - 1) * stride + 1:stride, :]
            prod = (xt.to(torch.float32)[..., None]
                    * qw[di, dj].to(torch.float32)).sum(dim=3)
            acc = acc + prod * st.to(torch.float32)
    out = acc * sw.to(torch.float32).reshape(1, 1, 1, -1) \
        + b.to(torch.float32)
    return torch.clamp_min(out, 0.0) if fuse_relu else out
