"""Mamba-2 SSD (state-space duality) layer [arXiv:2405.21060] (port of
``repro.nn.ssm``).

Chunked SSD for prefill (intra-chunk quadratic form plus an inter-chunk
recurrence over chunk states) and a constant-memory recurrent step for
decode.  The projections route through q_matmul (on a CUDA tensor, the
Q-MAC kernel); the recurrent state stays fp32.

Every contraction, ``exp``, cumulative sum, softplus and SiLU sigmoid
runs through fp64 and rounds once (``core.exact``), so the card and the
CPU compute the same program bit for bit.  The reference's inter-chunk
``lax.scan`` is a Python loop over the chunks that emits the state
before each chunk, as the scan does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import exact
from repro_torch.core.policy import QuantPolicy
from repro_torch.nn.conv import (causal_conv1d_apply, causal_conv1d_axes,
                                 causal_conv1d_init)
from repro_torch.nn.linear import linear_apply, linear_axes, linear_init
from repro_torch.nn.module import normal_init, ones_init, uniform
from repro_torch.nn.norm import rmsnorm_apply

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int           # expand * d_model
    head_dim: int = 64     # P
    d_state: int = 128     # N
    n_groups: int = 1      # G
    conv_width: int = 4
    chunk: int = 128

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssm_init(gen: torch.Generator, cfg: SSMConfig, dtype=torch.float32,
             device="cpu"):
    conv_dim = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state \
        + cfg.n_heads
    h = (cfg.n_heads,)
    return {
        "in_proj": linear_init(gen, cfg.d_model, d_in_proj, bias=False,
                               dtype=dtype, device=device),
        "conv": causal_conv1d_init(gen, conv_dim, cfg.conv_width, dtype,
                                   device),
        "A_log": torch.log(uniform(gen, h, 1.0, 16.0)).to(device),
        "D": ones_init()(gen, h, device=device),
        "dt_bias": normal_init(0.1)(gen, h, device=device),
        "norm": {"scale": ones_init()(gen, (cfg.d_inner,), dtype, device)},
        "out_proj": linear_init(gen, cfg.d_inner, cfg.d_model, bias=False,
                                dtype=dtype, device=device),
    }


def ssm_axes():
    """The logical axes of :func:`ssm_init`'s tree."""
    return {
        "in_proj": linear_axes(("d_model", "d_inner"), False),
        "conv": causal_conv1d_axes(),
        "A_log": ("heads",),
        "D": ("heads",),
        "dt_bias": ("heads",),
        "norm": {"scale": (None,)},
        "out_proj": linear_axes(("d_inner", "d_model"), False),
    }


def _split_zxbcdt(zxbcdt: Tensor, cfg: SSMConfig):
    di, gn, h = cfg.d_inner, cfg.n_groups * cfg.d_state, cfg.n_heads
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    assert dt.shape[-1] == h
    return z, xBC, dt


def _segsum(x: Tensor) -> Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k in (j, i]} x_k, and
    -inf above the diagonal."""
    T = x.shape[-1]
    cs = exact.cumsum(x, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, float("-inf"))


def ssd_chunked(X: Tensor, A: Tensor, Bm: Tensor, C: Tensor, chunk: int):
    """Minimal SSD (discrete): X:[b,l,h,p] A:[b,l,h] B,C:[b,l,g,n].

    Returns (Y [b,l,h,p], final_state [b,h,p,n]).
    """
    b, l, h, p = X.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = chunk
    nc = l // q
    assert l % q == 0, (l, q)
    rep = h // g

    def cshape(t):
        return t.reshape(b, nc, q, *t.shape[2:])

    Xc, Ac, Bc, Cc = cshape(X), cshape(A), cshape(Bm), cshape(C)
    Ac = Ac.movedim(-1, 2)                        # [b, nc, h, q]
    A_cum = exact.cumsum(Ac, -1)                  # [b, nc, h, q]

    # 1. intra-chunk (diagonal block): quadratic within the chunk
    L = exact.exp(_segsum(Ac))                    # [b,nc,h,q,q]
    Cr = torch.repeat_interleave(Cc, rep, dim=3) if g != h else Cc
    Br = torch.repeat_interleave(Bc, rep, dim=3) if g != h else Bc
    CB = exact.einsum("bcihn,bcjhn->bchij", Cr, Br)
    Y_diag = exact.einsum("bchij,bchij,bcjhp->bcihp", CB, L, Xc)

    # 2. chunk states: B^T (decay-weighted) X
    decay_states = exact.exp(A_cum[..., -1:] - A_cum)  # [b,nc,h,q]
    states = exact.einsum("bcjhn,bchj,bcjhp->bchpn",
                          Br, decay_states, Xc)        # [b,nc,h,p,n]

    # 3. inter-chunk recurrence over chunk states, emitting the state
    # before each chunk
    chunk_decay = exact.exp(A_cum[..., -1])            # [b,nc,h]
    carry = X.new_zeros((b, h, p, n))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)             # [b,nc,h,p,n]

    # 4. off-diagonal contribution from previous chunks' state
    state_decay = exact.exp(A_cum)                     # [b,nc,h,q]
    Y_off = exact.einsum("bcihn,bchpn,bchi->bcihp",
                         Cr, prev_states, state_decay)

    Y = (Y_diag + Y_off).reshape(b, l, h, p)
    return Y, carry


def ssm_apply(p, u: Tensor, cfg: SSMConfig,
              policy: Optional[QuantPolicy] = None,
              state: Optional[dict] = None, return_state: bool = False):
    """Full-sequence forward. u: [B, S, d_model].

    With ``state`` (dict with "ssm" [B,H,P,N] and "conv" [B,W-1,C]),
    performs a single decode step (S == 1).  ``return_state=True`` on
    the full path also returns the final recurrent state (prefill).
    """
    B, S, _ = u.shape
    h, pd, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    di = cfg.d_inner
    f32 = torch.float32
    zxbcdt = linear_apply(p["in_proj"], u, policy)
    z, xBC, dt = _split_zxbcdt(zxbcdt, cfg)
    dt = exact.softplus(dt.to(f32) + p["dt_bias"])              # [B,S,H]
    A = -exact.exp(p["A_log"].to(f32))                          # [H]

    if state is not None:
        xBC_t, conv_state = causal_conv1d_apply(p["conv"], xBC,
                                                state["conv"])
        xBC_t = exact.silu(xBC_t)
        x = xBC_t[..., :di].reshape(B, h, pd)
        Bm = xBC_t[..., di:di + g * n].reshape(B, g, n)
        Cm = xBC_t[..., di + g * n:].reshape(B, g, n)
        rep = h // g
        Br = torch.repeat_interleave(Bm, rep, dim=1)
        Cr = torch.repeat_interleave(Cm, rep, dim=1)
        dt1 = dt[:, 0]                                          # [B,H]
        dA = exact.exp(dt1 * A)                                 # [B,H]
        ssm = state["ssm"] * dA[..., None, None] \
            + exact.einsum("bhn,bhp,bh->bhpn", Br, x, dt1)
        y = exact.einsum("bhn,bhpn->bhp", Cr, ssm)
        y = y + x * p["D"][None, :, None]
        y = y.reshape(B, 1, di)
        y = rmsnorm_apply(p["norm"], y * exact.silu(z))
        out = linear_apply(p["out_proj"], y, policy)
        return out, {"ssm": ssm, "conv": conv_state}

    xBC_raw = xBC
    xBC = exact.silu(causal_conv1d_apply(p["conv"], xBC))
    x = xBC[..., :di].reshape(B, S, h, pd)
    Bm = xBC[..., di:di + g * n].reshape(B, S, g, n)
    Cm = xBC[..., di + g * n:].reshape(B, S, g, n)
    X_dt = x.to(f32) * dt[..., None]                            # dt * x
    A_dt = A[None, None, :] * dt                                # [B,S,H]
    Y, final = ssd_chunked(X_dt, A_dt, Bm.to(f32), Cm.to(f32), cfg.chunk)
    Y = Y + x * p["D"][None, None, :, None]
    Y = Y.reshape(B, S, di).to(u.dtype)
    Y = rmsnorm_apply(p["norm"], Y * exact.silu(z))
    out = linear_apply(p["out_proj"], Y, policy)
    if return_state:
        w = cfg.conv_width - 1
        conv_state = xBC_raw[:, S - w:S].to(f32)
        return out, {"ssm": final, "conv": conv_state}
    return out


def ssm_init_state(batch: int, cfg: SSMConfig, device="cpu"):
    conv_dim = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    return {
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=torch.float32, device=device),
    }
