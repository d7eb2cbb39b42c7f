"""Multi-head / grouped-query attention with quantized projections and
an optionally int8 KV cache (port of ``repro.nn.attention``).

All four projections route through q_matmul (on a CUDA tensor, the
Q-MAC kernel).  The score and value contractions are plain ``einsum``
in the compute dtype, as the reference leaves them to XLA, and the
softmax is the reference's ``exp(x - max) / sum``; the contractions,
the ``exp`` and the sum run through fp64 and round once
(``core.exact``), so the card and the CPU agree bit for bit.  With
``kv_bits=8`` the cache holds int8 payloads with a scale per (token,
head).

Supports: causal, bidirectional (encoder), sliding-window with a ring
buffer, cross-attention (enc-dec), GQA/MQA, qk-norm, QKV biases, RoPE.

Differences from the reference, none of them in a result:

* the reference's ``distributed.sharding.constrain`` layout hints sit
  where the reference's do; each rank computes on its own rows, so on
  a plain tensor they return their input;
* a cache update writes the new positions into the cache's tensors in
  place and returns the cache (a decode step would otherwise copy every
  layer's whole cache); callers hand each cache to one update;
* on a laid-out step (``distributed.sharding.layout``) the rank
  attends with its own heads: the q, k and v projections are
  column-parallel over the heads and ``wo`` row-parallel.  Where the kv
  heads stay whole on every model rank (their count does not divide the
  model axis), the rank projects them all and keeps the kv groups of its
  own q heads (:func:`kv_groups`);
* a laid-out serving step's KV cache lies as ``launch.steps.
  cache_shardings`` lays it (:func:`kv_split`): its kv heads over the
  model axis with the q heads, so a rank attends alone, or, where the
  kv heads do not divide the axis, its sequence (flash-decoding): a
  rank holds every kv head at its own positions, a decode step gathers
  the queries of every head, scores them on those positions, and the
  softmax's max, its sum and the value contraction's partials are
  reduced over the model axis (the sums in fp64, rounded once after
  them, as ``core.exact`` rounds the whole-cache program's); the rank
  that owns a new position alone writes it.  A prefill writes each
  rank's block of its cache, slicing positions where the sequence is
  split;
* the q-chunked path loops over chunks in Python.  Under autograd each
  chunk is rematerialised (``nn.remat.checkpoint``, the reference's
  ``jax.checkpoint(block)``): the backward recomputes its scores rather
  than keeping every chunk's softmax weights.  Serving runs under
  ``no_grad`` and checkpoints nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import exact
from repro_torch.core.fxp import div_scalar, fxp_dtype, fxp_qmax
from repro_torch.core.policy import QuantPolicy
from repro_torch.distributed.sharding import (Layout, axes_index, axes_size,
                                              constrain, gather_over, layout,
                                              pmax, psum)
from repro_torch.nn.linear import linear_apply, linear_axes, linear_init
from repro_torch.nn.module import ones_init
from repro_torch.nn.norm import rmsnorm_apply
from repro_torch.nn.remat import checkpoint
from repro_torch.nn.rotary import apply_rope

Tensor = torch.Tensor
NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    window: Optional[int] = None        # sliding-window size (SWA)
    rope: bool = True
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    cross: bool = False                 # cross-attention (enc-dec)
    # q-chunked attention: the live score block is [B, H, q_chunk, T];
    # a non-divisible or small S takes the direct path
    q_chunk: int = 512


def attention_init(gen: torch.Generator, cfg: AttnConfig,
                   dtype=torch.float32, device="cpu"):
    H, Hk, D, dm = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": linear_init(gen, dm, H * D, bias=cfg.qkv_bias, **kw),
        "wk": linear_init(gen, dm, Hk * D, bias=cfg.qkv_bias, **kw),
        "wv": linear_init(gen, dm, Hk * D, bias=cfg.qkv_bias, **kw),
        "wo": linear_init(gen, H * D, dm, bias=False, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": ones_init()(gen, (D,), dtype, device)}
        p["k_norm"] = {"scale": ones_init()(gen, (D,), dtype, device)}
    return p


def attention_axes(cfg: AttnConfig):
    """The logical axes of :func:`attention_init`'s tree: the kv
    projections over ``"kv_heads"``, which the rules map to the model
    axis only where the head count divides it."""
    p = {
        "wq": linear_axes(("d_model", "heads"), cfg.qkv_bias),
        "wk": linear_axes(("d_model", "kv_heads"), cfg.qkv_bias),
        "wv": linear_axes(("d_model", "kv_heads"), cfg.qkv_bias),
        "wo": linear_axes(("heads", "d_model"), False),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": (None,)}
        p["k_norm"] = {"scale": (None,)}
    return p


# ---------------------------------------------------------------------------
# KV cache (optionally int8)
# ---------------------------------------------------------------------------

def init_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
               kv_bits: int = 32, dtype=torch.float32, ring: bool = False,
               device="cpu"):
    """A fixed-capacity KV cache for one layer.  ``ring=True`` makes it
    a circular buffer of ``max_len`` slots (sliding-window attention
    with max_len == window): a per-slot absolute position drives the
    mask."""
    shape = (batch, max_len, n_kv, head_dim)
    if kv_bits < 32:
        dt = fxp_dtype(kv_bits)
        cache = {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "k_scale": torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                   device=device),
        }
    else:
        cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
    if ring:
        cache["pos"] = torch.full((batch, max_len), -1, dtype=torch.int32,
                                  device=device)
    return cache


def _quant_kv(x: Tensor, bits: int):
    """Per-(token, head) symmetric quantization over the head dim."""
    qmax = fxp_qmax(bits)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = div_scalar(torch.clamp_min(amax, 1e-12), qmax)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(fxp_dtype(bits))
    return q, scale.to(torch.float32)


def _write(buf: Tensor, new: Tensor, index: int) -> None:
    """``buf[:, index:index+S] = new``, with the start clamped so the
    write fits, as ``lax.dynamic_update_slice`` clamps it."""
    s = new.shape[1]
    start = min(max(int(index), 0), buf.shape[1] - s)
    buf[:, start:start + s] = new


def cache_update(cache, k_new: Tensor, v_new: Tensor, index,
                 kv_bits: int = 32):
    """Write k/v for positions [index, index+S) (decode: S == 1), in
    place; returns the cache."""
    if "pos" in cache:
        return _ring_update(cache, k_new, v_new, index, kv_bits)
    if kv_bits < 32:
        qk, sk = _quant_kv(k_new, kv_bits)
        qv, sv = _quant_kv(v_new, kv_bits)
        for key, new in (("k", qk), ("v", qv), ("k_scale", sk),
                         ("v_scale", sv)):
            _write(cache[key], new, index)
        return cache
    _write(cache["k"], k_new.to(cache["k"].dtype), index)
    _write(cache["v"], v_new.to(cache["v"].dtype), index)
    return cache


def _ring_update(cache, k_new: Tensor, v_new: Tensor, index,
                 kv_bits: int = 32):
    """Circular-buffer write, in place: position p lands in slot
    p % capacity."""
    B, S = k_new.shape[0], k_new.shape[1]
    cap = cache["k"].shape[1]
    pos = int(index) + torch.arange(S, device=k_new.device)
    slots = torch.remainder(pos, cap)
    if kv_bits < 32:
        qk, sk = _quant_kv(k_new, kv_bits)
        qv, sv = _quant_kv(v_new, kv_bits)
        for key, new in (("k", qk), ("v", qv), ("k_scale", sk),
                         ("v_scale", sv)):
            cache[key][:, slots] = new
    else:
        cache["k"][:, slots] = k_new.to(cache["k"].dtype)
        cache["v"][:, slots] = v_new.to(cache["v"].dtype)
    cache["pos"][:, slots] = pos[None, :].expand(B, S).to(torch.int32)
    return cache


def cache_kv(cache, dtype=torch.float32) -> Tuple[Tensor, Tensor]:
    """Read the cache back as fp tensors (dequantizing if int8)."""
    if "k_scale" in cache:
        k = cache["k"].to(dtype) * cache["k_scale"].to(dtype)
        v = cache["v"].to(dtype) * cache["v_scale"].to(dtype)
        return k, v
    return cache["k"].to(dtype), cache["v"].to(dtype)


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------

def _mask_bias(q_pos: Tensor, k_pos: Tensor, causal: bool,
               window: Optional[int], valid_len=None) -> Tensor:
    """Additive mask [*, S, T] from absolute positions."""
    i = q_pos[..., :, None]
    j = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(i.shape, j.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= (i - j) < window
    if valid_len is not None:
        ok &= j < valid_len
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _softmax(x: Tensor) -> Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum."""
    e = exact.exp(x - x.amax(dim=-1, keepdim=True))
    return e / exact.total(e)


def gqa_attend(q: Tensor, k: Tensor, v: Tensor, bias: Tensor,
               compute_dtype=torch.float32) -> Tensor:
    """Grouped path (decode: S small, KV read un-repeated).

    q:[B,S,H,D] k,v:[B,T,Hk,D] bias:[B?,S,T] -> [B,S,H,D]."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    qg = q.reshape(B, S, Hk, G, D).to(compute_dtype)
    scores = exact.einsum("bskgd,btkd->bkgst", qg, k.to(compute_dtype))
    scores = div_scalar(scores, math.sqrt(D))
    scores = scores.to(torch.float32) + bias[:, None, None]
    w = _softmax(scores).to(compute_dtype)
    out = exact.einsum("bkgst,btkd->bskgd", w, v.to(compute_dtype))
    return out.reshape(B, S, H, D)


def attend_full(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                k_pos: Tensor, *, causal: bool, window: Optional[int],
                compute_dtype=torch.float32,
                q_chunk: Optional[int] = 512) -> Tensor:
    """Train/prefill attention: KV repeated to H heads and Q taken in
    chunks of ``q_chunk`` rows, so the live score block is [B, H,
    q_chunk, T]; the mask is built per chunk from positions.

    q: [B,S,H,D]  k,v: [B,T,Hk,D]  q_pos: [B,S]  k_pos: [B,T].
    """
    B, S, H, D = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    k = constrain(k.to(compute_dtype), ("batch", None, "heads", None))
    v = constrain(v.to(compute_dtype), ("batch", None, "heads", None))
    q = constrain(q.to(compute_dtype), ("batch", None, "heads", None))

    def block(q_blk: Tensor, pos_blk: Tensor) -> Tensor:
        scores = exact.einsum("bshd,bthd->bhst", q_blk, k)
        # the scale rounded to the compute dtype, as the reference's
        # weak-typed Python number is
        scores = scores * scores.new_full((), 1.0 / math.sqrt(D))
        scores = constrain(scores, ("batch", "heads", None, None))
        bias = _mask_bias(pos_blk, k_pos, causal, window)
        scores = scores.to(torch.float32) + bias[:, None]
        w = _softmax(scores).to(compute_dtype)
        out = exact.einsum("bhst,bthd->bshd", w, v)
        return constrain(out, ("batch", None, "heads", None))

    if q_chunk is None or S <= q_chunk or S % q_chunk != 0:
        return block(q, q_pos)
    # remat each chunk: the backward recomputes its scores instead of
    # keeping every chunk's [B, H, q_chunk, T] softmax weights
    blk = checkpoint(block)
    return torch.cat([blk(q[:, i:i + q_chunk], q_pos[:, i:i + q_chunk])
                      for i in range(0, S, q_chunk)], dim=1)


def kv_groups(cfg: AttnConfig, lay: Layout) -> Optional[Tuple[int, int]]:
    """On a laid-out step whose q heads lie over the model axis and kv
    heads do not: the kv heads ``[lo, hi)`` this rank's q heads read;
    None where the kv heads are split with the q heads, or nothing is."""
    tp = lay.split("heads")
    if not tp or lay.split("kv_heads"):
        return None
    per = cfg.n_heads // axes_size(lay.mesh, tp)
    first = axes_index(lay.mesh, tp) * per
    group = cfg.n_heads // cfg.n_kv_heads
    return first // group, (first + per - 1) // group + 1


def kv_split(cfg: AttnConfig, lay: Optional[Layout]) -> Optional[str]:
    """How a laid-out serving step's KV cache lies over the model axis
    (``launch.steps.cache_shardings``): ``"heads"`` where its kv heads
    are split with the q heads, ``"seq"`` where its sequence is (the
    rules' ``cache_seq``), None where every model rank holds it whole,
    or off a laid-out step."""
    if lay is None or cfg.cross:
        return None
    if lay.split("kv_heads"):
        return "heads"
    return "seq" if lay.split("cache_seq") else None


def _own_groups(k: Tensor, v: Tensor, cfg: AttnConfig
                ) -> Tuple[Tensor, Tensor]:
    """``k`` and ``v`` of every kv head, cut to the groups this rank's q
    heads read (:func:`kv_groups`) on a laid-out step; as they are
    otherwise."""
    lay = layout()
    groups = kv_groups(cfg, lay) if lay is not None else None
    if groups is None:
        return k, v
    return k[:, :, groups[0]:groups[1]], v[:, :, groups[0]:groups[1]]


def model_summed(cfg: AttnConfig, lay: Layout):
    """The paths of the attention params whose gradient a laid-out step
    sums over the model axis: those every model rank holds whole but
    reads for its own heads alone (the kv projections of
    :func:`kv_groups`, the qk-norm scales)."""
    if not lay.split("heads"):
        return []
    out = []
    if kv_groups(cfg, lay) is not None:
        for name in ("wk", "wv"):
            out += [(name, "w")] + ([(name, "b")] if cfg.qkv_bias else [])
    if cfg.qk_norm:
        out += [("q_norm", "scale"), ("k_norm", "scale")]
    return out


def project_q(p, x: Tensor, cfg: AttnConfig, policy) -> Tensor:
    """The queries [B, S, H, D] (qk-normed if the config says so); on a
    laid-out step, this rank's heads."""
    ax = attention_axes(cfg)["wq"]["w"]
    q = linear_apply(p["wq"], x, policy, ax).reshape(
        x.shape[0], x.shape[1], -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q)
    return q


def project_kv(p, kv_src: Tensor, cfg: AttnConfig, policy,
               own_groups: bool = True) -> Tuple[Tensor, Tensor]:
    """The keys and values [B, T, Hk, D] of ``kv_src`` (the keys
    qk-normed if the config says so); on a laid-out step, the kv heads
    this rank's q heads read (every kv head the rank projects, for its
    cache, without ``own_groups``)."""
    B, T, D = kv_src.shape[0], kv_src.shape[1], cfg.head_dim
    ax = attention_axes(cfg)["wk"]["w"]
    k = linear_apply(p["wk"], kv_src, policy, ax).reshape(B, T, -1, D)
    v = linear_apply(p["wv"], kv_src, policy, ax).reshape(B, T, -1, D)
    if own_groups:
        k, v = _own_groups(k, v, cfg)
    if cfg.qk_norm:
        k = rmsnorm_apply(p["k_norm"], k)
    return k, v


def _compute_dtype(policy: Optional[QuantPolicy]):
    return policy.compute_dtype if policy else torch.float32


def attention_apply(p, x: Tensor, cfg: AttnConfig,
                    policy: Optional[QuantPolicy] = None, *,
                    positions: Optional[Tensor] = None,
                    encoder_out: Optional[Tensor] = None,
                    cache=None, kv_bits: int = 32,
                    return_cache: bool = False,
                    kv: Optional[Tuple[Tensor, Tensor]] = None,
                    scatter: Optional[int] = None):
    """Full-sequence attention (train / prefill).

    If ``return_cache`` and not cross-attention, also returns the filled
    KV cache (quantized per kv_bits) for later decode steps.  ``kv``:
    the keys and values ``project_kv`` gave already (an enc-dec prefill
    projects the encoder's once for its cross cache and its attention),
    in place of projecting them here.  ``scatter``: on a laid-out step,
    the dimension ``wo``'s sum is reduce-scattered along (sequence
    parallelism).
    """
    B, S, _ = x.shape
    kv_src = encoder_out if cfg.cross else x
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    caching = return_cache and not cfg.cross
    q = project_q(p, x, cfg, policy)
    k, v = project_kv(p, kv_src, cfg, policy, own_groups=not caching) \
        if kv is None else kv
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        if not cfg.cross:
            k = apply_rope(k, positions, cfg.rope_theta)
    T = k.shape[1]
    k_pos = torch.arange(T, device=x.device)[None, :].expand(B, T)
    # the cache holds every kv head this rank projects; the attention
    # reads its q heads' groups
    k_att, v_att = _own_groups(k, v, cfg) if caching else (k, v)
    out = attend_full(q, k_att, v_att, positions, k_pos,
                      causal=cfg.causal and not cfg.cross,
                      window=cfg.window, compute_dtype=_compute_dtype(policy),
                      q_chunk=cfg.q_chunk)
    out = linear_apply(p["wo"], out.reshape(B, S, -1), policy,
                       attention_axes(cfg)["wo"]["w"], scatter)
    if caching:
        lay = layout()
        if kv_split(cfg, lay) == "seq":
            # this rank's positions of every kv head: a slice, sent nowhere
            axes = lay.split("cache_seq")
            n = T // axes_size(lay.mesh, axes)
            first = axes_index(lay.mesh, axes) * n
            k, v = k[:, first:first + n], v[:, first:first + n]
        if cache is None:
            cache = init_cache(B, k.shape[1], k.shape[2], cfg.head_dim,
                               kv_bits, k.dtype, device=x.device)
        cache = cache_update(cache, k, v, 0, kv_bits)
        return out, cache
    return out


def _attend_positions(q: Tensor, k: Tensor, v: Tensor, bias: Tensor,
                      compute_dtype, mesh, axes) -> Tensor:
    """:func:`gqa_attend` of every head's queries ``q`` [B, S, H, D] on
    this rank's positions of a cache split along its sequence over
    ``axes`` (``k``, ``v`` [B, T / n, Hk, D], ``bias`` from the global
    positions): the row max a ``pmax``; the sum of the ``exp`` terms and
    the value contraction's partials kept in fp64, summed over the peers
    and rounded once after it, as the whole cache's program rounds
    them.  Every peer gets every head's output."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    qg = q.reshape(B, S, Hk, H // Hk, D).to(compute_dtype)
    scores = exact.einsum("bskgd,btkd->bkgst", qg, k.to(compute_dtype))
    scores = div_scalar(scores, math.sqrt(D))
    scores = scores.to(torch.float32) + bias[:, None, None]
    e = exact.exp(scores - pmax(scores.amax(dim=-1, keepdim=True), mesh,
                                axes))
    total = psum(e.to(torch.float64).sum(dim=-1, keepdim=True), mesh, axes)
    w = (e / total.to(e.dtype)).to(compute_dtype)
    part = torch.einsum("bkgst,btkd->bskgd", w.to(torch.float64),
                        v.to(compute_dtype).to(torch.float64))
    return psum(part, mesh, axes).to(compute_dtype).reshape(B, S, H, D)


def _decode_seq_split(q: Tensor, k_new: Tensor, v_new: Tensor, cache,
                      index: int, positions: Tensor, cfg: AttnConfig,
                      lay: Layout, kv_bits: int, cdt) -> Tensor:
    """One decode step's attention on a cache split along its sequence
    (flash-decoding): the new k/v written by the rank that owns
    ``index`` alone (clamped as a whole cache's write is), every head's
    queries gathered over the model axis (``[B, 1, H, D]``: bytes, not
    the cache) and attended on this rank's positions
    (:func:`_attend_positions`); this rank's heads' output."""
    axes = lay.split("cache_seq")
    n, r = axes_size(lay.mesh, axes), axes_index(lay.mesh, axes)
    B, T = k_new.shape[0], cache["k"].shape[1]
    at = min(max(int(index), 0), n * T - 1)
    if at // T == r:
        cache_update(cache, k_new, v_new, at - r * T, kv_bits)
    k, v = cache_kv(cache, cdt)
    k_pos = (r * T + torch.arange(T, device=q.device))[None, :].expand(B, T)
    bias = _mask_bias(positions, k_pos, causal=True, window=cfg.window,
                      valid_len=index + 1)
    heads = lay.split("heads")
    q_all = torch.cat(gather_over(q.contiguous(), lay.mesh, heads), dim=2)
    out = _attend_positions(q_all, k, v, bias, cdt, lay.mesh, axes)
    h = q.shape[2]
    first = axes_index(lay.mesh, heads) * h
    return out[:, :, first:first + h]


def attention_decode(p, x: Tensor, cfg: AttnConfig, cache,
                     cache_index: int,
                     policy: Optional[QuantPolicy] = None, *,
                     encoder_out: Optional[Tensor] = None,
                     cross_cache=None, kv_bits: int = 32):
    """One-token decode step against a fixed-capacity cache.

    x: [B, 1, d_model]; cache_index: the current length (an int).
    Returns (out [B,1,d_model], the cache, updated in place).  On a
    laid-out step the cache is this rank's block (:func:`kv_split`).
    """
    B = x.shape[0]
    positions = torch.full((B, 1), int(cache_index), dtype=torch.int32,
                           device=x.device)
    cdt = _compute_dtype(policy)
    wo_axes = attention_axes(cfg)["wo"]["w"]
    if cfg.cross:
        # cross-attention: cross_cache holds the (static) encoder K/V
        k, v = cache_kv(cross_cache, cdt)
        # the reference projects k and v of x here too and drops them
        # (dead code under jit); only the queries are projected
        q = project_q(p, x, cfg, policy)
        if cfg.rope:
            q = apply_rope(q, positions, cfg.rope_theta)
        T = k.shape[1]
        k_pos = torch.arange(T, device=x.device)[None, :].expand(B, T)
        bias = _mask_bias(positions, k_pos, causal=False, window=None)
        out = gqa_attend(q, k, v, bias, cdt)
        out = linear_apply(p["wo"], out.reshape(B, 1, -1), policy)
        return out, cache
    lay = layout()
    if lay is not None and "pos" in cache:
        raise ValueError("a ring-buffer cache's slot positions are not "
                         "laid out: a laid-out decode takes a full cache")
    q = project_q(p, x, cfg, policy)
    k_new, v_new = project_kv(p, x, cfg, policy, own_groups=False)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    if kv_split(cfg, lay) == "seq":
        out = _decode_seq_split(q, k_new, v_new, cache, cache_index,
                                positions, cfg, lay, kv_bits, cdt)
        out = linear_apply(p["wo"], out.reshape(B, 1, -1), policy, wo_axes)
        return out, cache
    cache = cache_update(cache, k_new, v_new, cache_index, kv_bits)
    k, v = _own_groups(*cache_kv(cache, cdt), cfg)
    T = k.shape[1]
    if "pos" in cache:
        # ring buffer: mask from the stored absolute positions
        k_pos = cache["pos"]                               # [B, T]
        ok = (k_pos >= 0) & (k_pos <= cache_index)
        if cfg.window is not None:
            ok &= k_pos > (cache_index - cfg.window)
        bias = torch.where(ok, 0.0, NEG_INF)[:, None, :].to(torch.float32)
    else:
        k_pos = torch.arange(T, device=x.device)[None, :].expand(B, T)
        bias = _mask_bias(positions, k_pos, causal=True, window=cfg.window,
                          valid_len=cache_index + 1)
    out = gqa_attend(q, k, v, bias, cdt)
    out = linear_apply(p["wo"], out.reshape(B, 1, -1), policy, wo_axes)
    return out, cache
