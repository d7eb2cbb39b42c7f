"""Batched policy inference: micro-batching engine + episode slots (port
of ``repro.serve.engine``).

Requests are assembled into power-of-two buckets (pad-to-bucket), as in
the reference.  The padding is part of the result, not only of the
cost: the per-tensor requantization after each layer takes its scale
over every row of the bucket, zero padding rows included, so the port
pads exactly as the reference does and its Q-values agree row for row.
The engine records each request's wall latency (a micro-batch's wall,
synchronized with the card) in a bounded histogram, and the requests of
each bucket size, and reports actions/s, p50/p99 and the packed model
footprint; :func:`serve_episodes` writes them as ``obs/v1`` ``serve``
windows when given a sink.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.core.quantizer import quantized_nbytes
from repro_torch.obs import SCHEMA, FixedHistogram, JsonlSink, SpanClock
from repro_torch.rl.rollout import init_envs
from repro_torch.serve.loader import PRECISIONS, ServedPolicy


def bucket_sizes(max_bucket: int) -> List[int]:
    """Power-of-two bucket ladder: 1, 2, 4, ..., max_bucket."""
    if max_bucket < 1:
        raise ValueError(f"max_bucket must be >= 1, got {max_bucket}")
    sizes = []
    b = 1
    while b < max_bucket:
        sizes.append(b)
        b *= 2
    sizes.append(max_bucket)
    return sizes


def bucket_for(n: int, sizes: List[int]) -> int:
    """Smallest bucket that fits ``n`` requests (the largest caps)."""
    for b in sizes:
        if n <= b:
            return b
    return sizes[-1]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PolicyServer:
    """Micro-batched action server over one packed policy.

    ``act(obs)`` answers an [N, ...] observation batch of any N: chunks
    of ``max_bucket`` go through whole, the remainder pads up to the
    smallest fitting bucket.  ``mode="greedy"`` is the evaluation head
    (bit-identical at w8 to evaluation under fxp8); ``mode="sample"``
    draws Boltzmann actions at ``temperature`` from a generator on the
    policy's device seeded with ``seed``.
    """

    def __init__(self, policy: ServedPolicy, precision: str = "w8",
                 mode: str = "greedy", temperature: float = 1.0,
                 max_bucket: int = 256, seed: int = 0):
        if mode not in ("greedy", "sample"):
            raise ValueError(f"unknown serving mode {mode!r} "
                             "(expected 'greedy' or 'sample')")
        self.policy = policy
        self.precision = precision
        self.mode = mode
        self.temperature = float(temperature)
        self.buckets = bucket_sizes(max_bucket)
        self.max_bucket = max_bucket
        self.device = policy.device

        packed, apply_policy = policy.pack(precision)
        self.served_params = policy.agent.from_behaviour(packed)
        self.apply_policy = apply_policy
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # bucket sizes warmed (each has run once, outside any latency)
        self._warm: Set[int] = set()
        self._latency = FixedHistogram()
        self._bucket_requests: Dict[int, int] = {}
        self._requests = 0
        self._infer_s = 0.0

    def _run(self, obs: torch.Tensor) -> torch.Tensor:
        agent, pol = self.policy.agent, self.apply_policy
        if self.mode == "greedy":
            return agent.greedy(self.served_params, obs, pol)
        return agent.sampled(self.served_params, obs, self._gen,
                             temperature=self.temperature, policy=pol)

    def warmup(self, n_slots: Optional[int] = None):
        """Run each bucket a ``n_slots``-wide slot bank will hit (all
        buckets when ``None``) once, so first-call costs (kernel builds,
        allocator growth) never land in a request latency."""
        if n_slots is None:
            need = list(self.buckets)
        else:
            need = []
            n = n_slots
            while n > 0:
                b = bucket_for(min(n, self.max_bucket), self.buckets)
                if b not in need:
                    need.append(b)
                n -= min(n, self.max_bucket)
        shape = tuple(self.policy.env.obs_shape)
        for b in need:
            self._run(torch.zeros((b,) + shape, dtype=torch.float32,
                                  device=self.device))
            self._warm.add(b)
        _sync(self.device)

    def act(self, obs: torch.Tensor) -> torch.Tensor:
        """Actions for an [N, ...] observation batch, micro-batched."""
        obs = torch.as_tensor(obs, device=self.device)
        n = obs.shape[0]
        outs = []
        start = 0
        while start < n:
            chunk = min(n - start, self.max_bucket)
            bucket = bucket_for(chunk, self.buckets)
            block = obs[start:start + chunk]
            if bucket != chunk:
                pad = block.new_zeros((bucket - chunk,) + block.shape[1:])
                block = torch.cat([block, pad])
            t0 = time.perf_counter()
            acts = self._run(block)
            _sync(self.device)
            dt = time.perf_counter() - t0
            self._warm.add(bucket)
            self._latency.observe(dt, n=chunk)
            self._bucket_requests[bucket] = (
                self._bucket_requests.get(bucket, 0) + chunk)
            self._requests += chunk
            self._infer_s += dt
            outs.append(acts[:chunk])
            start += chunk
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def model_bytes(self):
        """(stored bytes, fp32 bytes) of the served behaviour subtree."""
        return quantized_nbytes(
            self.policy.agent.behaviour_subtree(self.served_params))

    def stats(self) -> Dict[str, float]:
        stored, fp32 = self.model_bytes()
        return {
            "requests": float(self._requests),
            "infer_s": self._infer_s,
            "actions_per_s": (self._requests / self._infer_s
                              if self._infer_s > 0 else 0.0),
            "p50_ms": self._latency.percentile(50) * 1e3,
            "p99_ms": self._latency.percentile(99) * 1e3,
            "model_bytes": float(stored),
            "model_fp32_bytes": float(fp32),
            "compression": stored / fp32 if fp32 else 1.0,
            # one program per bucket in the reference (a jit each); here
            # the bucket sizes warmed
            "jit_programs": float(len(self._warm)),
        }

    def bucket_requests(self) -> Dict[int, int]:
        """Requests answered per padded micro-batch bucket size."""
        return dict(self._bucket_requests)

    def latency_hist(self) -> Dict:
        """The latency histogram's ``{edges, counts}`` (seconds)."""
        return self._latency.to_dict()

    def reset_stats(self):
        self._latency.reset()
        self._bucket_requests = {}
        self._requests = 0
        self._infer_s = 0.0


@dataclasses.dataclass
class EpisodeStats:
    """What one :func:`serve_episodes` run produced."""

    episodes: int
    env_steps: int
    mean_return: float
    wall_s: float
    server: Dict[str, float]
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)


def serve_episodes(server: PolicyServer, episodes: int, n_slots: int = 64,
                   seed: int = 0, max_env_steps: Optional[int] = None,
                   telemetry: Optional[JsonlSink] = None,
                   flush_every: int = 0) -> EpisodeStats:
    """Run ``n_slots`` concurrent auto-resetting episode slots on the
    policy's device until ``episodes`` episodes complete, every action
    answered through the server's micro-batching path.

    With ``telemetry`` (a :class:`~repro_torch.obs.sink.JsonlSink`) the
    loop writes ``serve`` records: one per ``flush_every`` loop steps (0:
    one record for the whole run), each with the window's request count,
    inference seconds, env steps and finished episodes, the latency
    histogram's delta, the per-bucket request counts and the
    ``infer``/``env`` spans.  ``EpisodeStats.spans`` holds the spans no
    record took: the whole run's without ``telemetry``.
    """
    if n_slots < 1:
        raise ValueError(f"n_slots must be >= 1, got {n_slots}")
    env = server.policy.env
    cap = (max_env_steps if max_env_steps is not None
           else env.spec.max_steps * (episodes + 2 * n_slots))
    est, obs = init_envs(env, seed, n_slots, server.device)
    server.warmup(n_slots)
    # one throwaway step outside the timed region, then fresh stats
    env.step(est, server.act(obs))
    _sync(server.device)
    server.reset_stats()

    clock = SpanClock()
    prev_r = 0
    prev_inf = 0.0
    prev_counts = np.array(server._latency.counts)
    prev_buckets: Dict[int, int] = {}
    prev_steps = prev_eps = 0

    def flush_window(env_steps: int, done_episodes: int):
        nonlocal prev_r, prev_inf, prev_counts, prev_buckets
        nonlocal prev_steps, prev_eps
        r1 = server._requests
        if telemetry is None or r1 == prev_r:
            return
        counts = np.array(server._latency.counts)
        buckets = server.bucket_requests()
        telemetry.write({
            "schema": SCHEMA, "kind": "serve", "t_wall": time.time(),
            "window": [prev_r, r1],
            "metrics": {"requests": r1 - prev_r,
                        "infer_s": server._infer_s - prev_inf,
                        "env_steps": env_steps - prev_steps,
                        "episodes": done_episodes - prev_eps},
            "hists": {"latency_s": {
                "edges": [float(e) for e in server._latency.edges],
                "counts": [int(c) for c in counts - prev_counts]}},
            "buckets": {str(b): n - prev_buckets.get(b, 0)
                        for b, n in buckets.items()
                        if n - prev_buckets.get(b, 0)},
            "spans": clock.drain(),
        })
        prev_r, prev_inf, prev_counts = r1, server._infer_s, counts
        prev_buckets = buckets
        prev_steps, prev_eps = env_steps, done_episodes

    done_episodes = 0
    env_steps = 0
    loop_steps = 0
    acc = np.zeros(n_slots, np.float64)       # running per-slot return
    returns: List[float] = []
    t0 = time.perf_counter()
    while done_episodes < episodes and env_steps < cap:
        with clock("infer"):
            acts = server.act(obs)
        with clock("env"):
            est, obs, r, d, tr, _ = env.step(est, acts)
            fin = (d | tr).cpu().numpy()
            r = r.cpu().numpy()
        env_steps += n_slots
        loop_steps += 1
        acc += r.astype(np.float64)
        if fin.any():
            returns.extend(acc[fin].tolist())
            done_episodes += int(fin.sum())
            acc[fin] = 0.0
        if flush_every and loop_steps % flush_every == 0:
            flush_window(env_steps, done_episodes)
    wall = time.perf_counter() - t0
    flush_window(env_steps, done_episodes)
    mean_ret = float(np.mean(returns)) if returns else float("nan")
    return EpisodeStats(episodes=done_episodes, env_steps=env_steps,
                        mean_return=mean_ret, wall_s=wall,
                        server=server.stats(), spans=clock.drain())


def check_parity(policy: ServedPolicy, precision: str = "w8",
                 n_obs: int = 128, seed: int = 0) -> int:
    """Count of observations (rows) whose served greedy action (packed
    QTensor weights) differs from the evaluation greedy head's (fp32
    weights under the same quant policy) on a rollout of real
    observations; a multi-dimensional action counts once.  Zero at w8
    by construction: both round on the same fxp8 grid in the same
    order."""
    if precision not in PRECISIONS or precision == "fp32":
        raise ValueError("parity is defined for the packed precisions "
                         f"('w8', 'w4'), got {precision!r}")
    env, agent = policy.env, policy.agent
    n_slots = min(n_obs, 32)
    est, obs = init_envs(env, seed, n_slots, policy.device)
    packed, pol = policy.pack(precision)
    served = agent.from_behaviour(packed)
    mismatches = 0
    seen = 0
    while seen < n_obs:
        a_eval = agent.greedy(policy.params, obs, pol)
        a_serve = agent.greedy(served, obs, pol)
        diff = a_eval != a_serve
        if diff.ndim > 1:
            diff = diff.reshape(diff.shape[0], -1).any(dim=1)
        mismatches += int(diff.sum())
        seen += n_slots
        est, obs, *_ = env.step(est, a_eval)
    return mismatches
