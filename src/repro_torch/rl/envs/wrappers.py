"""Composable environment wrappers (port of ``repro.rl.envs.wrappers``):
affine observation and reward transforms, a time limit, the MLP view of
image envs and the pixel pipeline.

Each wrapper takes an :class:`Environment` and returns a new one whose
batched reset/step close over the inner functions; a wrapper that needs
a carry (time-limit counter, frame buffer, Welford stats) wraps the
inner state in a NamedTuple with the reference's field names, so
checkpointed env states carry the same keys in both packages.  Every
wrapper tags its step (``wrapper_stack(env)``), so the order-sensitive
composition can be checked: normalize raw frames first, stack after
(:func:`pixel_pipeline`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.rl.envs.base import Environment, auto_reset, split_key
from repro_torch.rl.envs.spaces import Box

Tensor = torch.Tensor


def wrapper_stack(env: Environment) -> Tuple[str, ...]:
    """Names of the wrappers applied to ``env``, outermost first."""
    return getattr(env.step, "_wrapper_stack", ())


def _wrap(env: Environment, name: str, *, reset, step,
          spec=None) -> Environment:
    step._wrapper_stack = (name,) + wrapper_stack(env)
    return env.replace(spec=spec if spec is not None else env.spec,
                       reset=reset, step=step)


def _per_env(mask: Tensor, like: Tensor) -> Tensor:
    """A [B] mask (or count) shaped to broadcast over ``like``'s leaves."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


# ---------------------------------------------------------------------------
# stateless observation / reward transforms
# ---------------------------------------------------------------------------

def normalize_observation(env: Environment, mean, std) -> Environment:
    """Affine observation transform ``(obs - mean) / std`` with constant
    ``mean``/``std`` (scalars or obs-shaped)."""
    mean = torch.as_tensor(mean, dtype=torch.float32)
    std = torch.as_tensor(std, dtype=torch.float32)
    if bool((std == 0).any()):
        raise ValueError("normalize_observation: std must be non-zero")

    def norm(obs: Tensor) -> Tensor:
        return (obs.to(torch.float32) - mean.to(obs.device)) \
            / std.to(obs.device)

    def reset(key):
        state, obs = env.reset(key)
        return state, norm(obs)

    def step(state, action):
        state, obs, reward, done, truncated, final_obs = \
            env.step(state, action)
        return state, norm(obs), reward, done, truncated, norm(final_obs)

    in_space = env.observation_space
    if isinstance(in_space, Box) and in_space.bounded:
        # the elementwise bounds' tightest enclosing interval (a negative
        # std flips low and high per element)
        lo = (in_space.low - mean) / std
        hi = (in_space.high - mean) / std
        space = Box(float(torch.minimum(lo, hi).min()),
                    float(torch.maximum(lo, hi).max()), env.obs_shape)
    else:
        space = Box(-math.inf, math.inf, env.obs_shape)
    spec = dataclasses.replace(env.spec, observation_space=space)
    return _wrap(env, "normalize_observation", reset=reset, step=step,
                 spec=spec)


def scale_reward(env: Environment, scale: float) -> Environment:
    """Multiply rewards by a constant (rounded to fp32)."""

    def step(state, action):
        state, obs, reward, done, truncated, final_obs = \
            env.step(state, action)
        return (state, obs, reward * reward.new_full((), scale), done,
                truncated, final_obs)

    return _wrap(env, "scale_reward", reset=env.reset, step=step)


# ---------------------------------------------------------------------------
# the MLP view of image envs
# ---------------------------------------------------------------------------

def flatten_observation(env: Environment) -> Environment:
    """Ravel observations to 1-D: lets MLP policies drive pixel envs."""
    flat = int(math.prod(env.obs_shape))

    def ravel(obs: Tensor) -> Tensor:
        return obs.reshape(obs.shape[0], flat).to(torch.float32)

    def reset(key):
        state, obs = env.reset(key)
        return state, ravel(obs)

    def step(state, action):
        state, obs, reward, done, truncated, final_obs = \
            env.step(state, action)
        return state, ravel(obs), reward, done, truncated, ravel(final_obs)

    in_space = env.observation_space
    if isinstance(in_space, Box):
        space = Box(in_space.low, in_space.high, (flat,))
    else:
        space = Box(-math.inf, math.inf, (flat,))
    spec = dataclasses.replace(env.spec, observation_space=space)
    return _wrap(env, "flatten_observation", reset=reset, step=step,
                 spec=spec)


def ensure_vector_obs(env: Environment) -> Environment:
    """The MLP-policy view of any env: identity for vector observations,
    ``flatten_observation`` for image grids."""
    if len(env.obs_shape) == 1:
        return env
    return flatten_observation(env)


# ---------------------------------------------------------------------------
# time limit
# ---------------------------------------------------------------------------

class TimeLimitState(NamedTuple):
    inner: Any
    t: Tensor           # [B] int32 steps taken in the current episode
    key: Tensor         # [B, 2] int64 reset stream of the forced reset


def time_limit(env: Environment, max_steps: int) -> Environment:
    """Truncate episodes after ``max_steps`` wrapper-level steps.

    A pure timeout is reported as ``truncated`` (never folded into
    ``done``); if the inner env terminates on the timeout tick, ``done``
    wins.  On a pure timeout the inner env is reset from the wrapper's
    own stream, which then moves to a new one; ``final_obs`` stays the
    pre-reset observation.
    """

    def reset(key):
        state, obs = env.reset(key)
        t = torch.zeros(key.shape[0], dtype=torch.int32, device=key.device)
        return TimeLimitState(state, t, split_key(key)), obs

    def step(state, action):
        inner, obs, reward, done, truncated, final_obs = \
            env.step(state.inner, action)
        t = state.t + 1
        # a pure wrapper timeout: the episode still alive at the limit
        timeout = (t >= max_steps) & ~done & ~truncated
        truncated = truncated | timeout
        fresh_inner, fresh_obs = env.reset(state.key)
        inner = auto_reset(timeout, fresh_inner, inner)
        obs = torch.where(_per_env(timeout, obs), fresh_obs, obs)
        key = torch.where(timeout[:, None], split_key(state.key), state.key)
        t = torch.where(done | truncated, 0, t).to(torch.int32)
        return TimeLimitState(inner, t, key), obs, reward, done, \
            truncated, final_obs

    spec = dataclasses.replace(env.spec,
                               max_steps=min(env.spec.max_steps,
                                             max_steps))
    return _wrap(env, "time_limit", reset=reset, step=step, spec=spec)


# ---------------------------------------------------------------------------
# frame stacking
# ---------------------------------------------------------------------------

class FrameStackState(NamedTuple):
    inner: Any
    frames: Tensor      # [B, k, *obs_shape], frames[:, -1] is newest


def frame_stack(env: Environment, k: int) -> Environment:
    """Stack the last ``k`` observations along the trailing axis: images
    (H, W, C) become (H, W, C*k).  On an episode boundary the buffer
    refills with the fresh episode's first observation."""
    if k < 1:
        raise ValueError(f"frame_stack needs k >= 1, got {k}")

    def stacked(frames: Tensor) -> Tensor:
        return torch.cat([frames[:, i] for i in range(k)], dim=-1)

    def reset(key):
        state, obs = env.reset(key)
        frames = torch.stack([obs] * k, dim=1)
        return FrameStackState(state, frames), stacked(frames)

    def step(state, action):
        inner, obs, reward, done, truncated, final_obs = \
            env.step(state.inner, action)
        final = torch.cat([state.frames[:, 1:], final_obs[:, None]], dim=1)
        rolled = torch.cat([state.frames[:, 1:], obs[:, None]], dim=1)
        fresh = torch.stack([obs] * k, dim=1)
        frames = torch.where(_per_env(done | truncated, rolled), fresh,
                             rolled)
        return (FrameStackState(inner, frames), stacked(frames),
                reward, done, truncated, stacked(final))

    in_space = env.observation_space
    shape = in_space.shape[:-1] + (in_space.shape[-1] * k,)
    low = in_space.low if isinstance(in_space, Box) else -math.inf
    high = in_space.high if isinstance(in_space, Box) else math.inf
    spec = dataclasses.replace(env.spec,
                               observation_space=Box(low, high, shape))
    return _wrap(env, "frame_stack", reset=reset, step=step, spec=spec)


# ---------------------------------------------------------------------------
# running observation statistics (Welford carry in env state)
# ---------------------------------------------------------------------------

class NormStats(NamedTuple):
    """Welford accumulator: ``count`` is [B] per env (or a scalar once
    merged), ``mean``/``m2`` obs-shaped with the same leading axes.
    ``var = m2 / count`` (population)."""

    count: Tensor
    mean: Tensor
    m2: Tensor

    @property
    def std(self) -> Tensor:
        count = _per_env(self.count, self.mean)
        return torch.sqrt(self.m2 / torch.clamp_min(count, 1.0))


def init_norm_stats(batch: int, obs_shape, device="cpu") -> NormStats:
    return NormStats(
        torch.zeros(batch, dtype=torch.float32, device=device),
        torch.zeros((batch, *obs_shape), dtype=torch.float32, device=device),
        torch.zeros((batch, *obs_shape), dtype=torch.float32, device=device))


def _welford_update(stats: NormStats, x: Tensor) -> NormStats:
    count = stats.count + 1.0
    delta = x - stats.mean
    mean = stats.mean + delta / _per_env(count, x)
    return NormStats(count, mean, stats.m2 + delta * (x - mean))


def _normalize_with(stats: NormStats, x: Tensor,
                    eps: float = 1e-8) -> Tensor:
    """(x - mean) / (std + eps); identity while the stream is empty."""
    seen = _per_env(stats.count > 0.0, stats.mean)
    mean = torch.where(seen, stats.mean, 0.0)
    std = torch.where(seen, stats.std, 1.0)
    return (x.to(torch.float32) - mean) / (std + eps)


def merge_norm_stats(stats: NormStats) -> NormStats:
    """Chan's parallel Welford merge over the leading (env) axis: per-env
    carries [B, ...] -> one fleet-wide NormStats (scalar count)."""
    counts = stats.count.reshape(-1)
    b = counts.shape[0]
    mean_b = stats.mean.reshape((b,) + tuple(stats.mean.shape[1:]))
    m2_b = stats.m2.reshape((b,) + tuple(stats.m2.shape[1:]))
    n = counts.sum()
    cshape = (b,) + (1,) * (mean_b.ndim - 1)
    w = counts.reshape(cshape) / torch.clamp_min(n, 1.0)
    mean = (w * mean_b).sum(dim=0)
    m2 = (m2_b + counts.reshape(cshape)
          * torch.square(mean_b - mean)).sum(dim=0)
    return NormStats(n, mean, m2)


class RunningNormState(NamedTuple):
    inner: Any
    stats: NormStats


def norm_stats_of(state) -> NormStats:
    """The Welford carry of a (possibly further-wrapped) env state."""
    while True:
        if isinstance(state, RunningNormState):
            return state.stats
        if not hasattr(state, "inner"):
            raise TypeError(
                "no running_normalize_observation carry found in this "
                "env state — was the env built with the wrapper?")
        state = state.inner


def running_normalize_observation(env: Environment,
                                  stats: Optional[NormStats] = None,
                                  eps: float = 1e-8) -> Environment:
    """Normalize observations by running mean/std.

    ``stats=None`` (training): a per-env Welford carry is threaded
    through the env state; every emitted observation updates it first
    and is normalized with the updated stats (``final_obs`` with the
    same stats, no second update).  ``stats=NormStats`` (evaluation,
    serving): the given (merged) statistics are constants, never
    updated.  Statistics are over raw single frames, so wrapping a
    frame-stacked env is refused.
    """
    if "frame_stack" in wrapper_stack(env):
        raise ValueError(
            "running_normalize_observation must wrap the raw env, not a "
            "frame-stacked one: Welford statistics are defined over raw "
            "single frames. Apply running_normalize_observation first "
            "and frame_stack second (pixel_pipeline does this).")
    space = Box(-math.inf, math.inf, env.obs_shape)
    spec = dataclasses.replace(env.spec, observation_space=space)

    if stats is not None:
        frozen = stats

        def reset(key):
            state, obs = env.reset(key)
            return state, _normalize_with(frozen, obs, eps)

        def step(state, action):
            state, obs, reward, done, truncated, final_obs = \
                env.step(state, action)
            return (state, _normalize_with(frozen, obs, eps), reward,
                    done, truncated, _normalize_with(frozen, final_obs,
                                                     eps))

        return _wrap(env, "running_normalize_observation", reset=reset,
                     step=step, spec=spec)

    def reset(key):
        state, obs = env.reset(key)
        st = _welford_update(
            init_norm_stats(obs.shape[0], env.obs_shape, obs.device), obs)
        return RunningNormState(state, st), _normalize_with(st, obs, eps)

    def step(state, action):
        inner, obs, reward, done, truncated, final_obs = \
            env.step(state.inner, action)
        st = _welford_update(state.stats, obs)
        return (RunningNormState(inner, st), _normalize_with(st, obs, eps),
                reward, done, truncated,
                _normalize_with(st, final_obs, eps))

    return _wrap(env, "running_normalize_observation", reset=reset,
                 step=step, spec=spec)


def pixel_pipeline(env: Environment, k: int = 1,
                   stats: Optional[NormStats] = None) -> Environment:
    """The pixel stack for conv agents: running (or frozen) observation
    normalization over raw frames, THEN frame stacking."""
    if k < 1:
        raise ValueError(f"pixel_pipeline needs frame_stack k >= 1, "
                         f"got {k}")
    if len(env.obs_shape) != 3:
        raise ValueError(
            f"pixel_pipeline needs image (H, W, C) observations; "
            f"{env.spec.name} has shape {env.obs_shape}")
    env = running_normalize_observation(env, stats=stats)
    return frame_stack(env, k) if k > 1 else env
