"""Small actor-critic and Q networks (port of ``repro.rl.nets``: the
``mlp_ac_*`` actor-critic and the ``conv_*`` torso with its actor-critic
and Q heads).

Every product is a Q-MAC (``q_matmul`` under the QuantPolicy), every
activation a V-ACT, so the quantized actors exercise exactly the
quantized paths:

  * ``mlp_ac_*`` — a 2-layer tanh torso over flat [B, D] observations
    with a distribution head and a value head (the PPO/A2C agent);
  * ``conv_*`` — the paper's vision stem: stride-2 Q-Conv blocks (stride
    replaces pooling, ReLU after) over [B, H, W, C] pixel observations,
    a dense layer to ``hidden`` features, then policy and value heads
    (``conv_ac_*``, the pixel PPO/A2C agent) or a linear Q head
    (``conv_q_*``).

The quantile heads arrive with the value slice.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.core.vact import activation
from repro_torch.nn.conv import conv2d_init, qconv_block
from repro_torch.nn.linear import linear_apply, linear_init

def mlp_ac_init(gen: torch.Generator, obs_dim: int, head_dim: int,
                hidden: int = 64, dtype=torch.float32, device="cpu"):
    """``head_dim`` = spaces.head_dim(action_space): n logits for
    Discrete, 2*act_dim (mean, log_std) for Box."""
    return {
        "torso": {
            "fc1": linear_init(gen, obs_dim, hidden, dtype=dtype,
                               device=device),
            "fc2": linear_init(gen, hidden, hidden, dtype=dtype,
                               device=device),
        },
        "pi": linear_init(gen, hidden, head_dim, dtype=dtype,
                          device=device),
        "v": linear_init(gen, hidden, 1, dtype=dtype, device=device),
    }


def mlp_ac_apply(params, obs: torch.Tensor,
                 policy: Optional[QuantPolicy] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, D] -> (dist params [B, H], value [B])."""
    h = activation(linear_apply(params["torso"]["fc1"], obs, policy),
                   "tanh", policy)
    h = activation(linear_apply(params["torso"]["fc2"], h, policy),
                   "tanh", policy)
    logits = linear_apply(params["pi"], h, policy)
    value = linear_apply(params["v"], h, policy)[..., 0]
    return logits, value


CONV_CHANNELS = (16, 32)
CONV_KERNEL = 3
CONV_HIDDEN = 128


def conv_flat_dim(obs_shape: Tuple[int, ...],
                  channels: Sequence[int] = CONV_CHANNELS) -> int:
    """Flattened feature size after the stride-2 stack (SAME padding
    halves each spatial dim, rounding up)."""
    h, w, _ = obs_shape
    for _ in channels:
        h = (h + 1) // 2
        w = (w + 1) // 2
    return h * w * channels[-1]


def conv_torso_init(gen: torch.Generator, obs_shape: Tuple[int, ...],
                    channels: Sequence[int] = CONV_CHANNELS,
                    kernel: int = CONV_KERNEL, hidden: int = CONV_HIDDEN,
                    dtype=torch.float32, device="cpu"):
    """Stride-2 Q-Conv stem + FC: obs [H, W, C] -> [hidden] features.
    ``obs_shape`` is the wrapped (frame-stacked) observation shape."""
    if len(obs_shape) != 3:
        raise ValueError(f"conv torso needs (H, W, C) observations, "
                         f"got shape {obs_shape}")
    convs = []
    c_in = obs_shape[-1]
    for c_out in channels:
        convs.append(conv2d_init(gen, c_in, c_out, kernel, dtype, device))
        c_in = c_out
    return {
        "convs": convs,
        "fc": linear_init(gen, conv_flat_dim(obs_shape, channels), hidden,
                          dtype=dtype, device=device),
    }


def conv_torso_apply(params, obs: torch.Tensor,
                     policy: Optional[QuantPolicy] = None) -> torch.Tensor:
    """obs [B, H, W, C] -> [B, hidden] (ReLU'd features)."""
    x = obs
    for pc in params["convs"]:
        x = qconv_block(pc, x, stride=2, policy=policy)
    x = x.reshape(x.shape[0], -1)
    return activation(linear_apply(params["fc"], x, policy), "relu",
                      policy)


def conv_ac_init(gen: torch.Generator, obs_shape: Tuple[int, ...],
                 head_dim: int, channels: Sequence[int] = CONV_CHANNELS,
                 kernel: int = CONV_KERNEL, hidden: int = CONV_HIDDEN,
                 dtype=torch.float32, device="cpu"):
    """Conv actor-critic: the shared Q-Conv trunk with policy and value
    heads, the pixel counterpart of :func:`mlp_ac_init`."""
    return {
        "torso": conv_torso_init(gen, obs_shape, channels, kernel, hidden,
                                 dtype, device),
        "pi": linear_init(gen, hidden, head_dim, dtype=dtype,
                          device=device),
        "v": linear_init(gen, hidden, 1, dtype=dtype, device=device),
    }


def conv_ac_apply(params, obs: torch.Tensor,
                  policy: Optional[QuantPolicy] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, H, W, C] -> (dist params [B, H], value [B]): the contract
    of :func:`mlp_ac_apply`, so rollout, PPO and A2C are agnostic."""
    h = conv_torso_apply(params["torso"], obs, policy)
    logits = linear_apply(params["pi"], h, policy)
    value = linear_apply(params["v"], h, policy)[..., 0]
    return logits, value


def conv_q_init(gen: torch.Generator, obs_shape: Tuple[int, ...],
                n_actions: int, channels: Sequence[int] = CONV_CHANNELS,
                kernel: int = CONV_KERNEL, hidden: int = CONV_HIDDEN,
                dtype=torch.float32, device="cpu"):
    return {
        "torso": conv_torso_init(gen, obs_shape, channels, kernel, hidden,
                                 dtype, device),
        "q": linear_init(gen, hidden, n_actions, dtype=dtype,
                         device=device),
    }


def conv_q_apply(params, obs: torch.Tensor,
                 policy: Optional[QuantPolicy] = None) -> torch.Tensor:
    """obs [B, H, W, C] -> Q values [B, A]."""
    h = conv_torso_apply(params["torso"], obs, policy)
    return linear_apply(params["q"], h, policy)
