"""The Q-Conv pixel Q network (port of the ``conv_*`` torso and Q head
of ``repro.rl.nets``).

The paper's vision stem: stride-2 Q-Conv blocks (stride replaces
pooling, ReLU after) over [B, H, W, C] pixel observations, a dense
layer to ``hidden`` features, and a linear Q head.  Every product is a
Q-MAC or Q-Conv under the QuantPolicy, every activation a V-ACT.  The
actor-critic and quantile heads arrive with the training and value
slices.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.core.vact import activation
from repro_torch.nn.conv import conv2d_init, qconv_block
from repro_torch.nn.linear import linear_apply, linear_init

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
