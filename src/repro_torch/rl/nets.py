"""Small actor-critic and Q networks (port of ``repro.rl.nets``).

Every product is a Q-MAC (``q_matmul`` under the QuantPolicy), every
activation a V-ACT, so the quantized actors exercise exactly the
quantized paths:

  * ``mlp_ac_*`` — a 2-layer tanh torso over flat [B, D] observations
    with a distribution head and a value head (the PPO/A2C agent);
  * ``mlp_q``/``mlp_qr``/``mlp_pi``/``mlp_twin_q``/``mlp_twin_qr`` — the
    value family's 2-layer ReLU nets: the DQN Q net, its QR-DQN
    quantile head, the DDPG actor (a V-ACT tanh squash into the action
    bounds) and the twin (quantile) critics over (obs, action);
  * ``conv_*`` — the paper's vision stem: stride-2 Q-Conv blocks (stride
    replaces pooling, ReLU after) over [B, H, W, C] pixel observations,
    a dense layer to ``hidden`` features, then policy and value heads
    (``conv_ac_*``, the pixel PPO/A2C agent) or a linear Q head
    (``conv_q_*``) and its quantile head (``conv_qr_*``).
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


def mlp_q_init(gen: torch.Generator, obs_dim: int, n_actions: int,
               hidden: int = 64, dtype=torch.float32, device="cpu"):
    return {
        "fc1": linear_init(gen, obs_dim, hidden, dtype=dtype,
                           device=device),
        "fc2": linear_init(gen, hidden, hidden, dtype=dtype, device=device),
        "q": linear_init(gen, hidden, n_actions, dtype=dtype,
                         device=device),
    }


def mlp_q_apply(params, obs: torch.Tensor,
                policy: Optional[QuantPolicy] = None) -> torch.Tensor:
    h = activation(linear_apply(params["fc1"], obs, policy), "relu", policy)
    h = activation(linear_apply(params["fc2"], h, policy), "relu", policy)
    return linear_apply(params["q"], h, policy)


def mlp_qr_init(gen: torch.Generator, obs_dim: int, n_actions: int,
                n_quantiles: int, hidden: int = 64, dtype=torch.float32,
                device="cpu"):
    """QR-DQN: the plain Q net with a [n_actions * n_quantiles] head."""
    return mlp_q_init(gen, obs_dim, n_actions * n_quantiles, hidden, dtype,
                      device)


def mlp_qr_apply(params, obs: torch.Tensor, n_actions: int,
                 n_quantiles: int,
                 policy: Optional[QuantPolicy] = None) -> torch.Tensor:
    """obs [B, D] -> quantile values [B, n_actions, n_quantiles]."""
    q = mlp_q_apply(params, obs, policy)
    return q.reshape(q.shape[:-1] + (n_actions, n_quantiles))


def mlp_pi_init(gen: torch.Generator, obs_dim: int, act_dim: int,
                hidden: int = 64, dtype=torch.float32, device="cpu"):
    """Deterministic DDPG actor: obs -> tanh-squashed action."""
    return {
        "fc1": linear_init(gen, obs_dim, hidden, dtype=dtype,
                           device=device),
        "fc2": linear_init(gen, hidden, hidden, dtype=dtype, device=device),
        "out": linear_init(gen, hidden, act_dim, dtype=dtype,
                           device=device),
    }


def mlp_pi_apply(params, obs: torch.Tensor, low: float, high: float,
                 policy: Optional[QuantPolicy] = None) -> torch.Tensor:
    """obs [B, D] -> action [B, act_dim] in [low, high]; the tanh squash
    is a V-ACT activation like every other."""
    h = activation(linear_apply(params["fc1"], obs, policy), "relu", policy)
    h = activation(linear_apply(params["fc2"], h, policy), "relu", policy)
    u = activation(linear_apply(params["out"], h, policy), "tanh", policy)
    mid, half = 0.5 * (high + low), 0.5 * (high - low)
    return mid + half * u


def mlp_twin_q_init(gen: torch.Generator, obs_dim: int, act_dim: int,
                    hidden: int = 64, dtype=torch.float32, device="cpu"):
    """TD3-style twin critics Q(s, a): two Q torsos over the
    concatenated (obs, action)."""
    return {"q1": mlp_q_init(gen, obs_dim + act_dim, 1, hidden, dtype,
                             device),
            "q2": mlp_q_init(gen, obs_dim + act_dim, 1, hidden, dtype,
                             device)}


def _obs_act(obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    return torch.cat([obs, act.reshape(obs.shape[0], -1).to(obs.dtype)],
                     dim=-1)


def mlp_twin_q_apply(params, obs: torch.Tensor, act: torch.Tensor,
                     policy: Optional[QuantPolicy] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(obs [B, D], act [B, d]) -> (q1 [B], q2 [B])."""
    x = _obs_act(obs, act)
    return (mlp_q_apply(params["q1"], x, policy)[..., 0],
            mlp_q_apply(params["q2"], x, policy)[..., 0])


def mlp_twin_qr_init(gen: torch.Generator, obs_dim: int, act_dim: int,
                     n_quantiles: int, hidden: int = 64,
                     dtype=torch.float32, device="cpu"):
    """TQC-style twin quantile critics Z(s, a) with [n_quantiles]
    heads."""
    return {"q1": mlp_q_init(gen, obs_dim + act_dim, n_quantiles, hidden,
                             dtype, device),
            "q2": mlp_q_init(gen, obs_dim + act_dim, n_quantiles, hidden,
                             dtype, device)}


def mlp_twin_qr_apply(params, obs: torch.Tensor, act: torch.Tensor,
                      policy: Optional[QuantPolicy] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(obs [B, D], act [B, d]) -> (z1 [B, N], z2 [B, N])."""
    x = _obs_act(obs, act)
    return (mlp_q_apply(params["q1"], x, policy),
            mlp_q_apply(params["q2"], x, policy))


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


def conv_qr_init(gen: torch.Generator, obs_shape: Tuple[int, ...],
                 n_actions: int, n_quantiles: int,
                 channels: Sequence[int] = CONV_CHANNELS,
                 kernel: int = CONV_KERNEL, hidden: int = CONV_HIDDEN,
                 dtype=torch.float32, device="cpu"):
    """QR-DQN over pixels: the conv Q net with a [n_actions *
    n_quantiles] head."""
    return conv_q_init(gen, obs_shape, n_actions * n_quantiles, channels,
                       kernel, hidden, dtype, device)


def conv_qr_apply(params, obs: torch.Tensor, n_actions: int,
                  n_quantiles: int,
                  policy: Optional[QuantPolicy] = None) -> torch.Tensor:
    """obs [B, H, W, C] -> quantile values [B, n_actions, n_quantiles]."""
    q = conv_q_apply(params, obs, policy)
    return q.reshape(q.shape[:-1] + (n_actions, n_quantiles))
