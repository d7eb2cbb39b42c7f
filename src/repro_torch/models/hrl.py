"""The paper's agent: quantized hierarchical RL network (port of
``repro.models.hrl``, forward only).

Pipeline (paper Sec. III):
  obs image -> 3x Q-Conv (stride 2 replaces pooling, ReLU)
            -> flatten -> Q-FC -> 32-d image embedding
            -> sub-goal module (Q-FC "FC-HRL" or Q-LSTM "LSTM-HRL")
            -> concat(embedding, sub-goal) -> Q-FC -> Softmax action

The parameter tree has the reference's keys ("stem", "subgoal",
"action", "value"), so ``from_numpy_tree`` carries reference weights
across.  A value head (not in the FPGA datapath, needed by PPO) reads
the same concat features.

Every matmul is a Q-MAC (``q_matmul``) and every conv a Q-Conv;
softmax/sigmoid/tanh are V-ACT (the CORDIC kernels when the policy says
``act_backend="cordic"``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.e2hrl import HRLConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.vact import activation
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.conv import conv2d_init, qconv_block
from repro_torch.nn.linear import linear_apply, linear_init
from repro_torch.nn.lstm import lstm_apply, lstm_init

Tensor = torch.Tensor


def _flat_dim(cfg: HRLConfig) -> int:
    h, w, _ = cfg.obs_shape
    for _ in cfg.conv_channels:
        h = (h + 1) // 2
        w = (w + 1) // 2
    return h * w * cfg.conv_channels[-1]


def init(gen: torch.Generator, cfg: HRLConfig, dtype=torch.float32,
         device: DeviceLike = None):
    """Random weights drawn from the CPU generator ``gen``, placed on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    convs = []
    c_in = cfg.obs_shape[-1]
    for c_out in cfg.conv_channels:
        convs.append(conv2d_init(gen, c_in, c_out, cfg.conv_kernel, dtype,
                                 dev))
        c_in = c_out
    feat = cfg.embed_dim + cfg.subgoal_dim
    params = {
        "stem": {
            "convs": convs,
            "fc": linear_init(gen, _flat_dim(cfg), cfg.embed_dim,
                              dtype=dtype, device=dev),
        },
        "subgoal": {},
        "action": {"fc": linear_init(gen, feat, cfg.n_actions, dtype=dtype,
                                     device=dev)},
    }
    if cfg.subgoal_kind == "fc":
        params["subgoal"] = {
            "fc1": linear_init(gen, cfg.embed_dim, cfg.subgoal_hidden,
                               dtype=dtype, device=dev),
            "fc2": linear_init(gen, cfg.subgoal_hidden, cfg.subgoal_dim,
                               dtype=dtype, device=dev),
        }
    else:
        params["subgoal"] = {
            "lstm": lstm_init(gen, cfg.embed_dim, cfg.subgoal_hidden, dtype,
                              dev),
            "out": linear_init(gen, cfg.subgoal_hidden, cfg.subgoal_dim,
                               dtype=dtype, device=dev),
        }
    if cfg.value_head:
        params["value"] = linear_init(gen, feat, 1, dtype=dtype, device=dev)
    return params


def embed(params, obs: Tensor, cfg: HRLConfig,
          policy: Optional[QuantPolicy] = None) -> Tensor:
    """obs: [B, H, W, C] in [0, 1] -> [B, embed_dim] (ReLU'd)."""
    x = obs
    for pc in params["stem"]["convs"]:
        x = qconv_block(pc, x, stride=2, policy=policy)
    x = x.reshape(x.shape[0], -1)
    x = linear_apply(params["stem"]["fc"], x, policy)
    return activation(x, "relu", policy)


def subgoal(params, e: Tensor, cfg: HRLConfig,
            policy: Optional[QuantPolicy] = None,
            lstm_state: Optional[Tuple] = None):
    """e: [B, embed_dim] (fc) or [B, K, embed_dim] (lstm window)."""
    p = params["subgoal"]
    if cfg.subgoal_kind == "fc":
        h = activation(linear_apply(p["fc1"], e, policy), "relu", policy)
        g = activation(linear_apply(p["fc2"], h, policy), "tanh", policy)
        return g, None
    hs, state = lstm_apply(p["lstm"], e, policy, lstm_state)
    g = activation(linear_apply(p["out"], hs[:, -1], policy), "tanh",
                   policy)
    return g, state


def apply(params, obs: Tensor, cfg: HRLConfig,
          policy: Optional[QuantPolicy] = None,
          lstm_state: Optional[Tuple] = None):
    """Full agent.  obs: [B,H,W,C] (fc) or [B,K,H,W,C] (lstm window).

    Returns (action_logits [B, A], value [B], new_lstm_state)."""
    if cfg.subgoal_kind == "lstm":
        B, K = obs.shape[:2]
        e_seq = embed(params, obs.reshape((B * K,) + tuple(obs.shape[2:])),
                      cfg, policy).reshape(B, K, -1)
        e = e_seq[:, -1]
        g, state = subgoal(params, e_seq, cfg, policy, lstm_state)
    else:
        e = embed(params, obs, cfg, policy)
        g, state = subgoal(params, e, cfg, policy)
    feat = torch.cat([e, g], dim=-1)
    logits = linear_apply(params["action"]["fc"], feat, policy)
    value = None
    if cfg.value_head:
        value = linear_apply(params["value"], feat, policy)[..., 0]
    return logits, value, state


def action_probs(logits: Tensor,
                 policy: Optional[QuantPolicy] = None) -> Tensor:
    """Softmax action head — V-ACT's softmax mode under quantization."""
    return activation(logits, "softmax", policy)
