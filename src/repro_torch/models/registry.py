"""Family registry: resolve an ArchConfig to its model module, its
sharding rules and the inputs of its steps (port of
``repro.models.registry``).

Dense and MoE configs resolve to the transformer, the enc-dec config to
``models.encdec``, the hybrid config to ``models.recurrent`` and the ssm
config to ``models.mamba``.  ``input_specs`` returns ``meta`` tensors,
the stand-ins of the reference's ``ShapeDtypeStruct``: the shape and
dtype of every input, no storage.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models import encdec, mamba, recurrent, transformer

FAMILIES = {
    "dense": transformer,
    "moe": transformer,
    "encdec": encdec,
    "hybrid": recurrent,
    "ssm": mamba,
}


def model_for(cfg: ArchConfig):
    return FAMILIES[cfg.family]


def sharding_rules(cfg: ArchConfig, model_axis: int = 16,
                   serve: bool = False) -> Dict:
    """Per-arch logical->mesh overrides of ``BASE_RULES``.

    ``serve=True``: no optimizer state exists and steps are
    latency-bound, so weights drop the FSDP ("d_model" over data)
    sharding."""
    rules: Dict[str, Any] = {}
    if serve:
        rules["d_model"] = None
    # KV heads shard on the model axis only when the head count divides
    if cfg.n_kv_heads and cfg.n_kv_heads % model_axis == 0:
        rules["kv_heads"] = "model"
    if cfg.seq_shard:
        rules["seq"] = "model"       # sequence parallelism
    # MoE: expert-parallel when experts divide the axis, else
    # TP-within-expert
    if cfg.is_moe:
        if cfg.n_experts % model_axis == 0:
            rules["experts"] = "model"
            rules["d_ff_expert"] = None
        else:
            rules["experts"] = None
            rules["d_ff_expert"] = "model"
    return rules


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The inputs of the step this (arch, shape) cell runs, as ``meta``
    tensors:

    train   -> {tokens, labels} (+frames for enc-dec)
    prefill -> {tokens} (+frames)
    decode  -> {token [B, 1]}; the caches are state, not inputs
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {}
        if cfg.is_encdec:
            specs["frames"] = _spec((B, S, cfg.d_model), torch.float32)
        specs["tokens"] = _spec((B, S), torch.int32)
        if shape.kind == "train":
            specs["labels"] = _spec((B, S), torch.int32)
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"token": _spec((B, 1), torch.int32)}
