"""The assigned input-shape set (same four shapes for every LM arch;
port of ``repro.configs.shapes``)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in [TRAIN_4K, PREFILL_32K, DECODE_32K,
                              LONG_500K]}


def shape_applicable(cfg, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; else a skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "skip (pure full attention; no sub-quadratic path)"
    return None
