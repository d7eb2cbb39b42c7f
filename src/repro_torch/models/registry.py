"""Family registry: resolve an ArchConfig to its model module (port of
``repro.models.registry``).

Dense and MoE configs resolve to the transformer, the enc-dec config to
``models.encdec``, the hybrid config to ``models.recurrent`` and the ssm
config to ``models.mamba``.  ``sharding_rules`` and ``input_specs``
arrive with the sharded paths and the dry-run tools.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
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
