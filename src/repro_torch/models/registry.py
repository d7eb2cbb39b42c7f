"""Family registry: resolve an ArchConfig to its model module (port of
``repro.models.registry``).

Dense and MoE configs resolve to the transformer, which serves the dense
ones (an MoE config raises there), and the enc-dec config to
``models.encdec``.  The ssm and hybrid families arrive with a later
slice; ``sharding_rules`` and ``input_specs`` arrive with the sharded
paths and the dry-run tools.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.common import not_in_slice

FAMILIES = {
    "dense": transformer,
    "moe": transformer,
    "encdec": encdec,
}

# the slice of the port that brings each family not ported yet
LATER = {
    "hybrid": "ssm and hybrid",
    "ssm": "ssm and hybrid",
}


def model_for(cfg: ArchConfig):
    if cfg.family in LATER:
        raise not_in_slice(f"the {cfg.family} family ({cfg.name})",
                           LATER[cfg.family])
    return FAMILIES[cfg.family]
