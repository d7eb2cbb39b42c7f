"""Synthetic token streams and their placement over a mesh (port of
``repro.data``)."""
from repro_torch.data.sharded_loader import place
from repro_torch.data.synthetic import (DataConfig, batch_at, iterate,
                                        stream_seed)

__all__ = ["DataConfig", "batch_at", "iterate", "place", "stream_seed"]
