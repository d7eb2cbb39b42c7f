"""Synthetic token streams (port of ``repro.data``).  ``place``, the
sharded loader's device placement, arrives with the sharded paths; on
one device a batch is moved with ``.to(device)``."""
from repro_torch.data.synthetic import (DataConfig, batch_at, iterate,
                                        stream_seed)

__all__ = ["DataConfig", "batch_at", "iterate", "stream_seed"]
