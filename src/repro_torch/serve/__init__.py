"""Batched quantized policy serving (port of ``repro.serve``)."""
from repro_torch.serve.engine import (EpisodeStats, PolicyServer,
                                      bucket_for, bucket_sizes,
                                      check_parity, serve_episodes)
from repro_torch.serve.loader import PRECISIONS, ServedPolicy, load_policy

__all__ = ["PRECISIONS", "EpisodeStats", "PolicyServer", "ServedPolicy",
           "bucket_for", "bucket_sizes", "check_parity", "load_policy",
           "serve_episodes"]
