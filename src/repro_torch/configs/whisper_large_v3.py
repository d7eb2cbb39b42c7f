"""Whisper-large-v3 backbone [arXiv:2212.04356]: enc-dec transformer.

The conv/audio frontend is a stub: input_specs() feeds precomputed
frame embeddings [B, S, d_model].  n_layers counts each of encoder and
decoder (32 + 32).  Positional: sinusoidal (any
length), LayerNorm + GELU per the whisper architecture.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec", is_encdec=True,
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    rope=False, act="gelu", norm="layernorm", frontend="audio",
    microbatches=4,
    source="arXiv:2212.04356 (hf:openai/whisper-large-v3)",
)
