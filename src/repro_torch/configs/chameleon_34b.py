"""Chameleon-34B [arXiv:2405.09818]: early-fusion VLM backbone.

VQ image tokens share the text token space (vocab 65536); the VQ-VAE
image tokenizer is a stub — input_specs() feeds token ids directly.
QK-norm per the chameleon training recipe.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536, head_dim=128,
    qk_norm=True, rope_theta=1e4, act="silu", frontend="vq",
    seq_shard=True, microbatches=2,
    source="arXiv:2405.09818 (Chameleon-34B)",
)
