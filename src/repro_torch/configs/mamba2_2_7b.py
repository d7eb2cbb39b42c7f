"""Mamba2-2.7B [arXiv:2405.21060]: SSD (state-space duality), attn-free.

d_inner = 2 * 2560 = 5120, head_dim 64 -> 80 SSD heads, d_state 128.
Constant-size recurrent state: runs the long_500k decode shape.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    microbatches=2,
    source="arXiv:2405.21060 (state-spaces/mamba2-2.7b)",
)
