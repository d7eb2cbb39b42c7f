"""RecurrentGemma-9B [arXiv:2402.19427]: RG-LRU + local attn, 1:2.

Block pattern repeats (R, R, A); 38 layers = 12 full patterns + 2
recurrent blocks.  MQA (kv=1), local window 2048, GeGLU-style MLP.
Sub-quadratic: runs the long_500k decode shape.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    lru_width=4096, local_window=2048, block_pattern=("R", "R", "A"),
    rope_theta=1e4, act="gelu",
    microbatches=4,
    source="arXiv:2402.19427 (RecurrentGemma-9B)",
)
