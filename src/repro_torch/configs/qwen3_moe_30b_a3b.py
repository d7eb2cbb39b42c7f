"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 128-expert top-8 MoE.

MoE sharding regime: expert parallelism (128 experts / 16-way model
axis = 8 experts per device); complements mixtral's TP-in-expert.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, qk_norm=True,
    rope_theta=1e6, act="silu",
    microbatches=4,
    source="hf:Qwen/Qwen3-30B-A3B",
)
