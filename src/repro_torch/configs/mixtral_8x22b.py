"""Mixtral-8x22B [arXiv:2401.04088; hf]: 8-expert top-2 MoE, SWA.

MoE sharding regime: TP-within-expert (8 experts < 16-way model axis;
d_ff 16384 shards 16-way) — see distributed/sharding rules.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, head_dim=128,
    n_experts=8, top_k=2, window=4096,
    rope_theta=1e6, act="silu",
    seq_shard=True, microbatches=8,
    source="arXiv:2401.04088 (hf:mistralai/Mixtral-8x22B)",
)
