"""Qwen2-72B [arXiv:2407.10671; hf]: dense GQA, QKV bias."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6, act="silu",
    # execution: SP + 4 microbatches -> 12.9 GiB/chip at train_4k
    seq_shard=True, microbatches=4,
    source="arXiv:2407.10671 (hf:Qwen/Qwen2-72B)",
)
