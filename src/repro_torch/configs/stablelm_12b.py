"""StableLM-2-12B [hf:stabilityai]: dense GQA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352, head_dim=160,
    rope_theta=1e4, act="silu",
    microbatches=4,
    source="hf:stabilityai/stablelm-2-12b",
)
