"""ArchConfig: one dataclass describes every assigned architecture
(port of ``repro.configs.base``: the same fields, defaults, ``reduced``,
``pad_vocab`` and parameter counts, kept as the port's own copy).

``reduced()`` yields the CPU-smoke-test configuration of the same
family (same code paths, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | encdec | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # attention details
    rope: bool = True
    rope_theta: float = 1e6
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None         # SWA window (mixtral)
    tie_embeddings: bool = False
    act: str = "silu"
    norm: str = "rmsnorm"
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # hybrid (recurrentgemma): pattern repeats (R, R, A)
    lru_width: int = 0
    local_window: int = 0
    block_pattern: Tuple[str, ...] = ()
    # enc-dec (whisper): n_layers counts EACH of encoder and decoder
    is_encdec: bool = False
    # modality frontend stub: None | "audio" | "vq"
    frontend: Optional[str] = None
    # execution
    remat: bool = True
    scan_layers: bool = True
    # sequence parallelism: saved inter-block activations sharded over
    # the model axis (in-block compute all-gathers as needed).  Cuts
    # saved-activation memory by the TP degree at the cost of per-block
    # collectives — required to fit the biggest archs' train steps.
    seq_shard: bool = False
    # q-chunk size for flash-style attention (None = never chunk)
    q_chunk: Optional[int] = 512
    # gradient-accumulation microbatches per step (1 = none): divides
    # per-layer transient memory by k at the cost of k sequential
    # passes; grads accumulate in fp32 sharded like the params
    microbatches: int = 1
    # notes for DESIGN/EXPERIMENTS
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token decode shape?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window is not None      # SWA bounds the KV working set

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if not self.block_pattern
                         else len(self.block_pattern) + 1),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128,
            vocab=256,
            head_dim=16,
            # production-mesh execution knobs don't apply on-host
            seq_shard=False,
            microbatches=1,
        )
        if self.is_moe:
            kw.update(n_experts=min(self.n_experts, 8),
                      top_k=min(self.top_k, 2))
        if self.family == "ssm":
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                      n_heads=0, n_kv_heads=0)
        if self.family == "hybrid":
            kw.update(lru_width=64, local_window=8)
        if self.window is not None:
            kw.update(window=8)
        return dataclasses.replace(self, **kw)


def pad_vocab(vocab: int, multiple: int = 128) -> int:
    """Megatron-style padded table size: divisible by any mesh axis up
    to ``multiple`` and MXU-aligned.  Padded logit columns are masked to
    -inf in logits_from_hidden, so semantics don't change."""
    return ((vocab + multiple - 1) // multiple) * multiple


def param_count(cfg: ArchConfig) -> float:
    """Analytic parameter count (embedding + blocks), for 6ND checks."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    hd = cfg.hd
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    attn = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) \
        + (cfg.n_heads * hd) * d if cfg.n_heads else 0
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * d
        blk = d * (2 * d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim) \
            + d_in * d
        return emb + L * blk
    if cfg.is_moe:
        mlp = cfg.n_experts * 3 * d * f
    else:
        mlp = 3 * d * f if cfg.act in ("silu", "geglu") else 2 * d * f
    blocks = L * (attn + mlp)
    if cfg.is_encdec:
        blocks = 2 * L * attn + L * attn + 2 * L * mlp  # enc+dec+cross
    if cfg.family == "hybrid":
        rec = d * cfg.lru_width * 3 + 2 * cfg.lru_width ** 2 \
            + cfg.lru_width * d
        n_rec = sum(1 for i in range(L)
                    if cfg.block_pattern[i % len(cfg.block_pattern)] == "R")
        n_att = L - n_rec
        blocks = n_rec * (rec + 3 * d * f) + n_att * (attn + 3 * d * f)
    return emb + blocks


def active_param_count(cfg: ArchConfig) -> float:
    """Active (per-token) params for MoE: 6*N_active*D MODEL_FLOPS."""
    if not cfg.is_moe:
        return param_count(cfg)
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    hd = cfg.hd
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    attn = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) \
        + (cfg.n_heads * hd) * d
    mlp = cfg.top_k * 3 * d * f
    return emb + L * (attn + mlp)
