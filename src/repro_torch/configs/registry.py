"""Architecture registry: --arch <id> resolution (port of
``repro.configs.registry``)."""
from repro_torch.configs import (chameleon_34b, mamba2_2_7b,
                                 mixtral_8x22b, phi3_mini_3_8b, qwen2_72b,
                                 qwen3_moe_30b_a3b, recurrentgemma_9b,
                                 stablelm_12b, tinyllama_1_1b,
                                 whisper_large_v3)

ARCHS = {m.CONFIG.name: m.CONFIG for m in [
    qwen2_72b, stablelm_12b, phi3_mini_3_8b, tinyllama_1_1b,
    whisper_large_v3, mixtral_8x22b, qwen3_moe_30b_a3b,
    recurrentgemma_9b, mamba2_2_7b, chameleon_34b,
]}


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}' "
                       f"(available: {sorted(ARCHS)})")
    return ARCHS[name]
