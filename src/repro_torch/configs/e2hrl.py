"""The paper's own architecture: E2HRL hierarchical RL agent (port of
``repro.configs.e2hrl``; same fields, same defaults).

3 Q-Conv layers (stride 2, ReLU) -> flatten -> Q-FC -> 32-d embedding
-> sub-goal module (Q-FC h2 or Q-LSTM K4) -> concat -> action softmax.
Input 32x32x3 (paper Table V I/P size for the proposed engine).
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class HRLConfig:
    name: str = "e2hrl"
    obs_shape: Tuple[int, int, int] = (32, 32, 3)
    conv_channels: Tuple[int, ...] = (16, 32, 32)
    conv_kernel: int = 3
    embed_dim: int = 32
    subgoal_dim: int = 8
    subgoal_kind: str = "fc"       # "fc" (FC-HRL) | "lstm" (LSTM-HRL)
    subgoal_hidden: int = 32
    n_actions: int = 6
    value_head: bool = True


CONFIG = HRLConfig()
CONFIG_LSTM = HRLConfig(name="e2hrl-lstm", subgoal_kind="lstm")
