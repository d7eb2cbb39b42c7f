"""Training drivers (port of ``repro.rl.trainer``; the on-policy family
on one device)."""
from repro_torch.rl.trainer.base import Trainer, resolve_mesh
from repro_torch.rl.trainer.evaluation import greedy_action, greedy_eval
from repro_torch.rl.trainer.onpolicy import (OnPolicyTrainer, make_agent,
                                             rl_train)
from repro_torch.rl.trainer.state import (STATE_SCHEMA, TrainState,
                                          onpolicy_state)

__all__ = ["OnPolicyTrainer", "STATE_SCHEMA", "TrainState", "Trainer",
           "greedy_action", "greedy_eval", "make_agent", "onpolicy_state",
           "resolve_mesh", "rl_train"]
