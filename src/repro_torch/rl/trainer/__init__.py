"""The trainers (port of ``repro.rl.trainer``; the on-policy and
value families on one device)."""
from repro_torch.rl.trainer.base import Trainer, flag_mismatch, resolve_mesh
from repro_torch.rl.trainer.evaluation import greedy_action, greedy_eval
from repro_torch.rl.trainer.onpolicy import (OnPolicyTrainer, make_agent,
                                             rl_train)
from repro_torch.rl.trainer.state import (STATE_SCHEMA, TrainState,
                                          onpolicy_state, value_state)
from repro_torch.rl.trainer.value import (ValueTrainer, value_eval,
                                          value_train)

__all__ = ["OnPolicyTrainer", "STATE_SCHEMA", "TrainState", "Trainer",
           "ValueTrainer", "flag_mismatch", "greedy_action",
           "greedy_eval", "make_agent", "onpolicy_state", "resolve_mesh",
           "rl_train", "value_eval", "value_state", "value_train"]
