"""The trainers (port of ``repro.rl.trainer``; the on-policy and
value families, on one device or over a mesh of ranks)."""
from repro_torch.rl.trainer.base import (Trainer, build_mesh, flag_mismatch,
                                         resolve_mesh)
from repro_torch.rl.trainer.evaluation import greedy_action, greedy_eval
from repro_torch.rl.trainer.onpolicy import (OnPolicyTrainer, make_agent,
                                             rl_train)
from repro_torch.rl.trainer.state import (STATE_SCHEMA, TrainState,
                                          onpolicy_state, value_state)
from repro_torch.rl.trainer.value import (SYNC_MODES, ValueTrainer,
                                          value_eval, value_train)

__all__ = ["OnPolicyTrainer", "STATE_SCHEMA", "SYNC_MODES", "TrainState",
           "Trainer", "ValueTrainer", "build_mesh", "flag_mismatch",
           "greedy_action",
           "greedy_eval", "make_agent", "onpolicy_state", "resolve_mesh",
           "rl_train", "value_eval", "value_state", "value_train"]
