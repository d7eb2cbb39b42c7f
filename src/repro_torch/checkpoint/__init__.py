"""npz + JSON checkpoints shared with the reference package."""
from repro_torch.checkpoint.checkpointer import (from_numpy_tree,
                                                 read_metadata, restore,
                                                 save)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "from_numpy_tree", "read_metadata",
           "restore", "save"]
