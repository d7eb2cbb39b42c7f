"""Optimizers, clipping and schedules (port of ``repro.optim``)."""
from repro_torch.optim.adam import (AdamWConfig, adamw_init, adamw_update,
                                    optimizer_shardings)
from repro_torch.optim.clip import (clip_by_global_norm, global_norm,
                                    zero_nonfinite)
from repro_torch.optim.compression import (compressed_psum_mean,
                                           compression_ratio)
from repro_torch.optim.schedule import (constant, inverse_sqrt,
                                        linear_warmup, warmup_cosine)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compressed_psum_mean",
           "compression_ratio", "constant", "global_norm",
           "inverse_sqrt", "linear_warmup", "optimizer_shardings",
           "warmup_cosine", "zero_nonfinite"]
