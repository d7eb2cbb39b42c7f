"""Rematerialisation: the port's ``jax.checkpoint``.

``checkpoint(fn)`` returns ``fn`` run under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
intermediates of ``fn`` are not kept for the backward, which runs
``fn`` again on the same inputs to get them back.  Only the inputs are
kept, as under the reference's
``policy=jax.checkpoint_policies.nothing_saveable``.  The recompute must
give the forward's tensors bit for bit, and it does: the same ops on the
same inputs, the int8 codes and an MoE's expert choice included.

* Outside autograd (``torch.is_grad_enabled()`` false: the serving
  steps run under ``no_grad``) ``fn`` runs as it is, so a prefill or a
  decode step launches and records exactly what it would without this
  module.
* No forward the port checkpoints draws a random number, so the RNG
  state is not saved at each checkpoint (``preserve_rng_state=False``).
* On the card, autograd runs the backward, and so the recompute, on a
  thread of its own.  The mesh context of ``distributed.sharding``
  (``mesh_rules``, ``manual``) is thread-local, so the recompute runs
  under the context the forward saw: ``across_slots`` then takes the
  same requantization maxima over the slots in both.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from repro_torch.distributed import sharding


def checkpoint(fn: Callable) -> Callable:
    """``fn`` rematerialised in the backward (``jax.checkpoint(fn)`` with
    nothing saveable); under ``no_grad``, ``fn`` itself."""

    def call(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        ctx = sharding.context()

        def body(*a):
            with sharding.restored(ctx):
                return fn(*a)

        return _torch_checkpoint(body, *args, use_reentrant=False,
                                 preserve_rng_state=False)

    return call
