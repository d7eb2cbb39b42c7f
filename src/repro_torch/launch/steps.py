"""Step functions of the launchers (port of ``repro.launch.steps``):
one training step, a prefill and a decode step.

The reference's steps take a mesh and run under its sharding rules;
on one device those do nothing, so here ``mesh`` must be ``None`` and a
mesh raises, naming the sharded paths that bring it.  The abstract
trees, their shardings and ``lower_cell`` are dry-run tools and are not
ported.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.fxp import div_scalar
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.registry import model_for
from repro_torch.optim import (AdamWConfig, adamw_update,
                               warmup_cosine)
from repro_torch.rl.inference import not_in_slice
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _one_device(mesh, what: str) -> None:
    if mesh is not None:
        raise not_in_slice(f"{what} on a mesh", "sharded paths")


def make_train_step(cfg: ArchConfig, mesh,
                    policy: Optional[QuantPolicy],
                    ocfg: AdamWConfig = AdamWConfig(),
                    schedule: Optional[Callable] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr", "nonfinite"})``: the loss and its
    gradient by autograd, then :func:`adamw_update`.  New trees are
    returned; the caller rebinds its names to them."""
    _one_device(mesh, "make_train_step")
    model = model_for(cfg)
    sched = schedule or warmup_cosine(3e-4, 100, 10_000)

    def _compute_cast(params):
        """Under a bf16 compute policy, the fp32 matrices (two or more
        dimensions) as bf16 copies, inside the differentiated function,
        so the gradients come back fp32."""
        if policy is None or policy.compute_dtype != torch.bfloat16:
            return params
        return tree_map(
            lambda p: p.to(torch.bfloat16)
            if p.dtype == torch.float32 and p.ndim >= 2 else p, params)

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in
                  tree_leaves(params)]
        with torch.enable_grad():
            loss = model.loss_fn(
                _compute_cast(tree_unflatten(params, leaves)), batch, cfg,
                policy)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss never reads has a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads, strict=True)]
        return loss.detach(), tree_unflatten(params, grads)

    def train_step(params, opt_state, batch):
        k = max(cfg.microbatches, 1)
        if k > 1:
            def split(x):
                if x.shape[0] % k:
                    raise ValueError(f"a batch of {x.shape[0]} does not "
                                     f"split into {k} microbatches")
                return x.reshape((k, x.shape[0] // k) + x.shape[1:])

            mb = tree_map(split, batch)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(k):
                l, g = value_and_grad(params, tree_map(lambda x: x[i], mb))
                # the reference's order: loss l_acc + l, gradients
                # a + g in fp32, then both over k
                loss = loss + l
                grads = tree_unflatten(params, [
                    a + gi.to(torch.float32) for a, gi in zip(
                        tree_leaves(grads), tree_leaves(g), strict=True)])
            loss = div_scalar(loss, k)
            grads = tree_map(lambda g: div_scalar(g, k), grads)
        else:
            loss, grads = value_and_grad(params, batch)
        with torch.no_grad():
            params, opt_state, stats = adamw_update(grads, opt_state,
                                                    params, sched, ocfg)
        return params, opt_state, dict(loss=loss, **stats)

    return train_step


def make_prefill_step(cfg: ArchConfig, mesh,
                      policy: Optional[QuantPolicy],
                      kv_bits: int = 32) -> Callable:
    _one_device(mesh, "make_prefill_step")
    model = model_for(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.is_encdec:
            return model.prefill(params, batch, cfg, policy, kv_bits)
        return model.prefill(params, batch["tokens"], cfg, policy,
                             kv_bits)

    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh,
                     policy: Optional[QuantPolicy],
                     kv_bits: int = 32) -> Callable:
    _one_device(mesh, "make_decode_step")
    model = model_for(cfg)

    @torch.no_grad()
    def decode_step(params, caches, token, index):
        return model.decode_step(params, token, caches, index, cfg, policy,
                                 kv_bits)

    return decode_step
