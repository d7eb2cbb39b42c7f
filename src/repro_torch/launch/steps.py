"""Step functions of the launchers (port of ``repro.launch.steps``):
one training step, a prefill and a decode step, on one device or on a
mesh, and the specs of their inputs and caches.

Given a mesh (``launch.mesh.make_host_mesh``), a step runs under
``mesh_rules(mesh, sharding_rules(...))``, as the reference's do.  Each
rank runs the model on its own rows of the batch (``data.place``) with
the params replicated; the MoE layers exchange their capacity buffers
over the model axis (``nn.moe_shard``).  The training step's loss is
the mean of the slots' losses and its gradient the mean of the slots'
gradients, each gathered and summed in slot order (a leaf at a time, so
a rank holds at most world x the largest leaf more); the gradient norm,
clipping and AdamW then run on every rank alike, on the whole gradient.
At one rank every collective hands back its input, and a step computes
the unsharded program bit for bit.  Prefill and decode return this
rank's rows of the logits and the caches.

``cache_shardings`` and ``batch_shardings`` give the reference's specs
of the serving caches and the inputs.  The abstract trees and
``lower_cell`` belong to the dry-run tools and are not ported.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.fxp import div_scalar
from repro_torch.core.policy import QuantPolicy
from repro_torch.distributed.sharding import (NamedSharding, P, batch_spec,
                                              data_axes, data_axis_size,
                                              gather_rows, local_rows,
                                              mesh_rules, mesh_shape, psum)
from repro_torch.models.registry import model_for, sharding_rules
from repro_torch.optim import (AdamWConfig, adamw_update,
                               warmup_cosine)
from repro_torch.tree import (map_with_path, tree_leaves, tree_map,
                              tree_unflatten)


def _rules(cfg: ArchConfig, mesh, serve: bool = False) -> Dict:
    if mesh is None:
        return {}
    return sharding_rules(cfg, mesh_shape(mesh).shape.get("model", 1),
                          serve=serve)


# ---------------------------------------------------------------------------
# specs of the caches and inputs
# ---------------------------------------------------------------------------

def cache_shardings(caches, cfg: ArchConfig, batch: int, mesh):
    """Specs of the serving state, by leaf name:

      k/v[_scale]  [.., B, cap, n_kv, hd]  batch->data, kv->model if div
      pos          [.., B, cap]            batch->data
      ssm          [.., B, H, hd, N]       batch->data, heads->model
      conv         [.., B, w, C]           batch->data, C->model if div
      rglru        [.., B, W]              batch->data, W->model if div

    Where the kv heads do not divide the model axis, the cache's
    sequence dimension goes over it instead (flash-decoding layout)."""
    model_n = mesh_shape(mesh).shape.get("model", 1)
    dax = data_axes(mesh)
    # global_batch=1 (long_500k) cannot shard the batch dim
    dax = dax if (dax and batch % data_axis_size(mesh) == 0) else ()
    dax = (dax[0] if len(dax) == 1 else dax) if dax else None

    def spec(path, leaf):
        name = str(path[-1])
        nd = leaf.ndim
        ax: list = [None] * nd
        if name in ("k", "v", "k_scale", "v_scale"):
            ax[nd - 4] = dax
            if cfg.n_kv_heads and cfg.n_kv_heads % model_n == 0:
                ax[nd - 2] = "model"
            elif leaf.shape[nd - 3] % model_n == 0:
                ax[nd - 3] = "model"
        elif name == "pos":
            ax[nd - 2] = dax
            if leaf.shape[nd - 1] % model_n == 0 and \
                    not (cfg.n_kv_heads and
                         cfg.n_kv_heads % model_n == 0):
                ax[nd - 1] = "model"
        elif name == "ssm":
            ax[nd - 4] = dax
            if leaf.shape[nd - 3] % model_n == 0:
                ax[nd - 3] = "model"
        elif name == "conv":
            ax[nd - 3] = dax
            if leaf.shape[nd - 1] % model_n == 0:
                ax[nd - 1] = "model"
        elif name == "rglru":
            ax[nd - 2] = dax
            if leaf.shape[nd - 1] % model_n == 0:
                ax[nd - 1] = "model"
        return NamedSharding(mesh, P(*ax))

    return map_with_path(spec, caches)


def batch_shardings(specs: Dict, mesh) -> Dict:
    """The specs of a step's inputs (``models.registry.input_specs``):
    the batch dim over the data axes where it divides them."""
    return {k: NamedSharding(mesh, batch_spec(mesh, v.ndim - 1,
                                              batch_size=v.shape[0]))
            for k, v in specs.items()}


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def _microbatches(batch, k: int):
    """``batch`` as ``k`` microbatches, ``[k, B / k, ...]``."""
    def split(x):
        if x.shape[0] % k:
            raise ValueError(f"a batch of {x.shape[0]} does not split "
                             f"into {k} microbatches")
        return x.reshape((k, x.shape[0] // k) + x.shape[1:])

    return tree_map(split, batch)


def _slot_microbatches(batch, mesh, k: int):
    """The reference's microbatches on a mesh: the global batch split
    into ``k`` microbatches, each laid over the data slots; this slot's
    rows of each, ``[k, B / (k n), ...]`` (the placed batch is
    gathered first: it is token ids, small)."""
    return local_rows(_microbatches(gather_rows(batch, mesh), k), mesh, 1)


def make_train_step(cfg: ArchConfig, mesh,
                    policy: Optional[QuantPolicy],
                    ocfg: AdamWConfig = AdamWConfig(),
                    schedule: Optional[Callable] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr", "nonfinite"})``: the loss and its
    gradient by autograd (on a mesh, each rank on its rows of ``batch``,
    then the means over the slots), then :func:`adamw_update`.  New
    trees are returned; the caller rebinds its names to them."""
    model = model_for(cfg)
    rules = _rules(cfg, mesh)
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

    def local_step(params, batch):
        """This rank's loss and gradient over its rows."""
        k = max(cfg.microbatches, 1)
        if k > 1:
            mb = _microbatches(batch, k) if mesh is None \
                else _slot_microbatches(batch, mesh, k)
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
            return div_scalar(loss, k), tree_map(lambda g: div_scalar(g, k),
                                                 grads)
        return value_and_grad(params, batch)

    def train_step(params, opt_state, batch):
        with mesh_rules(mesh, rules):
            if mesh is not None and "mask" in batch:
                raise ValueError("a masked batch's loss is not the mean of "
                                 "the slots' losses")
            loss, grads = local_step(params, batch)
        if mesh is not None:
            # the means over the slots, summed in slot order
            n = data_axis_size(mesh)
            loss = div_scalar(psum(loss, mesh), n)
            grads = tree_map(lambda g: div_scalar(psum(g, mesh), n), grads)
        with torch.no_grad():
            params, opt_state, stats = adamw_update(grads, opt_state,
                                                    params, sched, ocfg)
        return params, opt_state, dict(loss=loss, **stats)

    return train_step


def make_prefill_step(cfg: ArchConfig, mesh,
                      policy: Optional[QuantPolicy],
                      kv_bits: int = 32) -> Callable:
    model = model_for(cfg)
    rules = _rules(cfg, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        with mesh_rules(mesh, rules):
            if cfg.is_encdec:
                return model.prefill(params, batch, cfg, policy, kv_bits)
            return model.prefill(params, batch["tokens"], cfg, policy,
                                 kv_bits)

    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh,
                     policy: Optional[QuantPolicy],
                     kv_bits: int = 32) -> Callable:
    model = model_for(cfg)
    rules = _rules(cfg, mesh, serve=True)

    @torch.no_grad()
    def decode_step(params, caches, token, index):
        with mesh_rules(mesh, rules):
            return model.decode_step(params, token, caches, index, cfg,
                                     policy, kv_bits)

    return decode_step
