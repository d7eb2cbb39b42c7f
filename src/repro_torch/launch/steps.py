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

``make_train_step(..., shardings=p_shard)`` is the reference's step
jitted with ``in_shardings=(p_shard, ...)`` (the dense family): each
rank holds its blocks of the params and AdamW's state under ``p_shard``
(``distributed.sharding.local_shards``) and the model computes on them
laid out (``models.transformer``).  A gradient split over the data axes
reaches its rank reduce-scattered over the slots in slot order; one
whole on every slot is summed over them as a reduce-scatter and an
all-gather of its pieces.  No rank gathers a whole leaf.

``make_prefill_step(..., shardings=p_shard)`` and
``make_decode_step(..., shardings=p_shard, cache_shardings=c_shard)``
are the reference's serving steps jitted with their ``in_shardings``
(the dense family): each rank holds its blocks of the PTQ'd params, a
prefill under the FSDP+TP rules and a decode step under the serve
rules, and a decode step its blocks of the caches under
``cache_shardings``; a prefill returns its caches as those blocks.

``cache_shardings`` and ``batch_shardings`` give the reference's specs
of the serving caches and the inputs.  ``abstract_params``,
``abstract_opt_state`` and ``abstract_caches`` give the trees as
``meta`` tensors (``nn.module.eval_shape``) with their shardings, and
``lower_cell`` traces one rank's step of a cell on the meta device for
the dry run.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.fxp import QTensor, div_scalar, is_qtensor
from repro_torch.core.policy import QuantPolicy
from repro_torch.distributed.sharding import (NamedSharding, P, axes_size,
                                              axis_index, batch_spec,
                                              data_axes, data_axis_size,
                                              gather_over, gather_rows,
                                              local_rows, make_shardings,
                                              map_sharded, mesh_rules,
                                              mesh_shape, psum, psum_pieces,
                                              spec_axes)
from repro_torch.models.registry import (input_specs, model_for,
                                         sharding_rules)
from repro_torch.nn.module import eval_shape
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)
from repro_torch.tree import (leaves_with_path, map_with_path, tree_leaves,
                              tree_map, tree_unflatten)


def _rules(cfg: ArchConfig, mesh, serve: bool = False) -> Dict:
    if mesh is None:
        return {}
    return sharding_rules(cfg, mesh_shape(mesh).shape.get("model", 1),
                          serve=serve)


# ---------------------------------------------------------------------------
# specs of the caches and inputs
# ---------------------------------------------------------------------------

def _kv_split(cfg: ArchConfig, capacity: int, model_n: int
              ) -> Optional[str]:
    """What of a KV cache of ``capacity`` positions lies over the model
    axis: ``"heads"`` where the kv heads divide it, else ``"seq"`` where
    the capacity does (flash-decoding), else None."""
    if cfg.n_kv_heads and cfg.n_kv_heads % model_n == 0:
        return "heads"
    return "seq" if capacity % model_n == 0 else None


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
            split = _kv_split(cfg, leaf.shape[nd - 3], model_n)
            if split == "heads":
                ax[nd - 2] = "model"
            elif split == "seq":
                ax[nd - 3] = "model"
        elif name == "pos":
            ax[nd - 2] = dax
            if _kv_split(cfg, leaf.shape[nd - 1], model_n) == "seq":
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


def _cache_seq(cache_shards):
    """The rules' ``cache_seq`` entry for caches laid out by
    ``cache_shards`` (``nn.attention.kv_split`` reads it): the mesh axis
    the keys' sequence lies over, or None."""
    for path, s in leaves_with_path(
            cache_shards, is_leaf=lambda x: isinstance(x, NamedSharding)):
        if str(path[-1]) == "k":
            return s.spec[-3]
    raise ValueError("the cache shardings hold no 'k' leaf")


def pad_cache_blocks(caches, prompt_len: int, extra: int,
                     cfg: ArchConfig, mesh):
    """``launch.serve.pad_caches`` on a rank's blocks (a laid-out
    prefill's, ``prompt_len`` positions): the blocks of the caches grown
    by ``extra`` zero positions, under the grown caches'
    ``cache_shardings``.  Where the sequence lies over the model axis
    the split's boundaries move with the capacity, so each block is
    gathered over that axis, grown, and cut to this rank's positions of
    the new capacity; kv heads split over it stay where they are."""
    model_n = mesh_shape(mesh).shape.get("model", 1)
    old = _kv_split(cfg, prompt_len, model_n)
    new = _kv_split(cfg, prompt_len + extra, model_n)

    def grow(t):
        if old == "seq" and model_n > 1:
            t = torch.cat(gather_over(t.contiguous(), mesh, ("model",)),
                          dim=-3)
        shape = list(t.shape)
        shape[-3] = extra
        t = torch.cat([t, t.new_zeros(shape)], dim=-3)
        if new == "seq" and model_n > 1:
            n = t.shape[-3] // model_n
            t = t.narrow(-3, axis_index(mesh, "model") * n, n).clone()
        return t

    return {k: grow(v) if k in ("k", "v", "k_scale", "v_scale") else v
            for k, v in caches.items()}


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


def laid_out(cfg: ArchConfig) -> bool:
    """Whether the steps take ``shardings`` for ``cfg``: the dense
    decoders.  The other families keep the whole-param steps."""
    return cfg.family == "dense"


def _check_laid_out(cfg: ArchConfig, mesh) -> None:
    if mesh is None or not laid_out(cfg):
        raise ValueError(f"{cfg.name}: a laid-out step takes a mesh and a "
                         "dense decoder")


def _split_axes(shardings, mesh):
    """Each leaf's mesh axes of more than one peer, in leaf order, and
    whether it is split over the data axes."""
    dax, names = data_axes(mesh), mesh_shape(mesh).axis_names
    out = []
    for _, s in leaves_with_path(
            shardings, is_leaf=lambda x: isinstance(x, NamedSharding)):
        axes = sorted((a for e in spec_axes(s.spec) for a in e),
                      key=names.index)
        out.append((tuple(a for a in axes if axes_size(mesh, (a,)) > 1),
                    any(a in dax for a in axes)))
    return out


def make_train_step(cfg: ArchConfig, mesh,
                    policy: Optional[QuantPolicy],
                    ocfg: AdamWConfig = AdamWConfig(),
                    schedule: Optional[Callable] = None,
                    shardings=None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr", "nonfinite"})``: the loss and its
    gradient by autograd (on a mesh, each rank on its rows of ``batch``,
    then the means over the slots), then :func:`adamw_update`.  New
    trees are returned; the caller rebinds its names to them.

    ``shardings`` (``make_shardings``' tree of the params, on ``mesh``):
    the params and the moments are this rank's blocks under it, and the
    step runs laid out (a dense decoder, :func:`laid_out`)."""
    model = model_for(cfg)
    rules = _rules(cfg, mesh)
    sched = schedule or warmup_cosine(3e-4, 100, 10_000)
    if shardings is not None:
        _check_laid_out(cfg, mesh)
        split = _split_axes(shardings, mesh)

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

    def slot_means(grads):
        """The laid-out gradient's means over the slots: the leaves split
        over the data axes came back summed (reduce-scattered); those
        whole on every slot are summed here, laid end to end, as one
        reduce-scatter and all-gather in slot order."""
        n = data_axis_size(mesh)
        leaves = tree_leaves(grads)
        whole = [i for i, (_, on_data) in enumerate(split) if not on_data]
        if whole and n > 1:
            flat = torch.cat([leaves[i].reshape(-1) for i in whole])
            flat = psum_pieces(flat, mesh, data_axes(mesh))
            start = 0
            for i in whole:
                leaves[i] = flat[start:start + leaves[i].numel()].reshape(
                    leaves[i].shape)
                start += leaves[i].numel()
        return tree_unflatten(grads, [div_scalar(g, n) for g in leaves])

    def train_step(params, opt_state, batch):
        with mesh_rules(mesh, rules, laid_out=shardings is not None):
            if mesh is not None and "mask" in batch:
                raise ValueError("a masked batch's loss is not the mean of "
                                 "the slots' losses")
            loss, grads = local_step(params, batch)
        kw = {}
        if mesh is not None:
            # the means over the slots, summed in slot order
            n = data_axis_size(mesh)
            loss = div_scalar(psum(loss, mesh), n)
            if shardings is None:
                grads = tree_map(lambda g: div_scalar(psum(g, mesh), n),
                                 grads)
            else:
                grads = slot_means(grads)
                kw = dict(mesh=mesh, split=[a for a, _ in split])
        with torch.no_grad():
            params, opt_state, stats = adamw_update(grads, opt_state,
                                                    params, sched, ocfg,
                                                    **kw)
        return params, opt_state, dict(loss=loss, **stats)

    return train_step


def make_prefill_step(cfg: ArchConfig, mesh,
                      policy: Optional[QuantPolicy],
                      kv_bits: int = 32, shardings=None) -> Callable:
    """``prefill_step(params, batch) -> (last-position logits, caches)``
    on this rank's rows of ``batch``, under the FSDP+TP rules.

    ``shardings`` (``make_shardings``' tree of the PTQ'd params under
    those rules, on ``mesh``): the params are this rank's blocks under
    it (a dense decoder, :func:`laid_out`).  The logits are this rank's
    rows, whole over the vocabulary, and the caches this rank's blocks
    under ``cache_shardings`` of the prefill's own caches (the prompt's
    length): the reference leaves the prefill's output layout to XLA,
    and its decode step's ``in_shardings`` fix what it must be, so the
    prefill returns that (:func:`pad_cache_blocks` grows them for a
    decode)."""
    model = model_for(cfg)
    rules = _rules(cfg, mesh)
    if shardings is not None:
        _check_laid_out(cfg, mesh)
        model_n = mesh_shape(mesh).shape.get("model", 1)

    @torch.no_grad()
    def prefill_step(params, batch):
        step_rules = rules
        if shardings is not None:
            seq = _kv_split(cfg, batch["tokens"].shape[1], model_n)
            step_rules = dict(rules, cache_seq="model" if seq == "seq"
                              else None)
        with mesh_rules(mesh, step_rules, laid_out=shardings is not None):
            if cfg.is_encdec:
                return model.prefill(params, batch, cfg, policy, kv_bits)
            return model.prefill(params, batch["tokens"], cfg, policy,
                                 kv_bits)

    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh,
                     policy: Optional[QuantPolicy],
                     kv_bits: int = 32, shardings=None,
                     cache_shardings=None) -> Callable:
    """``decode_step(params, caches, token, index) -> (logits, caches)``
    on this rank's rows, under the serve rules (no FSDP: the weights'
    ``d_model`` lies over no data axis).

    ``shardings`` (``make_shardings``' tree of the PTQ'd params under
    the serve rules) with ``cache_shardings`` (``cache_shardings``' tree
    of the caches): the params and the caches are this rank's blocks
    under them (a dense decoder, :func:`laid_out`), the caches updated
    in place; the logits this rank's rows, whole over the vocabulary."""
    model = model_for(cfg)
    rules = _rules(cfg, mesh, serve=True)
    laid = shardings is not None or cache_shardings is not None
    if laid:
        if shardings is None or cache_shardings is None:
            raise ValueError("a laid-out decode step takes the params' and "
                             "the caches' shardings")
        _check_laid_out(cfg, mesh)
        rules = dict(rules, cache_seq=_cache_seq(cache_shardings))

    @torch.no_grad()
    def decode_step(params, caches, token, index):
        with mesh_rules(mesh, rules, laid_out=laid):
            return model.decode_step(params, token, caches, index, cfg,
                                     policy, kv_bits)

    return decode_step


# ---------------------------------------------------------------------------
# abstract state and shardings: meta tensors, nothing drawn or allocated
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _abstract_init(cfg: ArchConfig, dtype):
    return eval_shape(functools.partial(model_for(cfg).init, cfg=cfg,
                                        dtype=dtype, device="cpu"),
                      torch.Generator().manual_seed(0))


def abstract_params(cfg: ArchConfig, mesh, dtype=torch.float32,
                    weight_ptq: Optional[QuantPolicy] = None,
                    serve: bool = False) -> Tuple[Any, Any]:
    """(the param tree as meta tensors, its ``NamedSharding`` tree), the
    reference's ``jax.eval_shape(model.init)``: the family's ``init``
    runs under a ``FakeTensorMode``.  ``weight_ptq``: the serving
    weights, int8 QTensors (payload and scales), as a deployed engine
    loads them.  ``mesh`` is a live mesh or a ``MeshShape``."""
    model = model_for(cfg)
    # fresh containers around the cached meta leaves
    params = tree_map(lambda t: t, _abstract_init(cfg, dtype))
    if weight_ptq is not None and weight_ptq.quantized_w:
        from repro_torch.core.quantizer import quantize_params
        params = eval_shape(lambda t: quantize_params(t, weight_ptq), params)
    rules = sharding_rules(cfg, mesh_shape(mesh).shape.get("model", 1),
                           serve=serve)
    return params, make_shardings(params, model.param_axes(cfg), mesh, rules)


def abstract_opt_state(abs_params, param_shardings, mesh):
    """(AdamW's state of ``abs_params`` as meta tensors, its shardings):
    the moments take the params' shardings, the count is replicated."""
    opt = eval_shape(adamw_init, abs_params)
    shard = {"mu": param_shardings, "nu": param_shardings,
             "count": NamedSharding(mesh, P())}
    return opt, shard


def abstract_caches(cfg: ArchConfig, shape: ShapeConfig, mesh,
                    kv_bits: int = 32, dtype=torch.float32):
    """(the serving caches of ``shape``'s whole batch as meta tensors,
    their ``cache_shardings``)."""
    model = model_for(cfg)
    caches = eval_shape(lambda: model.init_caches(
        cfg, shape.global_batch, shape.seq_len, kv_bits, dtype,
        device="meta"))
    return caches, cache_shardings(caches, cfg, shape.global_batch, mesh)


def _sharded_pairs(tree, shardings):
    """(tensor, its ``NamedSharding``) for every tensor of ``tree``, a
    QTensor's payload and scale each with its own."""
    at = dict(leaves_with_path(shardings, is_leaf=is_qtensor))
    for path, leaf in leaves_with_path(tree, is_leaf=is_qtensor):
        s = at[path]
        if isinstance(leaf, QTensor):
            yield leaf.qvalue, s.qvalue
            yield leaf.scale, s.scale
        elif isinstance(leaf, torch.Tensor):
            yield leaf, s


def _shard_shape(shape, sharding: NamedSharding, axes=None) -> Tuple:
    """A shard of ``shape`` under ``sharding``: each dimension divided
    (rounding up) by the sizes of the mesh axes its spec names (of
    ``axes`` only, when given)."""
    sizes = mesh_shape(sharding.mesh).shape
    out = list(shape)
    for d, entry in enumerate(sharding.spec):
        names = entry if isinstance(entry, tuple) else \
            (entry,) if entry else ()
        k = math.prod(sizes[a] for a in names if axes is None or a in axes)
        out[d] = -(-out[d] // k)
    return tuple(out)


def layout_bytes(tree, shardings) -> int:
    """The bytes one device holds of ``tree`` laid out by
    ``shardings``."""
    return sum(math.prod(_shard_shape(t.shape, s)) * t.dtype.itemsize
               for t, s in _sharded_pairs(tree, shardings))


def rank_blocks(tree, shardings, axes=None):
    """``tree`` (meta tensors, whole; a QTensor's payload and scale each
    under its own sharding) as a rank holds its blocks under
    ``shardings``: every dimension divided by the mesh axes its spec
    names (of ``axes`` only, when given)."""
    return map_sharded(lambda t, s: torch.empty(
        _shard_shape(t.shape, s, axes), dtype=t.dtype, device="meta"),
        tree, shardings)


def rank_rows(tree, shardings, mesh):
    """``tree`` (meta tensors of the whole batch) as this rank holds it:
    the dimensions its shardings lay over the data axes divided among
    the slots (``data.place``'s rows), the rest whole."""
    return rank_blocks(tree, shardings, data_axes(mesh))


# ---------------------------------------------------------------------------
# one (arch x shape x mesh) cell: its step, traced on the meta device
# ---------------------------------------------------------------------------

STEP_NAMES = {"train": "train_step", "prefill": "prefill_step",
              "decode": "serve_step"}


def _served_weights(cfg: ArchConfig, policy: Optional[QuantPolicy]
                    ) -> Optional[QuantPolicy]:
    """The PTQ a serving cell's weights take: the policy's, but an
    MoE's (its packed experts' scales do not lead with the layer count,
    and neither package's layer walk takes them)."""
    return policy if (policy and policy.quantized_w and not cfg.is_moe) \
        else None


def cell_step(cfg: ArchConfig, shape: ShapeConfig, mesh,
              policy: Optional[QuantPolicy] = None) -> Callable:
    """The step a cell runs, with the reference's choices: a training
    cell at ``seq_len <= 8192`` with two or more microbatches attends
    unchunked (``q_chunk=None``), a dense decoder's steps run laid out
    on the params' shardings (a prefill on the PTQ'd params' under the
    FSDP+TP rules, a decode step on the serve rules' and the caches'),
    serving steps quantize the KV cache at the policy's ``kv_bits``."""
    kv_bits = policy.kv_bits if policy else 32
    if shape.kind == "train":
        if shape.seq_len <= 8192 and cfg.microbatches >= 2:
            cfg = cfg.replace(q_chunk=None)
        p_shard = abstract_params(cfg, mesh)[1] if laid_out(cfg) else None
        return make_train_step(cfg, mesh, policy, shardings=p_shard)
    ptq = _served_weights(cfg, policy)
    if shape.kind == "prefill":
        p_shard = abstract_params(cfg, mesh, weight_ptq=ptq)[1] \
            if laid_out(cfg) else None
        return make_prefill_step(cfg, mesh, policy, kv_bits,
                                 shardings=p_shard)
    if not laid_out(cfg):
        return make_decode_step(cfg, mesh, policy, kv_bits)
    return make_decode_step(
        cfg, mesh, policy, kv_bits,
        shardings=abstract_params(cfg, mesh, weight_ptq=ptq, serve=True)[1],
        cache_shardings=abstract_caches(cfg, shape, mesh, kv_bits)[1])


def cell_inputs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                policy: Optional[QuantPolicy] = None, dtype=torch.float32):
    """(a cell's step inputs as rank 0 of ``mesh`` holds them, as meta
    tensors; their bytes a device under the reference's layout).

    The inputs are ``input_specs`` laid out as ``data.place`` lays them
    on the rank (its rows over the data axes).  A dense decoder's steps
    hold the rank's blocks of the params (and AdamW's state in
    training, the caches in decode) under their shardings, as the
    reference lays them out, so the traced arguments are the layout's
    bytes; every other step holds them whole, as the port's steps do,
    and its caches' rows.
    Serving steps take PTQ'd weights, but an MoE's: its packed experts'
    scales do not lead with the layer count, and neither package's layer
    walk takes them (the reference's dry run fails there), so an MoE
    serves fp weights quantized at each call, as ``launch.serve`` serves
    it (``weight_ptq=False``).  Decode takes the ``serve=True`` rules,
    one token at the cache's last position."""
    ms = mesh_shape(mesh)
    specs = input_specs(cfg, shape)
    in_shard = batch_shardings(specs, ms)
    ptq = _served_weights(cfg, policy) if shape.kind != "train" else None
    abs_params, p_shard = abstract_params(cfg, ms, dtype, weight_ptq=ptq,
                                          serve=shape.kind == "decode")
    batch = rank_rows(specs, in_shard, ms)
    params = rank_blocks(abs_params, p_shard) if laid_out(cfg) \
        else abs_params
    if shape.kind == "train":
        abs_opt, o_shard = abstract_opt_state(abs_params, p_shard, ms)
        opt = rank_blocks(abs_opt, o_shard) if laid_out(cfg) else abs_opt
        return (params, opt, batch), layout_bytes(
            (abs_params, abs_opt, specs), (p_shard, o_shard, in_shard))
    if shape.kind == "prefill":
        return (params, batch), layout_bytes((abs_params, specs),
                                             (p_shard, in_shard))
    kv_bits = policy.kv_bits if policy else 32
    abs_caches, c_shard = abstract_caches(cfg, shape, ms, kv_bits, dtype)
    caches = rank_blocks(abs_caches, c_shard) if laid_out(cfg) \
        else rank_rows(abs_caches, c_shard, ms)
    args = (params, caches, batch["token"], shape.seq_len - 1)
    # the index: one int32 scalar, replicated
    return args, layout_bytes((abs_params, abs_caches, specs),
                              (p_shard, c_shard, in_shard)) + 4


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               policy: Optional[QuantPolicy] = None, dtype=torch.float32,
               donate: bool = True):
    """Trace one rank's step of this cell on the meta device; returns
    (``hlo_analysis.Program``, meta dict).  Nothing is allocated.

    The mesh is taken by its names and sizes alone (a ``MeshShape``):
    this process is the mesh's rank 0 and no process group is touched.
    The step is :func:`cell_step`'s, its inputs :func:`cell_inputs`'
    (``meta["laid_out"]``: the step runs on rank 0's blocks of the
    params, a dense decoder's step of any kind).
    ``donate`` is the reference's; the port donates nothing."""
    del donate
    from repro_torch.launch import hlo_analysis

    ms = mesh_shape(mesh)
    args, layout = cell_inputs(cfg, shape, ms, policy, dtype)
    program = hlo_analysis.trace(cell_step(cfg, shape, ms, policy), args,
                                 layout)
    return program, {"step": STEP_NAMES[shape.kind],
                     "inputs": input_specs(cfg, shape),
                     "laid_out": laid_out(cfg)}


def materialize(tree, gen: torch.Generator, vocab: int):
    """Real tensors for a meta tree (``cell_inputs``'), drawn on the
    device of ``gen`` (so a full-width tree costs the host nothing), to
    run a cell's step there: floats N(0, 0.02^2), token ids below
    ``vocab``, int8 codes in [-127, 127], a QTensor's scales in [1e-3,
    1.1e-2]."""
    dev = gen.device

    def draw(t, scale=False):
        if t.dtype == torch.int8:
            x = torch.randint(-127, 128, t.shape, generator=gen, device=dev,
                              dtype=torch.int8)
        elif not t.dtype.is_floating_point:
            x = torch.randint(0, vocab, t.shape, generator=gen, device=dev,
                              dtype=t.dtype)
        elif scale:
            x = torch.rand(t.shape, generator=gen, device=dev) * 1e-2 + 1e-3
        else:
            x = torch.randn(t.shape, generator=gen, device=dev) * 0.02
        return x.to(t.dtype)

    def one(x):
        if isinstance(x, QTensor):
            return QTensor(draw(x.qvalue), draw(x.scale, True), x.bits)
        return draw(x) if isinstance(x, torch.Tensor) else x

    return tree_map(one, tree, is_leaf=is_qtensor)
