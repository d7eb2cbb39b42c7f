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
from repro_torch.distributed.sharding import (NamedSharding, P, batch_spec,
                                              data_axes, data_axis_size,
                                              gather_rows, local_rows,
                                              make_shardings, mesh_rules,
                                              mesh_shape, psum)
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


def rank_rows(tree, shardings, mesh):
    """``tree`` (meta tensors of the whole batch) as this rank holds it:
    the dimensions its shardings lay over the data axes divided among
    the slots (``data.place``'s rows), the rest whole."""
    at = dict(leaves_with_path(shardings))
    dax = data_axes(mesh)
    return map_with_path(lambda path, t: torch.empty(
        _shard_shape(t.shape, at[path], dax), dtype=t.dtype, device="meta"),
        tree)


# ---------------------------------------------------------------------------
# one (arch x shape x mesh) cell: its step, traced on the meta device
# ---------------------------------------------------------------------------

STEP_NAMES = {"train": "train_step", "prefill": "prefill_step",
              "decode": "serve_step"}


def cell_step(cfg: ArchConfig, shape: ShapeConfig, mesh,
              policy: Optional[QuantPolicy] = None) -> Callable:
    """The step a cell runs, with the reference's choices: a training
    cell at ``seq_len <= 8192`` with two or more microbatches attends
    unchunked (``q_chunk=None``), serving steps quantize the KV cache at
    the policy's ``kv_bits``."""
    kv_bits = policy.kv_bits if policy else 32
    if shape.kind == "train":
        if shape.seq_len <= 8192 and cfg.microbatches >= 2:
            cfg = cfg.replace(q_chunk=None)
        return make_train_step(cfg, mesh, policy)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, policy, kv_bits)
    return make_decode_step(cfg, mesh, policy, kv_bits)


def cell_inputs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                policy: Optional[QuantPolicy] = None, dtype=torch.float32):
    """(a cell's step inputs as rank 0 of ``mesh`` holds them, as meta
    tensors; their bytes a device under the reference's layout).

    The inputs are ``input_specs`` laid out as ``data.place`` lays them
    on the rank (its rows over the data axes); the params (and AdamW's
    state) are whole on the rank, as the port's steps hold them.
    Serving steps take PTQ'd weights, but an MoE's: its packed experts'
    scales do not lead with the layer count, and neither package's layer
    walk takes them (the reference's dry run fails there), so an MoE
    serves fp weights quantized at each call, as ``launch.serve`` serves
    it (``weight_ptq=False``).  Decode takes the ``serve=True`` rules,
    one token at the cache's last position."""
    ms = mesh_shape(mesh)
    specs = input_specs(cfg, shape)
    in_shard = batch_shardings(specs, ms)
    serve = shape.kind != "train"
    ptq = policy if (serve and policy and policy.quantized_w
                     and not cfg.is_moe) else None
    abs_params, p_shard = abstract_params(cfg, ms, dtype, weight_ptq=ptq,
                                          serve=shape.kind == "decode")
    batch = rank_rows(specs, in_shard, ms)
    if shape.kind == "train":
        abs_opt, o_shard = abstract_opt_state(abs_params, p_shard, ms)
        return (abs_params, abs_opt, batch), layout_bytes(
            (abs_params, abs_opt, specs), (p_shard, o_shard, in_shard))
    if shape.kind == "prefill":
        return (abs_params, batch), layout_bytes((abs_params, specs),
                                                 (p_shard, in_shard))
    kv_bits = policy.kv_bits if policy else 32
    caches, c_shard = abstract_caches(cfg, shape, ms, kv_bits, dtype)
    args = (abs_params, rank_rows(caches, c_shard, ms), batch["token"],
            shape.seq_len - 1)
    # the index: one int32 scalar, replicated
    return args, layout_bytes((abs_params, caches, specs),
                              (p_shard, c_shard, in_shard)) + 4


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               policy: Optional[QuantPolicy] = None, dtype=torch.float32,
               donate: bool = True):
    """Trace one rank's step of this cell on the meta device; returns
    (``hlo_analysis.Program``, meta dict).  Nothing is allocated.

    The mesh is taken by its names and sizes alone (a ``MeshShape``):
    this process is the mesh's rank 0 and no process group is touched.
    The step is :func:`cell_step`'s, its inputs :func:`cell_inputs`'.
    ``donate`` is the reference's; the port donates nothing."""
    del donate
    from repro_torch.launch import hlo_analysis

    ms = mesh_shape(mesh)
    args, layout = cell_inputs(cfg, shape, ms, policy, dtype)
    program = hlo_analysis.trace(cell_step(cfg, shape, ms, policy), args,
                                 layout)
    return program, {"step": STEP_NAMES[shape.kind],
                     "inputs": input_specs(cfg, shape)}


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
