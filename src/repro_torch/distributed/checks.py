"""Bodies of the sharded paths' multi-rank checks.

Each function here runs on every rank of a group (``ranks.run_ranks``
spawns them on the CPU; ``chip_smoke.py`` calls the fleet's in-process
on the card) and returns what its rank computed, as numpy, for a caller
to hold against a reference.  The RL fleet's: the sharded collects, the
compressed gradient mean, and one sharded value update.  The LM
layout's: the training step on the host mesh, the MoE dispatch on a
(data, model) mesh, the batch placement and a tree's layout, and
``launch.train`` fed given batches; the laid-out training step on a
(data, model) mesh and its trace; the laid-out serving steps (a prefill
and decode steps on the PTQ'd blocks and the cache blocks), the split
packed products and the sequence-split decode attention.  Inputs come
in as numpy or as the
port's tensors on the CPU; the mesh is the host mesh over every rank
unless a body says otherwise.
"""
from __future__ import annotations

import contextlib
import math
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.checkpointer import from_numpy_tree
from repro_torch.configs.registry import get_arch
from repro_torch.core import exact, qmatmul
from repro_torch.core.fxp import QTensor, is_qtensor
from repro_torch.core.policy import FXP8, get_policy
from repro_torch.data import place
from repro_torch.distributed import sharding
from repro_torch.distributed.ranks import to_host as as_numpy
from repro_torch.launch import steps as lsteps
from repro_torch.launch import train as ltrain
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models.registry import model_for, sharding_rules
from repro_torch.nn.attention import _softmax
from repro_torch.nn.moe import _top_k
from repro_torch.nn.moe_shard import _local_dispatch, moe_shard_map
from repro_torch.optim import (AdamWConfig, adamw_init, constant,
                               warmup_cosine)
from repro_torch.optim.compression import compressed_psum_mean, shared_codes
from repro_torch.rl.actor_learner import collect_sharded, collect_value_sharded
from repro_torch.rl.envs import make
from repro_torch.rl.inference import build_env, make_value_agent
from repro_torch.rl.nets import mlp_ac_apply
from repro_torch.rl.replay import make_replay
from repro_torch.rl.rollout import init_envs
from repro_torch.rl.train_steps import ValueDraws, make_sharded_value_iteration
from repro_torch.tree import leaves_with_path, path_str, tree_map


def fleet_collects(packed, est, obs, noise, value_packed, value_est,
                   value_obs, actions, uniforms, eps: float, n_steps: int,
                   reset_seed: int) -> dict:
    """The cartpole fleets over the host mesh: ``collect_sharded`` of
    the fxp8 mlp actor-critic with the global Gumbel draws ``noise``,
    ``collect_value_sharded`` of the fxp8 DQN behaviour with the global
    ε-greedy draws (``actions``, ``uniforms`` [T, B]), and
    ``init_envs(..., mesh)`` of ``len(obs)`` envs from ``reset_seed``:
    the global results every rank holds."""
    mesh = make_host_mesh(device="cpu")
    env = make("cartpole")
    res = collect_sharded(packed, env, mlp_ac_apply, FXP8, noise, est, obs,
                          n_steps, mesh)
    venv = build_env("cartpole", "mlp")
    agent = make_value_agent("dqn", venv.spec, device="cpu")
    value = collect_value_sharded(
        value_packed, venv, agent.behave, FXP8,
        lambda t: (actions[t], uniforms[t]), value_est, value_obs, n_steps,
        eps, mesh)
    reset = init_envs(env, reset_seed, obs.shape[0], "cpu", mesh=mesh)
    return as_numpy({"onpolicy": tuple(res), "value": value,
                     "reset": reset})


def compressed_means(gs: np.ndarray, cases: Sequence, steps: int) -> dict:
    """``compressed_psum_mean`` over the host mesh: rank ``r`` holds
    ``gs[step, r]`` at each of ``steps`` steps, the error buffer carried
    from step to step.  For each ``(bits, strategy)`` case, every step's
    shared scale, this rank's codes, the mean and the new error."""
    mesh = make_host_mesh(device="cpu")
    rank = torch.distributed.get_rank()
    out = {}
    for bits, strategy in cases:
        err, rows = None, []
        for k in range(steps):
            g = torch.from_numpy(gs[k, rank])
            row = {}
            if bits < 32:
                corr = g + (err if err is not None else torch.zeros_like(g))
                row["codes"], row["scale"] = shared_codes(corr, mesh, bits)
            row["mean"], err = compressed_psum_mean(g, mesh, bits, err,
                                                    strategy)
            row["error"] = err
            rows.append(as_numpy(row))
        out[f"{bits}-{strategy}"] = rows
    return out


def value_update(algo: str, env_name: str, params, target,
                 batches: List[Dict[str, np.ndarray]], alive: Sequence[bool],
                 smoothing: np.ndarray, lr: float, learn_start: int) -> dict:
    """One update of the sharded value iteration over the host mesh,
    slot ``d`` learning from ``batches[d]``: its replay slot holds that
    batch and samples it in order.  Returns each gradient the learner
    applied (the mean over the live slots, by name), and the params and
    AdamW state after the update."""
    mesh = make_host_mesh(device="cpu")
    env = build_env(env_name, "mlp")
    agent = make_value_agent(algo, env.spec, learn_start=learn_start,
                             device="cpu")
    n_slots = len(batches)
    n_local = len(batches[0]["rewards"])
    act = batches[0]["actions"]
    rb = make_replay("uniform", n_local, env.spec.obs_shape, act.shape[1:],
                     torch.float32 if algo == "ddpg" else torch.int32)
    ocfg = AdamWConfig(weight_decay=0.0, max_grad_norm=10.0)
    it = make_sharded_value_iteration(
        env, agent, rb, None, constant(lr), ocfg, mesh, algo=algo,
        rollout_len=1, updates_per_iter=1, per_beta0=0.4, beta_iters=1)
    b = {k: torch.from_numpy(v)
         for k, v in batches[torch.distributed.get_rank()].items()}
    buf = rb.add(rb.init(), b["obs"], b["actions"], b["rewards"],
                 b["next_obs"], b["discounts"])
    params = from_numpy_tree(params, "cpu")
    target = from_numpy_tree(target, "cpu")
    opt = ({k: adamw_init(v) for k, v in params.items()} if algo == "ddpg"
           else adamw_init(params))
    slots = torch.arange(n_local).repeat(n_slots)[None]
    draws = ValueDraws(None, None, None, slots,
                       torch.from_numpy(smoothing)[None]
                       if algo == "ddpg" else None)
    grads = {}
    view = it.slot_view(buf, torch.tensor(list(alive)))
    step = it.mean_grad_step(view.n_alive, grads.__setitem__)
    params, _, opt, _ = it.update(params, target, opt, buf, draws, 0, 1.0,
                                  step=step, view=view)
    return as_numpy({"grads": grads, "params": params, "opt": opt})


@contextlib.contextmanager
def recorded_codes(seq_len: int):
    """Within the block, the int8 codes of each ``[..., seq_len, K]``
    activation ``core.qmatmul.quantize_rowwise`` quantizes (the dense
    products' inputs; an expert buffer's second dimension is its
    capacity), appended to the list it yields."""
    rec, orig = [], qmatmul.quantize_rowwise

    def record(x, bits, *split):
        q, scale = orig(x, bits, *split)
        if x.ndim == 3 and x.shape[1] == seq_len:
            rec.append(q)
        return q, scale

    qmatmul.quantize_rowwise = record
    try:
        yield rec
    finally:
        qmatmul.quantize_rowwise = orig


def train_steps(cases: Dict[str, dict]) -> dict:
    """For each case (``arch``, ``policy``, reference ``params``,
    ``opt``, the global ``batch``, the schedule's ``lr``, ``warmup`` and
    ``total``, ``q_chunk``): one ``make_train_step`` step on the host
    mesh over every rank from the placed batch, and the int8 codes
    of the forward's dense products on this rank's rows.  Rank 0 also
    returns the loss, the stats, the gradient ``adamw_update`` was
    handed, and the new params and optimizer state."""
    mesh = make_host_mesh(device="cpu")
    lead = torch.distributed.get_rank() == 0
    out = {}
    for name, c in cases.items():
        cfg = get_arch(c["arch"]).reduced().replace(q_chunk=c["q_chunk"])
        pol = get_policy(c["policy"])
        params, opt = from_numpy_tree((c["params"], c["opt"]), "cpu")
        batch = place(c["batch"], mesh)
        seq = batch["tokens"].shape[1]
        with recorded_codes(seq) as rec, torch.no_grad(), \
                sharding.mesh_rules(mesh, sharding_rules(cfg, 1)):
            model_for(cfg).loss_fn(params, batch, cfg, pol)
        grads = []
        update = lsteps.adamw_update
        lsteps.adamw_update = lambda g, *a, **kw: (grads.append(g),
                                                   update(g, *a, **kw))[1]
        try:
            step = lsteps.make_train_step(
                cfg, mesh, pol, schedule=warmup_cosine(
                    c["lr"], c["warmup"], c["total"]))
            new_p, new_o, stats = step(params, opt, batch)
        finally:
            lsteps.adamw_update = update
        res = {"codes": rec}
        if lead:
            res.update(params=new_p, opt=new_o, stats=stats,
                       grads=grads[0])
        out[name] = as_numpy(res)
    return out


def _recording_grads(step, *args):
    """``step(*args)`` with the gradient ``adamw_update`` is handed:
    (its result, the gradient)."""
    grads = []
    update = lsteps.adamw_update
    lsteps.adamw_update = lambda g, *a, **kw: (grads.append(g),
                                               update(g, *a, **kw))[1]
    try:
        out = step(*args)
    finally:
        lsteps.adamw_update = update
    return out, grads[0]


def laid_out_steps(cases: Dict[str, dict]) -> dict:
    """For each case (``arch``, its reduced config's overrides
    ``extra``, the (data, model) mesh ``shape``, ``policy``, reference
    ``params`` and ``opt`` whole, the global ``batch``, the schedule's
    ``lr``, ``warmup`` and ``total``, ``q_chunk``): this rank's blocks
    of the reference's init (``checkpoint.shards_from_numpy``), then on
    the mesh the data-parallel step on the whole params and the laid-out
    step (``make_train_step(..., shardings=...)``) on the blocks, each
    from the placed batch: the int8 codes of each one's forward on this
    rank's rows, their losses, and the gradients ``adamw_update`` was
    handed (the data-parallel one cut to this rank's blocks), and the
    laid-out step's new blocks of the params and the state and its
    stats."""
    from repro_torch.checkpoint.checkpointer import shards_from_numpy

    out = {}
    for name, c in cases.items():
        cfg = get_arch(c["arch"]).reduced().replace(q_chunk=c["q_chunk"],
                                                   **c["extra"])
        pol = get_policy(c["policy"])
        mesh = make_mesh(tuple(c["shape"]), ("data", "model"), device="cpu")
        _, p_shard = lsteps.abstract_params(cfg, mesh)
        params, opt = from_numpy_tree((c["params"], c["opt"]), "cpu")
        blocks = shards_from_numpy(c["params"], p_shard, mesh, "cpu")
        state = {"mu": shards_from_numpy(c["opt"]["mu"], p_shard, mesh,
                                         "cpu"),
                 "nu": shards_from_numpy(c["opt"]["nu"], p_shard, mesh,
                                         "cpu"),
                 "count": opt["count"]}
        batch = place(c["batch"], mesh)
        seq = batch["tokens"].shape[1]
        rules = sharding_rules(cfg, c["shape"][1])
        codes = {}
        for kind, tree, lay in (("dp", params, False), ("laid", blocks,
                                                        True)):
            with recorded_codes(seq) as rec, torch.no_grad(), \
                    sharding.mesh_rules(mesh, rules, laid_out=lay):
                model_for(cfg).loss_fn(tree, batch, cfg, pol)
            codes[kind] = rec
        sched = warmup_cosine(c["lr"], c["warmup"], c["total"])
        (_, _, dp_stats), dp_grads = _recording_grads(
            lsteps.make_train_step(cfg, mesh, pol, schedule=sched),
            params, opt, batch)
        (new_p, new_o, stats), grads = _recording_grads(
            lsteps.make_train_step(cfg, mesh, pol, schedule=sched,
                                   shardings=p_shard),
            blocks, state, batch)
        out[name] = as_numpy({
            "init": blocks, "codes": codes["laid"], "dp_codes": codes["dp"],
            "dp_loss": dp_stats["loss"], "dp_grad_norm":
                dp_stats["grad_norm"],
            "grads": grads, "dp_grads": sharding.local_shards(
                dp_grads, p_shard, mesh),
            "params": new_p, "opt": new_o, "stats": stats})
    return out


def laid_out_trace(arch: str, shape: Sequence[int], seq: int, batch: int,
                   policy: str, kind: str = "train") -> Optional[list]:
    """One laid-out step of ``kind`` (train, prefill or decode) of the
    reduced ``arch`` on a ``shape`` (data, model) mesh over every rank,
    at ``batch`` rows of ``seq`` tokens (a decode step's cache
    capacity): ``launch.steps.cell_step`` on ``cell_inputs`` drawn on
    the CPU (each rank its own draw, at rank 0's shapes), traced by the
    costing recorder.  Rank 0 returns its records (kind, name, operand
    and output specs, view flag), the others None."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import hlo_analysis

    cfg = get_arch(arch).reduced()
    pol = get_policy(policy)
    mesh = make_mesh(tuple(shape), ("data", "model"), device="cpu")
    cell = ShapeConfig("laid_out", seq, batch, kind)
    args, _ = lsteps.cell_inputs(cfg, cell, mesh, pol)
    rank = torch.distributed.get_rank()
    args = lsteps.materialize(args, torch.Generator().manual_seed(rank),
                              cfg.vocab)
    program = hlo_analysis.trace(lsteps.cell_step(cfg, cell, mesh, pol),
                                 args)
    return [tuple(r[:5]) for r in program.ops] if rank == 0 else None


def _packed_flat(tree) -> Dict[str, np.ndarray]:
    """A tree's tensors as numpy by checkpoint key, a QTensor's payload
    and scale under ``<path>/.qvalue`` and ``<path>/.scale``."""
    out = {}
    for path, leaf in leaves_with_path(tree, is_leaf=is_qtensor):
        key = path_str(path)
        if isinstance(leaf, QTensor):
            out[f"{key}/.qvalue"] = as_numpy(leaf.qvalue)
            out[f"{key}/.scale"] = as_numpy(leaf.scale)
        else:
            out[key] = as_numpy(leaf)
    return out


def laid_out_serving(cases: Dict[str, dict]) -> dict:
    """For each case (``arch``, its reduced config's overrides
    ``extra``, the (data, model) mesh ``shape``, ``policy``, reference
    ``params`` whole (fp), the global ``prompts`` [B, S], the tokens
    each decode step is fed ``fed`` [steps, B, 1], ``q_chunk``, and
    ``layout_caches``, a whole numpy cache tree): the params PTQ'd
    whole, this rank's blocks of them under the FSDP+TP rules and under
    the serve rules; a laid-out prefill of its rows of the prompts, its
    cache blocks grown by ``steps`` positions
    (``launch.steps.pad_cache_blocks``) and ``steps`` laid-out decode
    steps.  Returns the blocks, the prefill's and each step's logits,
    the cache blocks after the prefill and after the last step, each
    call's int8 codes of the dense products' inputs, and this rank's
    blocks of ``layout_caches`` under the decode's cache shardings."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core.quantizer import quantize_params

    out = {}
    for name, c in cases.items():
        cfg = get_arch(c["arch"]).reduced().replace(q_chunk=c["q_chunk"],
                                                   **c["extra"])
        pol = get_policy(c["policy"])
        mesh = make_mesh(tuple(c["shape"]), ("data", "model"), device="cpu")
        packed = quantize_params(from_numpy_tree(c["params"], "cpu"), pol)
        p_pre = lsteps.abstract_params(cfg, mesh, weight_ptq=pol)[1]
        p_dec = lsteps.abstract_params(cfg, mesh, weight_ptq=pol,
                                       serve=True)[1]
        pre = sharding.local_shards(packed, p_pre, mesh)
        dec = sharding.local_shards(packed, p_dec, mesh)
        B, S = c["prompts"].shape
        steps = len(c["fed"])
        cap = ShapeConfig("decode", S + steps, B, "decode")
        c_shard = lsteps.abstract_caches(cfg, cap, mesh, pol.kv_bits)[1]
        res = {"pre": _packed_flat(pre), "dec": _packed_flat(dec),
               "layout_caches": as_numpy(sharding.local_shards(
                   from_numpy_tree(c["layout_caches"], "cpu"), c_shard,
                   mesh))}
        prefill = lsteps.make_prefill_step(cfg, mesh, pol, pol.kv_bits,
                                           shardings=p_pre)
        with recorded_codes(S) as rec:
            logits, caches = prefill(pre, place({"tokens": c["prompts"]},
                                                mesh))
        res.update(prefill_logits=as_numpy(logits), prefill_caches=as_numpy(
            caches), prefill_codes=as_numpy(list(rec)))
        caches = lsteps.pad_cache_blocks(caches, S, steps, cfg, mesh)
        decode = lsteps.make_decode_step(cfg, mesh, pol, pol.kv_bits,
                                         shardings=p_dec,
                                         cache_shardings=c_shard)
        res["decode_logits"], res["decode_codes"] = [], []
        for i in range(steps):
            token = place({"t": c["fed"][i]}, mesh)["t"]
            with recorded_codes(1) as rec:
                logits, caches = decode(dec, caches, token, S + i)
            res["decode_logits"].append(as_numpy(logits))
            res["decode_codes"].append(as_numpy(list(rec)))
        res["decode_caches"] = as_numpy(caches)
        out[name] = res
    return out


def split_serving(x: np.ndarray, w: np.ndarray, q: np.ndarray,
                  k: np.ndarray, v: np.ndarray, index: int,
                  shapes: Sequence[Sequence[int]]) -> dict:
    """The serving layout's two new pieces on each (data, model) mesh of
    ``shapes`` over every rank: the packed product of ``x`` [B, S, K] and
    ``w`` [K, N] (PTQ'd whole, per column) on this rank's rows,
    column-parallel (its columns), row-parallel (its slice of the
    contraction; the sum whole, and reduce-scattered along the
    sequence), at w8a8; and the sequence-split decode attention of
    every head's queries ``q`` [B, 1, H, D] on this rank's positions of
    ``k``, ``v`` [B, T, Hk, D] at ``index`` (every head's output)."""
    from repro_torch.nn.attention import _attend_positions, _mask_bias

    pol = get_policy("w8a8")
    packed = QTensor.quant(torch.from_numpy(w), 8, channel_axis=1)
    out = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape), ("data", "model"), device="cpu")
        model = ("model",)
        m, r = shape[1], sharding.axis_index(mesh, "model")
        xs = sharding.local_rows(torch.from_numpy(x), mesh)
        cols = sharding.local_shards(packed, QTensor(
            sharding.NamedSharding(mesh, sharding.P(None, "model")),
            sharding.NamedSharding(mesh, sharding.P(None, "model"))), mesh)
        rows = sharding.local_shards(packed, QTensor(
            sharding.NamedSharding(mesh, sharding.P("model", None)),
            sharding.NamedSharding(mesh, sharding.P(None, None))), mesh)
        kk = xs.shape[-1] // m
        x_k = xs[..., r * kk:(r + 1) * kk]
        res = {
            "column": qmatmul.q_matmul(xs, cols, pol, qmatmul.Split(
                mesh, n=model)),
            "row": qmatmul.q_matmul(x_k, rows, pol, qmatmul.Split(
                mesh, k=model)),
            "row_scattered": qmatmul.q_matmul(x_k, rows, pol, qmatmul.Split(
                mesh, k=model, scatter=1))}
        qs = sharding.local_rows(torch.from_numpy(q), mesh)
        t = k.shape[1] // m
        ks, vs = (sharding.local_rows(torch.from_numpy(a), mesh)[
            :, r * t:(r + 1) * t] for a in (k, v))
        pos = torch.full((qs.shape[0], 1), index, dtype=torch.int32)
        k_pos = (r * t + torch.arange(t))[None].expand(qs.shape[0], t)
        bias = _mask_bias(pos, k_pos, causal=True, window=None,
                          valid_len=index + 1)
        res["attend"] = _attend_positions(qs, ks, vs, bias, torch.float32,
                                          mesh, model)
        out["x".join(map(str, shape))] = as_numpy(res)
    return out


def moe_dispatch(cases: Dict[str, dict], shape: Sequence[int]) -> dict:
    """``moe_shard_map`` on a ``shape`` mesh over ("data", "model"), for
    each case (the global ``x`` [B, S, D], ``router``, ``w_gate``,
    ``w_up``, ``w_down``, the output's cotangent ``ct``, ``top_k``,
    ``capacity_factor``, ``policy``): this rank's output rows, the
    gradient of ``sum(out * ct)`` with respect to its rows and to each
    weight (its slot's share, the same on every model peer), and its
    slot's routing (experts chosen, token by token, and the assignments
    kept under capacity)."""
    mesh = make_mesh(tuple(shape), ("data", "model"), device="cpu")
    out = {}
    for name, c in cases.items():
        x, ct = (sharding.local_rows(torch.from_numpy(c[k]), mesh)
                 for k in ("x", "ct"))
        ws = {k: torch.from_numpy(c[k]).requires_grad_(True)
              for k in ("router", "w_gate", "w_up", "w_down")}
        x = x.clone().requires_grad_(True)
        y = moe_shard_map(x, ws["router"], ws["w_gate"], ws["w_up"],
                          ws["w_down"], mesh, top_k=c["top_k"],
                          capacity_factor=c["capacity_factor"],
                          policy=get_policy(c["policy"]) if c["policy"]
                          else None, act="silu")
        (y * ct).sum().backward()
        with torch.no_grad():
            b, s, d = x.shape
            e = ws["w_gate"].shape[0]
            xf = x.reshape(-1, d)
            probs = _softmax(exact.einsum("td,de->te", xf, ws["router"],
                                          dtype=torch.float32))
            idx = _top_k(probs, c["top_k"])[1].reshape(-1)
            cap = max(int(math.ceil(b * s * c["top_k"] / e
                                    * c["capacity_factor"])), 4)
            keep = _local_dispatch(torch.repeat_interleave(xf, c["top_k"], 0),
                                   idx, e, cap)[2]
        out[name] = as_numpy({"out": y, "dx": x.grad, "experts": idx,
                             "keep": keep,
                             **{f"d_{k}": w.grad for k, w in ws.items()}})
    return out


def layouts(batch: Dict[str, np.ndarray], tree, axes, shape: Sequence[int]
            ) -> dict:
    """``place`` of the global ``batch`` on the host mesh over every
    rank, and ``distribute`` of ``tree`` (numpy, its logical axes
    ``axes``) by ``make_shardings`` on a ``shape`` mesh over ("data",
    "model"): this rank's rows, its local shard of every leaf, and the
    tree ``gather`` brings back."""
    def local_numpy(tree):
        """Tensors (a DTensor's local shard) as numpy, a QTensor as its
        (payload, scale, bits)."""
        def one(t):
            if isinstance(t, QTensor):
                return (one(t.qvalue), one(t.scale), t.bits)
            if isinstance(t, DTensor):
                t = t.to_local()
            return t.detach().numpy()
        return tree_map(one, tree, is_leaf=is_qtensor)

    host = make_host_mesh(device="cpu")
    mesh = make_mesh(tuple(shape), ("data", "model"), device="cpu")
    tree = from_numpy_tree(tree, "cpu")
    laid = sharding.distribute(tree, sharding.make_shardings(tree, axes,
                                                             mesh))
    return {"rows": as_numpy(place(batch, host)), "local": local_numpy(laid),
            "gathered": local_numpy(sharding.gather(laid))}


def train_run(batches: str, ckpt_dir: str,
              resume_from: Optional[Tuple[str, int]] = None, **kw) -> list:
    """``launch.train.train(**kw)`` on every rank, fed the global batch
    of each step from the npz ``batches`` (``<step>/tokens``,
    ``<step>/labels``) in place of the synthetic stream, checkpointing to
    ``ckpt_dir``.  With ``resume_from=(dir, step)``, rank 0 first copies
    that checkpoint into ``ckpt_dir``, as if a run had stopped there.
    Returns the logged losses."""
    if resume_from is not None:
        if torch.distributed.get_rank() == 0:
            src, step = resume_from
            os.makedirs(ckpt_dir, exist_ok=True)
            for suffix in (".npz", ".npz.json"):
                shutil.copy(os.path.join(src, f"step_{step}{suffix}"),
                            ckpt_dir)
        torch.distributed.barrier()
    with np.load(batches) as f:
        fed = {k: torch.from_numpy(f[k]) for k in f.files}
    orig = ltrain.batch_at
    ltrain.batch_at = lambda cfg, step, *a: {
        k: fed[f"{step}/{k}"] for k in ("tokens", "labels")}
    try:
        return ltrain.train(ckpt_dir=ckpt_dir, device="cpu", **kw)[1]
    finally:
        ltrain.batch_at = orig


def suite(jobs: dict) -> dict:
    """Several of the checks above in one launch: ``jobs`` maps a name
    to ``(function name, kwargs)``."""
    return {name: globals()[fn](**kw) for name, (fn, kw) in jobs.items()}
