"""The LM layout of the PyTorch port against the JAX package, in one
process: the boxed-parameter helpers, every family's logical axes, the
sharding rules and the specs they give (``make_shardings`` of fp and
PTQ'd trees, the caches', the inputs'), the steps on a one-rank mesh
against the unsharded steps, ``moe_shard_map`` at one rank, and
``constrain``.

Specs are computed from a mesh's names and sizes alone: the port's from
a ``MeshShape``, the reference's from a ``jax.sharding.AbstractMesh`` of
the same shape, so the (16, 16) and (2, 16, 16) production meshes need
no devices, and the trees at full width are abstract on both sides
(``jax.eval_shape`` there, ``meta`` tensors here).  Specs are compared
as tuples, one entry a dimension.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.core import policy as jpolicy
from repro.core.quantizer import quantize_params
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import registry as jmodels
from repro.nn import module as jmodule
from repro.nn import moe_shard as jmoe_shard
from repro.optim import adam as jadam
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.core import exact
from repro_torch.core.fxp import QTensor
from repro_torch.core.policy import get_policy
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import registry as tmodels
from repro_torch.nn import module as tmodule
from repro_torch.nn.moe import moe_apply
from repro_torch.nn.moe_shard import moe_shard_map
from repro_torch.optim import adamw_init, optimizer_shardings
from repro_torch.tree import leaves_with_path, map_with_path, path_str
from test_torch_lm_layers import _via_torch, bits_equal, close, one_library

__all__ = ["one_library"]          # the fixture, requested by name

ARCHS = sorted(jreg.ARCHS)
FAMILIES = ["tinyllama-1.1b", "qwen3-moe-30b-a3b", "whisper-large-v3",
            "mamba2-2.7b", "recurrentgemma-9b"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "8x1": ((8, 1), ("data", "model"))}
CPU = torch.device("cpu")


def _is_q(x):
    return hasattr(x, "qvalue") and hasattr(x, "scale")


def _meshes(name):
    shape, names = MESHES[name]
    return tsh.MeshShape(names, shape), AbstractMesh(shape, names)


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    """The reference's full-width boxed init, abstract."""
    cfg = jreg.get_arch(arch)
    return jax.eval_shape(functools.partial(
        jmodels.model_for(cfg).init, cfg=cfg), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _abstract_ptq(arch):
    return jax.eval_shape(
        lambda t: quantize_params(t, jpolicy.get_policy("w8a8")),
        jmodule.unbox(_abstract(arch)))


def _meta(tree):
    """An abstract reference tree as the port's ``meta`` tensors (a
    QTensor's payload and scale each)."""
    def one(s):
        return torch.empty(s.shape, dtype=torch.int8 if s.dtype == jnp.int8
                           else torch.float32, device="meta")

    return map_with_path(
        lambda _p, x: QTensor(one(x.qvalue), one(x.scale), x.bits)
        if _is_q(x) else one(x), tree, is_leaf=_is_q)


def _axes(tree):
    return dict(leaves_with_path(tree, is_leaf=tmodule.is_axes))


def _specs(tree):
    """``{path: spec tuple}`` of a sharding tree (a QTensor's ``#q`` and
    ``#s``)."""
    out = {}
    for path, s in leaves_with_path(tree, is_leaf=_is_q):
        if _is_q(s):
            out[path_str(path) + "#q"] = tuple(s.qvalue.spec)
            out[path_str(path) + "#s"] = tuple(s.scale.spec)
        else:
            out[path_str(path)] = tuple(s.spec)
    return out


# ---------------------------------------------------------------------------
# boxed params and axes
# ---------------------------------------------------------------------------

def test_boxed_helpers_match_the_reference():
    cfg = jreg.get_arch("qwen3-moe-30b-a3b").reduced()
    boxed = jmodels.model_for(cfg).init(jax.random.PRNGKey(0), cfg)
    values = jax.tree.map(np.asarray, jmodule.unbox(boxed))
    tcfg = treg.get_arch("qwen3-moe-30b-a3b").reduced()
    ours = tmodule.rebox(from_numpy_tree(values, "cpu"),
                         tmodels.model_for(tcfg).param_axes(tcfg))
    assert all(tmodule.is_param(p) for _, p in leaves_with_path(
        ours, is_leaf=tmodule.is_param))
    for (path, got), (_, want) in zip(
            leaves_with_path(tmodule.unbox(ours)),
            leaves_with_path(values), strict=True):
        bits_equal(got, want)
    assert _axes(tmodule.axes_of(ours)) == _axes(jmodule.axes_of(boxed))
    assert tmodule.count_params(ours) == jmodule.count_params(boxed) > 0
    ptq = quantize_params(jmodule.unbox(boxed), jpolicy.get_policy("w8a8"))
    tptq = from_numpy_tree(jax.tree.map(np.asarray, ptq), "cpu")
    assert tmodule.count_params(tptq) == jmodule.count_params(ptq)
    # a Param of the reference's ``param``: value drawn, axes kept
    p = tmodule.param(torch.Generator().manual_seed(0), (3, 4),
                      ("d_model", None))
    assert p.shape == (3, 4) and p.axes == ("d_model", None)
    with pytest.raises(ValueError, match="do not name"):
        tmodule.param(torch.Generator(), (3, 4), ("d_model",))


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_tree_is_the_references_at_full_width(arch):
    cfg = treg.get_arch(arch)
    got = _axes(tmodels.model_for(cfg).param_axes(cfg))
    assert got == _axes(jmodule.axes_of(_abstract(arch)))
    # and it names every dimension of the port's own init (reduced)
    small = cfg.reduced()
    params = tmodels.model_for(small).init(torch.Generator().manual_seed(0),
                                           small, device=CPU)
    axes = _axes(tmodels.model_for(small).param_axes(small))
    shapes = dict(leaves_with_path(params))
    assert sorted(axes, key=str) == sorted(shapes, key=str)
    assert all(len(axes[k]) == shapes[k].ndim for k in axes)


# ---------------------------------------------------------------------------
# rules and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_rules_are_the_references(arch):
    for model_axis in (1, 16):
        for serve in (False, True):
            assert tmodels.sharding_rules(
                treg.get_arch(arch), model_axis, serve) == \
                jmodels.sharding_rules(jreg.get_arch(arch), model_axis,
                                       serve)
    assert tsh.BASE_RULES == jsh.BASE_RULES


@pytest.mark.parametrize("arch", ARCHS)
def test_make_shardings_specs_are_the_references(arch):
    """Leaf by leaf, fp and PTQ'd, on the production and host meshes,
    with the arch's rules for training and for serving."""
    tcfg, jcfg = treg.get_arch(arch), jreg.get_arch(arch)
    t_axes = tmodels.model_for(tcfg).param_axes(tcfg)
    j_axes = jmodule.axes_of(_abstract(arch))
    trees = {"fp": jmodule.unbox(_abstract(arch)), "ptq": _abstract_ptq(arch)}
    for mesh_name in MESHES:
        tm, jm = _meshes(mesh_name)
        model_n = tm.shape.get("model", 1)
        for serve in (False, True):
            rules = tmodels.sharding_rules(tcfg, model_n, serve)
            for kind, tree in trees.items():
                got = _specs(tsh.make_shardings(_meta(tree), t_axes, tm,
                                                rules))
                want = _specs(jsh.make_shardings(
                    tree, j_axes, jm,
                    jmodels.sharding_rules(jcfg, model_n, serve)))
                assert got == want, (mesh_name, serve, kind)
    # spec_for alone, with and without a rule that names no mesh axis
    tm, jm = _meshes("2x16x16")
    for axes in (None, ("batch", "seq", "vocab"), ("layers", "d_model"),
                 ("experts", "d_model", "d_ff_expert")):
        for rules in (jsh.BASE_RULES, dict(jsh.BASE_RULES, seq="model")):
            assert tuple(tsh.spec_for(axes, rules, tm)) == \
                tuple(jsh.spec_for(axes, rules, jm))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_and_input_specs_are_the_references(arch):
    tcfg, jcfg = treg.get_arch(arch), jreg.get_arch(arch)
    tmodel, jmodel = tmodels.model_for(tcfg), jmodels.model_for(jcfg)
    for name, jshape in jshapes.SHAPES.items():
        tshape = tshapes.SHAPES[name]
        got = tmodels.input_specs(tcfg, tshape)
        want = jmodels.input_specs(jcfg, jshape)
        assert list(got) == list(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape)
            assert str(got[k].dtype).split(".")[-1] == str(w.dtype)
            assert got[k].device.type == "meta"
        for mesh_name in MESHES:
            tm, jm = _meshes(mesh_name)
            assert {k: tuple(v.spec) for k, v in
                    tsteps.batch_shardings(got, tm).items()} == \
                {k: tuple(v.spec) for k, v in
                 jsteps.batch_shardings(want, jm).items()}
            if jshape.kind != "decode":
                continue
            for kv_bits in (32, 8):
                jc = jax.eval_shape(lambda: jmodel.init_caches(
                    jcfg, jshape.global_batch, jshape.seq_len, kv_bits))
                tc = tmodel.init_caches(tcfg, tshape.global_batch,
                                        tshape.seq_len, kv_bits,
                                        device="meta")
                assert {path_str(p): tuple(t.shape) for p, t in
                        leaves_with_path(tc)} == \
                    {path_str(p): tuple(t.shape) for p, t in
                     leaves_with_path(jc)}
                assert _specs(tsteps.cache_shardings(
                    tc, tcfg, tshape.global_batch, tm)) == \
                    _specs(jsteps.cache_shardings(
                        jc, jcfg, jshape.global_batch, jm))


def test_batch_spec_and_optimizer_shardings_are_the_references():
    for mesh_name in MESHES:
        tm, jm = _meshes(mesh_name)
        for extra in (0, 1, 2):
            for bs in (None, 1, 8, 256, 512):
                assert tuple(tsh.batch_spec(tm, extra, bs)) == \
                    tuple(jsh.batch_spec(jm, extra, bs))
    tree = {"a": "spec-a", "b": ["spec-b"]}
    assert optimizer_shardings(tree) == jadam.optimizer_shardings(tree)
    assert tmesh.production_mesh_shape() == tsh.MeshShape(
        ("data", "model"), (16, 16))
    assert tmesh.production_mesh_shape(multi_pod=True).size == 512


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = tmesh.make_host_mesh(device=CPU)
    assert tsh.placements(tsh.P("data", None, "model"), mesh) == \
        [Shard(0), Shard(2)]
    assert tsh.placements(tsh.P(None, None), mesh) == \
        [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="not in the mesh's order"):
        tsh.placements(tsh.P(("model", "data")), mesh)


# ---------------------------------------------------------------------------
# one rank is the unsharded program
# ---------------------------------------------------------------------------

def _init(arch):
    cfg = treg.get_arch(arch).reduced()
    params = tmodels.model_for(cfg).init(torch.Generator().manual_seed(0),
                                         cfg, device=CPU)
    g = torch.Generator().manual_seed(1)
    base = torch.randint(0, cfg.vocab, (2, 17), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": base[:, :-1], "labels": base[:, 1:]}
    if cfg.is_encdec:
        batch["frames"] = torch.randn((2, 16, cfg.d_model), generator=g)
    return cfg, params, batch


def _same(a, b):
    la = leaves_with_path(a, is_leaf=_is_q)
    lb = leaves_with_path(b, is_leaf=_is_q)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            bits_equal(x, y.numpy())
        else:
            assert x == y, path


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_rank_mesh_steps_are_the_unsharded_steps(arch):
    cfg, params, batch = _init(arch)
    mesh = tmesh.make_host_mesh(device=CPU)
    pol = get_policy("w8a8")
    runs = []
    for m in (None, mesh):
        step = tsteps.make_train_step(cfg, m, pol)
        p, o = params, adamw_init(params)
        for _ in range(2):
            p, o, stats = step(p, o, batch if m is None
                               else tsh.local_rows(batch, mesh))
        runs.append((p, o, stats))
    _same(*runs)
    pol8 = get_policy("w8a8kv8")
    pre = [tsteps.make_prefill_step(cfg, m, pol8, 8)(params, batch)
           for m in (None, mesh)]
    _same(*pre)
    if cfg.is_encdec or cfg.family == "ssm":
        return
    from repro_torch.launch.serve import pad_caches
    token = pre[0][0].argmax(-1, keepdim=True).to(torch.int32)
    dec = [tsteps.make_decode_step(cfg, m, pol8, 8)(
        params, pad_caches(tsteps.tree_map(lambda t: t.clone(), pre[0][1]),
                           1), token, 16) for m in (None, mesh)]
    _same(*dec)


def test_a_mesh_step_refuses_a_batch_its_slots_cannot_mean():
    cfg, params, batch = _init("tinyllama-1.1b")
    mesh = tmesh.make_host_mesh(device=CPU)
    with pytest.raises(ValueError, match="masked batch"):
        tsteps.make_train_step(cfg, mesh, None)(
            params, adamw_init(params),
            dict(batch, mask=torch.ones(batch["tokens"].shape)))


# ---------------------------------------------------------------------------
# the MoE dispatch at one rank
# ---------------------------------------------------------------------------

def _moe_inputs(seed=0, b=2, s=16, d=32, e=8, f=16):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=n(b, s, d), router=n(d, e, scale=d ** -0.5),
                w_gate=n(e, d, f, scale=d ** -0.5),
                w_up=n(e, d, f, scale=d ** -0.5),
                w_down=n(e, f, d, scale=f ** -0.5))


@pytest.mark.parametrize("policy", [None, "w8a8"])
def test_one_rank_moe_shard_map_is_moe_apply_and_the_references(
        request, monkeypatch, policy):
    """At one rank the dispatch is ``moe_apply`` bit for bit (the
    output and every gradient), and the reference's ``moe_shard_map`` on
    a one-device mesh, op by op under ``one_library`` (with the body's
    router product routed too): under w8a8 the output bit for bit (the
    same experts, drops and int8 codes); in fp32, whose expert products
    each library sums its own way, at rtol 1e-5."""
    c = _moe_inputs()
    t = from_numpy_tree(c, "cpu")
    mesh = tmesh.make_host_mesh(device=CPU)
    pol = get_policy(policy) if policy else None
    kw = dict(top_k=2, capacity_factor=1.25, policy=pol, act="silu")

    def run(fn):
        x = t["x"].clone().requires_grad_(True)
        ws = {k: t[k].clone().requires_grad_(True)
              for k in ("w_gate", "w_up", "w_down")}
        out = fn(x, ws)
        out.square().sum().backward()
        return out.detach(), [x.grad] + [ws[k].grad for k in sorted(ws)]

    got, g_got = run(lambda x, ws: moe_shard_map(
        x, t["router"], ws["w_gate"], ws["w_up"], ws["w_down"], mesh, **kw))
    want, g_want = run(lambda x, ws: moe_apply(
        {"router": {"w": t["router"]}, **ws}, x, **kw))
    bits_equal(got, want.numpy())
    for a, b in zip(g_got, g_want, strict=True):
        bits_equal(a, b.numpy())

    request.getfixturevalue("one_library")
    routed = _via_torch(jnp.matmul, lambda a, b: exact.einsum(
        "td,de->te", a, b, dtype=torch.float32))
    monkeypatch.setattr(jax.core.Tracer, "__matmul__",
                        lambda a, b: routed(a, b))
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jpol = jpolicy.get_policy(policy) if policy else None
    with jax.disable_jit():
        ref = jmoe_shard.moe_shard_map(
            *(jnp.asarray(c[k]) for k in ("x", "router", "w_gate", "w_up",
                                          "w_down")), jmesh, top_k=2,
            capacity_factor=1.25, policy=jpol, act="silu")
    if policy:
        bits_equal(got, np.asarray(ref))
    else:
        # fp32 expert products: each library sums its own way
        close(got, np.asarray(ref), rtol=1e-5, scale=1e-6)


# ---------------------------------------------------------------------------
# constrain
# ---------------------------------------------------------------------------

def test_constrain_leaves_a_ranks_tensor_as_it_is():
    x = torch.randn(4, 3)
    axes = ("batch", None)
    assert tsh.constrain(x, axes) is x
    mesh = tmesh.make_host_mesh(device=CPU)
    with tsh.mesh_rules(mesh, {"seq": "model"}):
        assert tsh.current_mesh() is mesh
        assert tsh.constrain(x, axes) is x
        # a DTensor is laid out to the spec's placements, its values kept
        from torch.distributed.tensor import Replicate, Shard
        d = tsh.distribute({"x": x}, {"x": tsh.NamedSharding(
            mesh, tsh.P(None, None))})["x"]
        assert list(d.placements) == [Replicate(), Replicate()]
        c = tsh.constrain(d, axes)
        assert list(c.placements) == [Shard(0), Replicate()]
        bits_equal(tsh.gather({"c": c})["c"], x.numpy())
    assert tsh.current_mesh() is None
    assert tsh.constrain(x, axes) is x


def test_every_family_is_held_at_one_rank():
    assert {jreg.ARCHS[a].family for a in FAMILIES} == {
        "dense", "moe", "encdec", "ssm", "hybrid"}
