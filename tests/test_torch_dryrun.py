"""The port's dry run (``repro_torch.launch.{steps,roofline,dryrun}``)
against the JAX package: the abstract trees and their specs at full
width on the production meshes, the layout's bytes, the meta trace
against a real CPU trace of the same step, the roofline, and the CLI.

The reference's trees come from ``jax.eval_shape`` on a
``jax.sharding.AbstractMesh``; the port's from ``FakeTensorMode`` as
``meta`` tensors on a ``MeshShape``.  Nothing here allocates a
full-width tensor.
"""
import math
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.core.policy import get_policy as jpolicy
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.fxp import QTensor
from repro_torch.core.policy import get_policy
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as troof
from repro_torch.launch import steps as tsteps
from repro_torch.tree import leaves_with_path, path_str

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(jreg.ARCHS)
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _is_q(x):
    return hasattr(x, "qvalue") and hasattr(x, "scale")


def _flat(tree, shardings):
    """{path: (shape, dtype name, spec tuple)} over the tensors of a tree
    and its sharding tree (a QTensor's payload ``#q`` and scale ``#s``)."""
    at = dict(leaves_with_path(shardings, is_leaf=_is_q))
    out = {}
    for path, leaf in leaves_with_path(tree, is_leaf=_is_q):
        s, key = at[path], path_str(path)
        pairs = ([(key + "#q", leaf.qvalue, s.qvalue),
                  (key + "#s", leaf.scale, s.scale)] if _is_q(leaf)
                 else [(key, leaf, s)])
        for k, t, sh in pairs:
            out[k] = (tuple(t.shape), str(t.dtype).split(".")[-1],
                      tuple(sh.spec))
    return out


def _numpy_layout_bytes(flat, sizes):
    """The bytes a device holds under the reference's specs, reckoned with
    numpy: each dimension divided, rounding up, by the sizes of the mesh
    axes its spec entry names."""
    total = 0
    for shape, dtype, spec in flat.values():
        div = np.ones(len(shape), dtype=np.int64)
        for d, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else \
                (entry,) if entry else ()
            div[d] = np.prod([sizes[a] for a in names], dtype=np.int64)
        shard = np.ceil(np.asarray(shape, dtype=np.float64) / div)
        total += int(np.prod(shard)) * np.dtype(dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_are_the_references(arch):
    """At full width on both production meshes: params (fp and PTQ'd for
    serving), AdamW's state and the decode caches, leaf by leaf in shape,
    dtype and spec; and the layout's bytes a device against a numpy
    reckoning from the reference's specs."""
    tcfg, jcfg = treg.get_arch(arch), jreg.get_arch(arch)
    shape = "decode_32k"
    for multi_pod, (sizes, names) in MESHES.items():
        tm = tmesh.production_mesh_shape(multi_pod=multi_pod)
        jm = AbstractMesh(sizes, names)
        mesh_sizes = dict(zip(names, sizes))
        tp, tps = tsteps.abstract_params(tcfg, tm)
        jp, jps = jsteps.abstract_params(jcfg, jm)
        got, want = _flat(tp, tps), _flat(jp, jps)
        assert got == want, (arch, multi_pod, "params")
        assert all(t.device.type == "meta" for t in
                   jax.tree_util.tree_leaves(tp))
        assert tsteps.layout_bytes(tp, tps) == \
            _numpy_layout_bytes(want, mesh_sizes)
        to, tos = tsteps.abstract_opt_state(tp, tps, tm)
        jo, jos = jsteps.abstract_opt_state(jp, jps, jm)
        want = _flat(jo, jos)
        assert _flat(to, tos) == want, (arch, multi_pod, "opt")
        assert tsteps.layout_bytes(to, tos) == \
            _numpy_layout_bytes(want, mesh_sizes)
        ptq = get_policy("w8a8")
        tq, tqs = tsteps.abstract_params(tcfg, tm, weight_ptq=ptq,
                                         serve=True)
        jq, jqs = jsteps.abstract_params(jcfg, jm, weight_ptq=jpolicy("w8a8"),
                                         serve=True)
        want = _flat(jq, jqs)
        assert _flat(tq, tqs) == want, (arch, multi_pod, "ptq")
        assert any(isinstance(x, QTensor) for _, x in
                   leaves_with_path(tq, is_leaf=_is_q))
        assert tsteps.layout_bytes(tq, tqs) == \
            _numpy_layout_bytes(want, mesh_sizes)
        tc, tcs = tsteps.abstract_caches(tcfg, tshapes.SHAPES[shape], tm, 8)
        jc, jcs = jsteps.abstract_caches(jcfg, jshapes.SHAPES[shape], jm, 8)
        want = _flat(jc, jcs)
        assert _flat(tc, tcs) == want, (arch, multi_pod, "caches")
        assert tsteps.layout_bytes(tc, tcs) == \
            _numpy_layout_bytes(want, mesh_sizes)


def test_rank_rows_are_data_places():
    """A rank's inputs: the batch dim over the data axes where the spec
    lays it there, whole where it does not divide (long_500k's one
    sequence), every other dim whole."""
    cfg = treg.get_arch("tinyllama-1.1b")
    tm = tmesh.production_mesh_shape(multi_pod=True)
    for name, rows in (("train_4k", 8), ("long_500k", 1)):
        specs = tsteps.input_specs(cfg, tshapes.SHAPES[name])
        got = tsteps.rank_rows(specs, tsteps.batch_shardings(specs, tm), tm)
        for k, t in got.items():
            assert tuple(t.shape) == (rows,) + tuple(specs[k].shape[1:])
    args, layout = tsteps.cell_inputs(cfg, tshapes.SHAPES["decode_32k"], tm,
                                      get_policy("qforce8"))
    k = args[1]["k"]
    # [L, B, cap, kv, hd]: 128 sequences over 32 slots, the rank's block
    # of the laid-out cache: its 4 kv heads do not divide 16 model ranks,
    # so the 32,768 positions lie over them, 2,048 a rank
    assert tuple(k.shape) == (22, 4, 2048, 4, 64)
    assert args[3] == 32767 and layout > 0


# ---------------------------------------------------------------------------
# the meta trace is the step's trace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kinds", [
    ("tinyllama-1.1b", ("train", "prefill", "decode")),
    ("qwen3-moe-30b-a3b", ("decode",))])
def test_meta_trace_equals_a_cpu_trace(arch, kinds):
    """``lower_cell``'s meta trace of a reduced step records the same
    calls, costs and memory as the same step run on the CPU (plain
    kernels) on a (2, 2) mesh of one process.  Each device runs the
    first step once before (a table the rope builds once a device,
    ``nn.rotary``).  The dense steps run laid out, on rank 0's blocks of
    the params (and AdamW's state, or the caches): their traced
    arguments are the layout's bytes."""
    cfg = treg.get_arch(arch).reduced()
    mesh = tsh.MeshShape(("data", "model"), (2, 2))
    pol = get_policy("w8a8kv8")
    for i, kind in enumerate(kinds):
        shape = ShapeConfig("t", 16, 4, kind)
        step = tsteps.cell_step(cfg, shape, mesh, pol)
        args, _ = tsteps.cell_inputs(cfg, shape, mesh, pol)
        args = tsteps.materialize(args, torch.Generator().manual_seed(0),
                                  cfg.vocab)
        if i == 0:
            H.trace(step, args)
            tsteps.lower_cell(cfg, shape, mesh, pol)
        meta, info = tsteps.lower_cell(cfg, shape, mesh, pol)
        cpu = H.trace(step, args)
        assert info["step"] == tsteps.STEP_NAMES[kind]
        assert [r[:5] for r in meta.ops] == [r[:5] for r in cpu.ops], kind
        assert H.cost_terms(meta) == H.cost_terms(cpu)
        assert H.op_histogram(meta) == H.op_histogram(cpu)
        m, c = H.memory_stats(meta), H.memory_stats(cpu)
        assert info["laid_out"] == (not cfg.is_moe)
        if info["laid_out"]:
            assert m["argument_size_in_bytes"] == m["layout_argument_bytes"]
        assert m.pop("layout_argument_bytes") > 0
        c.pop("layout_argument_bytes")
        assert m == c, kind


def test_a_data_dependent_op_fails_with_its_name(monkeypatch, capsys):
    """A cell whose step needs a value (here a host read of the logits)
    is reported FAIL, naming the op and the port's line, and the exit
    code is 1."""
    from repro_torch.models import transformer

    real = transformer.decode_step

    def reads_a_value(params, token, caches, index, *a, **kw):
        logits, caches = real(params, token, caches, index, *a, **kw)
        float(logits.sum())
        return logits, caches

    monkeypatch.setattr(transformer, "decode_step", reads_a_value)
    monkeypatch.setattr(dryrun, "get_arch",
                        lambda a: treg.get_arch(a).reduced())
    # the reduced config's 4 heads lay out over 2 model ranks, not 16
    monkeypatch.setattr(dryrun, "production_mesh_shape",
                        lambda multi_pod: tsh.MeshShape(("data", "model"),
                                                        (2, 2)))
    assert dryrun.main(["--arch", "tinyllama-1.1b",
                        "--shape", "decode_32k"]) == 1
    out, err = capsys.readouterr()
    assert "0 ok / 0 skipped / 1 FAILED" in out
    assert "!! FAIL tinyllama-1.1b x decode_32k (multi_pod=False): " \
        "aten._local_scalar_dense" in err
    assert "src/repro_torch/" in err


def test_full_attention_skips_long_500k():
    r = dryrun.run_cell("tinyllama-1.1b", "long_500k", False)
    assert r["status"].startswith("skip") and "full attention" in r["status"]


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------


def test_model_flops_are_the_references():
    for arch in ARCHS:
        for name in jshapes.SHAPES:
            assert troof.model_flops(treg.get_arch(arch),
                                     tshapes.SHAPES[name]) == \
                jroof.model_flops(jreg.get_arch(arch), jshapes.SHAPES[name])


def test_roofline_terms_on_a_hand_written_cost():
    cfg = treg.get_arch("tinyllama-1.1b")
    shape = tshapes.SHAPES["train_4k"]
    mesh = tmesh.production_mesh_shape()
    cost = {"flops": 3e12, "flops_by_dtype": {"float32": 1e12,
                                              "bfloat16": 2e12},
            "int_ops": 4e12, "bytes": 6.7e12, "collective_bytes": 9e10}
    r = troof.roofline_terms(cfg, shape, mesh, cost)
    t_compute = 1e12 / 66.9e12 + 2e12 / 989.4e12 + 4e12 / 1979e12
    assert r["t_compute"] == pytest.approx(t_compute, rel=1e-12)
    assert r["t_memory"] == pytest.approx(2.0, rel=1e-12)
    assert r["t_collective"] == pytest.approx(0.2, rel=1e-12)
    assert r["bound"] == "memory" and r["t_step"] == r["t_memory"]
    assert r["chips"] == 256
    mf = troof.model_flops(cfg, shape)
    assert r["hlo_flops_total"] == 7e12 * 256
    assert r["useful_flops_frac"] == min(mf / (7e12 * 256), 1.0)
    assert r["mfu_at_roofline"] == pytest.approx(
        mf / (256 * 989.4e12) / 2.0, rel=1e-12)
    # a cost with no dtype split runs its flops at peak_flops
    bare = {"flops": 1e12, "bytes": 0.0, "collective_bytes": 0.0}
    assert troof.roofline_terms(cfg, shape, mesh, bare)["t_compute"] == \
        pytest.approx(1e12 / 989.4e12, rel=1e-12)
    # no TPU constant is left
    assert not hasattr(troof, "ICI_BW")
    table = troof.summarize([{"arch": "a", "shape": "s", "status": "skip x"},
                             {"arch": "b", "shape": "t", "status": "ok",
                              "step": "train_step", "roofline": r}])
    assert table.splitlines()[2] == "| a | s | - | skip x | | | | | | |"
    assert "| b | t | train_step | memory |" in table


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

NUM = r"[0-9.]+(?:e[+-][0-9]+)?"
# the reference's printed lines (repro.launch.dryrun.run_cell and main);
# the port's banner also marks a laid-out cell
REFERENCE_LINES = [
    r"== tinyllama-1\.1b x decode_32k on mesh \{'data': 16, 'model': 16\} "
    r"\(256 devices\) \[serve_step, qforce8, laid out\] ==",
    r"   lower [0-9]+\.[0-9]s  compile 0\.0s",
    r"   memory/device: args [0-9]+\.[0-9]{2} GiB  temps [0-9]+\.[0-9]{2} "
    r"GiB  total [0-9]+\.[0-9]{2} GiB",
    rf"   HLO flops/device {NUM}  bytes/device {NUM}  collective "
    rf"bytes/device {NUM}",
    rf"   roofline: compute {NUM}s  memory {NUM}s  collective {NUM}s  -> "
    r"bound: (compute|memory|collective)  \(model-flops util ceiling "
    r"[0-9]+%\)",
    r"",
    r"1 ok / 0 skipped / 0 FAILED",
]


def test_cli_runs_a_production_cell_without_a_card(tmp_path):
    """``python -m repro_torch.launch.dryrun`` at full width on 16 x 16,
    in a process of its own with no card: exit 0, the reference's lines,
    the results as JSON."""
    out = tmp_path / "cells.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "decode_32k", "--json", str(out)],
        capture_output=True, text=True, env=env, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == len(REFERENCE_LINES), lines
    for line, pattern in zip(lines, REFERENCE_LINES):
        assert re.fullmatch(pattern, line), (line, pattern)
    import json
    (cell,) = json.loads(out.read_text())
    assert cell["status"] == "ok" and cell["step"] == "serve_step"
    assert cell["mesh"] == {"data": 16, "model": 16}
    assert cell["compile_s"] == 0.0
    mem = cell["memory"]
    # laid out: the rank holds its blocks of the params and the caches
    assert cell["laid_out"]
    assert mem["layout_argument_bytes"] == mem["argument_size_in_bytes"]
    assert cell["cost"]["int_ops"] > 0
    # the row-parallel products (wo, w_down) sum int32 partials over the
    # model ranks before the dequant; the rest fuse it
    assert cell["hlo_ops"]["qmac_i8_deq"] == 5 * 22 + 1
    assert cell["hlo_ops"]["qmac_i8"] == 2 * 22
    assert math.isclose(cell["roofline"]["t_memory"],
                        cell["cost"]["bytes"] / troof.HBM_BW)
