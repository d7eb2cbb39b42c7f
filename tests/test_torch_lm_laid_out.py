"""The laid-out training step of the PyTorch port (the dense family on
params laid out by ``make_shardings``) on eight gloo ranks, against the
port's data-parallel step and the JAX package's step jitted with
``in_shardings`` on eight host devices.

One session of ``repro_torch.distributed.ranks.run_ranks`` (8 spawned
ranks, one CPU thread each, killed at a deadline) runs every multi-rank
case (bodies in ``repro_torch.distributed.checks``), while one reference
subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(``tests/lm_laid_out_reference.py``) writes every reference case to one
npz.

The cases, each a reduced config on a (data, model) mesh: tinyllama on
(2, 4), where its 2 kv heads stay whole on every model rank, and on
(4, 2), where they are split with the q heads; qwen2 with its QKV
biases, sequence parallelism and 2 microbatches on (2, 4); chameleon
with QK-norm and sequence parallelism on (4, 2); stablelm on (2, 4);
all at w8a8, and tinyllama on (2, 4) at w8 and at fp32 too. Each case
holds, on every rank:

* its blocks of the reference's init equal the reference's addressable
  shards of its device;
* the laid-out step against the data-parallel step on the same mesh and
  batch: the forward's int8 codes bit for bit (at w8a8; a row-parallel
  product's input is the rank's slice of the contraction), the loss at
  rtol 1e-6, each gradient leaf within 1e-5 of its largest magnitude,
  and AdamW, given the laid-out gradient, at atol 1e-5 + rtol 1e-4;
* no leaf whole on the model ranks counted once per rank or not at all;
* against the reference's jitted step, at bars measured for each
  policy and stated below: the loss, each gradient leaf, AdamW's new
  mu and nu, and the new params (at w8a8, through AdamW of the
  reference's own gradient).

Beside them: the laid-out step at one rank (a ``MeshShape`` of (1, 1))
bit for bit the unsharded step, and ``lower_cell`` on a (2, 4)
``MeshShape`` tracing rank 0's program: its arguments the layout's
bytes, its records those of rank 0 on the live mesh, a reduce-scatter
among them, and no collective of a whole leaf.

The serving steps laid out, in the same session and the same reference
subprocess (``SERVING``, each at w8a8kv8, a prefill of 32 tokens and 4
decode steps on a cache of 36 positions): tinyllama on (2, 4), whose 2
kv heads do not divide 4 model ranks, so its cache lies split along its
sequence; tinyllama on (4, 2), its cache split over the kv heads;
qwen2 with sequence parallelism on (2, 4), the prefill's row-parallel
sums reduce-scattered.  On every rank: its blocks of the PTQ'd params
(FSDP+TP rules and serve rules) and of a cache tree equal the
reference's addressable shards; the logits, the cache payloads and
scales after the prefill and after the last decode step, and every
product's int8 codes bit for bit the port's unsharded program's rows
and blocks; against the reference's jitted steps at the bars measured
below (``SERVE_REF_BARS``).  Beside them: the serving steps at one rank
bitwise the unsharded ones for every dense arch, the split packed
products and the sequence-split decode attention bitwise their unsplit
counterparts on 8 ranks, ``lower_cell`` of a (2, 4) prefill and decode
cell tracing rank 0's live records, and the refusals.
"""
import math
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import registry as jmodels
from repro.nn.module import unbox
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.configs.registry import get_arch
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.fxp import QTensor
from repro_torch.core.policy import get_policy
from repro_torch.core.qmatmul import q_matmul
from repro_torch.core.quantizer import quantize_params
from repro_torch.distributed import checks
from repro_torch.distributed.ranks import run_ranks
from repro_torch.distributed.sharding import (MeshShape, local_shards,
                                              spec_axes)
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import steps
from repro_torch.launch.serve import pad_caches
from repro_torch.models.registry import model_for
from repro_torch.nn.attention import _mask_bias, gqa_attend
from repro_torch.optim import adamw_init, adamw_update, warmup_cosine
from repro_torch.tree import (leaves_with_path, map_with_path, path_str,
                               tree_leaves)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
DEADLINE_S = 150
B, S = 16, 32
LR, WARMUP, TOTAL, COUNT = 3e-4, 5, 50, 3
CASES = {
    # 2 kv heads against 4 model ranks: whole on every model rank
    "tinyllama_2x4": ("tinyllama-1.1b", (2, 4), {}, "w8a8"),
    # 2 kv heads over 2 model ranks: split with the q heads
    "tinyllama_4x2": ("tinyllama-1.1b", (4, 2), {}, "w8a8"),
    "qwen2_2x4": ("qwen2-72b", (2, 4), dict(seq_shard=True, microbatches=2),
                  "w8a8"),
    "chameleon_4x2": ("chameleon-34b", (4, 2), dict(seq_shard=True), "w8a8"),
    "stablelm_2x4": ("stablelm-12b", (2, 4), {}, "w8a8"),
    # the split products' other branches: fake-quantized weights with fp
    # activations (a row-parallel product's fp partials summed), and fp
    "tinyllama_2x4_w8": ("tinyllama-1.1b", (2, 4), {}, "w8"),
    "tinyllama_2x4_fp32": ("tinyllama-1.1b", (2, 4), {}, "fp32"),
}
# the cases whose products quantize their activations (int8 codes)
CODED = sorted(k for k, v in CASES.items() if v[3] == "w8a8")
TRACE = dict(arch="tinyllama-1.1b", shape=(2, 4), seq=32, batch=16,
             policy="w8a8")
# the serving cases: a prefill of SERVE_S tokens of SERVE_B rows, then
# SERVE_STEPS decode steps on a cache of SERVE_S + SERVE_STEPS positions
SERVE_B, SERVE_S, SERVE_STEPS = 8, 32, 4
SERVING = {
    # 2 kv heads against 4 model ranks: the cache split along its sequence
    "serve_tinyllama_2x4": ("tinyllama-1.1b", (2, 4), {}),
    # 2 kv heads over 2 model ranks: the cache split over the kv heads
    "serve_tinyllama_4x2": ("tinyllama-1.1b", (4, 2), {}),
    # sequence parallelism: the prefill's row-parallel sums scattered
    "serve_qwen2_2x4": ("qwen2-72b", (2, 4), dict(seq_shard=True)),
}
SERVE_POLICY = "w8a8kv8"
SERVE_TRACE = dict(TRACE, policy=SERVE_POLICY)


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _case(arch, shape, extra, policy, seed=0):
    cfg = jreg.get_arch(arch).reduced().replace(**extra)
    params = _numpy(unbox(jmodels.model_for(cfg).init(
        jax.random.PRNGKey(seed), cfg)))
    rng = np.random.default_rng(seed)
    opt = jadamw_init(params)
    opt = {"mu": jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                         * 1e-3).astype(np.float32),
                              opt["mu"]),
           "nu": jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                         * 1e-3).astype(np.float32) ** 2,
                              opt["nu"]),
           "count": np.asarray(COUNT, np.int32)}
    base = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return dict(arch=arch, extra=extra, shape=shape, policy=policy,
                params=params, opt=opt,
                batch={"tokens": base[:, :-1], "labels": base[:, 1:]},
                lr=LR, warmup=WARMUP, total=TOTAL, q_chunk=16)


def _serving_case(arch, shape, extra, seed=0):
    cfg = jreg.get_arch(arch).reduced().replace(**extra)
    params = _numpy(unbox(jmodels.model_for(cfg).init(
        jax.random.PRNGKey(seed), cfg)))
    rng = np.random.default_rng(seed + 1)
    cap = SERVE_S + SERVE_STEPS
    cache = (cfg.n_layers, SERVE_B, cap, cfg.n_kv_heads, cfg.hd)
    layout = {k: rng.integers(-127, 128, cache).astype(np.int8)
              for k in ("k", "v")}
    layout.update({k: rng.random(cache[:-1] + (1,), np.float32)
                   for k in ("k_scale", "v_scale")})
    return dict(arch=arch, extra=extra, shape=shape, policy=SERVE_POLICY,
                params=params, q_chunk=16,
                prompts=rng.integers(0, cfg.vocab, (SERVE_B, SERVE_S)
                                     ).astype(np.int32),
                fed=rng.integers(0, cfg.vocab, (SERVE_STEPS, SERVE_B, 1)
                                 ).astype(np.int32),
                layout_caches=layout)


# the split products' and the split attention's operands: x [B, S, K]
# and w [K, N]; every head's queries [B, 1, H, D] and a cache [B, T, Hk,
# D] read at SPLIT_INDEX (its later positions masked)
SPLIT_SHAPES = ((2, 4), (4, 2))
SPLIT_INDEX = 29


def _split_case(seed=3):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=n(8, 16, 64), w=n(64, 32), q=n(8, 1, 4, 16),
                k=n(8, 36, 2, 16), v=n(8, 36, 2, 16), index=SPLIT_INDEX,
                shapes=SPLIT_SHAPES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference npz as a dict, each rank's results, the cases)."""
    work = tmp_path_factory.mktemp("lm_laid_out")
    cases = {k: _case(*v) for k, v in CASES.items()}
    serving = {k: _serving_case(*v) for k, v in SERVING.items()}
    split = _split_case()
    with open(work / "in.pkl", "wb") as f:
        pickle.dump({**cases, **serving}, f)
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "lm_laid_out_reference.py"),
         str(work / "in.pkl"), str(work / "ref.npz")], cwd=str(ROOT),
        env=dict(_env(), JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        # the serving traces run after the steps, which built each
        # rank's rotary table (once a device)
        spawned = run_ranks(checks.suite, WORLD, {
            "steps": ("laid_out_steps", {"cases": cases}),
            "trace": ("laid_out_trace", TRACE),
            "serving": ("laid_out_serving", {"cases": serving}),
            "split": ("split_serving", split),
            "serve_trace_prefill": ("laid_out_trace",
                                    dict(SERVE_TRACE, kind="prefill")),
            "serve_trace_decode": ("laid_out_trace",
                                   dict(SERVE_TRACE, kind="decode"))},
            deadline_s=DEADLINE_S)
        deadline = time.monotonic() + DEADLINE_S
        try:
            _, err = ref.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            raise TimeoutError(f"the reference did not finish within "
                               f"{DEADLINE_S} s") from None
        assert ref.returncode == 0, err[-4000:]
    finally:
        if ref.poll() is None:
            os.killpg(ref.pid, 9)
            ref.wait()
    with np.load(work / "ref.npz") as f:
        want = {k: f[k] for k in f.files}
    return dict(want=want, spawned=spawned, cases={**cases, **serving},
                split=split)


# -- blocks of a whole leaf ---------------------------------------------------

def _cfg(name):
    arch, _, extra, _ = CASES[name]
    return get_arch(arch).reduced().replace(q_chunk=16, **extra)


def _specs(name):
    """Each leaf's spec of the case's params, by path."""
    shape = CASES[name][1]
    _, p_shard = steps.abstract_params(
        _cfg(name), MeshShape(("data", "model"), shape))
    return {path_str(p): s.spec for p, s in leaves_with_path(
        p_shard, is_leaf=lambda x: hasattr(x, "spec"))}


def _block(full, spec, shape, rank):
    """Rank ``rank``'s block of the whole array ``full`` under ``spec``
    on a (data, model) mesh of ``shape``."""
    coord = {"data": rank // shape[1], "model": rank % shape[1]}
    size = {"data": shape[0], "model": shape[1]}
    index = []
    for d, axes in enumerate(spec_axes(spec)):
        k, i = 1, 0
        for a in axes:
            k, i = k * size[a], i * size[a] + coord[a]
        per = full.shape[d] // k
        index.append(slice(i * per, (i + 1) * per))
    return full[tuple(index)]


def _whole(blocks, spec, shape, like):
    """The whole array of every rank's ``blocks`` (a ``like``-shaped
    array's)."""
    out = np.zeros(like.shape, like.dtype)
    for r, b in enumerate(blocks):
        _block(out, spec, shape, r)[...] = b
    return out


def _flat(tree):
    return {path_str(p): np.asarray(v.detach().numpy()
                                    if isinstance(v, torch.Tensor) else v)
            for p, v in leaves_with_path(tree)}


def _bits(got, want, what=""):
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                  err_msg=what)


def _ranks(runs, name):
    return [r["steps"][name] for r in runs["spawned"]]


# -- the cases ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_holds_the_references_addressable_shards(runs, name):
    specs = _specs(name)
    for r, port in enumerate(_ranks(runs, name)):
        got = _flat(port["init"])
        assert sorted(got) == sorted(specs)
        for k, v in got.items():
            _bits(v, runs["want"][f"{name}/init/{k}/{r}"], f"{k} rank {r}")


@pytest.mark.parametrize("name", CODED)
def test_laid_out_forward_codes_are_the_data_parallel_ones(runs, name):
    """Each product's int8 codes of the rank's rows: a column-parallel
    product's input whole, a row-parallel one's the rank's slice of the
    contraction, bit for bit the data-parallel step's."""
    m_size = CASES[name][1][1]
    n = 0
    for r, port in enumerate(_ranks(runs, name)):
        assert len(port["codes"]) == len(port["dp_codes"]) > 0
        m = r % m_size
        for i, (got, want) in enumerate(zip(port["codes"],
                                            port["dp_codes"])):
            if got.shape != want.shape:
                k = got.shape[-1]
                assert k * m_size == want.shape[-1], (i, got.shape)
                want = want[..., m * k:(m + 1) * k]
                n += 1
            _bits(got, want, f"product {i} rank {r}")
    assert n > 0            # the row-parallel products were split


@pytest.mark.parametrize("name", sorted(CASES))
def test_laid_out_step_is_the_data_parallel_step(runs, name):
    """The loss at rtol 1e-6 and each gradient leaf within 1e-5 of its
    largest magnitude, on every rank; AdamW given the laid-out gradient
    (made whole) at atol 1e-5 + rtol 1e-4 of the laid-out step's new
    blocks."""
    ranks = _ranks(runs, name)
    shape = CASES[name][1]
    specs = _specs(name)
    for port in ranks:
        np.testing.assert_allclose(float(port["stats"]["loss"]),
                                   float(port["dp_loss"]), rtol=1e-6)
    for k, spec in specs.items():
        got = [_flat(p["grads"])[k] for p in ranks]
        want = [_flat(p["dp_grads"])[k] for p in ranks]
        top = max(float(np.abs(w).max()) for w in want)
        for r, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * top,
                                       err_msg=f"grad {k} rank {r}")
    case = runs["cases"][name]
    params, opt = from_numpy_tree((case["params"], case["opt"]), "cpu")
    whole = {k: _whole([_flat(p["grads"])[k] for p in ranks], spec, shape,
                       _flat(params)[k]) for k, spec in specs.items()}
    grads = {}
    for p, _ in leaves_with_path(params):
        grads[p] = torch.from_numpy(whole[path_str(p)])
    grads = map_with_path(lambda p, _: grads[p], params)
    with torch.no_grad():
        new_p, new_o, _ = adamw_update(grads, opt, params,
                                       warmup_cosine(LR, WARMUP, TOTAL))
    for r, port in enumerate(ranks):
        for what, tree, mine in (("param", new_p, port["params"]),
                                 ("mu", new_o["mu"], port["opt"]["mu"]),
                                 ("nu", new_o["nu"], port["opt"]["nu"])):
            want, got = _flat(tree), _flat(mine)
            for k, spec in specs.items():
                np.testing.assert_allclose(
                    got[k], _block(want[k], spec, shape, r), atol=1e-5,
                    rtol=1e-4, err_msg=f"{what} {k} rank {r}")
        assert int(port["opt"]["count"]) == COUNT + 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_leaf_whole_on_the_model_ranks_is_counted_twice(runs, name):
    """The leaves every model rank holds whole (the norms, the qk-norm
    scales, the kv projections where the kv heads are not split): each
    gradient within 1e-5 of the data-parallel one in norm, neither
    summed over the model ranks where each computes it alike (a 4x or
    2x gradient) nor left a rank's partial where each reads it for its
    own heads or sequence piece."""
    ranks = _ranks(runs, name)
    whole = [k for k, spec in _specs(name).items()
             if not any("model" in a for a in spec_axes(spec))]
    assert any("ln1" in k for k in whole)
    for k in whole:
        got = np.linalg.norm(_flat(ranks[0]["grads"])[k])
        want = np.linalg.norm(_flat(ranks[0]["dp_grads"])[k])
        assert abs(got / want - 1) < 1e-5, (k, got / want)


@pytest.mark.parametrize("arch,extra", [
    ("tinyllama-1.1b", {}), ("phi3-mini-3.8b", {}), ("stablelm-12b", {}),
    ("qwen2-72b", dict(seq_shard=True, microbatches=2)),
    ("chameleon-34b", dict(seq_shard=True, microbatches=2))])
def test_laid_out_step_at_one_rank_is_the_unsharded_step(arch, extra):
    cfg = get_arch(arch).reduced().replace(q_chunk=16, **extra)
    pol = get_policy("w8a8")
    params = model_for(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    opt = adamw_init(params)
    rng = np.random.default_rng(1)
    base = torch.from_numpy(rng.integers(0, cfg.vocab, (4, S + 1)))
    batch = {"tokens": base[:, :-1], "labels": base[:, 1:]}
    sched = warmup_cosine(LR, WARMUP, TOTAL)
    mesh = MeshShape(("data", "model"), (1, 1))
    _, p_shard = steps.abstract_params(cfg, mesh)
    want = steps.make_train_step(cfg, None, pol, schedule=sched)(
        params, opt, batch)
    got = steps.make_train_step(cfg, mesh, pol, schedule=sched,
                                shardings=p_shard)(params, opt, batch)
    for (p, w), g in zip(leaves_with_path(want), tree_leaves(got)):
        _bits(g.numpy(), w.numpy(), path_str(p))


@pytest.mark.parametrize("arch,extra", [
    ("tinyllama-1.1b", {}), ("chameleon-34b", dict(seq_shard=True))])
def test_the_norms_read_whole_d_model_rows(arch, extra, monkeypatch):
    """``nn/norm`` is unchanged by the layout: on rank 0 of a (2, 4)
    ``MeshShape`` every RMSNorm of the blocks and the final one reads
    rows whole on ``d_model`` (under sequence parallelism, the rank's
    piece of the sequence), and returns them whole."""
    from repro_torch.distributed import sharding
    from repro_torch.models import transformer
    from repro_torch.models.registry import sharding_rules

    cfg = get_arch(arch).reduced().replace(**extra)
    mesh = MeshShape(("data", "model"), (2, 4))
    abs_params, p_shard = steps.abstract_params(cfg, mesh)
    blocks = steps.materialize(steps.rank_blocks(abs_params, p_shard),
                               torch.Generator().manual_seed(0), cfg.vocab)
    tokens = torch.randint(0, cfg.vocab, (2, S),
                           generator=torch.Generator().manual_seed(1))
    seen = []
    norm = transformer.rmsnorm_apply

    def recording(p, x, *a):
        out = norm(p, x, *a)
        seen.append((tuple(x.shape), tuple(out.shape)))
        return out

    monkeypatch.setattr(transformer, "rmsnorm_apply", recording)
    with torch.no_grad(), sharding.mesh_rules(
            mesh, sharding_rules(cfg, 4), laid_out=True):
        model_for(cfg).loss_fn(blocks, {"tokens": tokens, "labels": tokens},
                               cfg, get_policy("w8a8"))
    rows = S // 4 if cfg.seq_shard else S
    assert len(seen) == 2 * cfg.n_layers + 1
    assert all(x == out == (2, rows, cfg.d_model) for x, out in seen)


# the reference's jitted step rounds apart from the port's op-by-op
# program (XLA fuses the dequant's multiplies and uses its own exp,
# rsqrt and sigmoid), and at w8a8 an ulp moves an int8 code at a
# rounding tie.  Measured on these cases, at w8a8: the loss at most
# 3.1e-5 apart (relative), each gradient leaf within 1.2e-2 of its
# largest magnitude (the embedding's, at rank level), AdamW's mu within
# 5.9e-5 and nu within 7.5e-7 (beside rtol 1e-4).  At w8 and fp32, with
# no activation codes to flip: the loss 7.9e-8, the gradients 1.9e-6 of
# the largest magnitude, the new params within 1.0e-6, mu 3.0e-9 and nu
# 2.8e-13 (beside rtol 1e-4).  The bars leave three to thirteen times
# these figures, but for mu and nu at w8 and fp32, which keep the
# data-parallel comparison's atol 1e-5 + rtol 1e-4.  At w8a8 the new params are not held directly: AdamW
# divides the gradient's gap by sqrt(nu), as small as 1e-6 here, and
# the measured gap reached 1.29 (qwen2).  There the reference's new
# params are held against AdamW of its own gradient as the port
# computes it, which closes the chain: the laid-out step's params are
# AdamW of its gradient (held against the data-parallel step above),
# and its gradient is the reference's at the bar here
REF_BARS = {
    "w8a8": dict(loss=1e-4, grad=0.05, mu=2e-4, nu=3e-6, params=None),
    "w8": dict(loss=1e-6, grad=1e-5, mu=1e-5, nu=1e-5, params=1e-5),
    "fp32": dict(loss=1e-6, grad=1e-5, mu=1e-5, nu=1e-5, params=1e-5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_laid_out_step_matches_the_reference(runs, name):
    ranks = _ranks(runs, name)
    want = runs["want"]
    shape = CASES[name][1]
    bars = REF_BARS[CASES[name][3]]
    np.testing.assert_allclose(float(ranks[0]["stats"]["loss"]),
                               float(want[f"{name}/stats/loss"]),
                               rtol=bars["loss"])
    held = [("mu", "opt/mu"), ("nu", "opt/nu")]
    if bars["params"] is not None:
        held.append(("params", "params"))
    for k, spec in _specs(name).items():
        w = want[f"{name}/grads/{k}"]
        top = float(np.abs(w).max())
        for r, port in enumerate(ranks):
            np.testing.assert_allclose(
                _flat(port["grads"])[k], _block(w, spec, shape, r), rtol=0,
                atol=bars["grad"] * top, err_msg=f"grad {k} rank {r}")
            mine = {"mu": port["opt"]["mu"], "nu": port["opt"]["nu"],
                    "params": port["params"]}
            for what, pre in held:
                np.testing.assert_allclose(
                    _flat(mine[what])[k],
                    _block(want[f"{name}/{pre}/{k}"], spec, shape, r),
                    atol=bars[what], rtol=1e-4,
                    err_msg=f"{what} {k} rank {r}")
    if bars["params"] is None:
        case = runs["cases"][name]
        params, opt = from_numpy_tree((case["params"], case["opt"]), "cpu")
        grads = map_with_path(lambda p, _: torch.from_numpy(
            want[f"{name}/grads/{path_str(p)}"]), params)
        with torch.no_grad():
            new_p, _, _ = adamw_update(grads, opt, params,
                                       warmup_cosine(LR, WARMUP, TOTAL))
        for k, v in _flat(new_p).items():
            np.testing.assert_allclose(want[f"{name}/params/{k}"], v,
                                       atol=1e-5, rtol=1e-4, err_msg=k)
    assert int(ranks[0]["opt"]["count"]) == int(want[f"{name}/opt/count"])
    assert float(ranks[0]["stats"]["lr"]) == float(want[f"{name}/stats/lr"])


def test_lower_cell_traces_rank_zero_of_the_mesh(runs):
    """``lower_cell`` on a (2, 4) ``MeshShape``: the traced arguments are
    the layout's bytes, the records rank 0's on the live mesh call for
    call, among them a reduce-scatter, and no collective moves a whole
    leaf split over the data axis, or a whole layer of one."""
    cfg = get_arch(TRACE["arch"]).reduced()
    mesh = MeshShape(("data", "model"), TRACE["shape"])
    cell = ShapeConfig("laid_out", TRACE["seq"], TRACE["batch"], "train")
    # the first trace on a device builds the rotary table; the ranks
    # built theirs in the steps before
    steps.lower_cell(cfg, cell, mesh, get_policy(TRACE["policy"]))
    program, meta = steps.lower_cell(cfg, cell, mesh,
                                     get_policy(TRACE["policy"]))
    assert meta["laid_out"]
    assert program.argument_bytes == program.layout_argument_bytes
    live = runs["spawned"][0]["trace"]
    got = [tuple(r[:5]) for r in program.ops]
    assert len(got) == len(live)
    for i, (a, b) in enumerate(zip(got, live)):
        assert a == b, (i, a, b)
    kinds = {r.name for r in program.ops if r.kind == "collective"}
    assert "reduce-scatter" in kinds
    # a gradient reaches its rank as pieces (reduce-scatters, and the
    # 1-D pieces of a sum over the slots): no sum over peers moves a
    # leaf whole, not even one layer of the smallest split leaf
    abs_params, p_shard = steps.abstract_params(cfg, mesh)
    layer = min(math.prod(t.shape[1:] if p[0] == "blocks" else t.shape)
                for (p, t), (_, s) in zip(
                    leaves_with_path(abs_params), leaves_with_path(
                        p_shard, is_leaf=lambda x: hasattr(x, "spec")))
                if any("data" in a for a in spec_axes(s.spec)))
    sums = [r for r in program.ops
            if r.kind == "collective" and r.name == "all-reduce"]
    assert sums and max(r.ins[0][2] for r in sums) < layer


# -- the serving steps laid out ------------------------------------------------

def _serve_cfg(name):
    arch, _, extra = SERVING[name]
    return get_arch(arch).reduced().replace(q_chunk=16, **extra)


@pytest.fixture(scope="module")
def unsharded(runs):
    """Each serving case through the port's unsharded program on the
    global batch: the PTQ'd params, the prefill's logits, caches and
    int8 codes, each decode step's logits and codes, the caches after
    the last step."""
    out = {}
    pol = get_policy(SERVE_POLICY)
    for name in SERVING:
        c, cfg = runs["cases"][name], _serve_cfg(name)
        packed = quantize_params(from_numpy_tree(c["params"], "cpu"), pol)
        with checks.recorded_codes(SERVE_S) as rec:
            logits, caches = steps.make_prefill_step(
                cfg, None, pol, pol.kv_bits)(
                    packed, {"tokens": torch.from_numpy(c["prompts"])})
        res = dict(packed=packed, prefill_logits=logits.numpy(),
                   prefill_caches=_flat(caches),
                   prefill_codes=[t.numpy() for t in rec],
                   decode_logits=[], decode_codes=[])
        caches = pad_caches(caches, SERVE_STEPS)
        decode = steps.make_decode_step(cfg, None, pol, pol.kv_bits)
        for i in range(SERVE_STEPS):
            with checks.recorded_codes(1) as rec:
                logits, caches = decode(packed, caches, torch.from_numpy(
                    c["fed"][i]), SERVE_S + i)
            res["decode_logits"].append(logits.numpy())
            res["decode_codes"].append([t.numpy() for t in rec])
        res["decode_caches"] = _flat(caches)
        out[name] = res
    return out


def _serve_specs(name, kind):
    """Each leaf's spec by key: the PTQ'd params' under the FSDP+TP
    rules (``pre``) or the serve rules (``dec``), or the caches' after
    the prefill (``prefill``) or under the decode (``decode``)."""
    cfg, shape = _serve_cfg(name), SERVING[name][1]
    mesh = MeshShape(("data", "model"), shape)
    pol = get_policy(SERVE_POLICY)
    if kind in ("pre", "dec"):
        _, shard = steps.abstract_params(cfg, mesh, weight_ptq=pol,
                                         serve=kind == "dec")
        out = {}
        for p, s in leaves_with_path(shard,
                                     is_leaf=lambda x: hasattr(x, "spec")
                                     or hasattr(x, "qvalue")):
            if hasattr(s, "qvalue"):
                out[f"{path_str(p)}/.qvalue"] = s.qvalue.spec
                out[f"{path_str(p)}/.scale"] = s.scale.spec
            else:
                out[path_str(p)] = s.spec
        return out
    cap = SERVE_S + (SERVE_STEPS if kind == "decode" else 0)
    cell = ShapeConfig(kind, cap, SERVE_B, "decode")
    _, shard = steps.abstract_caches(cfg, cell, mesh, pol.kv_bits)
    return {path_str(p): s.spec for p, s in leaves_with_path(
        shard, is_leaf=lambda x: hasattr(x, "spec"))}


def _serve_ranks(runs, name):
    return [r["serving"][name] for r in runs["spawned"]]


def _rows(name, rank):
    """Rank ``rank``'s rows of the global batch."""
    data, model = SERVING[name][1]
    per = SERVE_B // data
    return slice(rank // model * per, (rank // model + 1) * per)


@pytest.mark.parametrize("name", sorted(SERVING))
def test_serving_blocks_are_the_references_addressable_shards(runs, name):
    """The PTQ'd params' blocks under the prefill's and the decode's
    rules, and a cache tree's under the decode's cache shardings, bit
    for bit the reference's addressable shards of the same device."""
    want = runs["want"]
    specs = {k: _serve_specs(name, k) for k in ("pre", "dec")}
    for r, port in enumerate(_serve_ranks(runs, name)):
        for kind in ("pre", "dec"):
            assert sorted(port[kind]) == sorted(specs[kind])
            for k, v in port[kind].items():
                _bits(v, want[f"{name}/{kind}/{k}/{r}"], f"{kind} {k} {r}")
        for k, v in port["layout_caches"].items():
            _bits(v, want[f"{name}/layout_caches/{k}/{r}"],
                  f"cache {k} rank {r}")


def _codes_match(got, want, rows, model_size, rank, what):
    """Each product's int8 codes of the rank's rows: a column-parallel
    product's input whole, a row-parallel one's the rank's slice of the
    contraction; returns how many were split."""
    assert len(got) == len(want) > 0, (what, len(got), len(want))
    n = 0
    for i, (g, w) in enumerate(zip(got, want)):
        w = w[rows]
        if g.shape != w.shape:
            k = g.shape[-1]
            assert k * model_size == w.shape[-1], (what, i, g.shape)
            m = rank % model_size
            w = w[..., m * k:(m + 1) * k]
            n += 1
        _bits(g, w, f"{what} product {i} rank {rank}")
    return n


@pytest.mark.parametrize("name", sorted(SERVING))
def test_laid_out_serving_is_the_unsharded_program(runs, unsharded, name):
    """On every rank: the prefill's last-position logits and each decode
    step's (its rows, whole over the vocabulary), its cache blocks
    (payloads and scales) after the prefill and after the last decode
    step, and every product's int8 codes, bit for bit the unsharded
    program's."""
    want = unsharded[name]
    shape = SERVING[name][1]
    specs = {k: _serve_specs(name, k) for k in ("prefill", "decode")}
    split = 0
    for r, port in enumerate(_serve_ranks(runs, name)):
        rows = _rows(name, r)
        _bits(port["prefill_logits"], want["prefill_logits"][rows],
              f"prefill logits rank {r}")
        for i in range(SERVE_STEPS):
            _bits(port["decode_logits"][i], want["decode_logits"][i][rows],
                  f"decode {i} logits rank {r}")
        for kind in ("prefill", "decode"):
            for k, spec in specs[kind].items():
                _bits(port[f"{kind}_caches"][k],
                      _block(want[f"{kind}_caches"][k], spec, shape, r),
                      f"{kind} cache {k} rank {r}")
        split += _codes_match(port["prefill_codes"], want["prefill_codes"],
                              rows, shape[1], r, "prefill")
        for i in range(SERVE_STEPS):
            split += _codes_match(port["decode_codes"][i],
                                  want["decode_codes"][i], rows, shape[1],
                                  r, f"decode {i}")
    assert split > 0          # the row-parallel products were split


# the reference's jitted serving steps round apart from its own op-by-op
# program (XLA fuses the dequant's multiplies and uses its own exp and
# rsqrt), and an ulp moves an int8 code at a rounding tie, which the
# tensor-wide requantization of the SwiGLU gate and the per-token KV
# scales carry on from layer to layer.  Measured on these cases at
# w8a8kv8 (the reference's sharded steps equal its unsharded jitted
# ones bit for bit, and its op-by-op prefill gives the port's cache codes
# to the bit; the jitted one's layer-0 scales are an ulp apart): the
# logits 2.2e-2 of their largest magnitude apart at most, 2.4% of the
# cache codes apart, by up to 8, the cache scales 4.6e-2 apart
# (relative).  The bars leave two to five times those figures.
SERVE_REF_BARS = {
    "w8a8kv8": dict(logits=0.1, code_share=0.1, code_gap=16, scale=0.25),
}


def _serve_gaps(runs, unsharded, name):
    """The reference against the unsharded port program (which every
    rank equals bit for bit, above): the logits' largest gap over their
    largest magnitude, the share of cache codes apart (and their
    largest gap), the cache scales' largest relative gap."""
    want, port = runs["want"], unsharded[name]
    logits = [(port["prefill_logits"], want[f"{name}/prefill/logits"])] + [
        (port["decode_logits"][i], want[f"{name}/decode/{i}/logits"])
        for i in range(SERVE_STEPS)]
    gap = max(float(np.abs(a - b).max() / np.abs(b).max())
              for a, b in logits)
    codes = apart = 0
    code_gap = scale_gap = 0.0
    for kind in ("prefill", "decode"):
        for k, v in port[f"{kind}_caches"].items():
            w = want[f"{name}/{kind}/caches/{k}"]
            if v.dtype == np.int8:
                d = np.abs(v.astype(np.int32) - w.astype(np.int32))
                codes += d.size
                apart += int((d > 0).sum())
                code_gap = max(code_gap, float(d.max()))
            else:
                scale_gap = max(scale_gap, float(
                    (np.abs(v - w) / np.maximum(np.abs(w), 1e-30)).max()))
    return dict(logits=gap, code_share=apart / codes, code_gap=code_gap,
                scale=scale_gap)


@pytest.mark.parametrize("name", sorted(SERVING))
def test_laid_out_serving_matches_the_reference(runs, unsharded, name):
    """The laid-out steps (bitwise the unsharded program on every rank,
    above) against the reference's steps jitted with their
    ``in_shardings``: the logits within ``logits`` of their largest
    magnitude, at most ``code_share`` of the cache codes apart and none
    by more than ``code_gap``, the cache scales within ``scale``
    relative."""
    gaps = _serve_gaps(runs, unsharded, name)
    bars = SERVE_REF_BARS[SERVE_POLICY]
    for k, bar in bars.items():
        assert gaps[k] <= bar, (k, gaps)


@pytest.mark.parametrize("arch,extra", [
    ("tinyllama-1.1b", {}), ("phi3-mini-3.8b", {}), ("stablelm-12b", {}),
    ("qwen2-72b", dict(seq_shard=True)),
    ("chameleon-34b", dict(seq_shard=True))])
def test_laid_out_serving_at_one_rank_is_the_unsharded_program(arch, extra):
    """A (1, 1) ``MeshShape``: the laid-out prefill, its caches grown by
    ``pad_cache_blocks`` and 4 laid-out decode steps bit for bit the
    unsharded steps, ``pad_caches`` and all."""
    cfg = get_arch(arch).reduced().replace(q_chunk=16, **extra)
    pol = get_policy(SERVE_POLICY)
    packed = quantize_params(model_for(cfg).init(
        torch.Generator().manual_seed(0), cfg, device="cpu"), pol)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, SERVE_S)))
    fed = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_STEPS, 4, 1)))
    mesh = MeshShape(("data", "model"), (1, 1))
    _, pre = steps.abstract_params(cfg, mesh, weight_ptq=pol)
    _, dec = steps.abstract_params(cfg, mesh, weight_ptq=pol, serve=True)
    cell = ShapeConfig("d", SERVE_S + SERVE_STEPS, 4, "decode")
    _, c_shard = steps.abstract_caches(cfg, cell, mesh, pol.kv_bits)
    w_logits, w_caches = steps.make_prefill_step(cfg, None, pol, 8)(
        packed, {"tokens": tokens})
    g_logits, g_caches = steps.make_prefill_step(
        cfg, mesh, pol, 8, shardings=pre)(local_shards(packed, pre, mesh),
                                          {"tokens": tokens})
    got, want = [g_logits, g_caches], [w_logits, w_caches]
    w_caches = pad_caches(w_caches, SERVE_STEPS)
    g_caches = steps.pad_cache_blocks(g_caches, SERVE_S, SERVE_STEPS, cfg,
                                      mesh)
    w_step = steps.make_decode_step(cfg, None, pol, 8)
    g_step = steps.make_decode_step(cfg, mesh, pol, 8, shardings=dec,
                                    cache_shardings=c_shard)
    blocks = local_shards(packed, dec, mesh)
    for i in range(SERVE_STEPS):
        lw, w_caches = w_step(packed, w_caches, fed[i], SERVE_S + i)
        lg, g_caches = g_step(blocks, g_caches, fed[i], SERVE_S + i)
        got.append(lg)
        want.append(lw)
    got.append(g_caches)
    want.append(w_caches)
    for (p, w), g in zip(leaves_with_path(want), tree_leaves(got)):
        _bits(g.numpy(), w.numpy(), path_str(p))


@pytest.mark.parametrize("shape", ["2x4", "4x2"])
@pytest.mark.parametrize("kind", ["column", "row", "row_scattered"])
def test_split_packed_product_is_the_unsplit_product(runs, shape, kind):
    """A packed weight (PTQ'd whole, per column) split over the model
    ranks: column-parallel, each rank's columns; row-parallel, each
    rank's slice of the contraction with the int32 sums taken over the
    ranks before the dequant, the whole output (or, scattered, the
    rank's piece of the sequence): bit for bit the unsplit
    ``q_matmul``'s, on the rank's rows."""
    c = runs["split"]
    packed = QTensor.quant(torch.from_numpy(c["w"]), 8, channel_axis=1)
    full = q_matmul(torch.from_numpy(c["x"]), packed,
                    get_policy("w8a8")).numpy()
    data, model = map(int, shape.split("x"))
    for r, res in enumerate(runs["spawned"]):
        got = res["split"][shape][kind]
        d, m = r // model, r % model
        want = full[d * 8 // data:(d + 1) * 8 // data]
        if kind == "column":
            n = want.shape[-1] // model
            want = want[..., m * n:(m + 1) * n]
        elif kind == "row_scattered":
            n = want.shape[1] // model
            want = want[:, m * n:(m + 1) * n]
        _bits(got, want, f"{kind} rank {r}")


@pytest.mark.parametrize("shape", ["2x4", "4x2"])
def test_sequence_split_decode_attention_is_bitwise(runs, shape):
    """Every head's queries attended on each rank's positions of a cache
    split along its sequence (the row max a ``pmax``, the exp sums and
    the value partials in fp64 summed over the ranks, rounded once):
    bit for bit ``gqa_attend`` on the whole cache, on every rank."""
    c = runs["split"]
    B, T = c["k"].shape[:2]
    pos = torch.full((B, 1), c["index"], dtype=torch.int32)
    bias = _mask_bias(pos, torch.arange(T)[None].expand(B, T), True, None,
                      c["index"] + 1)
    full = gqa_attend(*(torch.from_numpy(c[k]) for k in "qkv"), bias).numpy()
    data = int(shape.split("x")[0])
    model = WORLD // data
    for r, res in enumerate(runs["spawned"]):
        d = r // model
        _bits(res["split"][shape]["attend"],
              full[d * B // data:(d + 1) * B // data], f"rank {r}")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_lower_cell_traces_rank_zero_of_a_serving_cell(runs, kind):
    """``lower_cell`` of a (2, 4) serving cell (tinyllama: its cache
    split along the sequence): laid out, its arguments the layout's
    bytes, its records rank 0's on the live mesh call for call, and a
    collective of each kind a laid-out serving step runs."""
    cfg = get_arch(SERVE_TRACE["arch"]).reduced()
    mesh = MeshShape(("data", "model"), SERVE_TRACE["shape"])
    cell = ShapeConfig("laid_out", SERVE_TRACE["seq"], SERVE_TRACE["batch"],
                       kind)
    pol = get_policy(SERVE_TRACE["policy"])
    steps.lower_cell(cfg, cell, mesh, pol)
    program, meta = steps.lower_cell(cfg, cell, mesh, pol)
    assert meta["laid_out"]
    assert program.argument_bytes == program.layout_argument_bytes
    live = runs["spawned"][0][f"serve_trace_{kind}"]
    got = [tuple(r[:5]) for r in program.ops]
    assert len(got) == len(live)
    for i, (a, b) in enumerate(zip(got, live)):
        assert a == b, (i, a, b)
    kinds = {r.name for r in program.ops if r.kind == "collective"}
    assert {"all-gather", "all-reduce"} <= kinds, kinds
    hist = H.op_histogram(program)
    assert hist["qmac_i8"] == 2 * cfg.n_layers      # wo and w_down
    assert hist["qmac_i8_deq"] == 5 * cfg.n_layers + 1


def test_laid_out_serving_refusals():
    """A laid-out serving step takes a dense decoder and a mesh, a
    decode step both shardings, and a ring-buffer cache is refused."""
    pol = get_policy(SERVE_POLICY)
    mesh = MeshShape(("data", "model"), (1, 1))
    moe = get_arch("qwen3-moe-30b-a3b").reduced()
    dense = get_arch("tinyllama-1.1b").reduced()
    _, shard = steps.abstract_params(dense, mesh, weight_ptq=pol)
    with pytest.raises(ValueError, match="dense decoder"):
        steps.make_prefill_step(moe, mesh, pol, 8, shardings=shard)
    with pytest.raises(ValueError, match="dense decoder"):
        steps.make_prefill_step(dense, None, pol, 8, shardings=shard)
    with pytest.raises(ValueError, match="shardings"):
        steps.make_decode_step(dense, mesh, pol, 8, shardings=shard)
    ring = dense.replace(window=8)
    cell = ShapeConfig("d", 16, 2, "decode")
    _, c_shard = steps.abstract_caches(ring, cell, mesh, 8)
    _, d_shard = steps.abstract_params(ring, mesh, weight_ptq=pol,
                                       serve=True)
    packed = quantize_params(model_for(ring).init(
        torch.Generator().manual_seed(0), ring, device="cpu"), pol)
    caches = model_for(ring).init_caches(ring, 2, 16, 8)
    step = steps.make_decode_step(ring, mesh, pol, 8, shardings=d_shard,
                                  cache_shardings=c_shard)
    with pytest.raises(ValueError, match="ring-buffer"):
        step(local_shards(packed, d_shard, mesh), caches,
             torch.zeros((2, 1), dtype=torch.int32), 3)
