"""The LM layout of the PyTorch port on eight gloo ranks, against the JAX
package on eight host devices.

One session of ``repro_torch.distributed.ranks.run_ranks`` (8 spawned
ranks, one CPU thread each, killed at a deadline) runs every multi-rank
case (bodies in ``repro_torch.distributed.checks``); one reference
subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(``tests/lm_sharded_reference.py``) writes every reference case to one
npz; and one ``torchrun`` launch of 8 ranks runs ``launch.train``.  The
three run at once.

* The training step on the (8, 1) host mesh, for tinyllama, qwen3-moe
  (the TP-within-expert branch at model 1), mamba2 and recurrentgemma,
  each reduced, 2 rows a rank: the reference jitted on the placed
  batch.  Both run under ``one_library`` (the reference's callbacks need
  the GSPMD partitioner; the script switches Shardy off).  Bars, as
  test_torch_lm_train.py's: the int8 codes of the forward's dense
  products bitwise, the loss at rtol 1e-6, each gradient leaf within
  1e-5 of its largest magnitude, AdamW given the reference's gradient
  at atol 1e-5 + rtol 1e-4.  The port's loss and gradient are the means
  of the slots', the reference's the global program's: the same sums in
  another order.
* ``moe_shard_map`` on a (2, 4) mesh, forward and gradients, expert
  parallelism (8 experts over 4) and TP-within-expert (2 experts, their
  ``d_ff`` over 4): each slot routes at its own capacity, and the
  ``w_down`` product of the TPE branch quantizes ``h`` a row over the
  rank's slice, so the port is held to the reference's per-slot
  program, not to the global ``moe_apply``.  The experts chosen and the
  drops equal; the output and gradients within 1e-5 of their largest
  magnitude.
* ``place``: each rank's rows equal the reference's addressable shard of
  its device; ``distribute`` on a (2, 4) ``DeviceMesh``: each rank's
  local shard of every leaf (fp and PTQ'd trees) equals the slice
  ``NamedSharding.devices_indices_map`` gives its device, and ``gather``
  brings the tree back bit for bit.
* ``launch.train`` at 8 ranks from the reference's init, fed the
  reference's batches: its losses at rtol 1e-5 of the reference's
  ``train`` on 8 devices; a run stopped at step 2 and resumed ends bit
  for bit where the straight run does; the CLI prints the mesh banner
  once.
"""
import json
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
from repro.core import policy as jpolicy
from repro.core.quantizer import quantize_params
from repro.data import DataConfig as JDataConfig
from repro.data import batch_at as jbatch_at
from repro.models import registry as jmodels
from repro.nn.module import axes_of, unbox
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import CheckpointManager, from_numpy_tree
from repro_torch.distributed import checks
from repro_torch.distributed.ranks import run_ranks
from repro_torch.optim import adamw_update, warmup_cosine
from repro_torch.tree import leaves_with_path, map_with_path, path_str

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
DEADLINE_S = 240
TRAIN = ["tinyllama-1.1b", "qwen3-moe-30b-a3b", "mamba2-2.7b",
         "recurrentgemma-9b"]
B, S = 16, 32
LR, WARMUP, TOTAL, COUNT = 3e-4, 5, 50, 3
MOE = {
    # 8 experts over the 4-way model axis: expert parallelism
    "ep": dict(n_experts=8, d_ff=16, top_k=2),
    # 2 experts < 4: each expert's d_ff over the model axis
    "tpe": dict(n_experts=2, d_ff=16, top_k=2),
}
CLI_STEPS, CLI_SEQ, CLI_BATCH = 4, 16, 8


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _triples(tree):
    """A reference tree with each QTensor as (payload, scale, bits)."""
    is_q = lambda x: hasattr(x, "qvalue")  # noqa: E731
    return jax.tree.map(lambda q: (np.asarray(q.qvalue),
                                   np.asarray(q.scale), int(q.bits))
                        if is_q(q) else np.asarray(q), tree, is_leaf=is_q)


def _train_case(arch, seed=0):
    cfg = jreg.get_arch(arch).reduced()
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
    return dict(arch=arch, policy="w8a8", params=params, opt=opt,
                batch={"tokens": base[:, :-1], "labels": base[:, 1:]},
                lr=LR, warmup=WARMUP, total=TOTAL, q_chunk=16)


def _moe_case(n_experts, d_ff, top_k, seed=0, d=32):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=normal(4, 8, d), ct=normal(4, 8, d),
                router=normal(d, n_experts, scale=d ** -0.5),
                w_gate=normal(n_experts, d, d_ff, scale=d ** -0.5),
                w_up=normal(n_experts, d, d_ff, scale=d ** -0.5),
                w_down=normal(n_experts, d_ff, d, scale=d_ff ** -0.5),
                top_k=top_k, capacity_factor=1.25, policy="w8a8")


def _layout_case():
    cfg = jreg.get_arch("tinyllama-1.1b").reduced()
    boxed = jmodels.model_for(cfg).init(jax.random.PRNGKey(0), cfg)
    params = unbox(boxed)
    ptq = quantize_params(params, jpolicy.get_policy("w8a8"))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
             "frames": rng.standard_normal((B, 4, 3)).astype(np.float32)}
    return dict(batch=batch, tree={"fp": _triples(params),
                                   "ptq": _triples(ptq)},
                axes={"fp": axes_of(boxed), "ptq": axes_of(boxed)})


def _cli_inputs(work):
    """The reference's init as a port checkpoint at step 0, and the
    reference's batches of each step."""
    cfg = jreg.get_arch("tinyllama-1.1b").reduced()
    params = _numpy(unbox(jmodels.model_for(cfg).init(
        jax.random.PRNGKey(0), cfg)))
    tree = from_numpy_tree((params, _numpy(jadamw_init(params))), "cpu")
    CheckpointManager(str(work / "straight")).save(0, tree)
    dcfg = JDataConfig(vocab=cfg.vocab, seq_len=CLI_SEQ,
                       global_batch=CLI_BATCH, seed=0)
    batches = {f"{s}/{k}": np.asarray(v) for s in range(CLI_STEPS)
               for k, v in jbatch_at(dcfg, s).items()}
    np.savez(work / "batches.npz", **batches)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of both packages: (reference npz as a dict, each rank's
    results of the spawned session, each rank's torchrun results)."""
    work = tmp_path_factory.mktemp("lm_sharded")
    cases = {"train": {a: _train_case(a) for a in TRAIN},
             "moe": {k: _moe_case(**v) for k, v in MOE.items()},
             "layout": _layout_case(),
             "cli": dict(steps=CLI_STEPS, seq_len=CLI_SEQ,
                         batch=CLI_BATCH)}
    with open(work / "in.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = _env()
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "lm_sharded_reference.py"),
         str(work / "in.pkl"), str(work / "ref.npz")], cwd=str(ROOT),
        env=dict(env, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        _cli_inputs(work)
        jobs = [{"name": "straight", "fn": "repro_torch.distributed."
                 "checks:train_run", "kwargs": dict(
                     arch="tinyllama-1.1b", steps=CLI_STEPS,
                     seq_len=CLI_SEQ, batch=CLI_BATCH, save_every=2,
                     log_every=1, batches=str(work / "batches.npz"),
                     ckpt_dir=str(work / "straight"))},
                {"name": "resumed", "fn": "repro_torch.distributed."
                 "checks:train_run", "kwargs": dict(
                     arch="tinyllama-1.1b", steps=CLI_STEPS,
                     seq_len=CLI_SEQ, batch=CLI_BATCH, save_every=2,
                     log_every=1, batches=str(work / "batches.npz"),
                     ckpt_dir=str(work / "resumed"),
                     resume_from=[str(work / "straight"), 2])},
                {"name": "cli", "fn": "repro_torch.launch.train:main",
                 "kwargs": {"argv": [
                     "--arch", "tinyllama-1.1b", "--steps", "2",
                     "--seq-len", "16", "--batch", "8", "--device",
                     "cpu"]}}]
        with open(work / "jobs.json", "w") as f:
            json.dump(jobs, f)
        cli = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={WORLD}", "-m",
             "repro_torch.distributed.ranks", str(work / "jobs.json"),
             str(work)], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
        spawned = run_ranks(checks.suite, WORLD, {
            "train": ("train_steps", {"cases": cases["train"]}),
            "moe": ("moe_dispatch", {"cases": cases["moe"],
                                     "shape": (2, 4)}),
            "layout": ("layouts", dict(
                batch=cases["layout"]["batch"],
                tree=cases["layout"]["tree"],
                axes=cases["layout"]["axes"], shape=(2, 4)))},
            deadline_s=DEADLINE_S)
        deadline = time.monotonic() + DEADLINE_S
        outs = {}
        for name, proc in (("torchrun", cli), ("reference", ref)):
            try:
                outs[name] = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"the {name} did not finish within "
                                   f"{DEADLINE_S} s") from None
            assert proc.returncode == 0, outs[name][1][-4000:]
    finally:
        for proc in (ref, locals().get("cli")):
            if proc is not None and proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    with np.load(work / "ref.npz") as f:
        want = {k: f[k] for k in f.files}
    ranks = []
    for r in range(WORLD):
        with open(work / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(want=want, spawned=spawned, cli=ranks, cases=cases,
                work=work)


def _under(flat, prefix):
    """The entries of a flat dict under ``prefix/``, the prefix cut."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


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


def _of_largest(got, want, frac, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * float(np.abs(want).max()),
                               err_msg=what)


def _close_trees(got, want, atol, rtol, what):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=atol, rtol=rtol,
                                   err_msg=f"{what} {k}")


def _one_process(case):
    """The eight-slot step's program in this one process, and each
    rank's share of its codes.  A dense family's is the unsharded step
    on the global batch (its activations requantized on the whole
    batch's grid, as the ranks' max over the slots gives it); an MoE
    family's is each slot's rows alone (each slot dispatches at its own
    capacity, and no activation outside the experts is requantized),
    the loss and gradient then the slots' means, summed in slot order.
    Returns (codes by rank, loss, gradient)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.fxp import div_scalar
    from repro_torch.core.policy import get_policy
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.registry import model_for
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = get_arch(case["arch"]).reduced().replace(q_chunk=case["q_chunk"])
    pol = get_policy(case["policy"])
    params, opt, batch = from_numpy_tree(
        (case["params"], case["opt"], case["batch"]), "cpu")
    model = model_for(cfg)

    def step(rows):
        b = {k: v[rows] for k, v in batch.items()}
        with checks.recorded_codes(S) as codes, torch.no_grad():
            model.loss_fn(params, b, cfg, pol)
        codes = [c.numpy() for c in codes]
        grads = []
        update = tsteps.adamw_update
        tsteps.adamw_update = lambda g, *a, **kw: (grads.append(g),
                                                   update(g, *a, **kw))[1]
        try:
            _, _, stats = tsteps.make_train_step(cfg, None, pol)(
                params, opt, b)
        finally:
            tsteps.adamw_update = update
        return codes, stats["loss"], grads[0]

    per = B // WORLD
    if not cfg.is_moe:
        codes, loss, grads = step(slice(None))
        return ([[c[r * per:(r + 1) * per] for c in codes]
                 for r in range(WORLD)], loss, grads)
    slots = [step(slice(r * per, (r + 1) * per)) for r in range(WORLD)]

    def mean(parts):
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return div_scalar(total, WORLD)

    grads = tree_unflatten(slots[0][2], [
        mean(list(ls)) for ls in zip(*(tree_leaves(s[2]) for s in slots))])
    return [s[0] for s in slots], mean([s[1] for s in slots]), grads


@pytest.mark.parametrize("arch", TRAIN)
def test_host_mesh_train_step_is_the_eight_slot_program(runs, arch):
    """The eight ranks against the same program in one process: the
    codes bit for bit; an MoE family's loss and gradient too (the same
    sums in the same order), a dense family's at the fp32 bars (the
    global batch's mean against the mean of the slots' means)."""
    port = [r["train"][arch] for r in runs["spawned"]]
    codes, loss, grads = _one_process(runs["cases"]["train"][arch])
    for r in range(WORLD):
        assert len(port[r]["codes"]) == len(codes[r]) > 0
        for i, (got, want) in enumerate(zip(port[r]["codes"], codes[r])):
            _bits(got, want, f"product {i} rank {r}")
    lead = port[0]
    got_g, want_g = _flat(lead["grads"]), _flat(grads)
    assert sorted(got_g) == sorted(want_g)
    if jreg.get_arch(arch).is_moe:
        _bits(np.asarray(lead["stats"]["loss"]), loss.numpy(), "loss")
        for k, w in want_g.items():
            _bits(got_g[k], w, f"grad {k}")
    else:
        np.testing.assert_allclose(float(lead["stats"]["loss"]),
                                   float(loss), rtol=1e-6)
        for k, w in want_g.items():
            _of_largest(got_g[k], w, 1e-5, f"grad {k}")


def _codes_apart(port, want):
    """The fraction of the reference's dense-product codes that the
    ranks' differ from, each rank against its rows."""
    codes = _under(want, "codes")
    per = B // WORLD
    assert len(codes) == len(port[0]["codes"]) > 0
    apart = total = 0
    for i in range(len(codes)):
        for r in range(WORLD):
            w = codes[str(i)][r * per:(r + 1) * per]
            apart += int((port[r]["codes"][i] != w).sum())
            total += w.size
    return apart / total


@pytest.mark.parametrize("arch", TRAIN)
def test_host_mesh_train_step_matches_the_reference(runs, arch):
    """The eight ranks against the reference's jitted step on eight
    devices.  XLA's compiled program rounds some products' dequant and
    its own exp/rsqrt/sigmoid differently from both packages' op-by-op
    programs (the single-device tests align those primitives with
    ``one_library``, whose callbacks deadlock XLA's host collectives
    across eight devices), and a one-ulp change moves an int8 code at a
    rounding tie: the codes at most 5% apart, the loss at rtol 2e-4,
    each gradient leaf within 0.25 of its largest magnitude (measured,
    at most 2.8%, 3.7e-5 and 6.3e-2).  AdamW, given the reference's
    gradient, at atol 1e-5 + rtol 1e-4."""
    want = _under(runs["want"], f"train/{arch}")
    port = [r["train"][arch] for r in runs["spawned"]]
    assert _codes_apart(port, want) <= 0.05
    lead = port[0]
    np.testing.assert_allclose(float(lead["stats"]["loss"]),
                               float(want["stats/loss"]), rtol=2e-4)
    got_g, want_g = _flat(lead["grads"]), _under(want, "grads")
    assert sorted(got_g) == sorted(want_g)
    for k, w in want_g.items():
        _of_largest(got_g[k], w, 0.25, f"grad {k}")
    case = runs["cases"]["train"][arch]
    params, opt = from_numpy_tree((case["params"], case["opt"]), "cpu")
    grads = map_with_path(
        lambda p, _: torch.from_numpy(want_g[path_str(p)]), params)
    with torch.no_grad():
        new_p, new_o, stats = adamw_update(
            grads, opt, params, warmup_cosine(LR, WARMUP, TOTAL))
    _close_trees(_flat(new_p), _under(want, "params"), 1e-5, 1e-4, "param")
    for m in ("mu", "nu"):
        _close_trees(_flat(new_o[m]), _under(want, f"opt/{m}"), 1e-5, 1e-4,
                     m)
    assert int(lead["opt"]["count"]) == int(want["opt/count"]) == COUNT + 1
    assert float(lead["stats"]["lr"]) == float(want["stats/lr"])


@pytest.mark.parametrize("kind", sorted(MOE))
def test_moe_shard_map_on_a_2x4_mesh_matches_the_reference(runs, kind):
    want = _under(runs["want"], f"moe/{kind}")
    port = [r["moe"][kind] for r in runs["spawned"]]
    rows = runs["cases"]["moe"][kind]["x"].shape[0] // 2
    for r in range(WORLD):
        d = r // 4
        p = port[r]
        _bits(p["experts"].astype(np.int32),
              want[f"experts/{d}"].astype(np.int32), f"experts rank {r}")
        _bits(p["keep"], want[f"keep/{d}"], f"drops rank {r}")
        _of_largest(p["out"], want["out"][d * rows:(d + 1) * rows], 1e-5,
                    f"out rank {r}")
        _of_largest(p["dx"], want["dx"][d * rows:(d + 1) * rows], 1e-5,
                    f"dx rank {r}")
        # every model peer holds its slot's result
        for k, v in port[d * 4].items():
            _bits(p[k], v, f"{k} rank {r} vs its slot's first rank")
    for k in ("d_router", "d_w_gate", "d_w_up", "d_w_down"):
        # the slots' shares, summed in slot order
        _of_largest(port[0][k] + port[4][k], want[k], 1e-5, k)


def _is_triple(x):
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[2], int)


def test_place_gives_each_rank_its_devices_rows(runs):
    batch = runs["cases"]["layout"]["batch"]
    for r in range(WORLD):
        got = runs["spawned"][r]["layout"]["rows"]
        assert sorted(got) == sorted(batch)
        for k in batch:
            _bits(got[k], runs["want"][f"place/{k}/{r}"], f"{k} rank {r}")


def test_distribute_gives_each_rank_its_devices_slice(runs):
    tree = runs["cases"]["layout"]["tree"]
    leaves = leaves_with_path(tree, is_leaf=_is_triple)
    n = 0
    for r in range(WORLD):
        local = dict(leaves_with_path(
            runs["spawned"][r]["layout"]["local"], is_leaf=_is_triple))
        back = dict(leaves_with_path(
            runs["spawned"][r]["layout"]["gathered"], is_leaf=_is_triple))
        for path, leaf in leaves:
            parts = (("#q", 0), ("#s", 1)) if _is_triple(leaf) \
                else (("", None),)
            for suffix, i in parts:
                full = leaf if i is None else leaf[i]
                got = local[path] if i is None else local[path][i]
                bounds = runs["want"][f"layout/{path_str(path)}{suffix}/{r}"]
                want = full[tuple(slice(a, b) for a, b in bounds)]
                _bits(got, want, f"{path_str(path)}{suffix} rank {r}")
                _bits(back[path] if i is None else back[path][i], full,
                      f"gathered {path_str(path)}{suffix} rank {r}")
                n += 1
    assert n > 0
    # the layout splits something over each mesh axis
    shapes = {tuple(np.shape(v)) for v in runs["spawned"][5]["layout"][
        "local"]["fp"]["blocks"]["attn"]["wq"].values()}
    assert (4, 32, 16) in shapes


def test_train_under_torchrun_matches_one_rank_and_the_reference(
        runs, tmp_path, monkeypatch):
    """``launch.train`` at eight ranks, from the reference's init and on
    its batches: the losses at rtol 1e-5 of the same run at one rank in
    this process, and at rtol 1e-2 of the reference's ``train`` on eight
    devices (its compiled program rounds apart, as above: measured
    1.5e-3 after four steps)."""
    from repro_torch.launch import train as ttrain

    straight = [r["straight"] for r in runs["cli"]]
    assert all(s["error"] is None for s in straight), straight[0]["error"]
    losses = straight[0]["value"]
    assert all(s["value"] == losses for s in straight)
    out = straight[0]["stdout"].splitlines()
    assert out[:2] == ["training tinyllama-1.1b-smoke on mesh {'data': 8, "
                       "'model': 1} (8 devices) policy=w8a8",
                       "resumed from step 0"]
    assert all(s["stdout"] == "" for s in straight[1:])
    with np.load(runs["work"] / "batches.npz") as f:
        fed = {k: torch.from_numpy(f[k]) for k in f.files}
    monkeypatch.setattr(ttrain, "batch_at", lambda cfg, step, *a: {
        k: fed[f"{step}/{k}"] for k in ("tokens", "labels")})
    ck = tmp_path / "one"
    ck.mkdir()
    for suffix in (".npz", ".npz.json"):
        (ck / f"step_0{suffix}").write_bytes(
            (runs["work"] / "straight" / f"step_0{suffix}").read_bytes())
    _, one = ttrain.train("tinyllama-1.1b", steps=CLI_STEPS, seq_len=CLI_SEQ,
                          batch=CLI_BATCH, log_every=1, ckpt_dir=str(ck),
                          device="cpu")
    np.testing.assert_allclose(losses, one, rtol=1e-5)
    np.testing.assert_allclose(losses, runs["want"]["cli/losses"],
                               rtol=1e-2)


def test_a_resumed_run_at_eight_ranks_ends_where_a_straight_one_does(runs):
    straight, resumed = (runs["cli"][0][k] for k in ("straight", "resumed"))
    assert resumed["error"] is None, resumed["error"]
    assert resumed["stdout"].splitlines()[1] == "resumed from step 2"
    assert resumed["value"] == straight["value"][2:]
    work = runs["work"]
    with np.load(work / "straight" / "step_4.npz") as a, \
            np.load(work / "resumed" / "step_4.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            _bits(b[k], a[k], k)


def test_the_cli_trains_on_the_eight_rank_mesh(runs):
    cli = [r["cli"] for r in runs["cli"]]
    assert all(c["error"] is None for c in cli), cli[0]["error"]
    lines = cli[0]["stdout"].splitlines()
    assert lines[0] == ("training tinyllama-1.1b-smoke on mesh {'data': 8, "
                        "'model': 1} (8 devices) policy=w8a8")
    assert [ln.split()[:2] for ln in lines[1:]] == [["step", "0"],
                                                    ["step", "1"]]
    assert abs(float(lines[1].split()[3]) - np.log(256)) < 1.0
    assert all(c["stdout"] == "" for c in cli[1:])
