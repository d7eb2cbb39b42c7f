"""LM training of the PyTorch port, second file: the MoE, ssm and hybrid
families' step against the JAX package (the bars of
test_torch_lm_train.py), then the behaviour of
``launch.train``: the synthetic stream, a stopped and resumed run
against an uninterrupted one, resuming the reference's checkpoint, the
reference's whisper caveat, the device rule and the CLI."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import batch_at as jbatch_at
from repro.launch import train as jtrain
from repro_torch.data import DataConfig, batch_at, iterate, stream_seed
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.tree import leaves_with_path
from test_torch_lm_layers import bits_equal, one_library
from test_torch_lm_train import check_step

__all__ = ["one_library"]          # the fixture, requested by name

HERE = ["mamba2-2.7b", "mixtral-8x22b", "qwen3-moe-30b-a3b",
        "recurrentgemma-9b"]


@pytest.mark.parametrize("arch", HERE)
def test_train_step_matches_the_reference(request, monkeypatch, arch):
    check_step(request, monkeypatch, arch)


def test_compute_cast_keeps_fp32_gradients():
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import get_policy
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init

    cfg = get_arch("tinyllama-1.1b").reduced()
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    seen = []
    orig = tsteps.adamw_update
    tsteps.adamw_update = lambda g, *a, **kw: (seen.append(g),
                                               orig(g, *a, **kw))[1]
    try:
        batch = batch_at(DataConfig(cfg.vocab, 16, 2, 0), 0)
        new, _, stats = tsteps.make_train_step(
            cfg, None, get_policy("w8a8_bf16"))(params, adamw_init(params),
                                                batch)
    finally:
        tsteps.adamw_update = orig
    for (path, g), (_, p), (_, q) in zip(leaves_with_path(seen[0]),
                                         leaves_with_path(params),
                                         leaves_with_path(new)):
        assert g.dtype == p.dtype == q.dtype == torch.float32, path
    assert stats["loss"].dtype == torch.float32
    assert torch.isfinite(stats["loss"])


def test_microbatches_must_divide_the_batch():
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init

    cfg = get_arch("tinyllama-1.1b").reduced().replace(microbatches=2)
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    batch = batch_at(DataConfig(cfg.vocab, 8, 3, 0), 0)
    with pytest.raises(ValueError, match="does not split into 2"):
        tsteps.make_train_step(cfg, None, None)(params, adamw_init(params),
                                                batch)


def test_a_mesh_is_refused():
    """The steps take a mesh now: on the one-rank host mesh each returns
    what ``mesh=None`` returns, bit for bit (the training step's params,
    state and stats; the prefill's logits and caches; the decode step's
    logits)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import get_policy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import pad_caches
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_arch("tinyllama-1.1b").reduced()
    mesh = make_host_mesh(device="cpu")
    params = transformer.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    batch = batch_at(DataConfig(cfg.vocab, 16, 2, 0), 0)
    pol = get_policy("w8a8kv8")

    def same(a, b):
        for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
            bits_equal(x, y.numpy())

    same(*(tsteps.make_train_step(cfg, m, None)(params, adamw_init(params),
                                                batch)
           for m in (mesh, None)))
    pre = [tsteps.make_prefill_step(cfg, m, pol, 8)(params, batch)
           for m in (mesh, None)]
    same(*pre)
    token = pre[0][0].argmax(-1, keepdim=True).to(torch.int32)
    same(*(tsteps.make_decode_step(cfg, m, pol, 8)(
        params, pad_caches(tree_map(lambda t: t.clone(), pre[0][1]), 1),
        token, 16)[0] for m in (mesh, None)))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-large-v3"])
def test_prefill_and_decode_steps_are_the_models(arch):
    """``make_prefill_step`` takes the reference's batch dict (tokens,
    and frames for enc-dec) and ``make_decode_step`` its argument
    order; both return what the model's own functions do."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.policy import get_policy
    from repro_torch.launch.serve import pad_caches
    from repro_torch.models.registry import model_for

    cfg, pol = get_arch(arch).reduced(), get_policy("w8a8kv8")
    model = model_for(cfg)
    params = model.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8), generator=g)}
    if cfg.is_encdec:
        batch["frames"] = torch.randn((2, 8, cfg.d_model), generator=g)
    logits, caches = tsteps.make_prefill_step(cfg, None, pol, 8)(params,
                                                                  batch)
    with torch.no_grad():
        want, _ = model.prefill(params, batch if cfg.is_encdec
                                else batch["tokens"], cfg, pol, 8)
    assert torch.equal(logits, want)
    token = logits.argmax(-1, keepdim=True).to(torch.int32)
    caches = pad_caches(caches, 1)
    step = tsteps.make_decode_step(cfg, None, pol, 8)
    got, _ = step(params, caches, token, 8)
    assert got.shape == (2, logits.shape[-1])
    assert torch.isfinite(got).all()


# ---------------------------------------------------------------------------
# the synthetic stream
# ---------------------------------------------------------------------------

def test_batch_at_is_a_pure_function_of_seed_step_and_shard():
    cfg = DataConfig(vocab=300, seq_len=16, global_batch=8, seed=5)
    a = batch_at(cfg, 7)
    assert torch.equal(a["tokens"], batch_at(cfg, 7)["tokens"])
    assert a["tokens"].shape == a["labels"].shape == (8, 16)
    assert a["tokens"].dtype == a["labels"].dtype == torch.int32
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert 0 <= int(a["tokens"].min()) and int(a["labels"].max()) < 300
    others = [batch_at(cfg, 8), batch_at(DataConfig(300, 16, 8, 6), 7),
              batch_at(cfg, 7, (1, 2))]
    assert all(not torch.equal(o["tokens"][:4], a["tokens"][:4])
               for o in others)
    halves = [batch_at(cfg, 7, (k, 2)) for k in range(2)]
    assert all(h["tokens"].shape == (4, 16) for h in halves)
    assert not torch.equal(halves[0]["tokens"], halves[1]["tokens"])
    # rebuilt in any order, as after a restart
    stream = iterate(cfg, start_step=5)
    for step in (5, 6, 7):
        assert torch.equal(next(stream)["labels"],
                           batch_at(cfg, step)["labels"])
    assert stream_seed(5, 7, 0) != stream_seed(5, 7, 1)
    assert stream_seed(-1, 0, 0) == stream_seed(2**64 - 1, 0, 0)
    # the reference's batches: the same shapes, dtypes and shift
    ref = jbatch_at(JDataConfig(300, 16, 8, 5), 7, (1, 2))
    assert ref["tokens"].shape == halves[1]["tokens"].shape
    assert str(ref["tokens"].dtype) == "int32"
    np.testing.assert_array_equal(np.asarray(ref["tokens"])[:, 1:],
                                  np.asarray(ref["labels"])[:, :-1])


def test_tokens_are_uniform():
    cfg = DataConfig(vocab=64, seq_len=256, global_batch=64, seed=0)
    counts = torch.bincount(batch_at(cfg, 0)["tokens"].reshape(-1).long(),
                            minlength=64).double()
    expect = counts.sum() / 64
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 120          # 63 degrees of freedom: p ~ 4e-5


# ---------------------------------------------------------------------------
# train()
# ---------------------------------------------------------------------------

KW = dict(seq_len=16, batch=2, log_every=1, seed=3, device="cpu")


class Stop(Exception):
    pass


def test_a_resumed_run_equals_an_uninterrupted_one(tmp_path, monkeypatch,
                                                    capsys):
    """Stopped after 4 of 6 steps (checkpoints after steps 2 and 4),
    then resumed to 6: the params bit for bit those of 6 straight
    steps, the resumed run's losses those of steps 4 and 5."""
    straight, losses = ttrain.train("tinyllama-1.1b", steps=6, **KW)
    ckpt = str(tmp_path / "ck")
    orig = ttrain.batch_at

    def stop_at_4(cfg, step, *a):
        if step == 4:
            raise Stop
        return orig(cfg, step, *a)

    monkeypatch.setattr(ttrain, "batch_at", stop_at_4)
    with pytest.raises(Stop):
        ttrain.train("tinyllama-1.1b", steps=6, ckpt_dir=ckpt,
                     save_every=2, **KW)
    assert sorted(os.listdir(ckpt)) == [
        "LATEST", "step_2.npz", "step_2.npz.json", "step_4.npz",
        "step_4.npz.json"]
    monkeypatch.setattr(ttrain, "batch_at", orig)
    capsys.readouterr()
    resumed, tail = ttrain.train("tinyllama-1.1b", steps=6, ckpt_dir=ckpt,
                                 save_every=2, **KW)
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "resumed from step 4"
    assert [ln.split()[1] for ln in out[2:]] == ["4", "5"]
    assert tail == losses[4:]
    for (path, a), (_, b) in zip(leaves_with_path(resumed),
                                 leaves_with_path(straight), strict=True):
        bits_equal(a, b.numpy())
    assert sorted(os.listdir(ckpt))[-2:] == ["step_6.npz",
                                             "step_6.npz.json"]


def test_resumes_the_references_checkpoint(tmp_path, capsys):
    """The reference's ``train`` writes its final checkpoint; the port's
    resumes it at the same step, with the same tree, bit for bit."""
    ckpt = str(tmp_path / "ck")
    want, _ = jtrain.train("tinyllama-1.1b", steps=2, seq_len=16, batch=2,
                           ckpt_dir=ckpt, seed=3)
    capsys.readouterr()
    got, losses = ttrain.train("tinyllama-1.1b", steps=2, ckpt_dir=ckpt,
                               **KW)
    assert capsys.readouterr().out.splitlines()[1] == \
        "resumed from step 2"
    assert losses == []
    want = dict(leaves_with_path(jax.tree.map(np.asarray, want)))
    got = dict(leaves_with_path(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        bits_equal(got[path], w)
    # and the port trains on from it
    _, more = ttrain.train("tinyllama-1.1b", steps=3, ckpt_dir=ckpt, **KW)
    assert len(more) == 1 and np.isfinite(more[0])


def test_whisper_needs_frames_in_both_packages():
    """The synthetic batches carry no audio frames, so both packages'
    ``train`` stop at the encoder with the same ``KeyError``."""
    with pytest.raises(KeyError, match="'frames'"):
        jtrain.train("whisper-large-v3", steps=1, seq_len=16, batch=2)
    with pytest.raises(KeyError, match="'frames'"):
        ttrain.train("whisper-large-v3", steps=1, **KW)


def test_train_runs_on_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train("tinyllama-1.1b", steps=1)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-2.7b",
                                  "recurrentgemma-9b", "chameleon-34b"])
def test_every_trainable_family_trains(arch):
    """Three steps of each trainable family's reduced config: finite
    losses, the last at most the first + 1 (the reference's own bar of
    not diverging)."""
    _, losses = ttrain.train(arch, steps=3, **KW)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] <= losses[0] + 1.0


def test_cli_reaches_the_reduced_config(monkeypatch):
    """``--smoke`` is store_true with a default of True in both CLIs, so
    both train the reduced config; ``python -m`` on the port prints the
    reference's lines."""
    seen = []
    monkeypatch.setattr(jtrain, "train", lambda *a, **kw: seen.append(a))
    monkeypatch.setattr(ttrain, "train", lambda *a, **kw: seen.append(a))
    jtrain.main(["--arch", "tinyllama-1.1b"])
    ttrain.main(["--arch", "tinyllama-1.1b", "--device", "cpu"])
    assert seen[0] == seen[1] == ("tinyllama-1.1b", 50, True, "w8a8", 128,
                                  8, None, 20, 3e-4)
    ttrain.main(["--arch", "tinyllama-1.1b", "--fp32", "--device", "cpu"])
    assert seen[2][3] is None
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "tinyllama-1.1b", "--steps", "3", "--device", "cpu"],
        capture_output=True, text=True, check=True, timeout=120, env=env)
    lines = out.stdout.splitlines()
    assert lines[0] == ("training tinyllama-1.1b-smoke on mesh {'data': 1, "
                        "'model': 1} (1 devices) policy=w8a8")
    assert [ln.split()[:2] for ln in lines[1:]] == [["step", "0"],
                                                    ["step", "2"]]
    loss = float(lines[1].split()[3])
    assert abs(loss - np.log(256)) < 1.0
