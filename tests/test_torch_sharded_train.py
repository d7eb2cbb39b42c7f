"""The sharded fleet's training runs in the PyTorch port: one rank
against the unsharded path and the reference's checkpoints, and eight
ranks end to end through ``torchrun`` (the reference's subprocess tests,
tests/test_distributed_rl.py).

The eight-rank runs go in one ``torchrun`` launch of
``repro_torch.distributed.ranks`` (gloo, one CPU thread a rank), which
runs each job in turn on every rank and writes each rank's results; a
second launch, of the CLI at four ranks, is refused the eight-slot
checkpoint.  Each launch has a deadline that kills its whole session.
"""
import json
import os
from pathlib import Path
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.rl.trainer.value import ValueTrainer as JValueTrainer
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.distributed.ranks import torchrun
from repro_torch.launch import rl_train as tcli
from repro_torch.rl.actor_learner import collect, merge_results, slot_key
from repro_torch.rl.rollout import episode_returns
from repro_torch.rl.trainer import OnPolicyTrainer, ValueTrainer, rl_train
from repro_torch.rl.trainer.state import onpolicy_state
from repro_torch.tree import leaves_with_path, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
N_RANKS = 8
DEADLINE_S = 300



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch work is small: one intra-op thread, as on the
    spawned ranks, restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _bits(a):
    a = np.ascontiguousarray(_np(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb, strict=True):
        assert _np(x).dtype == _np(y).dtype
        np.testing.assert_array_equal(_bits(x), _bits(y))


PPO = dict(env_name="cartpole", iters=2, n_envs=16, rollout_len=8)
QRDQN = dict(algo="qrdqn", env_name="cartpole", n_envs=16, rollout_len=8,
             replay="per", replay_capacity=2048, learn_start=64,
             mesh_kind="host", sync="doublebuf", save_every=1,
             per_beta_iters=5)


# ---------------------------------------------------------------------------
# one rank (this process)
# ---------------------------------------------------------------------------


class _PlainCollect(OnPolicyTrainer):
    """The on-policy trainer with the one-device ``collect`` of the
    iteration (``mesh=None``), as the port trained before the mesh, or
    with the fleet's per-slot program (``slots`` slots, each its envs and
    its share of the draws, merged in slot order) in one process."""

    def __init__(self, slots=None, **kw):
        super().__init__(**kw)
        self.slots = slots

    def step(self, iteration, state, packed, gen, g, stage_ctx, alive):
        draws = self.draws(gen)
        n = self.slots or 1
        parts = [collect(packed, self.env, self.apply_fn, self.a_policy,
                         slot_key(draws.noise, d, n, dim=1),
                         slot_key(state.est, d, n),
                         slot_key(state.obs, d, n), self.rollout_len,
                         self.dist) for d in range(n)]
        res = merge_results(parts, torch.ones(n, dtype=torch.bool))[0]
        params, opt = iteration.learn_phase(state.params, state.opt, res,
                                            draws, stage_ctx, alive)
        ret, n_ep = episode_returns(res.traj)
        return (onpolicy_state(params, opt, res.final_env, res.final_obs),
                ret, n_ep)


def test_default_ppo_is_the_plain_collect_run(capsys):
    """``rl_train``'s default (``--mesh host``) at one rank: params and
    history bitwise those of the same run with the one-device collect,
    and the reference's banner."""
    kw = dict(iters=3, n_envs=8, rollout_len=16, device=CPU)
    p_mesh, h_mesh = rl_train(**kw)
    assert "mesh {'data': 1, 'model': 1} (1 devices): 1 actor slot(s) " \
        "x 8 envs" in capsys.readouterr().out
    state, h_plain = _PlainCollect(verbose=False, **kw).train()
    assert h_mesh == h_plain
    _same_trees(p_mesh, state.params)


@pytest.mark.parametrize("algo,replay,env_name", [
    ("dqn", "uniform", "cartpole"), ("qrdqn", "per", "cartpole"),
    ("qrdqn", "per", "catch"), ("ddpg", "uniform", "pendulum")])
def test_value_mesh_lockstep_is_the_unsharded_run(algo, replay, env_name):
    """``value_train(mesh_kind="host", sync="lockstep")`` at one rank:
    params, targets, optimizer state, the replay (the PER tree
    included), envs and history bitwise the unsharded run's (catch with
    the conv torso over 4 stacked frames)."""
    pixels = dict(net="conv", frame_stack_k=4) if env_name == "catch" \
        else {}
    kw = dict(algo=algo, env_name=env_name, replay=replay, iters=4,
              n_envs=4, rollout_len=4, replay_capacity=64,
              updates_per_iter=2, learn_start=8, verbose=False, device=CPU,
              **pixels)
    s_plain, h_plain = ValueTrainer(**kw).train()
    s_mesh, h_mesh = ValueTrainer(mesh_kind="host", sync="lockstep",
                                  **kw).train()
    assert h_mesh == h_plain
    _same_trees(tuple(s_mesh), tuple(s_plain))


def test_reference_one_device_mesh_checkpoint_restores(tmp_path):
    """The reference's ``--mesh host`` value run on one device stores its
    replay slot-major (leading axis 1); the port at one rank restores
    it with every leaf bitwise (the env keys excepted: each package's
    reset streams are its own), and resumes after it."""
    ck = str(tmp_path / "ck")
    kw = dict(algo="dqn", env_name="cartpole", replay="per", iters=2,
              n_envs=4, rollout_len=4, replay_capacity=64,
              updates_per_iter=2, learn_start=8, verbose=False,
              mesh_kind="host", sync="lockstep", per_beta_iters=3)
    JValueTrainer(ckpt_dir=ck, save_every=1, **kw).train()
    jtr = JValueTrainer(ckpt_dir=ck, **kw)
    jstate, _ = jtr.restore(JManager(ck), jtr.init_state())
    assert np.asarray(jstate.replay.store.ptr).shape == (1,)
    tr = ValueTrainer(ckpt_dir=ck, device=CPU, **kw)
    state, md = tr.restore(TManager(ck), tr.init_state())
    assert md["replay_slots"] == 1 and tr.resume_start(md) == 2
    want = jstate._replace(replay=jax.tree.map(lambda x: x[0],
                                               jstate.replay))
    for (path, a), b in zip(leaves_with_path(tuple(state)),
                            jax.tree.leaves(want), strict=True):
        if path[-1] != ".key":
            np.testing.assert_array_equal(_bits(a), _bits(b),
                                          err_msg=str(path))
    _, hist = ValueTrainer(ckpt_dir=ck, device=CPU,
                           **dict(kw, iters=3)).train()
    assert len(hist) == 1 and np.isfinite(hist[0])
    with pytest.raises(ValueError, match="unsharded replay"):
        plain = str(tmp_path / "plain")
        ValueTrainer(ckpt_dir=plain, save_every=1, device=CPU,
                     **dict(kw, mesh_kind=None)).train()
        ValueTrainer(ckpt_dir=plain, device=CPU, **dict(kw, iters=3)).train()


@pytest.mark.parametrize("argv,match", [
    (["--algo", "dqn", "--sync", "doublebuf"], "--mesh host"),
    (["--algo", "dqn", "--mesh", "host", "--mesh-devices", "2"],
     "exposes 1 device"),
    (["--algo", "dqn", "--mesh", "production"], "256 ranks")])
def test_cli_refuses_what_the_reference_refuses_on_one_rank(argv, match):
    with pytest.raises(ValueError, match=match):
        tcli.main(["--device", "cpu", "--iters", "1"] + argv)


def test_cli_value_mesh_defaults_to_doublebuf(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    tcli.main(["--device", "cpu", "--algo", "dqn", "--mesh", "host",
               "--iters", "2", "--n-envs", "4", "--rollout-len", "4",
               "--learn-start", "8", "--ckpt-dir", ck, "--save-every", "1"])
    out = capsys.readouterr().out
    assert "1 actor slot(s) x 4 envs" in out and "replay     16" in out
    md = TManager(ck).metadata()
    assert md["sync"] == "doublebuf" and md["replay_slots"] == 1


# ---------------------------------------------------------------------------
# eight ranks through torchrun
# ---------------------------------------------------------------------------


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """The eight-rank jobs in one torchrun launch: each rank's results
    and the checkpoint directory of the qrdqn run."""
    work = tmp_path_factory.mktemp("eight")
    ck = str(work / "ck")
    train = "repro_torch.rl.trainer:rl_train"
    value = "repro_torch.rl.trainer:value_train"
    jobs = [
        {"name": "ppo", "fn": train, "kwargs": dict(PPO, device="cpu")},
        {"name": "qrdqn", "fn": value,
         "kwargs": dict(QRDQN, iters=3, ckpt_dir=ck, device="cpu")},
        {"name": "resume", "fn": value,
         "kwargs": dict(QRDQN, iters=5, ckpt_dir=ck, device="cpu")},
        {"name": "autofit", "fn": train,
         "kwargs": dict(env_name="cartpole", iters=1, n_envs=12,
                        rollout_len=4, device="cpu")},
        {"name": "explicit", "fn": train,
         "kwargs": dict(env_name="cartpole", iters=1, n_envs=12,
                        rollout_len=4, mesh_devices=8, device="cpu")}]
    with open(work / "jobs.json", "w") as f:
        json.dump(jobs, f)
    rc, out, err = torchrun(["-m", "repro_torch.distributed.ranks",
                             str(work / "jobs.json"), str(work)],
                            N_RANKS, DEADLINE_S, str(ROOT), _env())
    assert rc == 0, err[-4000:]
    ranks = []
    for r in range(N_RANKS):
        with open(work / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, ck


def test_eight_rank_ppo_is_finite_and_bannered_once(eight):
    ranks, _ = eight
    res = ranks[0]["ppo"]
    assert res["error"] is None
    params, hist = res["value"]
    assert len(hist) == 2 and all(np.isfinite(h) for h in hist)
    assert res["stdout"].count("mesh {'data': 8, 'model': 1} (8 devices)") \
        == 1
    assert "8 actor slot(s) x 2 envs" in res["stdout"]
    for r in range(1, N_RANKS):
        assert ranks[r]["ppo"]["stdout"] == ""
        _same_trees(ranks[r]["ppo"]["value"][0], params)


def test_eight_rank_ppo_is_the_per_slot_program_on_one_rank(eight):
    """Eight ranks end with params and history bitwise those of one
    rank running the fleet's per-slot program (each slot's collect on
    its envs and its share of the draws, merged): every rank runs the
    learner on the same gathered trajectory.  (Not those of one slot
    of 16 envs: the fxp8 actor requantizes each activation on its
    tensor's absmax, per slot.)"""
    ranks, _ = eight
    params, hist = ranks[0]["ppo"]["value"]
    state, h_one = _PlainCollect(slots=N_RANKS, device=CPU, verbose=False,
                                 **PPO).train()
    assert hist == h_one
    _same_trees(params, state.params)


def test_eight_rank_value_run_checkpoints_and_resumes(eight):
    ranks, ck = eight
    res = ranks[0]["qrdqn"]
    assert res["error"] is None
    params, hist = res["value"]
    assert len(hist) == 3 and all(np.isfinite(h) for h in hist)
    assert "8 actor slot(s) x 2 envs" in res["stdout"]
    resumed = ranks[0]["resume"]
    assert resumed["error"] is None
    assert "resumed at iter 3" in resumed["stdout"]
    assert len(resumed["value"][1]) == 2
    md = TManager(ck).metadata()
    assert md["replay_slots"] == 8 and md["sync"] == "doublebuf"
    for r in range(1, N_RANKS):
        _same_trees(ranks[r]["resume"]["value"][0], resumed["value"][0])


def test_eight_rank_mesh_fits_odd_envs_unless_explicit(eight):
    """n_envs=12 on eight ranks: the default host mesh fits to six slots
    (ranks 6 and 7 take no part and return (None, [])); an explicit
    ``mesh_devices=8`` is refused."""
    ranks, _ = eight
    auto = ranks[0]["autofit"]
    assert auto["error"] is None and len(auto["value"][1]) == 1
    assert "6 actor slot(s) x 2 envs" in auto["stdout"]
    for r in (6, 7):
        assert ranks[r]["autofit"]["value"] == (None, [])
    for r in range(N_RANKS):
        assert "divisible" in ranks[r]["explicit"]["error"]


def test_four_ranks_refuse_the_eight_slot_checkpoint(eight):
    """The CLI under torchrun at four ranks, pointed at the eight-slot
    checkpoint, fails with the reference's message."""
    _, ck = eight
    rc, out, err = torchrun(
        ["-m", "repro_torch.launch.rl_train", "--device", "cpu", "--algo",
         "qrdqn", "--env", "cartpole", "--iters", "6", "--n-envs", "16",
         "--rollout-len", "8", "--replay", "per", "--replay-capacity",
         "2048", "--learn-start", "64", "--mesh", "host", "--sync",
         "doublebuf", "--per-beta-iters", "5", "--ckpt-dir", ck], 4,
        DEADLINE_S, str(ROOT), _env())
    assert rc != 0
    assert "was saved with 8 replay slot(s), but this run's mesh shards 4" \
        in err
