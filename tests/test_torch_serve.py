"""The port's serving slice against the JAX package, end to end on the
CPU: checkpoints cross between the packages, the port's server answers
with the reference server's greedy actions at w8 and w4, and the port
imports neither ``jax`` nor ``repro``."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.nn.module import unbox
from repro.rl import inference as jinf
from repro.rl import nets as jnets
from repro.rl.rollout import init_envs as jinit_envs
from repro.serve import PolicyServer as JServer
from repro.serve import load_policy as jload
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.checkpoint import from_numpy_tree
from repro_torch.core.fxp import QTensor
from repro_torch.launch import serve_policy as tlaunch
from repro_torch.rl import inference as tinf
from repro_torch.rl import nets as tnets
from repro_torch.rl.rollout import init_envs as tinit_envs
from repro_torch.serve import (PolicyServer, bucket_for, bucket_sizes,
                               check_parity, load_policy, serve_episodes)

ROOT = pathlib.Path(__file__).resolve().parents[1]
K = 2                          # frame stack
WIDTH = dict(channels=(4, 8), hidden=16)
META = {"algo": "dqn", "env": "keydoor", "net": "conv", "frame_stack": K,
        "n_envs": 4, "schema": "trainstate/v1"}


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A conv-DQN checkpoint written by the JAX package: JAX-initialised
    params at a small width and a Welford carry from a few steps."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    env = jinf.build_env("keydoor", "conv", K)
    params = unbox(jnets.conv_q_init(jax.random.PRNGKey(3), env.obs_shape,
                                     4, **WIDTH))
    est, obs = jinit_envs(env, jax.random.PRNGKey(1), META["n_envs"])
    step = jax.jit(jax.vmap(env.step))
    for i in range(6):
        est, obs, *_ = step(est, jnp.full((META["n_envs"],), i % 4,
                                          jnp.int32))
    JManager(d).save(2, (params, None, None, None, est, obs),
                     metadata=META)
    return d


@pytest.fixture(scope="module")
def torch_ckpt(tmp_path_factory):
    """The same layout written by the port."""
    d = str(tmp_path_factory.mktemp("torch_ckpt"))
    env = tinf.build_env("keydoor", "conv", K)
    params = tnets.conv_q_init(torch.Generator().manual_seed(4),
                               env.obs_shape, 4, **WIDTH)
    est, obs = tinit_envs(env, 2, META["n_envs"], "cpu")
    gen = torch.Generator().manual_seed(5)
    for _ in range(6):
        est, obs, *_ = env.step(est, env.action_space.sample(
            gen, META["n_envs"]))
    TManager(d).save(3, (params, None, None, None, est, obs),
                     metadata=META)
    return d


def _obs(n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, 32, 32, 3 * K)).astype(np.float32)


@pytest.mark.parametrize("precision", ["w8", "w4"])
def test_jax_checkpoint_served_by_the_port(jax_ckpt, precision):
    jp, tp = jload(jax_ckpt), load_policy(jax_ckpt, device="cpu")
    assert (tp.algo, tp.net, tp.env_name, tp.frame_stack, tp.step) == \
        ("dqn", "conv", "keydoor", K, 2)
    np.testing.assert_array_equal(
        tp.params["torso"]["fc"]["w"].numpy(),
        np.asarray(jp.params["torso"]["fc"]["w"]))
    for a, b in zip(tp.norm_stats, jp.norm_stats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # 11 requests through max_bucket 8: a full bucket, then 3 padded to 4
    obs = _obs(11, seed=len(precision))
    jsrv = JServer(jp, precision=precision, max_bucket=8)
    tsrv = PolicyServer(tp, precision=precision, max_bucket=8)
    want = np.asarray(jsrv.act(jnp.asarray(obs)))
    got = tsrv.act(torch.from_numpy(obs))
    assert got.shape == (11,)
    np.testing.assert_array_equal(got.numpy(), want)
    # Q-values of one full bucket: the reference run op by op
    q_want = np.asarray(jp.agent.qvals(jsrv.served_params,
                                       jnp.asarray(obs[:8]),
                                       jsrv.apply_policy))
    q_got = tp.agent.qvals(tsrv.served_params, torch.from_numpy(obs[:8]),
                           tsrv.apply_policy).numpy()
    np.testing.assert_allclose(q_got, q_want, rtol=1e-6)
    assert set(tsrv.stats()) == set(jsrv.stats())
    assert tsrv.stats()["model_bytes"] == jsrv.stats()["model_bytes"]


def test_port_checkpoint_restores_in_the_reference(torch_ckpt):
    jp, tp = jload(torch_ckpt), load_policy(torch_ckpt, device="cpu")
    assert jp.metadata["step"] == 3 and jp.net == "conv"
    for path in (("torso", "convs", 1, "w"), ("q", "b")):
        a, b = jp.params, tp.params
        for p in path:
            a, b = a[p], b[p]
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(tp.norm_stats, jp.norm_stats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    obs = _obs(8, seed=9)
    want = JServer(jp, precision="w8", max_bucket=8).act(jnp.asarray(obs))
    got = PolicyServer(tp, precision="w8", max_bucket=8).act(
        torch.from_numpy(obs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serving_loop_and_parity_on_cpu(torch_ckpt):
    policy = load_policy(torch_ckpt, device="cpu")
    for precision in ("w8", "w4"):
        assert check_parity(policy, precision, n_obs=16) == 0
    with pytest.raises(ValueError, match="packed"):
        check_parity(policy, "fp32")
    server = PolicyServer(policy, precision="w8", max_bucket=4)
    st = serve_episodes(server, episodes=3, n_slots=6, max_env_steps=2000)
    assert st.episodes >= 3 and st.env_steps % 6 == 0
    s = st.server
    assert s["requests"] == st.env_steps
    # 6 slots = a bucket of 4 and a bucket of 2, both warmed
    assert s["jit_programs"] == 2.0
    assert server.bucket_requests() == {4: st.env_steps // 6 * 4,
                                        2: st.env_steps // 6 * 2}
    assert 0 < s["p50_ms"] <= s["p99_ms"]
    assert set(st.spans) == {"infer", "env"}
    sampler = PolicyServer(policy, precision="w4", mode="sample",
                           temperature=0.5, max_bucket=4)
    acts = sampler.act(torch.from_numpy(_obs(5, seed=1)))
    assert acts.shape == (5,) and ((acts >= 0) & (acts < 4)).all()
    with pytest.raises(ValueError, match="serving mode"):
        PolicyServer(policy, mode="beam")
    with pytest.raises(ValueError, match="precision"):
        policy.pack("w2")
    packed, pol = policy.pack("w4")
    assert pol.name == "w4a8" and packed["q"]["w"].bits == 4


def test_bucket_ladder():
    assert bucket_sizes(16) == [1, 2, 4, 8, 16]
    assert bucket_sizes(1) == [1]
    assert bucket_sizes(24) == [1, 2, 4, 8, 16, 24]
    sizes = bucket_sizes(16)
    assert [bucket_for(n, sizes) for n in (1, 3, 16, 40)] == [1, 4, 16, 16]
    with pytest.raises(ValueError, match="max_bucket"):
        bucket_sizes(0)


@pytest.mark.parametrize("kw,wrong,flag", [("algo", "qrdqn", "--algo"),
                                           ("net", "mlp", "--net"),
                                           ("env_name", "catch", "--env")])
def test_loader_names_the_mismatched_flag(torch_ckpt, kw, wrong, flag):
    with pytest.raises(ValueError, match=flag):
        load_policy(torch_ckpt, device="cpu", **{kw: wrong})


def test_loader_errors_and_unported_paths(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_policy(str(tmp_path / "none"), device="cpu")
    spec = tinf.build_env("keydoor", "conv", 1).spec
    agent = tinf.make_value_agent("qrdqn", spec, net="conv",
                                  gen=torch.Generator().manual_seed(0),
                                  device="cpu")
    assert agent.params["q"]["w"].shape == (128, 4 * 32)
    # a conv qrdqn checkpoint loads (its env state from the template:
    # this one saved none, so the normalizer is the template's)
    ck = str(tmp_path / "qrdqn")
    est, obs = tinit_envs(tinf.build_env("keydoor", "conv", 1), 0, 1, "cpu")
    TManager(ck).save(1, (agent.params, None, None, None, est, obs),
                      metadata={"algo": "qrdqn", "net": "conv",
                                "env": "keydoor"})
    served = load_policy(ck, device="cpu")
    assert (served.algo, served.net, served.step) == ("qrdqn", "conv", 1)
    assert torch.equal(served.params["q"]["w"], agent.params["q"]["w"])
    # --net mlp is the vector view (images flattened), as the
    # reference's; the classic-control envs build
    assert tinf.build_env("keydoor", "mlp").obs_shape == (3072,)
    assert tinf.build_env("pendulum", "mlp").obs_shape == (3,)
    with pytest.raises(ValueError, match="unknown net"):
        tinf.build_env("keydoor", "resnet")


def test_entry_points_need_cuda_unless_cpu_is_asked(torch_ckpt,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.serve_policy(torch_ckpt, episodes=1, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinit_envs(tinf.build_env("keydoor", "conv", 1), 0, 2)


def test_cli_serves_on_cpu(torch_ckpt, capsys):
    tlaunch.main(["--ckpt", torch_ckpt, "--policy", "w4", "--episodes",
                  "2", "--slots", "4", "--batch-bucket", "4",
                  "--check-parity", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "parity vs evaluation at w4: 0 mismatching actions" in out
    assert "actions/s" in out and "device cpu" in out


def test_from_numpy_tree_carries_qtensors():
    q = np.array([[1, -7], [3, 0]], np.int8)
    s = np.array([[0.5, 0.25]], np.float32)
    tree = from_numpy_tree({"w": (q, s, 4), "b": np.zeros(2, np.float32),
                            "l": [np.ones((1,), np.int32)]}, "cpu")
    assert isinstance(tree["w"], QTensor) and tree["w"].bits == 4
    assert torch.equal(tree["w"].qvalue, torch.from_numpy(q))
    assert tree["l"][0].dtype == torch.int32


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
