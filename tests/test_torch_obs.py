"""The port's telemetry against the JAX package's: metric buffers, the
obs/v1 JSONL schema (the port's files read by the reference's reader and
by ``tools/obs_summary.py``), summaries, profiler windows, and the
contract that instrumented training computes bitwise what plain
training does (``docs/observability.md``), on the CPU.

One value iteration is held against the reference's compiled one with
its metric buffer: from the reference's state and with its draws (the
machinery of ``tests/test_torch_value_train.py``), the counters equal,
the gauges within rtol=1e-6 and ε bitwise (the port's ``value.fma32``
is the compiled value).
"""
import importlib
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.rl.trainer.value import ValueTrainer as JValueTrainer
from repro_torch.launch import rl_train as tcli
from repro_torch.obs import (LATENCY_EDGES_S, SCHEMA, FixedHistogram,
                             JsonlSink, MetricSpec, ProfileWindow,
                             SpanClock, counter_add, flush, fmt_metrics,
                             gauge_max, gauge_set, hist_observe, log_edges,
                             read_records, render, summarize,
                             summarize_file, validate_record)
from repro_torch.rl.inference import build_env, make_value_agent
from repro_torch.rl.trainer import (OnPolicyTrainer, ValueTrainer, rl_train,
                                    value_train)
from repro_torch.rl.trainer.state import value_state
from repro_torch.serve import (PolicyServer, ServedPolicy,
                               serve_episodes)
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

value_train_tests = importlib.import_module("test_torch_value_train")


def _params_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _step_records(path):
    return [r for r in read_records(path) if r["kind"] == "step"]


def _assert_contiguous(windows, lo, hi):
    assert windows[0][0] == lo and windows[-1][1] == hi
    for (a, b), (c, d) in zip(windows, windows[1:]):
        assert b == c, f"gap between windows {[a, b]} and {[c, d]}"


def _load_cli():
    spec = importlib.util.spec_from_file_location(
        "obs_summary", os.path.join(ROOT, "tools", "obs_summary.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the metric buffer: 32-bit tensors, flush semantics, one host read
# ---------------------------------------------------------------------------


def test_metric_buffer_ops_and_flush_resets():
    spec = MetricSpec(counters=("steps",), gauges=("ret", "peak"),
                      hists=(("lat", (0.1, 1.0, 10.0)),))

    def update(buf, x):
        buf = counter_add(buf, "steps", 4)
        buf = gauge_set(buf, "ret", x)
        buf = gauge_max(buf, "peak", x)
        return hist_observe(spec, buf, "lat",
                            torch.tensor([0.05, 0.5, 5.0, 50.0]))

    buf = spec.init("cpu")
    first = update(buf, torch.tensor(2.5))
    # updates leave their input buffer as it was
    assert int(buf["counters"]["steps"]) == 0
    buf = update(first, 1.0)
    for leaf in tree_leaves(buf):
        assert leaf.dtype in (torch.int32, torch.float32)
    assert buf["counters"]["steps"].shape == ()
    metrics, hists, fresh = flush(spec, buf)
    assert metrics == {"steps": 8, "ret": 1.0, "peak": 2.5}
    assert hists == {"lat": {"edges": [0.1, 1.0, 10.0],
                             "counts": [2, 2, 2, 2]}}
    assert all(not leaf.any() for leaf in tree_leaves(fresh))
    m2, _, _ = flush(spec, fresh)
    assert m2["steps"] == 0 and m2["peak"] == 0.0
    assert flush(MetricSpec(), {})[:2] == ({}, {})


def test_metric_writes_leave_their_values_alone():
    """A gauge set from a tensor keeps its own copy: the caller's tensor
    keeps its dtype and device, and writing it in place later does not
    move the gauge."""
    spec = MetricSpec(counters=("n",), gauges=("ret", "size"))
    ret = torch.tensor(3.25, dtype=torch.float32)
    size = torch.tensor(7, dtype=torch.int32)
    n_ep = torch.tensor(5, dtype=torch.int64)
    buf = gauge_set(spec.init(), "ret", ret)
    buf = gauge_set(buf, "size", size)
    buf = counter_add(buf, "n", n_ep)
    ret.add_(1.0)
    size.add_(1)
    assert ret.dtype == torch.float32 and float(ret) == 4.25
    assert n_ep.dtype == torch.int64
    metrics, _, _ = flush(spec, buf)
    assert metrics == {"n": 5, "ret": 3.25, "size": 7.0}


@pytest.mark.parametrize("cls", [MetricSpec, jobs.MetricSpec])
def test_metric_spec_rejects_bad_shapes(cls):
    with pytest.raises(ValueError, match="duplicate"):
        cls(counters=("x",), gauges=("x",))
    with pytest.raises(ValueError, match="sorted"):
        cls(hists=(("h", (2.0, 1.0)),))
    with pytest.raises(ValueError, match="edge"):
        cls(hists=(("h", ()),))


def test_flush_matches_the_references():
    """The same writes into both packages' buffers flush to the same
    numbers (fp32 gauges, int32 counters and counts)."""
    import jax.numpy as jnp
    edges = (1e-3, 1e-2, 1e-1)
    rng = np.random.default_rng(0)
    vals = rng.lognormal(-4.0, 2.0, 64).astype(np.float32)
    x = np.float32(0.1) * np.float32(3.0)
    tspec = MetricSpec(counters=("c",), gauges=("g", "m"),
                       hists=(("h", edges),))
    jspec = jobs.MetricSpec(counters=("c",), gauges=("g", "m"),
                            hists=(("h", edges),))
    tb, jb = tspec.init(), jspec.init()
    for k in range(3):
        tb = counter_add(tb, "c", torch.tensor(k + 2, dtype=torch.int32))
        jb = jobs.counter_add(jb, "c", jnp.int32(k + 2))
        tb = gauge_set(tb, "g", torch.tensor(x * k))
        jb = jobs.gauge_set(jb, "g", jnp.float32(x * k))
        tb = gauge_max(tb, "m", float(vals[k]))
        jb = jobs.gauge_max(jb, "m", float(vals[k]))
        tb = hist_observe(tspec, tb, "h", torch.from_numpy(vals))
        jb = jobs.hist_observe(jspec, jb, "h", jnp.asarray(vals))
    assert flush(tspec, tb)[:2] == jobs.flush(jspec, jb)[:2]


# ---------------------------------------------------------------------------
# FixedHistogram, spans, console
# ---------------------------------------------------------------------------


def test_histogram_percentiles_track_numpy_within_resolution():
    rng = np.random.RandomState(0)
    samples = np.exp(rng.normal(-7.0, 1.0, size=2000))
    h, jh = FixedHistogram(), jobs.FixedHistogram()
    for s in samples:
        h.observe(float(s))
        jh.observe(float(s))
    for q in (10, 50, 90, 99):
        exact = float(np.percentile(samples, q))
        approx = h.percentile(q)
        assert exact / 1.2 <= approx <= exact * 1.2, (q, exact, approx)
        assert approx == jh.percentile(q)
    assert h.count == len(samples)
    assert np.isclose(h.mean(), samples.mean(), rtol=1e-6)
    assert h.to_dict() == jh.to_dict()


def test_histogram_state_is_bounded_and_ends_clamp():
    h = FixedHistogram(log_edges(1e-3, 1e0, per_decade=4))
    n_buckets = len(h.counts)
    for v in (1e-9, 5e-2, 1e6):
        for _ in range(100):
            h.observe(v)
    assert len(h.counts) == n_buckets
    assert h.counts[0] == 100 and h.counts[-1] == 100
    assert h.percentile(0) == pytest.approx(1e-9)
    assert h.percentile(100) == pytest.approx(1e6)
    d = h.to_dict()
    assert len(d["counts"]) == len(d["edges"]) + 1
    h.reset()
    assert h.count == 0 and not any(h.counts) and h.mean() == 0.0


def test_span_clock_and_taxonomy_and_fmt_metrics():
    clock = SpanClock()
    for phase in ("step", "step", "sync"):
        with clock(phase):
            pass
    spans = clock.drain()
    assert set(spans) == {"step", "sync"} and spans["step"] >= 0.0
    assert clock.drain() == {}
    from repro_torch.obs import SERVE_PHASES, TRAIN_PHASES
    assert (TRAIN_PHASES, SERVE_PHASES) == (jobs.TRAIN_PHASES,
                                            jobs.SERVE_PHASES)
    m = {"a": 1.23456, "b": 7, "c": "x"}
    assert fmt_metrics(m, ("a", "b", "z")) == \
        jobs.fmt_metrics(m, ("a", "b", "z")) == "a=1.235  b=7"


# ---------------------------------------------------------------------------
# the JSONL sink: schema, byte compatibility, append mode
# ---------------------------------------------------------------------------


def test_jsonl_roundtrip_append_and_bytes_match_the_reference(tmp_path):
    recs = [{"schema": "obs/v1", "kind": "step", "t_wall": 1.0, "step": 1,
             "window": [0, 2], "metrics": {"env_steps": 64,
                                           "return_mean": 9.5},
             "spans": {"step": 0.25},
             "hists": {"h": {"edges": [1.0], "counts": [0, 3]}}},
            {"schema": "obs/v1", "kind": "profile", "t_wall": 2.0,
             "dir": "/tmp/prof", "window": [0, 2]}]
    paths = {}
    for name, sink_cls in (("port", JsonlSink), ("ref", jobs.JsonlSink)):
        p = str(tmp_path / name / "m" / "train.jsonl")
        with sink_cls(p) as sink:
            sink.write(recs[0])
        with sink_cls(p) as sink:         # append mode: the same file
            sink.write(recs[1])
        paths[name] = p
    with open(paths["port"], "rb") as a, open(paths["ref"], "rb") as b:
        assert a.read() == b.read()
    got = read_records(paths["port"])
    assert [r["kind"] for r in got] == ["step", "profile"]
    assert jobs.read_records(paths["port"]) == got
    p = str(tmp_path / "meta.jsonl")
    JsonlSink(p, run={"algo": "dqn"}).close()
    assert jobs.read_records(p)[0]["run"] == {"algo": "dqn"}


MALFORMED = [
    ({"schema": "obs/v2", "kind": "step", "t_wall": 0.0}, "schema"),
    ({"schema": "obs/v1", "kind": "stepz", "t_wall": 0.0}, "kind"),
    ({"schema": "obs/v1", "kind": "meta", "t_wall": 0.0}, "run"),
    ({"schema": "obs/v1", "kind": "step", "t_wall": 0.0, "step": 1,
      "window": [3, 1], "metrics": {}, "spans": {}}, "window"),
    ({"schema": "obs/v1", "kind": "step", "t_wall": 0.0, "step": 1,
      "window": [0, 1], "metrics": {"x": True}, "spans": {}}, "number"),
    ({"schema": "obs/v1", "kind": "serve", "t_wall": 0.0,
      "window": [0, 1], "metrics": {}, "buckets": {},
      "hists": {"h": {"edges": [1.0], "counts": [1]}}}, "counts"),
    ({"schema": "obs/v1", "kind": "serve", "t_wall": 0.0,
      "window": [0, 1], "metrics": {},
      "hists": {"h": {"edges": [1.0], "counts": [0, -1]}},
      "buckets": {}}, "negative"),
    ({"schema": "obs/v1", "kind": "serve", "t_wall": 0.0,
      "window": [0, 1], "metrics": {}, "hists": {},
      "buckets": {"big": 3}}, "digit"),
]


@pytest.mark.parametrize("rec,err", MALFORMED)
def test_validate_record_rejects_what_the_reference_rejects(rec, err):
    with pytest.raises(ValueError, match=err) as mine:
        validate_record(rec)
    with pytest.raises(ValueError) as theirs:
        jobs.validate_record(rec)
    assert str(mine.value) == str(theirs.value)


def test_sink_refuses_to_write_invalid_records(tmp_path):
    sink = JsonlSink(str(tmp_path / "x.jsonl"))
    with pytest.raises(ValueError):
        sink.write({"schema": SCHEMA, "kind": "nope", "t_wall": 0.0})
    sink.close()
    assert read_records(sink.path) == []


# ---------------------------------------------------------------------------
# the contract: metrics do not perturb training
# ---------------------------------------------------------------------------

VALUE_KW = dict(iters=6, n_envs=8, rollout_len=4, verbose=False,
                replay_capacity=512, seed=5, learn_start=32, log_every=2,
                updates_per_iter=1, device="cpu")


@pytest.mark.parametrize("replay", ["uniform", "per"])
def test_value_train_bitwise_parity_and_jsonl_content(replay, tmp_path):
    """dqn with ``metrics_dir`` is bitwise identical to without, and the
    step windows tile [0, iters) with exact env-step counts; the
    reference's reader and ``obs_summary --validate`` accept the file."""
    p0, h0 = value_train("dqn", "cartpole", replay=replay, **VALUE_KW)
    m = str(tmp_path / "metrics")
    p1, h1 = value_train("dqn", "cartpole", replay=replay, metrics_dir=m,
                         **VALUE_KW)
    assert h0 == h1
    assert _params_equal(p0, p1)
    path = os.path.join(m, "train.jsonl")
    recs = read_records(path)
    assert recs == jobs.read_records(path)
    assert recs[0]["kind"] == "meta" and recs[0]["run"]["algo"] == "dqn"
    assert recs[0]["run"]["replay"] == replay
    steps = _step_records(path)
    _assert_contiguous([r["window"] for r in steps], 0, VALUE_KW["iters"])
    assert sum(r["metrics"]["env_steps"] for r in steps) == \
        VALUE_KW["iters"] * VALUE_KW["n_envs"] * VALUE_KW["rollout_len"]
    last = steps[-1]["metrics"]
    for key in ("return_mean", "epsilon", "replay_size", "steps_per_s",
                "staleness_max", "alive_frac", "sync_payload_bytes"):
        assert key in last
    assert ("replay_max_priority" in last) == (replay == "per")
    assert last["replay_size"] == 6 * 8 * 4
    assert all("step" in r["spans"] and "sync" in r["spans"] for r in steps)
    assert _load_cli().main([path, "--validate"]) == 0


def test_onpolicy_train_bitwise_parity(tmp_path):
    kw = dict(iters=4, n_envs=8, rollout_len=8, verbose=False, seed=2,
              log_every=2, algo="ppo", device="cpu")
    p0, h0 = rl_train("cartpole", **kw)
    m = str(tmp_path / "metrics")
    p1, h1 = rl_train("cartpole", metrics_dir=m, **kw)
    assert h0 == h1
    assert _params_equal(p0, p1)
    steps = _step_records(os.path.join(m, "train.jsonl"))
    _assert_contiguous([r["window"] for r in steps], 0, kw["iters"])
    assert sum(r["metrics"]["env_steps"] for r in steps) == 4 * 8 * 8
    assert sum(r["metrics"]["episodes"] for r in steps) > 0
    last = steps[-1]["metrics"]
    assert last["alive_frac"] == 1.0 and "sync_payload_bytes" in last
    assert last["return_mean"] == pytest.approx(h0[-1])


class _Stop(Exception):
    pass


class _Crashing(ValueTrainer):
    """A run that dies before its step 4 (after step 3's checkpoint)."""

    def step(self, iteration, state, packed, gen, g, stage_ctx, alive):
        if g == 4:
            raise _Stop
        return super().step(iteration, state, packed, gen, g, stage_ctx,
                            alive)


def test_resume_continues_metric_windows(tmp_path):
    """A resumed run appends to the same file, its first window starts
    exactly at the resume step, and its windows tile [resume, iters)."""
    d, m = str(tmp_path / "ck"), str(tmp_path / "metrics")
    kw = dict(VALUE_KW, ckpt_dir=d, metrics_dir=m, save_every=1,
              seed=11)
    with pytest.raises(_Stop):
        _Crashing(algo="dqn", env_name="cartpole", **kw).train()
    path = os.path.join(m, "train.jsonl")
    n_first = len(read_records(path))
    value_train("dqn", "cartpole", **kw)
    resumed = read_records(path)[n_first:]
    assert resumed[0]["kind"] == "meta"
    _assert_contiguous([r["window"] for r in resumed if r["kind"] == "step"],
                       4, kw["iters"])


def _reference_and_port_iteration(kw, g):
    """The reference's compiled value iteration with its metric buffer,
    and the port's from the reference's state and draws, both at global
    step ``g``: (reference flush, port flush, port's spec)."""
    jtr = JValueTrainer(**kw)
    jtr.metrics = jtr.metric_spec()
    jstate = jtr.init_state()
    before = jax.tree.map(np.asarray, jstate)
    key = jax.random.fold_in(jtr.key, g)
    jout = jtr.step(jtr.build_iteration(), jstate, jtr.pack(jstate), key,
                    g, None, None, jtr.metrics.init())
    ttr = ValueTrainer(device="cpu", **kw)
    spec = ttr.metric_spec()
    tstate = value_train_tests._port_state(ttr.init_state(), before)
    draws = value_train_tests.reference_value_draws(key, ttr,
                                                    ttr.size_after(0))
    it = ttr.build_iteration()
    p, t, o, b, est, obs, ret, n_ep = it(
        tstate.params, tstate.target, tstate.opt, tstate.replay,
        ttr.pack(tstate), tstate.est, tstate.obs, draws, g)
    # the writes train() makes after the step
    state = value_state(p, t, o, b, est, obs)
    mbuf = ttr.record(it, spec.init("cpu"), state, ret, n_ep, g, None)
    return (jobs.flush(jtr.metrics, jout[-1])[0], flush(spec, mbuf)[0],
            spec)


@pytest.mark.parametrize("replay", ["uniform", "per"])
def test_one_value_iteration_writes_the_references_metrics(replay):
    # ε anneals over iters * rollout_len / 2 = 96 steps; step 3's rate is
    # mid-anneal, where the compiled multiply-add rounds once
    kw = dict(algo="dqn", env_name="cartpole", iters=12, n_envs=8,
              rollout_len=16, replay_capacity=256, updates_per_iter=2,
              learn_start=8, verbose=False, seed=3, replay=replay)
    want, got, spec = _reference_and_port_iteration(kw, 3)
    assert set(got) == set(want) == set(spec.counters + spec.gauges)
    for name in spec.counters:
        assert got[name] == want[name], name
    assert got["episodes"] > 0
    assert np.float32(got["epsilon"]).tobytes() == \
        np.float32(want["epsilon"]).tobytes()
    for name in spec.gauges:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the profiler window
# ---------------------------------------------------------------------------


def test_profile_window_semantics_on_cpu(tmp_path):
    pw = ProfileWindow(str(tmp_path / "p"), start=2, steps=3)
    wins = []
    for g in range(8):
        wins.append(pw.tick(g))
        torch.ones(64).sum()
    assert [w for w in wins if w] == [(2, 5)] and pw.done
    assert pw.stop() is None and pw.tick(9) is None
    events = json.load(open(pw.trace_path))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    with pytest.raises(ValueError, match="steps"):
        ProfileWindow(str(tmp_path), steps=0)
    # stop() closes a window early, with the steps ticked so far
    early = ProfileWindow(str(tmp_path / "q"), start=0, steps=10)
    early.tick(0)
    early.tick(1)
    assert early.stop() == (0, 1) and os.path.exists(early.trace_path)


def test_trainer_profile_window_writes_trace_and_record(tmp_path):
    m, p = str(tmp_path / "m"), str(tmp_path / "p")
    rl_train("cartpole", iters=5, n_envs=4, rollout_len=4, verbose=False,
             log_every=2, metrics_dir=m, profile_dir=p, profile_start=1,
             profile_steps=2, device="cpu")
    recs = read_records(os.path.join(m, "train.jsonl"))
    prof = [r for r in recs if r["kind"] == "profile"]
    assert [r["window"] for r in prof] == [[1, 3]]
    assert prof[0]["dir"] == p
    assert os.listdir(p) == ["trace_1_3.json"]
    events = json.load(open(os.path.join(p, "trace_1_3.json")))[
        "traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


# ---------------------------------------------------------------------------
# serving: bounded latency state, bucket counters, telemetry windows
# ---------------------------------------------------------------------------


def _mlp_server(max_bucket=8):
    env = build_env("cartpole", "mlp")
    agent = make_value_agent("dqn", env.spec,
                             gen=torch.Generator().manual_seed(0),
                             net="mlp", device="cpu")
    policy = ServedPolicy.from_agent(agent, "cartpole")
    assert policy.device == torch.device("cpu")
    return PolicyServer(policy, precision="w8", max_bucket=max_bucket)


def test_server_latency_state_is_bounded():
    server = _mlp_server()
    n_buckets = len(server.latency_hist()["counts"])
    assert n_buckets == len(LATENCY_EDGES_S) + 1
    for _ in range(40):
        server.act(torch.zeros((8, 4)))
    assert len(server.latency_hist()["counts"]) == n_buckets
    s = server.stats()
    assert s["requests"] == 40 * 8
    assert s["p99_ms"] >= s["p50_ms"] > 0
    assert sum(server.latency_hist()["counts"]) == s["requests"]
    assert sum(server.bucket_requests().values()) == s["requests"]
    server.reset_stats()
    assert not any(server.latency_hist()["counts"])
    assert server.bucket_requests() == {}


def test_serve_episodes_telemetry_matches_stats(tmp_path):
    server = _mlp_server()
    path = str(tmp_path / "serve.jsonl")
    sink = JsonlSink(path, run={"algo": "dqn", "env": "cartpole"})
    st = serve_episodes(server, episodes=6, n_slots=8, seed=0,
                        telemetry=sink, flush_every=3)
    sink.close()
    s = st.server
    serves = [r for r in read_records(path) if r["kind"] == "serve"]
    assert len(serves) >= 2
    _assert_contiguous([r["window"] for r in serves], 0, s["requests"])
    assert sum(r["metrics"]["requests"] for r in serves) == s["requests"]
    assert sum(r["metrics"]["env_steps"] for r in serves) == st.env_steps
    assert sum(r["metrics"]["episodes"] for r in serves) == st.episodes
    buckets = {}
    for r in serves:
        for b, n in r["buckets"].items():
            buckets[int(b)] = buckets.get(int(b), 0) + n
    assert buckets == server.bucket_requests()
    # the windows drain every span: each record carries both phases and
    # the last leaves none behind
    assert all(set(r["spans"]) == {"infer", "env"} for r in serves)
    assert st.spans == {}
    rows = summarize_file(path)
    fields = next(f for t, _, f in rows if t == "obs/serve")
    assert fields["requests"] == s["requests"]
    for key in ("p50_ms", "p99_ms"):
        assert fields[key] == pytest.approx(s[key], rel=0.35)


# ---------------------------------------------------------------------------
# summaries: the port's files read the same in both packages
# ---------------------------------------------------------------------------


def _write_train_file(path):
    with JsonlSink(path, run={"algo": "dqn", "env": "cartpole"}) as s:
        s.write({"schema": "obs/v1", "kind": "step", "t_wall": 1.0,
                 "step": 1, "window": [0, 2],
                 "metrics": {"env_steps": 64, "episodes": 3,
                             "return_mean": 12.5},
                 "spans": {"step": 0.5, "sync": 0.1}})
        s.write({"schema": "obs/v1", "kind": "step", "t_wall": 2.0,
                 "step": 3, "window": [2, 4],
                 "metrics": {"env_steps": 64, "episodes": 2,
                             "return_mean": 20.0},
                 "spans": {"step": 0.3, "checkpoint": 0.1}})


def test_summarize_folds_step_records(tmp_path):
    p = str(tmp_path / "train.jsonl")
    _write_train_file(p)
    out = render(summarize(read_records(p)))
    assert "[obs/train] dqn/cartpole:" in out
    assert "iters=4" in out and "env_steps=128" in out
    assert "episodes=5" in out and "final_return=20.0" in out
    assert "steps_per_s=128.0" in out
    assert "step=0.8" in out and "sync=0.1" in out
    assert out == jobs.render(jobs.summarize(jobs.read_records(p)))


def test_port_runs_summarize_the_same_in_both_packages(tmp_path, capsys):
    """A port training run's ``train.jsonl`` (with a profile record) and
    a port serving run's ``serve.jsonl`` fold to the same rows in both
    packages, and ``tools/obs_summary.py`` renders and validates them."""
    m = str(tmp_path / "m")
    rl_train("cartpole", iters=3, n_envs=4, rollout_len=4, verbose=False,
             log_every=1, metrics_dir=m, profile_dir=str(tmp_path / "p"),
             device="cpu")
    server = _mlp_server()
    with JsonlSink(os.path.join(m, "serve.jsonl"),
                   run={"driver": "serve_policy", "algo": "dqn",
                        "env": "cartpole"}) as sink:
        serve_episodes(server, episodes=4, n_slots=4, telemetry=sink,
                       flush_every=2)
    cli = _load_cli()
    for name, tables in (("train", {"obs/train", "obs/spans",
                                    "obs/profile"}),
                         ("serve", {"obs/serve", "obs/buckets"})):
        path = os.path.join(m, f"{name}.jsonl")
        rows = summarize_file(path)
        assert rows == jobs.summarize_file(path)
        assert {t for t, _, _ in rows} == tables
        assert cli.main([path, "--validate"]) == 0
        assert cli.main([path]) == 0
    out = capsys.readouterr().out
    assert "[obs/train] ppo/cartpole: iters=3  env_steps=48" in out
    assert "[obs/serve] dqn/cartpole: requests=" in out


# ---------------------------------------------------------------------------
# the CLI's telemetry and profiler flags (they named the observability
# slice until it came)
# ---------------------------------------------------------------------------

SMALL_CLI = ["--device", "cpu", "--iters", "2", "--n-envs", "2",
             "--rollout-len", "4"]


@pytest.mark.parametrize("argv,writes", [
    (["--metrics-dir", "M"], "metrics"),
    (["--profile-dir", "P"], "trace"),
    (["--profile-dir", "P", "--profile-start", "1"], "trace"),
    (["--profile-dir", "P", "--profile-steps", "2", "--metrics-dir", "M"],
     "both"),
    (["--agent", "hrl", "--two-stage", "--env", "keydoor", "--metrics-dir",
      "M", "--profile-dir", "P", "--profile-start", "2"], "both"),
    (["--net", "conv", "--env", "catch", "--frame-stack", "2",
      "--metrics-dir", "M"], "metrics"),
    (["--algo", "dqn", "--learn-start", "4", "--metrics-dir", "M",
      "--profile-dir", "P"], "both"),
    (["--algo", "ddpg", "--env", "pendulum", "--learn-start", "4",
      "--profile-dir", "P", "--profile-steps", "2"], "trace")])
def test_observability_flags_run_on_cpu(argv, writes, tmp_path, capsys):
    argv = [str(tmp_path / a) if a in ("M", "P") else a for a in argv]
    tcli.main(SMALL_CLI + argv)
    assert "done in" in capsys.readouterr().out
    m, p = tmp_path / "M", tmp_path / "P"
    assert m.exists() == (writes in ("metrics", "both"))
    assert p.exists() == (writes in ("trace", "both"))
    iters = 4 if "--two-stage" in argv else 2
    if m.exists():
        recs = read_records(str(m / "train.jsonl"))
        assert recs == jobs.read_records(str(m / "train.jsonl"))
        steps = [r for r in recs if r["kind"] == "step"]
        _assert_contiguous([r["window"] for r in steps], 0, iters)
        assert sum(r["metrics"]["env_steps"] for r in steps) == iters * 8
        assert ([r["kind"] for r in recs].count("profile")
                == (writes == "both"))
    if p.exists():
        (trace,) = os.listdir(p)
        assert json.load(open(p / trace))["traceEvents"]


def test_trainers_take_the_references_profile_defaults():
    tr = OnPolicyTrainer(iters=1, n_envs=2, rollout_len=4, verbose=False,
                         device="cpu")
    assert (tr.profile_start, tr.profile_steps) == (0, 1)
    assert tr.metric_spec() == MetricSpec(
        counters=("env_steps", "episodes"),
        gauges=("return_mean", "alive_frac"))
    assert tr.run_meta()["algo"] == "ppo"
    vt = ValueTrainer(algo="dqn", replay="per", iters=1, n_envs=2,
                      rollout_len=4, verbose=False, device="cpu")
    assert vt.metric_spec().gauges == ("return_mean", "epsilon",
                                       "replay_size", "replay_max_priority")
