"""Batched RL policy serving from the command line (port of
``repro.launch.serve_policy``).

    PYTHONPATH=src python -m repro_torch.launch.serve_policy \
        --ckpt /path/to/dqn_run --policy w8 --episodes 200 \
        --slots 64 --batch-bucket 32 --check-parity

Loads a value-RL checkpoint written by either package (dqn, qrdqn or
ddpg, with TQC's critics or not; mlp or conv), packs the behaviour net
(the Q net, or the ddpg actor) to int8/int4 ``QTensor``s and serves a
bank of concurrent episode slots through the micro-batching engine on
the card (``--device cpu`` runs the plain PyTorch path instead),
reporting actions/s, p50/p99 per-request latency, mean episode return
and the packed model footprint.
``--check-parity`` first asserts that the served greedy actions are
bit-identical to the evaluation path (guaranteed at w8).
``--metrics-dir`` writes ``obs/v1`` ``serve`` windows (``serve.jsonl``,
one every ``--metrics-every`` loop steps) and ``--profile-dir`` a
``torch.profiler`` trace of the serving loop with its ``profile``
record.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

from repro_torch.device import DeviceLike
from repro_torch.obs import SCHEMA, JsonlSink, ProfileWindow
from repro_torch.serve import (PRECISIONS, PolicyServer, check_parity,
                               load_policy, serve_episodes)


def serve_policy(ckpt_dir: str, algo: Optional[str] = None,
                 net: Optional[str] = None,
                 env_name: Optional[str] = None,
                 step: Optional[int] = None,
                 precision: str = "w8", mode: str = "greedy",
                 temperature: float = 1.0, episodes: int = 100,
                 n_slots: int = 64, max_bucket: int = 32,
                 seed: int = 0, do_check_parity: bool = False,
                 verbose: bool = True, metrics_dir: Optional[str] = None,
                 metrics_every: int = 50, profile_dir: Optional[str] = None,
                 device: DeviceLike = None):
    policy = load_policy(ckpt_dir, algo=algo, net=net, env_name=env_name,
                         step=step, device=device)
    if verbose:
        print(f"serving {policy.algo}/{policy.net} on "
              f"{policy.env_name} (step {policy.step}, "
              f"precision {precision}, mode {mode}, "
              f"device {policy.device})")
    if do_check_parity:
        if precision == "fp32":
            raise ValueError("--check-parity compares a *packed* "
                             "precision against the eval path; use "
                             "--policy w8 (bit-exact) or w4")
        bad = check_parity(policy, precision, seed=seed)
        if verbose:
            print(f"parity vs evaluation at {precision}: "
                  f"{bad} mismatching actions")
        if precision == "w8" and bad:
            raise AssertionError(
                f"served w8 greedy actions diverged from the "
                f"evaluation path on {bad} observations — the packed "
                "weights no longer share evaluation's fxp8 grid")
    server = PolicyServer(policy, precision=precision, mode=mode,
                          temperature=temperature, max_bucket=max_bucket,
                          seed=seed)
    sink = None
    if metrics_dir:
        sink = JsonlSink(
            os.path.join(metrics_dir, "serve.jsonl"),
            run={"driver": "serve_policy", "algo": policy.algo,
                 "env": policy.env_name, "net": policy.net,
                 "precision": precision, "mode": mode,
                 "n_slots": n_slots, "max_bucket": max_bucket,
                 "seed": seed})
    prof = None
    if profile_dir:
        prof = ProfileWindow(profile_dir, device=policy.device)
        prof.tick(0)
    try:
        stats = serve_episodes(server, episodes, n_slots=n_slots, seed=seed,
                               telemetry=sink, flush_every=metrics_every)
    finally:
        if prof:
            prof.stop()
            if sink:
                sink.write({"schema": SCHEMA, "kind": "profile",
                            "t_wall": time.time(), "dir": profile_dir,
                            "window": [0, int(server._requests)]})
        if sink:
            sink.close()
    s = stats.server
    if verbose:
        mib = 1024 * 1024
        print(f"served {stats.episodes} episodes / "
              f"{stats.env_steps} env steps in {stats.wall_s:.2f}s "
              f"(mean return {stats.mean_return:.3f})")
        print(f"  actions/s      {s['actions_per_s']:.0f}")
        print(f"  latency p50    {s['p50_ms']:.3f} ms")
        print(f"  latency p99    {s['p99_ms']:.3f} ms")
        print(f"  model bytes    {s['model_bytes']:.0f} "
              f"({s['model_bytes'] / mib:.3f} MiB, "
              f"{s['compression']:.3f}x of fp32)")
        print(f"  jit programs   {s['jit_programs']:.0f} "
              f"(buckets <= {max_bucket})")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint dir (step_N.npz + .json sidecar)")
    ap.add_argument("--algo", default=None,
                    help="cross-check against the checkpoint metadata")
    ap.add_argument("--net", default=None,
                    help="cross-check against the checkpoint metadata")
    ap.add_argument("--env", default=None,
                    help="cross-check against the checkpoint metadata")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--policy", default="w8", choices=sorted(PRECISIONS),
                    help="serving precision (weight packing)")
    ap.add_argument("--mode", default="greedy",
                    choices=["greedy", "sample"])
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--episodes", type=int, default=100)
    ap.add_argument("--slots", type=int, default=64,
                    help="concurrent episode slots")
    ap.add_argument("--batch-bucket", type=int, default=32,
                    help="largest micro-batch bucket (pad-to-bucket "
                         "ladder is powers of two up to this)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-parity", action="store_true",
                    help="assert served greedy actions match the "
                         "evaluation path before serving")
    # observability (docs/observability.md)
    ap.add_argument("--metrics-dir", default=None,
                    help="write obs/v1 JSONL telemetry (serve.jsonl) here")
    ap.add_argument("--metrics-every", type=int, default=50,
                    help="loop steps per serve record (0: one record "
                         "for the whole run)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the serving "
                         "loop into this dir")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    serve_policy(args.ckpt, algo=args.algo, net=args.net,
                 env_name=args.env, step=args.step,
                 precision=args.policy, mode=args.mode,
                 temperature=args.temperature, episodes=args.episodes,
                 n_slots=args.slots, max_bucket=args.batch_bucket,
                 seed=args.seed, do_check_parity=args.check_parity,
                 metrics_dir=args.metrics_dir,
                 metrics_every=args.metrics_every,
                 profile_dir=args.profile_dir, device=args.device)


if __name__ == "__main__":
    main()
