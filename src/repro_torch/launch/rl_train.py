"""Q-Actor RL training CLI (port of ``repro.launch.rl_train``):
quantized actors, a full-precision learner and an int8 weight sync
(the paper's Fig. 2 system), on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.rl_train
    PYTHONPATH=src python -m repro_torch.launch.rl_train --device cpu \\
        --iters 2 --n-envs 4 --rollout-len 8
    # the paper's E2HRL agent, two-stage PPO (40 iterations a stage)
    PYTHONPATH=src python -m repro_torch.launch.rl_train --env keydoor \\
        --agent hrl --two-stage
    # the conv actor-critic over the pixel pipeline
    PYTHONPATH=src python -m repro_torch.launch.rl_train --env catch \\
        --net conv --frame-stack 4 --algo ppo
    # the value family: replay, n-step targets, polyak targets
    PYTHONPATH=src python -m repro_torch.launch.rl_train --algo dqn \\
        [--replay per]
    PYTHONPATH=src python -m repro_torch.launch.rl_train --algo qrdqn \\
        --env catch --net conv --frame-stack 4
    PYTHONPATH=src python -m repro_torch.launch.rl_train --algo ddpg \\
        --env pendulum [--tqc-drop 2]
    # the sharded fleet over 8 gloo ranks on the CPU (one a slot)
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 8 -m repro_torch.launch.rl_train --device cpu \\
        --algo qrdqn --mesh host --n-envs 16 --replay per

The defaults are the reference's.  On-policy (``--algo ppo|a2c``): the
mlp agent (hidden 64), fxp8 actors, an 8-bit sync, lr 3e-3, 40
iterations (a stage) of 32 envs x 128 steps.  Value family (``--algo
dqn|qrdqn|ddpg``, :mod:`repro_torch.rl.trainer.value`): fxp8 behaviour
actors, lr 1e-3, 300 iterations of 32 envs x 8 steps, replay capacity
50,000, n-step 3, 4 updates an iteration, ``learn_start`` from the
algo's config (256), a checkpoint every 50.  ``--metrics-dir`` writes
``obs/v1`` telemetry (``train.jsonl``; ``tools/obs_summary.py`` renders
it) and ``--profile-dir`` a ``torch.profiler`` trace of
``--profile-steps`` iterations from ``--profile-start``; the run's params
stay bitwise those of a run without them.

``--mesh host`` runs the actor fleet over the host mesh, one slot a
rank: the on-policy family always does (its default), the value family
with ``--mesh`` (then ``--sync doublebuf`` by default, or ``lockstep``).
The ranks come from ``torchrun``'s environment; without a launcher the
world is one rank.  Rank 0 alone prints and writes.
"""
from __future__ import annotations

import argparse

from repro_torch.rl.envs import registered
from repro_torch.rl.inference import NETS, ON_POLICY_ALGOS, VALUE_ALGOS
from repro_torch.rl.replay import KINDS as REPLAY_KINDS
from repro_torch.rl.trainer import SYNC_MODES, rl_train, value_train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="ppo",
                    choices=list(ON_POLICY_ALGOS + VALUE_ALGOS))
    ap.add_argument("--env", default="cartpole", choices=list(registered()))
    ap.add_argument("--agent", default="mlp", choices=["mlp", "hrl"])
    ap.add_argument("--net", default="mlp", choices=list(NETS))
    ap.add_argument("--frame-stack", type=int, default=1,
                    help="stack the last K frames (conv net only)")
    ap.add_argument("--iters", type=int, default=None,
                    help="default: 40 (on-policy) / 300 (value-based)")
    ap.add_argument("--n-envs", type=int, default=32)
    ap.add_argument("--rollout-len", type=int, default=None,
                    help="default: 128 (on-policy) / 8 (value-based)")
    ap.add_argument("--actor-policy", default="fxp8")
    ap.add_argument("--fp32-actors", action="store_true")
    ap.add_argument("--comm-bits", type=int, default=8)
    ap.add_argument("--max-lag", type=int, default=1)
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 3e-3 (on-policy) / 1e-3 (value-based)")
    ap.add_argument("--two-stage", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=None)
    ap.add_argument("--mesh", default=None, choices=["host", "production"],
                    help="device mesh for the actor fleet (default: "
                         "host for on-policy; unset = single-device "
                         "for value-based)")
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="restrict the host mesh to the first N ranks")
    ap.add_argument("--sync", default=None, choices=list(SYNC_MODES),
                    help="sharded value weight sync: lockstep fences "
                         "every iteration; doublebuf overlaps the next "
                         "collect with the learner update (default "
                         "with a mesh)")
    # value-based knobs (--algo dqn|qrdqn|ddpg)
    ap.add_argument("--replay-capacity", type=int, default=50_000)
    ap.add_argument("--replay", default="uniform",
                    choices=list(REPLAY_KINDS),
                    help="replay backend: uniform circular, or per "
                         "(sum-tree proportional prioritization)")
    ap.add_argument("--per-alpha", type=float, default=0.6)
    ap.add_argument("--per-beta0", type=float, default=0.4)
    ap.add_argument("--per-beta-iters", type=int, default=None,
                    help="iterations to anneal beta to 1 over "
                         "(default: the whole run)")
    ap.add_argument("--tqc-drop", type=int, default=0,
                    help="ddpg: drop the top-k pooled target quantiles "
                         "(TQC; >0 switches the twin critics to "
                         "25-quantile heads)")
    ap.add_argument("--n-step", type=int, default=3)
    ap.add_argument("--updates-per-iter", type=int, default=4)
    ap.add_argument("--learn-start", type=int, default=None,
                    help="min replay size before updates (default: the "
                         "algo config's, 256)")
    # observability (docs/observability.md)
    ap.add_argument("--metrics-dir", default=None,
                    help="write obs/v1 JSONL telemetry (train.jsonl) "
                         "here; training stays bitwise identical")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace into this dir")
    ap.add_argument("--profile-start", type=int, default=0,
                    help="global step the profiler window opens at")
    ap.add_argument("--profile-steps", type=int, default=1,
                    help="iterations the profiler window spans")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu, the plain PyTorch path")
    args = ap.parse_args(argv)
    actor_policy = None if args.fp32_actors else args.actor_policy
    if args.algo not in VALUE_ALGOS and (args.replay != "uniform"
                                         or args.tqc_drop
                                         or args.sync is not None):
        raise ValueError(
            "--replay/--tqc-drop/--sync configure the value-based "
            f"replay loop; --algo {args.algo} is on-policy — drop "
            "these flags")
    if args.replay != "per" and (args.per_alpha != 0.6
                                 or args.per_beta0 != 0.4
                                 or args.per_beta_iters is not None):
        raise ValueError(
            "--per-alpha/--per-beta0/--per-beta-iters configure the "
            "prioritized backend and would be silently ignored — add "
            "--replay per (or drop them)")
    if args.algo in VALUE_ALGOS:
        if args.two_stage or args.agent == "hrl":
            raise ValueError("--two-stage/--agent hrl are on-policy "
                             "(PPO) features; value-based algos drive "
                             "the MLP nets")
        if args.sync is not None and args.mesh is None:
            raise ValueError("--sync configures the sharded weight "
                             "sync — add --mesh host")
        sync = args.sync or ("doublebuf" if args.mesh is not None
                             else "lockstep")
        value_train(args.algo, args.env,
                    iters=args.iters if args.iters is not None else 300,
                    n_envs=args.n_envs,
                    rollout_len=(args.rollout_len
                                 if args.rollout_len is not None else 8),
                    actor_policy=actor_policy,
                    lr=args.lr if args.lr is not None else 1e-3,
                    comm_bits=args.comm_bits, ckpt_dir=args.ckpt_dir,
                    save_every=(args.save_every
                                if args.save_every is not None else 50),
                    replay_capacity=args.replay_capacity,
                    n_step=args.n_step,
                    updates_per_iter=args.updates_per_iter,
                    learn_start=args.learn_start, net=args.net,
                    frame_stack_k=args.frame_stack, replay=args.replay,
                    per_alpha=args.per_alpha, per_beta0=args.per_beta0,
                    per_beta_iters=args.per_beta_iters,
                    tqc_drop=args.tqc_drop, mesh_kind=args.mesh,
                    mesh_devices=args.mesh_devices, sync=sync,
                    max_lag=args.max_lag,
                    metrics_dir=args.metrics_dir,
                    profile_dir=args.profile_dir,
                    profile_start=args.profile_start,
                    profile_steps=args.profile_steps, device=args.device)
        return
    rl_train(args.env, args.agent,
             args.iters if args.iters is not None else 40,
             args.n_envs,
             args.rollout_len if args.rollout_len is not None else 128,
             actor_policy,
             args.lr if args.lr is not None else 3e-3,
             args.comm_bits, args.max_lag,
             two_stage=args.two_stage, ckpt_dir=args.ckpt_dir,
             save_every=(args.save_every
                         if args.save_every is not None else 10),
             mesh_kind=args.mesh or "host", mesh_devices=args.mesh_devices,
             algo=args.algo, net=args.net, frame_stack_k=args.frame_stack,
             metrics_dir=args.metrics_dir, profile_dir=args.profile_dir,
             profile_start=args.profile_start,
             profile_steps=args.profile_steps, device=args.device)


if __name__ == "__main__":
    main()
