"""Greedy-evaluation returns of the JAX reference's training runs.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/ref_greedy_returns.py \\
        [--seeds 0 1 2 3 4] [--algo ppo] [--env cartpole] [--agent mlp] \\
        [--net mlp] [--frame-stack 1] [--two-stage] [--iters N] \\
        [--replay uniform|per] [--tqc-drop K] [--port [--device cpu]]

Trains the reference's trainer at each seed with the given run's flags
and the defaults of ``python -m repro.launch.rl_train`` otherwise, then
prints the greedy return of its evaluation (16 envs for 1.25x the env's
horizon) and the median.  ``--iters 0`` measures the untrained initial
params.

* ``--algo ppo|a2c`` (the default ppo) runs
  ``repro.rl.trainer.onpolicy.OnPolicyTrainer`` (fxp8 actors, 32 envs x
  128 steps, 40 iterations a stage) and evaluates with its fp32
  ``eval_policy``.  The defaults are the cartpole run; the two pixel
  runs are

      --env keydoor --agent hrl --two-stage     (E2HRL, 80 iterations)
      --env catch --net conv --frame-stack 4    (conv actor-critic)

* ``--algo dqn|qrdqn|ddpg`` runs ``repro.rl.trainer.value.ValueTrainer``
  (fxp8 behaviour actors, 32 envs x 8 steps, 300 iterations, replay
  capacity 50,000, n-step 3, 4 updates an iteration) and evaluates with
  ``value_eval(..., actor_policy="fxp8")``; over ``--net conv`` the
  evaluation freezes the run's merged normalizer statistics.  The value
  runs are

      --algo dqn                       (cartpole, uniform replay)
      --algo dqn --replay per
      --algo qrdqn --env catch --net conv --frame-stack 4
      --algo ddpg --env pendulum [--tqc-drop 2]

``chip_smoke.py`` holds the PyTorch port's runs on the card to bars
made from these medians (``REF_GREEDY_RETURNS``, ``PIXEL_RUNS``,
``VALUE_RUNS``).  The JAX run needs JAX installed, so it runs off the
card's machine.  ``--port`` runs the same measurement on the PyTorch
port's trainers instead, on the card as the port's entry points run
unless ``--device cpu`` asks for its plain path.
"""
from __future__ import annotations

import argparse
import statistics
import time

VALUE_ALGOS = ("dqn", "qrdqn", "ddpg")


def _onpolicy(args, kw):
    if args.port:
        from repro_torch.rl.trainer import OnPolicyTrainer
    else:
        from repro.rl.trainer.onpolicy import OnPolicyTrainer

    def run(seed):
        trainer = OnPolicyTrainer(
            args.env, args.agent,
            iters=40 if args.iters is None else args.iters, seed=seed,
            two_stage=args.two_stage, net=args.net,
            frame_stack_k=args.frame_stack, algo=args.algo, verbose=False,
            **kw)
        state, _ = trainer.train()
        return trainer.eval_policy(state.params)
    return run


def _value(args, kw):
    if args.port:
        from repro_torch.rl.envs.wrappers import (merge_norm_stats,
                                                  norm_stats_of)
        from repro_torch.rl.trainer import ValueTrainer, value_eval
    else:
        from repro.rl.envs.wrappers import merge_norm_stats, norm_stats_of
        from repro.rl.trainer.value import ValueTrainer, value_eval

    def run(seed):
        trainer = ValueTrainer(
            args.algo, args.env,
            iters=300 if args.iters is None else args.iters, seed=seed,
            net=args.net, frame_stack_k=args.frame_stack,
            replay=args.replay, tqc_drop=args.tqc_drop, verbose=False,
            **kw)
        state, _ = trainer.train()
        stats = (merge_norm_stats(norm_stats_of(state.est))
                 if args.net == "conv" else None)
        return value_eval(args.algo, args.env, state.params, n_envs=16,
                          actor_policy="fxp8", seed=0, net=args.net,
                          frame_stack_k=args.frame_stack, norm_stats=stats,
                          **kw)
    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--algo", default="ppo",
                    choices=["ppo", "a2c", *VALUE_ALGOS])
    ap.add_argument("--env", default="cartpole")
    ap.add_argument("--agent", default="mlp", choices=["mlp", "hrl"])
    ap.add_argument("--net", default="mlp", choices=["mlp", "conv"])
    ap.add_argument("--frame-stack", type=int, default=1)
    ap.add_argument("--two-stage", action="store_true")
    ap.add_argument("--iters", type=int, default=None,
                    help="iterations (a stage): default 40 on-policy, 300 "
                         "value; 0 evaluates the initial params")
    ap.add_argument("--replay", default="uniform", choices=["uniform", "per"])
    ap.add_argument("--tqc-drop", type=int, default=0)
    ap.add_argument("--port", action="store_true",
                    help="measure the PyTorch port instead of the reference")
    ap.add_argument("--device", default=None,
                    help="the port's device (with --port; default: the "
                         "card)")
    args = ap.parse_args(argv)
    if args.device is not None and not args.port:
        ap.error("--device picks the port's device: add --port")
    value = args.algo in VALUE_ALGOS
    if not value and (args.replay != "uniform" or args.tqc_drop):
        ap.error("--replay/--tqc-drop configure the value family")
    kw = {"device": args.device} if args.port else {}
    run = _value(args, kw) if value else _onpolicy(args, kw)

    returns = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        ret, n_ep = run(seed)
        returns.append(ret)
        print(f"seed {seed}: greedy return {ret!r} over {n_ep} episodes "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"median {statistics.median(returns)!r} of {returns!r}")


if __name__ == "__main__":
    main()
