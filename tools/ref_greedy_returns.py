"""Greedy-evaluation returns of the JAX reference's training runs.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/ref_greedy_returns.py \\
        [--seeds 0 1 2 3 4] [--env cartpole] [--agent mlp] [--net mlp] \\
        [--frame-stack 1] [--two-stage] [--iters 40] \\
        [--port [--device cpu]]

Trains ``repro.rl.trainer.onpolicy.OnPolicyTrainer`` at each seed with
the given run's flags and the defaults of ``python -m
repro.launch.rl_train`` otherwise (ppo, fxp8 actors, 32 envs x 128
steps, 40 iterations a stage), then prints the greedy return of its
``eval_policy`` (16 envs for 1.25x the env's horizon) and the median.
``--iters 0`` measures the untrained initial params.  The defaults are
the cartpole run; the two pixel runs are

    --env keydoor --agent hrl --two-stage     (E2HRL, 80 iterations)
    --env catch --net conv --frame-stack 4    (conv actor-critic)

``chip_smoke.py`` holds the PyTorch port's runs on the card to bars
made from these medians (``REF_GREEDY_RETURNS``, ``PIXEL_RUNS``).  The
JAX run needs JAX installed, so it runs off the card's machine.
``--port`` runs the same measurement on the PyTorch port's
``repro_torch.rl.trainer.OnPolicyTrainer`` instead, on the card as the
port's entry points run unless ``--device cpu`` asks for its plain
path.
"""
from __future__ import annotations

import argparse
import statistics
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--env", default="cartpole")
    ap.add_argument("--agent", default="mlp", choices=["mlp", "hrl"])
    ap.add_argument("--net", default="mlp", choices=["mlp", "conv"])
    ap.add_argument("--frame-stack", type=int, default=1)
    ap.add_argument("--two-stage", action="store_true")
    ap.add_argument("--iters", type=int, default=40,
                    help="iterations a stage; 0 evaluates the initial "
                         "params")
    ap.add_argument("--port", action="store_true",
                    help="measure the PyTorch port instead of the reference")
    ap.add_argument("--device", default=None,
                    help="the port's device (with --port; default: the "
                         "card)")
    args = ap.parse_args(argv)
    if args.device is not None and not args.port:
        ap.error("--device picks the port's device: add --port")
    if args.port:
        from repro_torch.rl.trainer import OnPolicyTrainer
        kw = {"device": args.device}
    else:
        from repro.rl.trainer.onpolicy import OnPolicyTrainer
        kw = {}

    returns = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        trainer = OnPolicyTrainer(
            args.env, args.agent, iters=args.iters, seed=seed,
            two_stage=args.two_stage, net=args.net,
            frame_stack_k=args.frame_stack, verbose=False, **kw)
        state, _ = trainer.train()
        ret, n_ep = trainer.eval_policy(state.params)
        returns.append(ret)
        print(f"seed {seed}: greedy return {ret!r} over {n_ep} episodes "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"median {statistics.median(returns)!r} of {returns!r}")


if __name__ == "__main__":
    main()
