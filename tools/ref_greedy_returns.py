"""Greedy-evaluation returns of the JAX reference's default training run.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/ref_greedy_returns.py \\
        [--seeds 0 1 2 3 4] [--port [--device cpu]]

Trains ``repro.rl.trainer.onpolicy.OnPolicyTrainer("cartpole",
iters=40, seed=s)`` (the defaults of ``python -m repro.launch.rl_train``:
ppo, the mlp agent, fxp8 actors, 32 envs x 128 steps) at each seed and
prints the greedy return of ``eval_policy`` (16 envs, 625 steps) and
the median.  ``chip_smoke.py`` holds the PyTorch port's training run on
the card to half of that median (``REF_GREEDY_RETURNS``).  The JAX run
needs JAX installed, so it runs off the card's machine; each seed takes
about 30 s on a CPU.  ``--port`` runs the same measurement on the
PyTorch port's ``repro_torch.rl.trainer.OnPolicyTrainer`` instead, on
the card as the port's entry points run unless ``--device cpu`` asks
for its plain path.
"""
from __future__ import annotations

import argparse
import statistics
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
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
        trainer = OnPolicyTrainer("cartpole", iters=40, seed=seed,
                                  verbose=False, **kw)
        state, _ = trainer.train()
        ret, n_ep = trainer.eval_policy(state.params)
        returns.append(ret)
        print(f"seed {seed}: greedy return {ret!r} over {n_ep} episodes "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"median {statistics.median(returns)!r} of {returns!r}")


if __name__ == "__main__":
    main()
