#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` alone: build the kernels, hold the
fxp8 actor's Q-MAC products against their plain version, then run the
sharded actor-learner fleet on a NCCL group of one rank (PPO through the
mesh against the plain collect, DQN, QR-DQN (conv, PER) and DDPG in
lockstep against their unsharded runs, QR-DQN with PER doublebuf twice,
the compressed gradient mean on the card against gloo on the CPU).
Needs one CUDA card; run from the repo root:

    python3 tools/fleet_probe.py
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("fleet_probe: no CUDA card", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    card = cs.card_line()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    from repro_torch import kernels
    worst = dict.fromkeys(kernels.WRAPPERS, 0.0)
    print(cs.check_training_kernels(torch, dev, worst), flush=True)
    t0 = time.perf_counter()
    print(cs.sharded_fleet(torch, dev, card), flush=True)
    print(f"sharded_fleet {time.perf_counter() - t0:.1f} s")
    print(f"probe wall {time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
