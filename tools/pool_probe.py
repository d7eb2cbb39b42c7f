#!/usr/bin/env python3
"""Phases 9-11's worker pool of ``chip_smoke.py`` alone: build the
kernels, then run the pool's 21 jobs (``worker_jobs``) once for each
WIDTH given, at most WIDTH processes at once, printing each job's wall,
the pool's wall and its jobs' CPU seconds, and checking each pool's
bars (greedy medians, launches, card vs CPU) as the script checks
them.  Needs one CUDA card; run from the repo root:

    python3 tools/pool_probe.py 8 6 4
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
        print("pool_probe: no CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for width in sys.argv[1:] or ["8"]:
        work = os.path.join(ROOT, "build", "pool_probe", width)
        results = cs._run_workers(torch, work, cs.worker_jobs(), int(width))
        cs.training_path(card, results)
        cs.pixel_training(card, results)
        cs.value_training(card, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
