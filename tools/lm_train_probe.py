#!/usr/bin/env python3
"""Phases 17, 19, 21 and 22 of ``chip_smoke.py`` alone, with phases
3-4's training rows: build the kernels, hold ``qmac_i8`` at TinyLlama's
training products (M = 1,024) against its plain version and time them,
train TinyLlama-1.1B at full width through ``repro_torch.launch.train``
(on the one-rank host mesh) and profile a step, then one training step
card against CPU at 2 full-width layers and at every reduced config,
then phase 19: the mesh's training steps against the unsharded ones and
one full-width qwen3-moe layer through ``moe_shard_map``; phase 21: the
dry run's traces and forecasts against the card; phase 22: the
rematerialised step against the plain one, and a step at train_4k's
sequence length.  Needs one CUDA card; run from the repo root:

    python3 tools/lm_train_probe.py [PHASE ...] [--no-limits]

Given phases (of 17, 19, 21, 22) run alone; phases 19 and 22 then
start from TinyLlama's params drawn from seed 0 on the card.
``--no-limits`` lifts phases 21 and 22's time limits, to measure them.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PHASES = ("17", "19", "21", "22")


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_train_probe: no CUDA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if "--no-limits" in args:
        args.remove("--no-limits")
        cs.DRY_RUN_LIMIT_S = cs.REMAT_LIMIT_S = 3600
        cs.DRY_RUN_CELL_LIMIT_S = 3600
    phases = args or PHASES
    if set(phases) - set(PHASES):
        print(f"lm_train_probe: phases are {PHASES}", file=sys.stderr)
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
    params = None
    if "17" in phases:
        worst = {"qmac_i8": 0.0, "qmac_i8_deq": 0.0}
        print(cs.check_lm_train_kernels(torch, dev, worst), flush=True)
        for r in cs.time_lm_train_kernels(torch, dev):
            cs.print_row("qmac_i8", r)
        t0 = time.perf_counter()
        launches, params = cs.lm_training(torch, dev, card)
        print(launches, flush=True)
        print(f"lm_training {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        cs.lm_train_card_vs_cpu(torch, dev)
        print(f"card vs CPU {time.perf_counter() - t0:.1f} s", flush=True)
    elif "19" in phases or "22" in phases:
        from repro_torch.configs.registry import get_arch
        from repro_torch.models import transformer
        params = transformer.init(torch.Generator().manual_seed(0),
                                  get_arch(cs.LM_ARCH), device=dev)
    if "19" in phases:
        t0 = time.perf_counter()
        print(cs.lm_layout(torch, dev, card, params), flush=True)
        print(f"lm_layout {time.perf_counter() - t0:.1f} s", flush=True)
    cell = cs.start_production_cell() if "21" in phases else None
    forecasts = cs.start_remat_forecasts(torch, dev) \
        if "22" in phases else None
    try:
        if cell is not None:
            t0 = time.perf_counter()
            print(cs.dry_run_gate(torch, dev, card), flush=True)
            print(f"dry_run_gate {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "22" in phases:
            t0 = time.perf_counter()
            launches = cs.remat_against_plain(torch, dev, card, params)
            params = None
            print(cs.train_4k_step(torch, dev, card, launches, t0,
                                   forecasts), flush=True)
            print(f"remat phase {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if cell is not None:
            cs.finish_production_cell(*cell)
    finally:
        for proc in (cell, forecasts):
            if proc is not None:
                cs.stop(proc[0])
    print(f"probe wall {time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
