"""Multi-pod dry run (port of ``repro.launch.dryrun``): trace one rank's
step of every (arch x shape) cell on the production meshes, print its
memory and cost, emit roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \
        --shape train_4k [--multi-pod] [--policy w8a8_bf16] [--json out]

This is the one entry point of the port that runs on no device: each
cell is traced on the meta device (``launch.steps.lower_cell``), so
nothing is drawn or allocated and no card is needed.  Where the
reference lowers and compiles, the port traces and compiles nothing:
``compile`` prints 0.

The production mesh's 256 or 512 ranks live in this one process, as
the reference's forced host devices do: the mesh is taken by its names
and sizes (``distributed.sharding.MeshShape``), this process is its rank
0, and every collective is recorded where it starts
(``sharding.gather_over``) as copies of the rank's own value.  A fake
process group of 256 ranks would also run, but it replaces the
process's group (``launch.mesh`` keeps one for the process's life) and
needs a private module of torch's tests; the ``MeshShape`` touches no
process-wide state, so a dry run also works inside a process that
trains.

The figures are forecasts at an H100's data-sheet peaks
(``launch.roofline``), not measurements.  A cell that fails, on an op
with a data-dependent shape for one, is reported ``FAIL`` with the op
and the line of the port that ran it, and the exit code is 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.core.policy import get_policy
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import describe, production_mesh_shape
from repro_torch.launch.roofline import roofline_terms
from repro_torch.launch.steps import lower_cell


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             policy_name: str = "qforce8",
             dtype=torch.float32, verbose: bool = True) -> dict:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    skip = shape_applicable(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "status": skip}

    mesh = production_mesh_shape(multi_pod=multi_pod)
    policy = get_policy(policy_name)
    t0 = time.time()
    program, meta = lower_cell(cfg, shape, mesh, policy, dtype)
    t_lower = time.time() - t0
    t_compile = 0.0

    mem = hlo_analysis.memory_stats(program)
    cost = hlo_analysis.cost_terms(program)
    roof = roofline_terms(cfg, shape, mesh, cost)
    result = {
        "arch": arch, "shape": shape_name, "status": "ok",
        "mesh": mesh.shape,
        "step": meta["step"], "policy": policy_name,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": mem, "cost": cost, "roofline": roof,
        "hlo_ops": hlo_analysis.op_histogram(program),
    }
    if verbose:
        print(f"== {arch} x {shape_name} on {describe(mesh)} "
              f"[{meta['step']}, {policy_name}] ==")
        print(f"   lower {t_lower:.1f}s  compile {t_compile:.1f}s")
        print(f"   memory/device: "
              f"args {mem['argument_size_in_bytes']/2**30:.2f} GiB  "
              f"temps {mem['temp_size_in_bytes']/2**30:.2f} GiB  "
              f"total {mem['total_bytes']/2**30:.2f} GiB")
        print(f"   HLO flops/device {cost['flops']:.3e}  "
              f"bytes/device {cost['bytes']:.3e}  "
              f"collective bytes/device {cost['collective_bytes']:.3e}")
        print(f"   roofline: compute {roof['t_compute']:.2e}s  "
              f"memory {roof['t_memory']:.2e}s  "
              f"collective {roof['t_collective']:.2e}s  "
              f"-> bound: {roof['bound']}  "
              f"(model-flops util ceiling "
              f"{100 * roof['useful_flops_frac']:.0f}%)", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help=f"one of {sorted(ARCHS)} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {sorted(SHAPES)} or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--policy", default="qforce8")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--json", default=None, help="write results here")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16

    results, failures = [], 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(run_cell(arch, shape, mp,
                                            args.policy, dtype))
                except Exception as e:   # a failure here is a real bug
                    failures += 1
                    results.append({"arch": arch, "shape": shape,
                                    "multi_pod": mp, "status": "FAIL",
                                    "error": repr(e)[:500]})
                    print(f"!! FAIL {arch} x {shape} "
                          f"(multi_pod={mp}): {e}", file=sys.stderr)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    ok = sum(1 for r in results if r["status"] == "ok")
    skipped = sum(1 for r in results if r["status"].startswith("skip"))
    print(f"\n{ok} ok / {skipped} skipped / {failures} FAILED")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
