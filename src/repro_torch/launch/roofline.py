"""Roofline terms for an NVIDIA H100 SXM from one rank's traced step
(port of ``repro.launch.roofline``).

    compute term    = sum over dtypes of flops / that dtype's peak
                      + integer ops / the int8 peak   [per device]
    memory term     = bytes / HBM bandwidth            [per device]
    collective term = collective bytes / link bandwidth [per device]

``launch.hlo_analysis`` counts one rank's step, so no division by the
card count is needed.  MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D
(MoE) gives the useful-work ceiling; its ratio to the counted work
exposes redundant compute (the port runs the dense layers whole on
every rank of the "model" axis).

These terms are forecasts from the data sheet's peaks, not
measurements.  A 256-card mesh spans nodes: past one node of 8 cards
the links are InfiniBand, slower than NVLink's ``LINK_BW``, so the
collective term of a production mesh is a floor.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (ArchConfig, active_param_count,
                                      param_count)
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.distributed.sharding import mesh_shape

# NVIDIA H100 SXM5 data sheet, per card
PEAK_INT8 = 1979e12          # OP/s, int8 tensor cores, dense
PEAK_BF16 = 989.4e12         # FLOP/s, bf16 tensor cores, dense
PEAK_FP32 = 66.9e12          # FLOP/s, fp32 without TF32 (the port's fp32
#                              products, PERF.md section 5)
PEAK_FP64 = 66.9e12          # FLOP/s, fp64 tensor cores
HBM_BW = 3.35e12             # B/s, HBM3
LINK_BW = 450e9              # B/s, NVLink 4, one direction

# the compute rate of each floating dtype's products
PEAKS = {"bfloat16": PEAK_BF16, "float16": PEAK_BF16,
         "float32": PEAK_FP32, "float64": PEAK_FP64}


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6*N*D for train; 2*N*D for a forward-only step (prefill);
    2*N*D_new for decode (D = tokens processed by the step)."""
    n = active_param_count(cfg) if cfg.is_moe else param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    return 2.0 * n * shape.global_batch


def roofline_terms(cfg: ArchConfig, shape: ShapeConfig, mesh,
                   cost: Dict, peak_flops: float = PEAK_BF16,
                   peak_int8: float = PEAK_INT8,
                   hbm_bw: float = HBM_BW,
                   ici_bw: float = LINK_BW) -> Dict:
    """The three terms of one rank's step.  Each dtype's flops run at its
    rate in ``PEAKS`` (a cost without ``flops_by_dtype`` runs all its
    flops at ``peak_flops``); ``mfu_at_roofline`` is the reference's,
    against ``peak_flops``."""
    chips = mesh_shape(mesh).size
    by_dtype = cost.get("flops_by_dtype") or {"": cost["flops"]}
    t_compute = (sum(f / PEAKS.get(dt, peak_flops)
                     for dt, f in by_dtype.items())
                 + cost.get("int_ops", 0.0) / peak_int8)
    t_memory = cost["bytes"] / hbm_bw
    t_collective = cost["collective_bytes"] / ici_bw
    bound = max((("compute", t_compute), ("memory", t_memory),
                 ("collective", t_collective)), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    hlo_total = (cost["flops"] + cost.get("int_ops", 0.0)) * chips
    useful = mf / hlo_total if hlo_total else 0.0
    t_bound = max(t_compute, t_memory, t_collective)
    # model-flops utilization IF the roofline bound were achieved
    mfu_ceiling = (mf / (chips * peak_flops)) / t_bound if t_bound else 0
    return {
        "t_compute": t_compute,
        "t_memory": t_memory,
        "t_collective": t_collective,
        "bound": bound,
        "t_step": t_bound,
        "model_flops": mf,
        "hlo_flops_total": hlo_total,
        "useful_flops_frac": min(useful, 1.0),
        "mfu_at_roofline": mfu_ceiling,
        "chips": chips,
    }


def summarize(results) -> str:
    """Markdown table from a list of run_cell() dicts."""
    rows = ["| arch | shape | step | bound | t_comp (s) | t_mem (s) | "
            "t_coll (s) | t_step (s) | MFU@roof | useful/HLO |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in results:
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | - | "
                        f"{r['status']} | | | | | | |")
            continue
        f = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['step']} | {f['bound']} "
            f"| {f['t_compute']:.2e} | {f['t_memory']:.2e} "
            f"| {f['t_collective']:.2e} | {f['t_step']:.2e} "
            f"| {100 * f['mfu_at_roofline']:.1f}% "
            f"| {100 * f['useful_flops_frac']:.1f}% |")
    return "\n".join(rows)
