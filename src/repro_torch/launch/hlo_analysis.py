"""The cost model of one rank's step (port of
``repro.launch.hlo_analysis``): flops, integer ops, bytes and collective
traffic, and the step's memory.

The reference reads XLA's optimized HLO text.  The port runs eagerly, so
its "HLO" is the op trace that ``launch.steps.lower_cell`` records on the
meta device (:class:`Program`): one ``OpRecord`` for every PyTorch op,
kernel wrapper call and collective, in the order they ran (the recorder
of ``analysis.trace_audit``, made with ``costing=True``).  There is no
HLO text to parse and no ``while`` loop to scale: the Python layer walk
records each op as often as it runs.  So ``parse_module`` and
``_trip_count`` have no counterpart.

Counted:
  flops        2 * out * K of ``mm``, ``bmm``, ``addmm``, ``baddbmm``,
               ``mv`` and ``dot``, and of ``convolution`` (K its kernel
               volume; ``convolution_backward`` once for each gradient
               it computes), kept by the output's dtype (fp64 from
               ``core.exact`` in a bucket of its own)
  int_ops      each kernel call's integer products (on the meta device,
               the CPU or the card alike: Q-MAC's 2 * M * N * K,
               Q-Conv's 2 * out * KH * KW * C, the Q-LSTM cell's gate
               products) and ``_int_mm``'s
  bytes        operand + output bytes of every op and kernel call: each
               eager op reads its operands from HBM and writes its
               outputs there (a broadcast operand, stride 0, is read
               once).  Views and the ops that allocate without moving
               data cost 0, as the reference's ``_SKIP_BYTES`` kinds do
  collectives  bytes by the reference's kind, as
               ``distributed.sharding.gather_over`` files them: the bytes
               this rank receives, ``n - 1`` copies of its input

A kernel's plain version (the CPU's) is charged as its kernel: the ops
inside it are not recorded, so a CPU trace, a card trace and a meta
trace of one step give the same numbers.
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.analysis.trace_audit import OpRecord, OpRecorder, recording
from repro_torch.tree import tree_leaves

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

# the ops that move no data: allocation, ranges and reshapes of a fresh
# buffer (the reference's parameter/constant/iota/reshape kinds); view
# ops are found by their schema
_SKIP_BYTES = {"aten.empty", "aten.empty_like", "aten.empty_strided",
               "aten.new_empty", "aten.new_empty_strided", "aten.arange",
               "aten._unsafe_view", "aten.lift_fresh"}
# products: the index of the [.., K] operand whose last dim contracts
_DOTS = {"aten.mm": 0, "aten.bmm": 0, "aten.addmm": 1, "aten.baddbmm": 1,
         "aten.mv": 0, "aten.dot": 0, "aten._int_mm": 0}


def _numel(shape) -> int:
    return math.prod(shape)


def _nbytes(specs) -> int:
    return sum(n * dt.itemsize for _, dt, n in specs)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


@dataclasses.dataclass
class Program:
    """One rank's step, traced (on the meta device by ``lower_cell``;
    on a device to hold a forecast against it): the counterpart of the
    reference's lowered and compiled executable.  ``ops`` holds the
    records in order; the byte counts are this rank's."""

    ops: List[OpRecord]
    argument_bytes: int          # the inputs as this rank holds them
    output_bytes: int            # the outputs' storages
    temp_bytes: int              # peak live bytes the step allocated
    layout_argument_bytes: int   # the inputs' shards under the layout

    def as_text(self) -> str:
        """A readable listing: one line a record."""
        def sig(specs):
            return ", ".join(f"{_dtype_name(dt)}{list(s)}"
                             for s, dt, _ in specs)

        lines = []
        for i, r in enumerate(self.ops):
            tag = {"op": "", "kernel": "kernel ",
                   "collective": "collective "}[r.kind]
            extra = "" if r.extra is None else f"  ; {r.extra}"
            lines.append(f"%{i} = {tag}{r.name}({sig(r.ins)}) -> "
                         f"({sig(r.outs)}){extra}")
        return "\n".join(lines)


def _unique_bytes(tensors) -> int:
    seen: Dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _tensor_leaves(tree) -> List[torch.Tensor]:
    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif hasattr(leaf, "qvalue"):          # a QTensor
            out += [leaf.qvalue, leaf.scale]
    return out


def trace(step: Callable, args: Sequence, layout_argument_bytes: int = 0
          ) -> Program:
    """Run ``step(*args)`` once under a costing recorder and return its
    :class:`Program`.  On meta tensors nothing is allocated."""
    rec = OpRecorder(costing=True)
    try:
        with recording(rec):
            out = step(*args)
    except Exception as e:
        if rec.failed_op is None:
            raise
        op, where = rec.failed_op
        raise RuntimeError(f"{op} at {where}: {e}") from e
    # a Python int argument (a decode step's index) is the reference's
    # int32 scalar
    scalars = sum(4 for leaf in tree_leaves(list(args))
                  if isinstance(leaf, int) and not isinstance(leaf, bool))
    return Program(rec.records,
                   _unique_bytes(_tensor_leaves(list(args))) + scalars,
                   _unique_bytes(_tensor_leaves(out)), rec.peak_bytes,
                   layout_argument_bytes)


def _dot_flops(r: OpRecord) -> float:
    k = r.ins[_DOTS[r.name]][0][-1]
    return 2.0 * _numel(r.outs[0][0]) * k


def _conv_flops(r: OpRecord) -> float:
    """2 * out * (c_in / groups * kernel volume) for each product the
    op computes: the forward's one, the backward's input and weight
    gradients as its mask asks."""
    if r.name == "aten.convolution":
        out, weight = r.outs[0][0], r.ins[1][0]
        return 2.0 * _numel(out) * _numel(weight[1:])
    grad_out, weight = r.ins[0][0], r.ins[2][0]
    n = sum(bool(m) for m in r.extra[:2])
    return n * 2.0 * _numel(grad_out) * _numel(weight[1:])


class CostModel:
    """Totals over a :class:`Program`'s records."""

    def __init__(self, program: Program):
        self.program = program

    def totals(self) -> Dict[str, float]:
        flops: Dict[str, float] = {}
        t = {"flops": 0.0, "int_ops": 0.0, "bytes": 0.0,
             **{k: 0.0 for k in COLLECTIVE_OPS}}
        for r in self.program.ops:
            if r.kind == "collective":
                t[r.name] += (r.extra - 1) * _nbytes(r.ins)
                continue
            if r.kind == "kernel":
                t["int_ops"] += r.extra
            elif r.name in _DOTS or r.name in ("aten.convolution",
                                               "aten.convolution_backward"):
                f = _dot_flops(r) if r.name in _DOTS else _conv_flops(r)
                dt = r.outs[0][1]
                if dt.is_floating_point or dt.is_complex:
                    key = _dtype_name(dt)
                    flops[key] = flops.get(key, 0.0) + f
                    t["flops"] += f
                else:
                    t["int_ops"] += f
            if not r.view and r.name not in _SKIP_BYTES:
                t["bytes"] += _nbytes(r.ins) + _nbytes(r.outs)
        t["flops_by_dtype"] = flops
        t["collective_bytes"] = sum(t[k] for k in COLLECTIVE_OPS)
        return t


def collective_bytes(program: Program) -> Dict[str, float]:
    """Collective traffic by kind."""
    t = CostModel(program).totals()
    out = {k: t[k] for k in COLLECTIVE_OPS}
    out["total"] = t["collective_bytes"]
    return out


def op_histogram(program: Program,
                 ops: Optional[Sequence[str]] = None) -> Dict[str, int]:
    """Calls by name (``aten.mm``, ``qmac_i8``, ``all-gather``, ...):
    every name, or those of ``ops``."""
    hist = Counter(r.name for r in program.ops)
    if ops is None:
        return dict(sorted(hist.items()))
    return {op: hist.get(op, 0) for op in ops}


def cost_terms(program: Program) -> Dict[str, float]:
    """{flops, flops_by_dtype, int_ops, bytes, collective_bytes,
    collectives} of one rank's step."""
    t = CostModel(program).totals()
    return {
        "flops": t["flops"],
        "flops_by_dtype": t["flops_by_dtype"],
        "int_ops": t["int_ops"],
        "bytes": t["bytes"],
        "collective_bytes": t["collective_bytes"],
        "collectives": {k: t[k] for k in COLLECTIVE_OPS},
    }


def memory_stats(program: Program) -> Dict[str, float]:
    """The reference's keys, for one rank.  ``temp_size_in_bytes`` is the
    peak of the live bytes the step allocated, its outputs among them
    (they are allocated inside the step), so ``total_bytes`` (arguments
    + temps - aliases) is the step's peak footprint.  The port donates
    nothing (no aliases) and generates no code.
    ``layout_argument_bytes`` is what the same inputs would take a
    device under the layout's shardings (the counterpart of XLA's
    ``argument_size_in_bytes``)."""
    out = {
        "argument_size_in_bytes": float(program.argument_bytes),
        "output_size_in_bytes": float(program.output_bytes),
        "temp_size_in_bytes": float(program.temp_bytes),
        "generated_code_size_in_bytes": 0.0,
        "alias_size_in_bytes": 0.0,
    }
    out["total_bytes"] = (out["argument_size_in_bytes"]
                          + out["temp_size_in_bytes"]
                          - out["alias_size_in_bytes"])
    out["layout_argument_bytes"] = float(program.layout_argument_bytes)
    return out
