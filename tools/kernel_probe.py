#!/usr/bin/env python3
"""Probes of the port's redesigned kernels on one CUDA card.

    python3 tools/kernel_probe.py split       # Q-MAC ms against K slices
    python3 tools/kernel_probe.py stages      # Q-Conv block stage cycles
    python3 tools/kernel_probe.py ew          # V-ACT ms against its plan
    python3 tools/kernel_probe.py cell        # Q-LSTM ms against its plan
    python3 tools/kernel_probe.py softmax     # V-ACT softmax by kernel plan
    python3 tools/kernel_probe.py q8          # V-ACT int8 by chunks a thread
    python3 tools/kernel_probe.py pair [SRC]  # V-ACT, Q-LSTM, LSTM-HRL of
                                              # the tree at SRC

Run from a checkout on the machine with the card (it needs ``nvcc``).

``split`` times the fused Q-MAC at the serving and HRL shapes for every
number of K slices from 1 to 64 that cuts K into 16-byte multiples,
next to what ``split_plan`` picks, each held bitwise against the plain
version.  ``stages`` builds a copy of ``qconv.cu`` that stamps
``clock64`` after each stage of every block (input staged; scales and
weights staged, after the barrier; taps and output done) into
``build/kernel_probe/``, runs it at the four stem shapes of
``chip_smoke.py`` phase 4 and prints the median and largest cycles of
each stage over the blocks.  ``ew`` times V-ACT's elementwise kernel at
the HRL path's three calls ([512, 8], [128, 32] and the [128, 32] gate
slice of [128, 128], tanh, n = 6) and at 2^24 elements, for 32-256
threads a block; ``cell`` times the Q-LSTM cell at
(B, Din, H) = (128, 32, 32), n = 6, for 1-8 rows by 4 or 8 units a
block; both hold every plan bitwise against the plain version and mark
what the planner picks.  ``softmax`` times V-ACT's softmax at [512, 4]
(the rows kernel at 4-32 lanes a row and 32-256 threads a block),
[4096, 1024], [4096, 8192] and [256, 65536] (the block kernel at 32-1024
threads with the row staged whole, half staged or not at all, and the
planned launch with rows 16-byte aligned or not), within rtol 1e-6 of
the plain version; ``q8`` times the int8 table kernel at [512, 8] and
2^26 elements for 1-64 16-byte chunks a thread, bitwise; both mark what
the planner picks.  ``pair`` runs phase 4's V-ACT and Q-LSTM rows (the
softmax and int8 rows past the path's sizes too) and phase 8's LSTM-HRL
profiles at pallas and xla with the ``repro_torch`` package under SRC
(default: this checkout's ``src``), so a parent tree unpacked beside
this one is timed by the same code on the same card.  All print the
card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

STEM_SHAPES = ((32, 32, 12, 16), (32, 16, 16, 32),    # DQN conv1, conv2
               (512, 32, 3, 16), (512, 16, 16, 32))   # HRL conv1, conv2


def split(torch, cs, dev):
    from repro_torch.kernels.qmac import ops as Q

    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for m, k, n in ((32, 2048, 128), (1, 2048, 128), (512, 512, 32),
                    (32, 128, 4)):
        qx, qw = cs._i8(torch, g, dev, (m, k)), cs._i8(torch, g, dev, (k, n))
        sx = torch.rand((m, 1), generator=g, device=dev)
        sw = torch.rand((1, n), generator=g, device=dev)
        want = Q.qmac_i8_deq_plain(qx, sx, qw, sw).view(torch.int32)
        out = torch.empty((m, n), device=dev)
        tiles = Q.split_plan(m, k, n).tiles
        cells = []
        for s in (1, 2, 4, 8, 16, 32, 64):
            sl = -(-(-(-k // s)) // 16) * 16
            if -(-k // sl) != s:
                continue
            plan = Q.SplitPlan(s, sl if s > 1 else k, tiles)
            ws, cnt = (Q._workspace(dev, stream, plan) if s > 1
                       else (None, None))

            def run():
                code = Q._lib()(
                    0, stream, qx.data_ptr(), qw.data_ptr(), sx.data_ptr(),
                    sw.data_ptr(), 1, out.data_ptr(), m, n, k, 1, s,
                    plan.slice, ws.data_ptr() if ws is not None else None,
                    ws.numel() if ws is not None else 0,
                    cnt.data_ptr() if cnt is not None else None,
                    cnt.numel() if cnt is not None else 0)
                if code:
                    raise RuntimeError(f"launch failed with {code}")

            run()
            if not torch.equal(out.view(torch.int32), want):
                raise AssertionError(f"{s} slices differ at {(m, k, n)}")
            cells.append(f"{s}: {cs.device_ms(torch, run):.5f}")
        print(f"qmac_i8_deq M={m} K={k} N={n}, split_plan takes "
              f"{Q.split_plan(m, k, n).splits}; ms by slices: "
              + ", ".join(cells))


STAMPS = '''
__device__ unsigned long long g_stamp[1 << 20];
#define STAMP(k) do { __syncthreads(); if (threadIdx.x == 0) \\
  g_stamp[blockIdx.x * 4 + (k)] = clock64(); } while (0)
'''


def instrumented_source() -> str:
    src = open(os.path.join(ROOT, "src/repro_torch/kernels/qconv/csrc/"
                            "qconv.cu")).read()
    marks = [("namespace {\n", "namespace {\n" + STAMPS),
             ("  int blk = blockIdx.x;\n",
              "  STAMP(0);\n  int blk = blockIdx.x;\n"),
             ("  // their per-pixel scales, [row][w]\n",
              "  STAMP(1);\n  // their per-pixel scales, [row][w]\n"),
             ("  __syncthreads();\n\n  const int* x32",
              "  __syncthreads();\n  STAMP(2);\n\n  const int* x32")]
    for old, new in marks:
        if src.count(old) != 1:
            raise RuntimeError(f"qconv.cu changed: no single {old!r}")
        src = src.replace(old, new)
    end = src.rindex("\n}\n", 0, src.index("}  // namespace"))
    src = src[:end] + "\n  STAMP(3);" + src[end:]
    return src + '''
extern "C" int qforce_probe_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamp, n * 4 * 8);
}
'''


def stages(torch, cs, dev):
    from repro_torch.kernels import _build
    from repro_torch.kernels.qconv import ops as Q

    out_dir = os.path.join(ROOT, "build", "kernel_probe")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "qconv_stamped.cu")
    so = os.path.join(out_dir, "libqconv_stamped.so")
    with open(cu, "w") as f:
        f.write(instrumented_source())
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    fn = lib.qforce_qconv_i8
    fn.argtypes = Q._lib().argtypes
    lib.qforce_probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for bsz, h, c, nc in STEM_SHAPES:
        qx = cs._i8(torch, g, dev, (bsz, h, h, c))
        qw = cs._i8(torch, g, dev, (3, 3, c, nc))
        sx = torch.rand((bsz, h, h, 1), generator=g, device=dev)
        sw = torch.rand((nc,), generator=g, device=dev)
        b = torch.rand((nc,), generator=g, device=dev)
        ho = h // 2
        out = torch.empty((bsz, ho, ho, nc), device=dev)
        p = Q.band_plan(bsz, h, h, c, 3, 3, nc, 2, "SAME")
        for _ in range(3):
            code = fn(0, stream, qx.data_ptr(), sx.data_ptr(), qw.data_ptr(),
                      sw.data_ptr(), 1, b.data_ptr(), out.data_ptr(), bsz, h,
                      h, c, 3, 3, nc, 2, 0, 0, ho, ho, 1, p.rows, p.n_tile,
                      p.threads, p.smem)
            if code:
                raise RuntimeError(f"launch failed with {code}")
        torch.cuda.synchronize()
        want = Q.qconv2d_i8_plain(qx, sx, qw, sw, b, stride=2,
                                  fuse_relu=True)
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"stamped qconv differs at x[{bsz},{h}]")
        st = (ctypes.c_ulonglong * (p.blocks * 4))()
        if lib.qforce_probe_stamps(st, p.blocks):
            raise RuntimeError("reading the stamps failed")
        spans = [[st[i * 4 + j + 1] - st[i * 4 + j] for j in range(3)]
                 for i in range(p.blocks)]
        med = [statistics.median(x[j] for x in spans) for j in range(3)]
        top = [max(x[j] for x in spans) for j in range(3)]
        print(f"qconv x[{bsz},{h},{h},{c}]->{nc}: {p.blocks} blocks of "
              f"{p.threads} threads; cycles a block, median (largest): "
              f"input {med[0]:.0f} ({top[0]}), scales + weights "
              f"{med[1]:.0f} ({top[1]}), taps + output {med[2]:.0f} "
              f"({top[2]})")


EW_CALLS = (("[512, 8]", lambda t, g, dev: t.randn(
                 (512, 8), generator=g, device=dev) * 2),
            ("[128, 32]", lambda t, g, dev: t.randn(
                (128, 32), generator=g, device=dev) * 2),
            ("[128, 32] gate slice", lambda t, g, dev: (t.randn(
                (128, 128), generator=g, device=dev) * 2)[:, 32:64]),
            ("[16777216]", lambda t, g, dev: t.randn(
                (1 << 24,), generator=g, device=dev) * 2))


def ew(torch, cs, dev):
    from repro_torch.kernels.vact import ops as V

    g = torch.Generator(device=dev).manual_seed(0)
    p = V.cordic_params(6)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for what, make in EW_CALLS:
        x = make(torch, g, dev)
        rows, cols, ld = V.ew_operand(tuple(x.shape), x.stride())
        picked = V.ew_plan(rows * cols)
        want = V.vact_ew_plain(x, "tanh", 6).view(torch.int32)
        out = torch.empty(x.shape, device=dev)
        cells = []
        for threads in (32, 64, 128, 256):
            plan = V.EwPlan(threads, min(-(-rows * cols // threads),
                                         V.EW_MAX_BLOCKS))

            def run():
                code = V._lib().qforce_vact_ew(
                    0, stream, x.data_ptr(), out.data_ptr(), rows, cols,
                    ld, V.EW_KINDS["tanh"], plan.threads, plan.blocks, p)
                if code:
                    raise RuntimeError(f"launch failed with {code}")

            out.zero_()
            run()
            if not torch.equal(out.view(torch.int32), want):
                raise AssertionError(f"vact_ew differs at {what} {plan}")
            mark = "*" if plan == picked else ""
            cells.append(f"{threads}x{plan.blocks}{mark}: "
                         f"{cs.device_ms(torch, run):.5f}")
        print(f"vact_ew {what} tanh n=6, threads x blocks (* planned): "
              + ", ".join(cells))


def _plan_cells(torch, cs, plans, run_plan, check, picked):
    """Time each plan of ``plans`` (label, plan) by ``run_plan``, after
    ``check`` holds its output against the plain version; the planner's
    choice is marked with *."""
    cells = []
    for label, plan in plans:
        def run(plan=plan):
            code = run_plan(plan)
            if code:
                raise RuntimeError(f"launch failed with {code}")

        run()
        check(label)
        mark = "*" if plan == picked else ""
        cells.append(f"{label}{mark}: {cs.device_ms(torch, run):.5f}")
    return cells


SOFTMAX_CALLS = ((512, 4), (4096, 1024), (4096, 8192), (256, 65536))


def softmax(torch, cs, dev):
    """Each softmax kernel's alternatives at FC-HRL's [512, 4] (lanes a
    row x threads a block), [4096, 1024], [4096, 8192] and [256, 65536]
    (threads a block up to 1024 with at most 256 elements a thread, the
    row staged whole, half or not at all), n = 6,
    within rtol 1e-6 of the plain version.  For the block kernel also
    the planned launch on the same rows at a row stride of cols + 4
    (float4 loads and stores) and of cols + 1 (one float at a time)."""
    from repro_torch.kernels.vact import ops as V

    g = torch.Generator(device=dev).manual_seed(0)
    p = V.cordic_params(6)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for rows, cols in SOFTMAX_CALLS:
        x = torch.randn((rows, cols), generator=g, device=dev) * 2
        want = V.vact_softmax_plain(x, 6)
        out = torch.empty_like(x)
        picked = V.softmax_plan(rows, cols)
        plans = []
        if picked.regime == "rows":
            for lanes in (4, 8, 16, 32):
                for threads in (32, 64, 128, 256):
                    total = -(-rows // (32 // lanes)) * 32
                    plans.append((f"{lanes} lanes x {threads} threads",
                                  V.SoftmaxPlan("rows", lanes, threads,
                                                -(-total // threads))))
        else:
            stages = sorted({min(cols, V.SOFTMAX_STAGE_MAX),
                             min(cols, V.SOFTMAX_STAGE_MAX) // 8 * 4, 0},
                            reverse=True)
            # a thread's serial share of the row sum at most 256
            # elements: a longer chain strays past rtol 1e-6 ([256, 65536]
            # at 32 threads)
            for threads in (t for t in (32, 64, 128, 256, 512, 1024)
                            if cols <= 256 * t):
                for staged in stages:
                    plans.append((f"{threads} threads, {staged} staged",
                                  V.SoftmaxPlan(
                                      "block", 0, threads,
                                      min(rows, V.EW_MAX_BLOCKS), staged)))
        src = [x]

        def run_plan(plan):
            return V._lib().qforce_vact_softmax(
                0, stream, src[0].data_ptr(), out.data_ptr(), rows, cols,
                src[0].stride(0), V.SOFTMAX_REGIMES[plan.regime],
                plan.lanes, plan.threads, plan.blocks, plan.staged, p)

        def check(label):
            torch.testing.assert_close(out, want, rtol=1e-6,
                                       atol=cs.FLT_MIN, msg=label)

        cells = _plan_cells(torch, cs, plans, run_plan, check, picked)
        print(f"vact_softmax [{rows}, {cols}] n=6 (* planned: {picked}); "
              "ms by plan: " + ", ".join(cells))
        if picked.regime != "block":
            continue
        cells = []
        for label, pad in (("float4, row stride cols + 4", 4),
                           ("one float at a time, row stride cols + 1", 1)):
            src[0] = torch.zeros((rows, cols + pad), device=dev)
            src[0][:, :cols] = x
            cells += _plan_cells(torch, cs, [(label, picked)], run_plan,
                                 check, None)
        print(f"vact_softmax [{rows}, {cols}] n=6, planned launch by row "
              "alignment: " + ", ".join(cells))
        src[0] = None


def q8(torch, cs, dev):
    """The int8 table kernel at [512, 8] and 2^26 elements, tanh, n = 6,
    for 1-64 16-byte chunks a thread (the grid uncapped), bitwise
    against the plain version."""
    from repro_torch.kernels.vact import ops as V

    g = torch.Generator(device=dev).manual_seed(0)
    p = V.cordic_params(6)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sx = torch.full((1,), 0.02, device=dev)
    for n in (512 * 8, 1 << 26):
        qx = cs._i8(torch, g, dev, (n,))
        want = V.vact_q8_plain(qx, sx, "tanh", 6)
        out = torch.empty_like(qx)
        picked = V.q8_plan(n)
        chunks = -(-n // V.Q8_CHUNK)
        plans = [(f"{items} chunks a thread", V.Q8Plan(
            V.Q8_THREADS, -(-chunks // (V.Q8_THREADS * items)), items))
                 for items in (1, 2, 4, 8, 16, 32, 64)]
        if picked not in [pl for _, pl in plans]:
            plans.append((f"{picked.items} chunks a thread, capped",
                          picked))

        def run_plan(plan):
            return V._lib().qforce_vact_ew_q8(
                0, stream, qx.data_ptr(), sx.data_ptr(), out.data_ptr(), n,
                V.EW_KINDS["tanh"], plan.threads, plan.blocks, p)

        def check(label):
            if not torch.equal(out, want):
                raise AssertionError(f"vact_q8 differs at {n}, {label}")

        cells = _plan_cells(torch, cs, plans, run_plan, check, picked)
        print(f"vact_ew_q8 [{n}] tanh n=6 (* planned: {picked}); ms by "
              "plan: " + ", ".join(cells))


def cell(torch, cs, dev):
    from repro_torch.kernels.qlstm import ops as Q
    from repro_torch.kernels.vact.ops import cordic_params

    g = torch.Generator(device=dev).manual_seed(0)
    b, d_in, h = 128, 32, 32
    args = [cs._i8(torch, g, dev, (b, d_in)), torch.full((), 0.01,
                                                          device=dev),
            cs._i8(torch, g, dev, (b, h)), torch.full((), 0.01, device=dev),
            cs._i8(torch, g, dev, (d_in, 4 * h)),
            torch.rand((4 * h,), generator=g, device=dev) * 0.004,
            cs._i8(torch, g, dev, (h, 4 * h)),
            torch.rand((4 * h,), generator=g, device=dev) * 0.004,
            torch.randn((4 * h,), generator=g, device=dev) * 0.1,
            torch.randn((b, h), generator=g, device=dev)]
    want = Q.qlstm_cell_plain(*args, 6)
    h_out = torch.empty((b, h), device=dev)
    c_out = torch.empty((b, h), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    picked = Q.cell_plan(b, d_in, h)
    cells = []
    for units in (4, 8):
        for rows in (1, 2, 4, 8):
            threads = 32 * -(-4 * rows * units // 32)
            smem = Q.smem_bytes(d_in, h, rows, units)

            def run():
                code = Q._lib()(0, stream, *[t.data_ptr() for t in args],
                                h_out.data_ptr(), c_out.data_ptr(), b, d_in,
                                h, rows, units, threads, smem,
                                cordic_params(6))
                if code:
                    raise RuntimeError(f"launch failed with {code}")

            run()
            for got, w in zip((h_out, c_out), want):
                if not torch.equal(got.view(torch.int32),
                                   w.view(torch.int32)):
                    raise AssertionError(f"qlstm differs at {rows} rows x "
                                         f"{units} units")
            blocks = -(-b // rows) * -(-h // units)
            mark = "*" if (rows, units) == (picked.rows, picked.units) else ""
            cells.append(f"{rows}x{units} ({blocks} blocks){mark}: "
                         f"{cs.device_ms(torch, run):.5f}")
    print(f"qlstm_cell B={b} Din={d_in} H={h} n=6, rows x units a block "
          f"(* planned): " + ", ".join(cells))


def pair(torch, cs, dev):
    from repro_torch.configs.e2hrl import HRLConfig
    from repro_torch.core.fxp import QTensor
    from repro_torch.core.policy import FXP8
    from repro_torch.models import hrl
    from repro_torch.tree import tree_map

    import repro_torch
    from repro_torch.kernels.qlstm import ops as Q
    from repro_torch.kernels.vact import ops as V
    print(f"repro_torch from {os.path.dirname(repro_torch.__file__)}")
    # a tree from before the launch planners: its kernels' own launch
    if not hasattr(V, "ew_plan"):
        cs.ew_plan_text = lambda x: "no launch planner in this tree"
    if not hasattr(Q, "cell_plan"):
        cs.cell_plan_text = lambda b, d_in, hid: ("no launch planner in "
                                                  "this tree")
    if not hasattr(V, "softmax_plan"):
        cs.softmax_plan_text = lambda x: "no launch planner in this tree"
    if not hasattr(V, "q8_plan"):
        cs.q8_plan_text = lambda n: "no launch planner in this tree"
    g = torch.Generator(device=dev).manual_seed(7)
    rows = [cs.time_ew(torch, torch.randn((m, n), generator=g, device=dev)
                       * 2, 6, f"[{m}, {n}]") for m, n in ((512, 8),
                                                          (128, 32))]
    gate, floor = cs.time_gate_slice_and_floor(torch, g, dev)
    rows = [("vact_ew", r) for r in rows + [gate]]
    rows += [("vact_softmax", cs.time_softmax(torch, torch.randn(
        (m, 4), generator=g, device=dev) * 2, 6, f"[{m}, 4]"))
             for m in (512, 128)]
    rows.append(("vact_ew_q8", cs.time_q8(
        torch, cs._i8(torch, g, dev, (512, 8)), 6, "[512, 8]")))
    sm, q8_row = cs.time_vact_large(torch, g, dev)
    rows += [("vact_softmax", r) for r in sm] + [("vact_ew_q8", q8_row)]
    rows.append(("qlstm_cell", cs._time_qlstm(torch, g, dev, 128, 32, 32,
                                              6)))
    print(cs.BOUND_TEXT)
    for name, r in rows:
        cs.print_row(name, r)
    print(f"launch floor under this timing: vact_ew on 1 element "
          f"{floor:.5f} ms")
    env, _, _, windows = cs._keydoor_frames(torch, dev)
    cfg = HRLConfig(obs_shape=tuple(env.obs_shape),
                    n_actions=env.spec.n_actions, subgoal_kind="lstm")
    params = tree_map(lambda x: x.to(dev),
                      hrl.init(torch.Generator().manual_seed(0), cfg,
                               device="cpu"),
                      is_leaf=lambda x: isinstance(x, QTensor))
    policies = {b: FXP8.replace(backend=b, act_backend="cordic")
                for b in ("pallas", "xla")}
    per_forward = cs.profile_hrl(torch, (params, cfg, policies, windows))
    print("LSTM-HRL device launches per forward: " + ", ".join(
        f"{b} {v}" for b, v in per_forward.items()))


MODES = {"split": split, "stages": stages, "ew": ew, "cell": cell,
         "softmax": softmax, "q8": q8, "pair": pair}


def main() -> int:
    import torch

    args = sys.argv[1:]
    if not args or args[0] not in MODES or len(args) > (2 if args[0] ==
                                                        "pair" else 1):
        print(__doc__, file=sys.stderr)
        return 2
    if len(args) == 2:
        src = os.path.abspath(args[1])
        if not os.path.isdir(os.path.join(src, "repro_torch")):
            print(f"kernel_probe: no repro_torch under {src}",
                  file=sys.stderr)
            return 2
        sys.path.insert(0, src)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA card", file=sys.stderr)
        return 2
    print(cs.card_line())
    dev = torch.device("cuda", 0)
    MODES[args[0]](torch, cs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
