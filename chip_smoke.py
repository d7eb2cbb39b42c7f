#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout (it imports ``repro_torch`` from ``src/`` beside
this file; never JAX, never ``repro``).  Phases, any failure exits
non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/kernels/*/csrc`` (one
   ``nvcc`` per source, all at once);
3. hold each kernel against its plain PyTorch version on the card, at
   the two paths' shapes and at ragged ones: int32 and int8 outputs
   equal, fp32 outputs bitwise equal, V-ACT's softmax within
   rtol=1e-6 (its row sum runs in another order); the split-K Q-MAC
   over the edges of its slices, its counters and two streams, and the
   band-staged Q-Conv over channel counts, strides, kernels, paddings,
   a band past 48 KB of shared memory and a row past 227 KB (refused);
   V-ACT's elementwise kernel at 1, 6, 13 and 24 iterations, sizes
   around its float4 items, and strided views read in place (the LSTM's
   gate slices at each offset, a view off 16-byte alignment, a row
   stride not a multiple of 4), one launch and no copy on a gate slice;
   the Q-LSTM cell over batch and hidden edges of its grid, Din = 37,
   a stripe off 4-byte alignment and a footprint past 227 KB (refused);
   the LSTM cell's xla and pallas branches on the card against the CPU;
   V-ACT's softmax in each of its three kernels at their bounds (rows
   of 1-65,536 elements, -inf and +-3e38 entries, row-strided views in
   one launch and no copy) and its int8 table kernel over every code,
   four scales, sizes to 2^26 + 3 and views off 16-byte alignment;
   Q-MAC's int32 product at the fxp8 actor's four shapes ([M, 4] x
   [4, 64], [M, 64] x [64, 64], [M, 64] x [64, 2], [M, 64] x [64, 1]) at
   M = 32 and ragged M; V-ACT at the pinned CORDIC input x = 4.2331 and
   its neighbours (tanh at x, sigmoid at 2x, n 6, 7, 13), tanh at n = 6
   equal to the JAX reference's eager value; Q-Conv and Q-MAC at the
   pixel runs' convs and products, and Q-MAC at the value runs' other
   two ([M, 3] x [3, 64], [M, 128] x [128, 96]);
4. time each kernel beside its plain version and, where one exists, a
   single PyTorch call computing the same function (CUDA events, median
   of 60 launches queued behind a device sleep so host overhead does not
   enter; ``torch.tanh`` and ``torch.softmax`` as approximate yardsticks
   of the CORDIC kernels), with each call's launch plan, and compute
   each kernel's bound on an H100; V-ACT also on a gate slice as the
   LSTM's xla branch passes it, softmax at LSTM-HRL's [128, 4], at
   [4096, 8192] and [256, 65536], int8 at 2^26 elements, and a
   1-element V-ACT call as the launch floor under this timing; Q-MAC
   also at the fxp8 actor's [32, 64] x [64, 64] and [32, 4] x [4, 64];
5. the serving path: build a conv DQN for keydoor at full width (seed
   0), save it as a checkpoint, and serve it through
   ``repro_torch.launch.serve_policy`` at w8 and at w4 with parity
   checks, counting kernel launches; then hold the served Q-values on
   the card against the plain path on the CPU;
6. profile served forwards of a full bucket (device time by kernel,
   host wall time, idle share);
7. the HRL path: the paper's E2HRL agent at its published width
   (32x32x3 keydoor frames, conv channels (16, 32, 32), seed 0), FC-HRL
   on 512 frames and LSTM-HRL on 128 windows of 4 frames, under
   ``FXP8`` with CORDIC activations at ``pallas`` (fused Q-LSTM) and
   ``xla`` (Q-MAC gates + V-ACT), and FC-HRL with packed w8 weights;
   logits and values on the card bitwise equal to the plain path on
   the CPU, probabilities within rtol=1e-6; 64 greedy keydoor steps;
   frames/s per variant; counting kernel launches;
8. profile LSTM-HRL forwards at pallas and at xla (device time by
   kernel, idle share, launches per forward: the port's from its
   wrappers' counters, PyTorch's from a trace whose every kernel row is
   a whole multiple of the forwards, traced again up to three times,
   else "not measured");
9. the training path: ``rl_train``'s default run (ppo on cartpole, the
   mlp agent at hidden 64, fxp8 actors on Q-MAC, an fp32 learner, an
   8-bit weight sync, 40 iterations of 32 envs x 128 steps) at seeds 0,
   1 and 2: greedy return (the median must reach half the JAX
   reference's median at seeds 0-4), env steps/s, the wall split between
   weight sync, rollout and learner, and Q-MAC's launches, exactly
   4 x 129 in every iteration; then one default iteration on the card
   against the CPU with the same params, states and draws (every action
   equal; log-probs and values within rtol 1e-5 at every (step, env)
   whose actor forward has the same int8 codes on both devices, the rows
   whose codes differ, where an ulp of the devices' libm flipped a code
   at a rounding tie, exempt and counted; params within atol 1e-5 + rtol
   1e-4), and a profile of the iteration's rollout and learner phases;
10. training from pixels: the paper's E2HRL agent with two-stage PPO on
   keydoor (``--env keydoor --agent hrl --two-stage``, 40 iterations a
   stage) and the conv actor-critic over the pixel pipeline on catch
   (``--env catch --net conv --frame-stack 4``, 40 iterations), both at
   32 envs x 128 steps with fxp8 actors on Q-Conv and Q-MAC, at seeds 0,
   1 and 2, and one iteration of each on the card against the CPU
   (E2HRL: one of each stage), each job in a process of its own, all at
   once: greedy return (the median must reach half the way from the
   untrained policy's to the JAX reference's median at seeds 0-2), env
   steps/s, the wall split, Q-Conv and Q-MAC launches exactly 3 + 5 and
   2 + 3 per actor forward in every iteration; the card-vs-CPU bars of
   phase 9, with both learners run from the CPU's rollout, Adam's moments
   held as the params and, in stage "action", the sub-goal subtree
   bitwise unchanged on both; then a profile of each run's iteration;
11. the value family: ``rl_train``'s value runs at their defaults (32
   envs x 8 steps, 300 iterations, replay capacity 50,000, n-step 3, 4
   updates an iteration, fxp8 behaviour actors on Q-MAC and Q-Conv, an
   fp32 learner): ``--algo dqn`` on cartpole, ``--algo qrdqn --env
   catch --net conv --frame-stack 4`` and ``--algo ddpg --env
   pendulum``, at seeds 0, 1 and 2, in processes of their own after
   phase 10's: greedy return (the median must reach half the way from
   the untrained reference's median to the trained reference's at
   seeds 0-2), env steps/s, the wall split, Q-MAC and Q-Conv launches
   exactly 3, 2 + 2 and 3 per behaviour forward in every iteration;
   one iteration of each run, of dqn ``--replay per`` and of ddpg
   ``--tqc-drop 2`` on the card against the CPU (actions equal, and
   observations within rtol 1e-5, in every env up to its first row
   whose int8 codes differ, such rows counted; the learners from the
   CPU's rollout, each update held from the CPU's state as phase 10
   holds them); the sum tree at 50,000 slots bitwise on both devices
   after updates with duplicate slots, ``find`` equal; then a profile
   of each run's iteration;
12. observability and serving the value checkpoints: phase 11's seed-0
   job of each value run also writes ``--metrics-dir`` telemetry and its
   last iteration's checkpoint; the ``train.jsonl`` of each read back
   (step windows tiling [0, 300), 76,800 env steps, ``steps_per_s`` in
   every window); each checkpoint served through ``serve_policy`` on the
   card at w8 with ``--check-parity`` (no mismatching row) and at w4,
   with ``--metrics-dir`` (actions/s, p50/p99, the served mean return),
   its served forward's launches held exactly (Q-MAC's fused product 3,
   Q-Conv 2 + 2, 3) and profiled as phase 6 profiles; PPO and DQN on cartpole, 6 iterations each with and
   without ``--metrics-dir``, history and params bitwise equal; a
   ``--profile-dir`` window of 2 PPO steps whose trace holds a ``qmac``
   kernel row;
13. print the kernels' JSON line, then the device line last.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense int8
# tensor-core ops/s, fp32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12

N_TIMED = 60
N_WARM = 10
FLT_MIN = 1.1754944e-38      # smallest normal fp32


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, int8_ops: float = 0.0,
             fp32_ops: float = 0.0):
    """(least time in ms, what bounds it) on the published peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int8_ops / INT8_OPS_PER_S + fp32_ops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_ms(torch, fn) -> float:
    """Median device time of one call of ``fn`` in ms: every timed call
    is bracketed by its own CUDA events, and all of them are queued
    behind a device-side sleep so they run back to back on the card."""
    for _ in range(N_WARM):
        fn()
    torch.cuda.synchronize()
    pairs = []
    torch.cuda._sleep(200_000_000)
    for _ in range(N_TIMED):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bits_equal(torch, a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def check_kernels(torch, dev):
    """Phase 3: every kernel against its plain version, bitwise."""
    from repro_torch.kernels.qconv import ops as qconv_ops
    from repro_torch.kernels.qmac import ops as qmac_ops

    g = torch.Generator(device=dev).manual_seed(1234)

    def i8(shape, qmax=127):
        return torch.randint(-qmax, qmax + 1, shape, generator=g,
                             device=dev, dtype=torch.int32).to(torch.int8)

    def pos(shape):
        return torch.rand(shape, generator=g, device=dev) * 0.02 + 1e-4

    worst = {"qmac_i8": 0.0, "qmac_i8_deq": 0.0, "qconv_i8_taps": 0.0,
             "vact_ew": 0.0, "vact_ew_q8": 0.0, "vact_softmax": 0.0,
             "qlstm_cell": 0.0}
    qmac_shapes = []
    for b in (1, 7, 32):
        qmac_shapes += [(b, 2048, 128), (b, 128, 4)]
    qmac_shapes += [(5, 12, 1), (33, 67, 40), (64, 300, 33), (1, 1, 1)]
    for (m, k, n) in qmac_shapes:
        for qmax in (127, 7):
            qx, qw = i8((m, k)), i8((k, n), qmax)
            sx, sw = pos((m, 1)), pos((1, n))
            got = qmac_ops.qmac_i8(qx, qw)
            want = qmac_ops.qmac_i8_plain(qx, qw)
            worst["qmac_i8"] = max(worst["qmac_i8"], float(
                (got.long() - want.long()).abs().max().item()))
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8 != plain at M,K,N={m},{k},{n}")
            for s in (sw, sw[:, :1].contiguous()):
                got = qmac_ops.qmac_i8_deq(qx, sx, qw, s)
                want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, s)
                err = (got - want).abs().max().item()
                worst["qmac_i8_deq"] = max(worst["qmac_i8_deq"], err)
                if not bits_equal(torch, got, want):
                    raise AssertionError(
                        f"qmac_i8_deq != plain at M,K,N={m},{k},{n} "
                        f"(max abs err {err})")
    print(f"Q-MAC: {len(qmac_shapes) * 2} shapes, int32 equal and fused "
          "fp32 bitwise equal to the plain version")

    conv_cases = []
    for b in (1, 7, 32):
        conv_cases += [((b, 32, 32, 12), (3, 3, 12, 16), 2, "SAME", True),
                       ((b, 16, 16, 16), (3, 3, 16, 32), 2, "SAME", True)]
    conv_cases += [((3, 15, 13, 5), (3, 3, 5, 7), 1, "SAME", False),
                   ((2, 17, 9, 20), (2, 2, 20, 33), 2, "VALID", True),
                   ((2, 11, 11, 40), (3, 3, 40, 16), 1, "SAME", False),
                   ((1, 7, 7, 12), (5, 5, 12, 3), 3, "VALID", False),
                   ((2, 9, 8, 12), (3, 3, 12, 48), 2, "SAME", True)]
    for xs, ws, stride, padding, relu in conv_cases:
        qx, qw = i8(xs), i8(ws)
        sx = pos(xs[:3] + (1,))
        sw = pos((ws[3],))
        bias = torch.randn(ws[3], generator=g, device=dev) * 0.1
        kw = dict(stride=stride, padding=padding, fuse_relu=relu)
        got = qconv_ops.qconv2d_i8(qx, sx, qw, sw, bias, **kw)
        want = qconv_ops.qconv2d_i8_plain(qx, sx, qw, sw, bias, **kw)
        err = (got - want).abs().max().item()
        worst["qconv_i8_taps"] = max(worst["qconv_i8_taps"], err)
        if not bits_equal(torch, got, want):
            raise AssertionError(f"qconv != plain at {xs} x {ws} stride "
                                 f"{stride} {padding} (max abs err {err})")
    print(f"Q-Conv: {len(conv_cases)} cases, fp32 bitwise equal to the "
          "plain version")
    torch.cuda.synchronize()
    return worst


def check_hrl_kernels(torch, dev, worst):
    """Phase 3, the HRL path's kernels: Q-Conv at the stem's three
    shapes (C_in = 3 first), Q-MAC at the agent's dense shapes, V-ACT
    (every kind, 6 and 13 iterations, fp32 and int8) and the fused
    Q-LSTM cell, each against its plain version on the card."""
    from repro_torch.kernels.qconv import ops as qconv_ops
    from repro_torch.kernels.qlstm import ops as qlstm_ops
    from repro_torch.kernels.qmac import ops as qmac_ops
    from repro_torch.kernels.vact import ops as vact_ops

    g = torch.Generator(device=dev).manual_seed(4321)

    def i8(shape):
        return _i8(torch, g, dev, shape)

    def pos(shape, scale=0.02):
        return torch.rand(shape, generator=g, device=dev) * scale + 1e-4

    n_conv = 0
    for b in (1, 7, 64):
        for h, c, nc in ((32, 3, 16), (16, 16, 32), (8, 32, 32)):
            qx, qw = i8((b, h, h, c)), i8((3, 3, c, nc))
            sx, sw = pos((b, h, h, 1)), pos((nc,))
            bias = torch.randn(nc, generator=g, device=dev) * 0.1
            kw = dict(stride=2, padding="SAME", fuse_relu=True)
            got = qconv_ops.qconv2d_i8(qx, sx, qw, sw, bias, **kw)
            want = qconv_ops.qconv2d_i8_plain(qx, sx, qw, sw, bias, **kw)
            err = (got - want).abs().max().item()
            worst["qconv_i8_taps"] = max(worst["qconv_i8_taps"], err)
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qconv != plain at HRL stem "
                                     f"x[{b},{h},{h},{c}] (max abs err "
                                     f"{err})")
            n_conv += 1
    n_mm = 0
    for m in (1, 7, 128, 512):
        for k, n in ((512, 32), (32, 32), (32, 8), (40, 4), (40, 1)):
            qx, qw = i8((m, k)), i8((k, n))
            sx, sw = pos((m, 1)), pos((1, n))
            if not bits_equal(torch, qmac_ops.qmac_i8(qx, qw),
                              qmac_ops.qmac_i8_plain(qx, qw)):
                raise AssertionError(f"qmac_i8 != plain at {m},{k},{n}")
            got = qmac_ops.qmac_i8_deq(qx, sx, qw, sw)
            want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, sw)
            worst["qmac_i8_deq"] = max(worst["qmac_i8_deq"],
                                       (got - want).abs().max().item())
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8_deq != plain at "
                                     f"{m},{k},{n}")
            n_mm += 1
    print(f"HRL shapes: Q-Conv {n_conv} cases (C_in 3, 16, 32) and Q-MAC "
          f"{n_mm} cases bitwise equal to the plain versions")

    edge = torch.tensor([0.0, 1e-8, -1e-8, 1.0, -1.0, 30.0, -30.0, 100.0,
                         -100.0, 88.5, -88.5], device=dev)

    def fp(shape):
        x = torch.randn(shape, generator=g, device=dev) * 4
        flat = x.view(-1)
        k = min(edge.numel(), flat.numel())
        flat[:k] = edge[:k]
        return x

    n_ew = 0
    for shape in ((512, 8), (128, 32), (1, 1), (7, 33), (300, 301),
                  (3, 5, 11)):
        x = fp(shape)
        qx = i8(shape)
        sx = pos((), 0.05)
        for n in (6, 13):
            for kind in ("relu", "sigmoid", "tanh"):
                got = vact_ops.vact(x, kind, n)
                want = vact_ops.vact_ew_plain(x, kind, n)
                err = (got - want).abs().max().item()
                worst["vact_ew"] = max(worst["vact_ew"], err)
                if not bits_equal(torch, got, want):
                    raise AssertionError(f"vact_ew {kind} n={n} != plain "
                                         f"at {shape} (max abs err {err})")
                got = vact_ops.vact_q8(qx, sx, kind, n)
                want = vact_ops.vact_q8_plain(qx, sx, kind, n)
                err = (got.int() - want.int()).abs().max().item()
                worst["vact_ew_q8"] = max(worst["vact_ew_q8"], err)
                if not bits_equal(torch, got, want):
                    raise AssertionError(f"vact_q8 {kind} n={n} != plain "
                                         f"at {shape} (max code err {err})")
                n_ew += 1
    print(f"V-ACT elementwise and q8: {n_ew} cases each bitwise equal to "
          "the plain versions")
    rel = 0.0
    for rows in (1, 512, 1000):
        for n_col in (1, 4, 6, 33):
            x = fp((rows, n_col))
            for n in (6, 13):
                got = vact_ops.vact(x, "softmax", n)
                want = vact_ops.vact_softmax_plain(x, n)
                err = (got - want).abs().max().item()
                worst["vact_softmax"] = max(worst["vact_softmax"], err)
                r = ((got - want).abs() / want.abs().clamp_min(
                    FLT_MIN)).max().item()
                rel = max(rel, r)
                # atol: a subnormal quotient keeps fewer significant bits
                if not torch.allclose(got, want, rtol=1e-6, atol=FLT_MIN):
                    raise AssertionError(
                        f"vact_softmax n={n} at [{rows}, {n_col}] off its "
                        f"plain version by {err} (rel {r}) > rtol 1e-6")
    print(f"V-ACT softmax: 24 cases within rtol=1e-6 of the plain version "
          f"(max abs err {worst['vact_softmax']}, max rel err {rel})")

    n_cell = 0
    for b in (1, 7, 128):
        for d_in, hid in ((32, 32), (8, 8), (40, 24)):
            args = (i8((b, d_in)), pos((), 0.02), i8((b, hid)),
                    pos((), 0.02), i8((d_in, 4 * hid)),
                    pos((1, 4 * hid), 0.004), i8((hid, 4 * hid)),
                    pos((1, 4 * hid), 0.004),
                    torch.randn(4 * hid, generator=g, device=dev) * 0.1,
                    torch.randn((b, hid), generator=g, device=dev))
            for n in (6, 13):
                got = qlstm_ops.qlstm_cell(*args, n_iters=n)
                want = qlstm_ops.qlstm_cell_plain(*args, n)
                for gt, wt, what in zip(got, want, ("h'", "c'")):
                    err = (gt - wt).abs().max().item()
                    worst["qlstm_cell"] = max(worst["qlstm_cell"], err)
                    if not bits_equal(torch, gt, wt):
                        raise AssertionError(
                            f"qlstm {what} != plain at B={b} Din={d_in} "
                            f"H={hid} n={n} (max abs err {err})")
                n_cell += 1
    print(f"Q-LSTM: {n_cell} cases, h' and c' bitwise equal to the plain "
          "version")
    torch.cuda.synchronize()
    return worst


def check_split_and_band_edges(torch, dev, worst):
    """Phase 3, the redesigned kernels at their edges: Q-MAC over every
    K x M x N of the split's edges with per-channel and per-tensor sw,
    its counters and workspaces (the same call twice, other shapes in
    between, two streams at once); Q-Conv over C in {3, 5, 12, 16, 40,
    130}, strides 1-3, SAME and VALID, 2x2/3x3/5x5 kernels, N in {3, 16,
    33, 48}, a band in more than 48 KB of shared memory, and a row past
    227 KB, which must raise."""
    from repro_torch.kernels.qconv import ops as qconv_ops
    from repro_torch.kernels.qmac import ops as qmac_ops

    g = torch.Generator(device=dev).manual_seed(2468)

    def i8(shape):
        return _i8(torch, g, dev, shape)

    def pos(shape):
        return torch.rand(shape, generator=g, device=dev) * 0.02 + 1e-4

    def mm_case(m, k, n):
        return i8((m, k)), i8((k, n)), pos((m, 1)), pos((1, n))

    def mm_check(qx, qw, sx, sw, what):
        got = qmac_ops.qmac_i8(qx, qw)
        want = qmac_ops.qmac_i8_plain(qx, qw)
        worst["qmac_i8"] = max(worst["qmac_i8"], float(
            (got.long() - want.long()).abs().max().item()))
        if not bits_equal(torch, got, want):
            raise AssertionError(f"qmac_i8 != plain at {what}")
        for s in (sw, sw[:, :1].contiguous()):
            got = qmac_ops.qmac_i8_deq(qx, sx, qw, s)
            want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, s)
            err = (got - want).abs().max().item()
            worst["qmac_i8_deq"] = max(worst["qmac_i8_deq"], err)
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8_deq != plain at {what} "
                                     f"(max abs err {err})")

    n_mm = 0
    for k in (1, 15, 16, 17, 40, 2047, 2048, 2049, 131072):
        for m in (1, 2, 31, 32, 33, 512):
            for n in (1, 4, 33, 128):
                mm_check(*mm_case(m, k, n), f"M,K,N={m},{k},{n} "
                         f"({qmac_ops.split_plan(m, k, n)})")
                n_mm += 1
    # counters: the same split call twice, other shapes in between
    fc, other = mm_case(32, 2048, 128), mm_case(512, 512, 32)
    qx, qw, sx, sw = fc
    want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, sw)
    runs = [qmac_ops.qmac_i8_deq(qx, sx, qw, sw) for _ in range(2)]
    for _ in range(3):
        for case in (other, fc, mm_case(8, 4096, 4)):
            mm_check(*case, "interleaved shapes")
    # two streams at once, each with its own workspace and counters
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    runs += [qmac_ops.qmac_i8_deq(qx, sx, qw, sw) for _ in range(8)]
    with torch.cuda.stream(side):
        runs += [qmac_ops.qmac_i8_deq(qx, sx, qw, sw) for _ in range(8)]
    main.wait_stream(side)
    torch.cuda.synchronize()
    for got in runs:
        if not bits_equal(torch, got, want):
            raise AssertionError("qmac_i8_deq: a repeated split call or a "
                                 "call on a second stream changed bits")
    print(f"Q-MAC split-K edges: {n_mm} shapes x (int32, per-channel, "
          f"per-tensor) equal to the plain version; {len(runs)} repeated "
          "and two-stream calls bitwise equal")

    n_conv = 0
    for c in (3, 5, 12, 16, 40, 130):
        i = 0
        for stride in (1, 2, 3):
            for kk in (2, 3, 5):
                for padding in ("SAME", "VALID"):
                    n = (3, 16, 33, 48)[i % 4]
                    b, h, w = 1 + i % 3, 13 + i % 4, 11 + 2 * (i % 3)
                    i += 1
                    qx, qw = i8((b, h, w, c)), i8((kk, kk, c, n))
                    sx, sw = pos((b, h, w, 1)), pos((n,))
                    bias = torch.randn(n, generator=g, device=dev) * 0.1
                    kw = dict(stride=stride, padding=padding,
                              fuse_relu=bool(i % 2))
                    got = qconv_ops.qconv2d_i8(qx, sx, qw, sw, bias, **kw)
                    want = qconv_ops.qconv2d_i8_plain(qx, sx, qw, sw, bias,
                                                      **kw)
                    err = (got - want).abs().max().item()
                    worst["qconv_i8_taps"] = max(worst["qconv_i8_taps"],
                                                 err)
                    if not bits_equal(torch, got, want):
                        raise AssertionError(
                            f"qconv != plain at x[{b},{h},{w},{c}] "
                            f"w[{kk},{kk},{c},{n}] stride {stride} "
                            f"{padding} (max abs err {err})")
                    n_conv += 1
    b, h, w, c, n = 1, 8, 512, 40, 16
    plan = qconv_ops.band_plan(b, h, w, c, 3, 3, n, 1, "SAME")
    if plan.smem <= 48 * 1024:
        raise AssertionError(f"the wide case takes only {plan.smem} bytes")
    qx, qw = i8((b, h, w, c)), i8((3, 3, c, n))
    sx, sw = pos((b, h, w, 1)), pos((n,))
    bias = torch.randn(n, generator=g, device=dev) * 0.1
    if not bits_equal(torch, qconv_ops.qconv2d_i8(qx, sx, qw, sw, bias),
                      qconv_ops.qconv2d_i8_plain(qx, sx, qw, sw, bias)):
        raise AssertionError(f"qconv != plain with a {plan.smem}-byte band")
    before = qconv_ops.qconv2d_i8.launches
    try:
        qconv_ops.qconv2d_i8(
            torch.zeros((1, 4, 2048, 40), dtype=torch.int8, device=dev),
            torch.ones((1, 4, 2048, 1), device=dev),
            torch.zeros((3, 3, 40, 16), dtype=torch.int8, device=dev),
            torch.ones(16, device=dev), torch.zeros(16, device=dev))
    except ValueError as e:
        print(f"Q-Conv refused a row past 227 KB: {e}")
    else:
        raise AssertionError("Q-Conv ran a row past 227 KB of shared "
                             "memory")
    if qconv_ops.qconv2d_i8.launches != before:
        raise AssertionError("the refused Q-Conv launched")
    torch.cuda.synchronize()
    print(f"Q-Conv band edges: {n_conv} cases and a {plan.smem}-byte band "
          "bitwise equal to the plain version")
    return worst


def check_ew_and_cell_edges(torch, dev, worst):
    """Phase 3, the redesigned V-ACT elementwise kernel and Q-LSTM cell
    at their edges, bitwise against the plain versions: every kind at
    n in {1, 6, 13, 24} and 1, 3, 4095, 4096, 4097 elements; strided
    views read in place (gate slices of [B, 4H] at each offset, views
    off 16-byte alignment, a row stride of 130, a 3-D view, and views
    past one wave and past the grid's cap, where threads stride), with one
    device launch and no copy on a gate slice (profiler); the cell at B
    in {1, 7, 128, 129, 512} x H in {1, 3, 32, 33, 64}, Din = H and Din
    = 37, a stripe off 4-byte alignment, and a footprint past 227 KB
    refused with no launch; the LSTM cell's two branches against the
    CPU."""
    from repro_torch import kernels
    from repro_torch.core.policy import FXP8
    from repro_torch.kernels.qlstm import ops as qlstm_ops
    from repro_torch.kernels.vact import ops as vact_ops
    from repro_torch.nn import lstm

    g = torch.Generator(device=dev).manual_seed(1357)
    edge = torch.tensor([0.0, 1e-8, -1e-8, 1.0, -1.0, 30.0, -30.0, 100.0,
                         -100.0, 88.5, -88.5], device=dev)

    def fp(shape):
        x = torch.randn(shape, generator=g, device=dev) * 4
        flat = x.view(-1)
        k = min(edge.numel(), flat.numel())
        flat[:k] = edge[:k]
        return x

    def ew_check(x, kind, n, what):
        before = vact_ops.vact_ew.launches
        got = vact_ops.vact_ew(x, kind, n)
        if vact_ops.vact_ew.launches != before + 1:
            raise AssertionError(f"vact_ew at {what}: not one launch")
        want = vact_ops.vact_ew_plain(x.contiguous(), kind, n)
        err = (got - want).abs().max().item()
        worst["vact_ew"] = max(worst["vact_ew"], err)
        if not (got.is_contiguous() and bits_equal(torch, got, want)):
            raise AssertionError(f"vact_ew {kind} n={n} != plain at {what} "
                                 f"(max abs err {err})")

    n_ew = 0
    for numel in (1, 3, 4095, 4096, 4097):
        x = fp((numel,))
        for n in (1, 6, 13, 24):
            for kind in ("relu", "sigmoid", "tanh"):
                ew_check(x, kind, n, f"{numel} elements")
                n_ew += 1
    views = []
    for b, h in ((128, 32), (7, 3), (129, 33)):
        gates = fp((b, 4 * h))
        views += [(f"gate {k} of [{b}, {4 * h}]",
                   gates[:, k * h:(k + 1) * h]) for k in range(4)]
    flat = fp((4099,))
    views += [("a contiguous view 4 B off alignment", flat[1:4098]),
              ("rows of 40, 4 B off alignment",
               flat[1:4001].view(100, 40)[:, :32]),
              ("row stride 130", fp((128, 130))[:, 2:34]),
              ("3-D, leading axes folded", fp((4, 32, 12))[:, :, 4:12])]
    # past one wave of one-element threads (132 x 256) and past the
    # grid's cap, where a thread strides over rows
    wave = vact_ops.SMS * vact_ops.EW_MAX_THREADS
    rows = -(-vact_ops.EW_MAX_BLOCKS * vact_ops.EW_MAX_THREADS // 32) + 100
    wide = fp((rows * 40 + 1,))
    views += [(f"[{wave + 3}] contiguous", fp((wave + 3,))),
              (f"[{rows}, 32] slice of [{rows}, 128]",
               fp((rows, 128))[:, 32:64]),
              (f"[{rows}, 32] at row stride 130", fp((rows, 130))[:, 2:34]),
              (f"[{rows}, 32] at row stride 40, 4 B off alignment",
               wide[1:].view(rows, 40)[:, :32])]
    for what, x in views:
        op = vact_ops.ew_operand(tuple(x.shape), x.stride())
        if op is None:
            raise AssertionError(f"vact_ew would copy {what}")
        for n in (6, 13):
            for kind in ("relu", "sigmoid", "tanh"):
                ew_check(x, kind, n, what)
                n_ew += 1
    # a gate slice is one device launch: the kernel, no copy before it
    gates = fp((128, 128))
    _, rows, per_call, why = _profiled(torch, lambda: (
        vact_ops.vact_ew(gates[:, 32:64], "sigmoid", 6),
        torch.cuda.synchronize()), 5)
    names = [name for _, _, name in rows]
    if per_call != 1 or not all("vact_ew" in name for name in names):
        raise AssertionError(f"vact_ew on a gate slice ran {per_call} "
                             f"device launches a call ({why}): {names}")
    print(f"V-ACT elementwise edges: {n_ew} cases bitwise equal to the "
          f"plain version ({len(views)} views read in place); a "
          f"gate slice is {per_call:g} device launch a call ({names[0]})")

    n_cell = 0
    for b in (1, 7, 128, 129, 512):
        for h in (1, 3, 32, 33, 64):
            for d_in, n, offset in ((h, 6, 0), (37, 13, 0), (37, 24, 1)):
                def i8_at(shape):
                    q = _i8(torch, g, dev, (offset + shape[0] * shape[1],))
                    return q[offset:].view(shape)
                args = (_i8(torch, g, dev, (b, d_in)),
                        torch.rand((), generator=g, device=dev) * 0.02,
                        _i8(torch, g, dev, (b, h)),
                        torch.rand((), generator=g, device=dev) * 0.02,
                        i8_at((d_in, 4 * h)),
                        torch.rand((1, 4 * h), generator=g,
                                   device=dev) * 0.004,
                        i8_at((h, 4 * h)),
                        torch.rand((1, 4 * h), generator=g,
                                   device=dev) * 0.004,
                        torch.randn(4 * h, generator=g, device=dev) * 0.1,
                        torch.randn((b, h), generator=g, device=dev))
                got = qlstm_ops.qlstm_cell(*args, n_iters=n)
                want = qlstm_ops.qlstm_cell_plain(*args, n)
                for gt, wt, what in zip(got, want, ("h'", "c'")):
                    err = (gt - wt).abs().max().item()
                    worst["qlstm_cell"] = max(worst["qlstm_cell"], err)
                    if not bits_equal(torch, gt, wt):
                        plan = qlstm_ops.cell_plan(b, d_in, h)
                        raise AssertionError(
                            f"qlstm {what} != plain at B={b} Din={d_in} "
                            f"H={h} n={n} offset {offset} ({plan}; max "
                            f"abs err {err})")
                n_cell += 1
    big = (torch.zeros((4, 8192), dtype=torch.int8, device=dev),
           torch.ones((), device=dev),
           torch.zeros((4, 8), dtype=torch.int8, device=dev),
           torch.ones((), device=dev),
           torch.zeros((8192, 32), dtype=torch.int8, device=dev),
           torch.ones(32, device=dev),
           torch.zeros((8, 32), dtype=torch.int8, device=dev),
           torch.ones(32, device=dev), torch.zeros(32, device=dev),
           torch.zeros((4, 8), device=dev))
    before = qlstm_ops.qlstm_cell.launches
    try:
        qlstm_ops.qlstm_cell(*big, n_iters=6)
    except ValueError as e:
        print(f"Q-LSTM refused a block past 227 KB: {e}")
    else:
        raise AssertionError("Q-LSTM ran a block past 227 KB of shared "
                             "memory")
    if qlstm_ops.qlstm_cell.launches != before:
        raise AssertionError("the refused Q-LSTM cell launched")
    print(f"Q-LSTM edges: {n_cell} cases, h' and c' bitwise equal to the "
          "plain version")

    p_cpu = lstm.lstm_init(torch.Generator().manual_seed(0), 32, 32)
    p_dev = {k: v.to(dev) for k, v in p_cpu.items()}
    xs = torch.randn((128, 4, 32), generator=torch.Generator().manual_seed(1))
    for backend in ("xla", "pallas"):
        pol = FXP8.replace(backend=backend, act_backend="cordic")
        kernels.reset_launch_counts()
        hs, (h, c) = lstm.lstm_apply(p_dev, xs.to(dev), pol)
        counts = kernels.launch_counts()
        want_hs, (want_h, want_c) = lstm.lstm_apply(p_cpu, xs, pol)
        for got, want in ((hs, want_hs), (h, want_h), (c, want_c)):
            if not bits_equal(torch, got.cpu(), want):
                raise AssertionError(f"LSTM {backend}: card and CPU differ")
        # xla: four gates and tanh(c') a step; pallas: one fused cell
        if (counts["vact_ew"], counts["qlstm_cell"]) != (
                (20, 0) if backend == "xla" else (0, 4)):
            raise AssertionError(f"LSTM {backend}: launches {counts}")
        print(f"LSTM cell, {backend}, 4 steps of B=128 Din=H=32: card "
              f"bitwise equal to the CPU; vact_ew {counts['vact_ew']}, "
              f"qlstm_cell {counts['qlstm_cell']} launches")
    torch.cuda.synchronize()
    return worst


SOFTMAX_COLS = (1, 2, 3, 4, 5, 31, 32, 33, 1023, 1024, 1025, 58079, 58080,
                58081, 65536)
# past each softmax kernel's grid cap, where its rows stride over the
# grid: the rows kernel at 1, 4 and 32 lanes, the block kernel at one
# warp, staging a whole row and past shared memory
SOFTMAX_STRIDED = ((600000, 1), (200000, 4), (20000, 32), (20000, 100),
                   (4096, 1025), (4096, 8192), (2113, 58081))


def check_softmax_and_q8_edges(torch, dev, worst):
    """Phase 3, V-ACT's redesigned softmax and int8 kernels at their
    edges.  Softmax within rtol=1e-6 of the plain version (NaN where it
    gives NaN): each kernel at its bounds (cols 1-5, 31-33, the block
    kernel's one-warp bound +-1, shared memory's limit +-1, a
    65,536-float row past it) over 1, 7, 512 and 1000 rows at n in {1, 6,
    13, 24}; rows past each kernel's grid cap (``SOFTMAX_STRIDED``) at n
    in {6, 13}; rows with -inf entries and entries near +-3e38; row-strided views
    read in place, one device launch and no copy.  The int8 kernel
    bitwise: every code (-128 included) at scales 1e-30, 0.003, 0.05 and
    3.0 for each kind, sizes 1-2^26 + 3 around its 16-byte chunks, and
    views off 16-byte alignment."""
    from repro_torch.kernels.vact import ops as vact_ops

    g = torch.Generator(device=dev).manual_seed(9753)
    edge = torch.tensor([0.0, 1e-8, -1e-8, 30.0, -30.0, 100.0, -100.0],
                        device=dev)

    def fp(shape):
        x = torch.randn(shape, generator=g, device=dev) * 4
        flat = x.view(-1)
        k = min(edge.numel(), flat.numel())
        flat[:k] = edge[:k]
        return x

    rel = 0.0

    def sm_check(x, n, what):
        nonlocal rel
        before = vact_ops.vact_softmax.launches
        got = vact_ops.vact_softmax(x, n)
        if vact_ops.vact_softmax.launches != before + 1:
            raise AssertionError(f"vact_softmax at {what}: not one launch")
        want = vact_ops.vact_softmax_plain(x.contiguous(), n)
        fin = torch.isfinite(want)
        err = (got - want)[fin].abs().max().item() if fin.any() else 0.0
        worst["vact_softmax"] = max(worst["vact_softmax"], err)
        if fin.any():
            rel = max(rel, ((got - want).abs() / want.abs().clamp_min(
                FLT_MIN))[fin].max().item())
        if not (got.is_contiguous() and torch.allclose(
                got, want, rtol=1e-6, atol=FLT_MIN, equal_nan=True)):
            raise AssertionError(f"vact_softmax n={n} at {what} off its "
                                 f"plain version by {err} > rtol 1e-6")

    n_sm = 0
    for cols in SOFTMAX_COLS:
        for rows in (1, 7, 512, 1000):
            x = fp((rows, cols))
            for n in (1, 6, 13, 24):
                sm_check(x, n, f"[{rows}, {cols}] "
                         f"({vact_ops.softmax_plan(rows, cols)})")
                n_sm += 1
    for rows, cols in SOFTMAX_STRIDED:
        plan = vact_ops.softmax_plan(rows, cols)
        lanes = max(plan.lanes, 1)
        if rows <= (plan.blocks * plan.threads // 32 * (32 // lanes)
                    if plan.regime == "rows" else plan.blocks):
            raise AssertionError(f"[{rows}, {cols}] fits one grid ({plan})")
        x = fp((rows, cols))
        for n in (6, 13):
            sm_check(x, n, f"[{rows}, {cols}] past the grid cap ({plan})")
            n_sm += 1
        del x
    for cols in (4, 33, 1000, 2048, 65536):
        x = fp((64, cols))
        x[0::4, 0] = -float("inf")
        x[1::4, -1] = -float("inf")
        x[2::4, 0] = 3e38
        x[2::4, -1] = -3e38
        x[3::4] = torch.where(torch.rand((16, cols), generator=g,
                                         device=dev) < 0.5, 3.3e38, -3.3e38)
        x[3::4, 0] = 3.4e38
        for n in (6, 13):
            sm_check(x, n, f"[64, {cols}] with -inf and +-3e38 entries")
            n_sm += 1
    views = [("[128, 32] at row stride 130", fp((128, 130))[:, 2:34]),
             ("3-D, leading axes folded", fp((4, 32, 12))[:, :, 4:8]),
             ("[64, 100] at row stride 257, 4 B off alignment",
              fp((64, 257))[:, 1:101]),
             ("[64, 1000] at row stride 1024", fp((64, 1024))[:, 8:1008]),
             ("[16, 4096] at row stride 8192", fp((16, 8192))[:, 4096:]),
             ("[4, 65536] at row stride 65540", fp((4, 65540))[:, 4:])]
    for what, x in views:
        op = vact_ops.softmax_operand(tuple(x.shape), x.stride())
        if op is None or op[2] != x.stride(-2):
            raise AssertionError(f"vact_softmax would copy {what}")
        for n in (6, 13):
            sm_check(x, n, what)
            n_sm += 1
        _, rows, per_call, why = _profiled(torch, lambda: (
            vact_ops.vact_softmax(x, 6), torch.cuda.synchronize()), 5)
        names = [name for _, _, name in rows]
        if per_call != 1 or "vact_softmax" not in names[0]:
            raise AssertionError(
                f"vact_softmax on {what} ran {per_call} device launches a "
                f"call ({why}): {names}; {torch.cuda.memory_reserved()} B "
                "reserved")
    print(f"V-ACT softmax edges: {n_sm} cases within rtol=1e-6 of the plain "
          f"version (max abs err {worst['vact_softmax']}, max rel err "
          f"{rel}); {len(views)} row-strided views one device launch a "
          "call, no copy")

    n_q8 = 0
    codes = torch.arange(-128, 128, device=dev,
                         dtype=torch.int32).to(torch.int8).repeat(3)

    def q8_check(qx, sx, kind, n, what):
        got = vact_ops.vact_q8(qx, sx, kind, n)
        want = vact_ops.vact_q8_plain(qx, sx, kind, n)
        err = (got.int() - want.int()).abs().max().item()
        worst["vact_ew_q8"] = max(worst["vact_ew_q8"], err)
        if not (got.is_contiguous() and bits_equal(torch, got, want)):
            raise AssertionError(f"vact_q8 {kind} n={n} != plain at {what} "
                                 f"(max code err {err})")

    for scale in (1e-30, 0.003, 0.05, 3.0):
        sx = torch.tensor(scale, device=dev)
        for kind in ("relu", "sigmoid", "tanh"):
            for n in (1, 6, 13, 24):
                q8_check(codes, sx, kind, n, f"every code, scale {scale}")
                n_q8 += 1
    sx = torch.tensor(0.05, device=dev)
    for numel in (1, 15, 16, 17, 4095, 4096, (1 << 26) + 3):
        flat = _i8(torch, g, dev, (numel + 1,))
        for what, qx in (("aligned", flat[:numel]), ("offset 1", flat[1:])):
            for kind in ("relu", "sigmoid", "tanh"):
                q8_check(qx, sx, kind, 6, f"{numel} elements, {what}")
                n_q8 += 1
    torch.cuda.synchronize()
    print(f"V-ACT int8 edges: {n_q8} cases bitwise equal to the plain "
          "version (every code at four scales, sizes around the 16-byte "
          "chunks, views off alignment)")
    return worst


# the fxp8 actor's four products at M = n_envs (torso.fc1, torso.fc2, pi,
# v of the mlp actor-critic on cartpole, hidden 64): (K, N)
ACTOR_KN = ((4, 64), (64, 64), (64, 2), (64, 1))
# x = 4.2331 (fp32 bits 0x4087758e) and its neighbours, where the JAX
# reference's eager and compiled CORDIC differ (the port follows eager)
PINNED_BITS = (0x4087758C, 0x4087758D, 0x4087758E, 0x4087758F, 0x40877590)


def check_training_kernels(torch, dev, worst):
    """Phase 3, the training path's kernel: Q-MAC's int32 product at the
    fxp8 actor's four shapes, at M = 32 (the default run's envs) and at
    ragged M, bitwise against its plain version; and V-ACT's
    elementwise kernel at the pinned CORDIC input, tanh at x and sigmoid
    at 2x, n 6, 7 and 13, bitwise against its plain version (which the
    CPU tests hold bitwise to the eager reference)."""
    from repro_torch.kernels.qmac import ops as qmac_ops
    from repro_torch.kernels.vact import ops as vact_ops

    g = torch.Generator(device=dev).manual_seed(1357)
    cases = 0
    for m in (32, 1, 4, 7, 33, 100):
        for k, n in ACTOR_KN:
            qx, qw = _i8(torch, g, dev, (m, k)), _i8(torch, g, dev, (k, n))
            got = qmac_ops.qmac_i8(qx, qw)
            want = qmac_ops.qmac_i8_plain(qx, qw)
            worst["qmac_i8"] = max(worst["qmac_i8"], float(
                (got.long() - want.long()).abs().max().item()))
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8 != plain at the actor's "
                                     f"M,K,N={m},{k},{n}")
            cases += 1
    print(f"Q-MAC at the fxp8 actor's shapes: {cases} cases, int32 equal "
          "to the plain version")
    x = torch.tensor(PINNED_BITS, dtype=torch.int64).to(torch.int32).view(
        torch.float32).to(dev)
    x = torch.cat([x, -x])
    for n_it in (6, 7, 13):
        for kind, arg in (("tanh", x), ("sigmoid", 2.0 * x)):
            got = vact_ops.vact_ew(arg, kind, n_it)
            want = vact_ops.vact_ew_plain(arg, kind, n_it)
            err = (got - want).abs().max().item()
            worst["vact_ew"] = max(worst["vact_ew"], err)
            if not bits_equal(torch, got, want):
                raise AssertionError(f"vact_ew {kind} != plain at the "
                                     f"pinned input, n={n_it} (max abs err "
                                     f"{err})")
    # the JAX reference's eager cordic_tanh at x, n = 6 (its compiled
    # one gives 0.9995922): the shortest decimal of the fp32 value
    tanh6 = vact_ops.vact_ew(x[2:3], "tanh", 6)
    if not bits_equal(torch, tanh6, torch.tensor([0.9995657], device=dev)):
        raise AssertionError(f"vact_ew tanh at the pinned input, n=6: "
                             f"{tanh6.item()!r}, not the eager reference's "
                             "0.9995657")
    print("V-ACT at the pinned input x = 4.2331 and its neighbours: 6 "
          "cases bitwise equal to the plain version; tanh(x) at n=6 is "
          "0.9995657, the eager reference's value")
    torch.cuda.synchronize()
    return worst


# the pixel runs' actor convs (phase 10), stride 2 SAME 3x3: (H, W, C,
# C_out) of E2HRL's stem on keydoor's 32x32x3 frames and of the conv
# actor-critic on catch's 10x5 frames stacked 4 deep
PIXEL_CONVS = ((32, 32, 3, 16), (16, 16, 16, 32), (8, 8, 32, 32),
               (10, 5, 4, 16), (5, 3, 16, 32))
# and their actor products (K, N): E2HRL's stem fc, sub-goal fc1, fc2,
# action and value heads; the conv actor-critic's fc, pi and v
PIXEL_KN = ((512, 32), (32, 32), (32, 8), (40, 4), (40, 1),
            (192, 128), (128, 3), (128, 1))


def check_pixel_kernels(torch, dev, worst):
    """Phase 3, the pixel training paths' kernels: Q-Conv at every actor
    conv of both runs and Q-MAC at every actor product, at the rollout's
    batch of 32 and at ragged batches, against their plain versions
    (fp32 bitwise, int32 equal)."""
    from repro_torch.kernels.qconv import ops as qconv_ops
    from repro_torch.kernels.qmac import ops as qmac_ops

    g = torch.Generator(device=dev).manual_seed(2468)
    n_conv = n_mm = 0
    for b in (32, 1, 5, 33):
        for h, w, c, nc in PIXEL_CONVS:
            qx, qw = _i8(torch, g, dev, (b, h, w, c)), _i8(torch, g, dev,
                                                         (3, 3, c, nc))
            sx = torch.rand((b, h, w, 1), generator=g, device=dev) * 0.02
            sw = torch.rand((nc,), generator=g, device=dev) * 0.02 + 1e-4
            bias = torch.randn(nc, generator=g, device=dev) * 0.1
            kw = dict(stride=2, padding="SAME", fuse_relu=True)
            got = qconv_ops.qconv2d_i8(qx, sx, qw, sw, bias, **kw)
            want = qconv_ops.qconv2d_i8_plain(qx, sx, qw, sw, bias, **kw)
            err = (got - want).abs().max().item()
            worst["qconv_i8_taps"] = max(worst["qconv_i8_taps"], err)
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qconv != plain at the pixel runs' "
                                     f"x[{b},{h},{w},{c}] -> {nc} (max abs "
                                     f"err {err})")
            n_conv += 1
        for k, n in PIXEL_KN:
            qx, qw = _i8(torch, g, dev, (b, k)), _i8(torch, g, dev, (k, n))
            got = qmac_ops.qmac_i8(qx, qw)
            want = qmac_ops.qmac_i8_plain(qx, qw)
            worst["qmac_i8"] = max(worst["qmac_i8"], float(
                (got.long() - want.long()).abs().max().item()))
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8 != plain at the pixel runs' "
                                     f"M,K,N={b},{k},{n}")
            n_mm += 1
    torch.cuda.synchronize()
    print(f"Q-Conv at the pixel runs' {len(PIXEL_CONVS)} actor convs and "
          f"Q-MAC at their {len(PIXEL_KN)} products, batches 32, 1, 5 and "
          f"33: {n_conv} and {n_mm} cases equal to the plain versions")
    return worst


def _i8(torch, g, dev, shape):
    return torch.randint(-127, 128, shape, generator=g, device=dev,
                         dtype=torch.int32).to(torch.int8)


def _yardstick(torch, fn, what):
    """Time one PyTorch call beside a kernel; None where the library
    refuses the shape (``torch._int_mm`` wants M > 16 and K, N multiples
    of 8)."""
    try:
        return device_ms(torch, fn)
    except RuntimeError as e:
        print(f"{what} refused this shape: {str(e).splitlines()[0]}")
        return None


def _time_qmac(torch, g, dev, m, k, n):
    """Q-MAC at one shape: (int32 row, fused row)."""
    from repro_torch.kernels.qmac import ops as qmac_ops

    qx, qw = _i8(torch, g, dev, (m, k)), _i8(torch, g, dev, (k, n))
    sx = torch.rand((m, 1), generator=g, device=dev) * 0.01
    sw = torch.rand((1, n), generator=g, device=dev) * 0.01
    shape = f"M={m} K={k} N={n}"
    p = qmac_ops.split_plan(m, k, n)
    plan = f"{p.splits} slices of {p.slice} B, {p.blocks} blocks"
    b_ms, b_by = bound_ms(m * k + k * n + 4 * m * n, 2.0 * m * n * k)
    i32 = dict(
        shape=shape, plan=plan,
        ms=device_ms(torch, lambda: qmac_ops.qmac_i8(qx, qw)),
        plain_ms=device_ms(torch, lambda: qmac_ops.qmac_i8_plain(qx, qw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=_yardstick(torch, lambda: torch._int_mm(qx, qw),
                              "torch._int_mm"))
    b_ms, b_by = bound_ms(m * k + k * n + 4 * m + 4 * n + 4 * m * n,
                          2.0 * m * n * k, 2.0 * m * n)
    deq = dict(
        shape=shape, plan=plan,
        ms=device_ms(torch, lambda: qmac_ops.qmac_i8_deq(qx, sx, qw, sw)),
        plain_ms=device_ms(torch, lambda: qmac_ops.qmac_i8_deq_plain(
            qx, sx, qw, sw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return i32, deq


def _time_qconv(torch, g, dev, bsz, h, c, nc, w=None):
    """Q-Conv at one stride-2 SAME 3x3 layer (an h x w frame, square
    unless ``w`` is given)."""
    import torch.nn.functional as F
    from repro_torch.kernels.qconv import ops as qconv_ops

    w = h if w is None else w
    cx = _i8(torch, g, dev, (bsz, h, w, c))
    cw = _i8(torch, g, dev, (3, 3, c, nc))
    csx = torch.rand((bsz, h, w, 1), generator=g, device=dev) * 0.01
    csw = torch.rand((nc,), generator=g, device=dev) * 0.01
    cb = torch.rand((nc,), generator=g, device=dev) * 0.1
    kw = dict(stride=2, padding="SAME", fuse_relu=True)
    p = qconv_ops.band_plan(bsz, h, w, c, 3, 3, nc, 2, "SAME")
    ho, wo, pt, pb, plf, prt = qconv_ops.out_geometry(h, w, 3, 3, 2, "SAME")
    mo = bsz * ho * wo
    b_ms, b_by = bound_ms(bsz * h * w * c + 4 * bsz * h * w + 9 * c * nc
                          + 8 * nc + 4 * mo * nc,
                          2.0 * mo * nc * 9 * c, mo * nc * (2 * 9 + 3))
    # the yardstick: one fp32 cuDNN convolution (TF32 off) of the
    # dequantized input with the dequantized filters, operands laid out
    # and padded (SAME at stride 2: (0, 1) at an even size, (1, 1) at an
    # odd one) beforehand
    xd = F.pad((cx.float() * csx).permute(0, 3, 1, 2), (plf, prt, pt, pb))
    wd = (cw.float() * csw).permute(3, 2, 0, 1).contiguous()
    return dict(
        shape=f"x[{bsz},{h},{w},{c}] w[3,3,{c},{nc}] stride 2 SAME",
        plan=(f"bands of {p.rows} rows, N tile {p.n_tile}, {p.threads} "
              f"threads, {p.smem} B shared, {p.blocks} blocks"),
        ms=device_ms(torch, lambda: qconv_ops.qconv2d_i8(
            cx, csx, cw, csw, cb, **kw)),
        plain_ms=device_ms(torch, lambda: qconv_ops.qconv2d_i8_plain(
            cx, csx, cw, csw, cb, **kw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=_yardstick(
            torch, lambda: F.conv2d(xd, wd, cb, stride=2), "F.conv2d"))


def cordic_exp_flops(n: int) -> int:
    """fp32 operations of one CORDIC e^x as the kernels run it: divide,
    floor, multiply, subtract; 5 per iteration (two scalings, two adds,
    one angle update); the final add, clamp, 2^m and scaling."""
    return 4 + 5 * n + 5


def vact_flops(kind: str, n: int) -> int:
    """fp32 operations of one V-ACT element: sigmoid adds |x|, negate,
    add, divide and select to e^x; tanh two multiplies and a subtract
    to sigmoid; relu one compare."""
    sig = cordic_exp_flops(n) + 5
    return {"relu": 1, "sigmoid": sig, "tanh": sig + 3}[kind]


def ew_plan_text(x) -> str:
    """How ``vact_ew`` launches on ``x``."""
    from repro_torch.kernels.vact import ops as vact_ops
    op = vact_ops.ew_operand(tuple(x.shape), x.stride())
    rows, cols, ld = op if op is not None else (1, x.numel(), x.numel())
    p = vact_ops.ew_plan(rows * cols)
    return (f"{'in place' if op is not None else 'contiguous copy first'}"
            f" as [{rows}, {cols}] at row stride {ld}, one element a "
            f"thread, {p.threads} threads x {p.blocks} blocks")


def softmax_plan_text(x) -> str:
    """How ``vact_softmax`` launches on ``x``."""
    from repro_torch.kernels.vact import ops as vact_ops
    op = vact_ops.softmax_operand(tuple(x.shape), x.stride())
    cols = x.shape[-1]
    rows, cols, ld = op if op is not None else (x.numel() // cols, cols,
                                                cols)
    p = vact_ops.softmax_plan(rows, cols)
    how = {"rows": f"{p.lanes} lanes a row, {32 // max(p.lanes, 1)} rows "
                   "a warp",
           "block": f"one block a row, {p.staged} of {cols} staged in "
                    f"{p.smem} B shared"}[p.regime]
    return (f"{'in place' if op is not None else 'contiguous copy first'}"
            f" at row stride {ld}; {p.regime} kernel, {how}, {p.threads} "
            f"threads x {p.blocks} blocks")


def q8_plan_text(n: int) -> str:
    from repro_torch.kernels.vact import ops as vact_ops
    p = vact_ops.q8_plan(n)
    return (f"256-code table a block, {p.threads} threads x {p.blocks} "
            f"blocks, {p.items} 16-byte chunks a thread")


def cell_plan_text(b, d_in, hid) -> str:
    from repro_torch.kernels.qlstm import ops as qlstm_ops
    p = qlstm_ops.cell_plan(b, d_in, hid)
    return (f"{p.row_groups} x {p.unit_groups} blocks of {p.rows} rows x "
            f"{p.units} units, {p.threads} threads, {p.smem} B shared")


APPROX = "approximate: not CORDIC"


def time_ew(torch, x, n_iters, what):
    """``vact_ew`` tanh on ``x`` (contiguous or a view) beside its plain
    version, ``torch.tanh`` and its bound."""
    from repro_torch.kernels.vact import ops as vact_ops

    el = x.numel()
    b_ms, b_by = bound_ms(8 * el, fp32_ops=el * vact_flops("tanh", n_iters))
    return dict(shape=f"{what} n={n_iters} tanh", plan=ew_plan_text(x),
                ms=device_ms(torch, lambda: vact_ops.vact_ew(x, "tanh",
                                                             n_iters)),
                plain_ms=device_ms(torch, lambda: vact_ops.vact_ew_plain(
                    x, "tanh", n_iters)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_ms(torch, lambda: torch.tanh(x)),
                library=f"torch.tanh, {APPROX}")


def time_softmax(torch, x, n_iters, what):
    """``vact_softmax`` on ``x`` beside its plain version,
    ``torch.softmax`` and its bound."""
    from repro_torch.kernels.vact import ops as vact_ops

    el = x.numel()
    # per element: subtract the max, e^x, add to the sum, divide
    b_ms, b_by = bound_ms(8 * el, fp32_ops=el * (
        cordic_exp_flops(n_iters) + 4))
    return dict(shape=f"{what} n={n_iters} softmax",
                plan=softmax_plan_text(x),
                ms=device_ms(torch, lambda: vact_ops.vact_softmax(x,
                                                                  n_iters)),
                plain_ms=device_ms(torch, lambda: vact_ops.vact_softmax_plain(
                    x, n_iters)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_ms(torch, lambda: torch.softmax(x, -1)),
                library=f"torch.softmax, {APPROX}")


def time_q8(torch, qx, n_iters, what):
    """``vact_ew_q8`` tanh on ``qx`` beside its plain version and its
    bound: the bytes (n in, n out, the scale), since a call's output is
    a function of at most 256 codes and the least work is 256
    evaluations and a gather."""
    from repro_torch.kernels.vact import ops as vact_ops

    sx = torch.full((), 0.02, device=qx.device)
    b_ms, b_by = bound_ms(2 * qx.numel() + 4)
    return dict(shape=f"{what} n={n_iters} tanh, int8",
                plan=q8_plan_text(qx.numel()),
                ms=device_ms(torch, lambda: vact_ops.vact_q8(
                    qx, sx, "tanh", n_iters)),
                plain_ms=device_ms(torch, lambda: vact_ops.vact_q8_plain(
                    qx, sx, "tanh", n_iters)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def _time_vact(torch, g, dev, m, n_col, n_iters):
    """V-ACT at one shape: (elementwise tanh, q8 tanh) rows."""
    x = torch.randn((m, n_col), generator=g, device=dev) * 2
    qx = _i8(torch, g, dev, (m, n_col))
    return (time_ew(torch, x, n_iters, f"[{m}, {n_col}]"),
            time_q8(torch, qx, n_iters, f"[{m}, {n_col}]"))


def time_vact_large(torch, g, dev, n_iters=6):
    """Softmax and int8 rows past the path's sizes, each larger than the
    50 MB L2 so the timed launches read device memory: softmax at
    [4096, 8192] (block kernel, rows staged) and [256, 65536] (rows past
    shared memory), int8 at 2^26 elements."""
    sm = [time_softmax(torch, torch.randn((r, c), generator=g, device=dev)
                       * 2, n_iters, f"[{r}, {c}]")
          for r, c in ((4096, 8192), (256, 65536))]
    q8 = time_q8(torch, _i8(torch, g, dev, (1 << 26,)), n_iters,
                 "[67108864]")
    return sm, q8


def time_gate_slice_and_floor(torch, g, dev, n_iters=6):
    """``vact_ew`` on the [128, 32] column slice of a [128, 128] gate
    tensor, as the LSTM's xla branch passes it, and on one element: the
    launch floor under ``device_ms``'s timing."""
    from repro_torch.kernels.vact import ops as vact_ops

    gates = torch.randn((128, 128), generator=g, device=dev) * 2
    row = time_ew(torch, gates[:, 32:64], n_iters,
                  "[128, 32] gate slice of [128, 128]")
    one = torch.randn((1,), generator=g, device=dev)
    floor = device_ms(torch, lambda: vact_ops.vact_ew(one, "tanh", n_iters))
    return row, floor


def _time_qlstm(torch, g, dev, b, d_in, hid, n_iters):
    """The fused Q-LSTM cell at one shape."""
    from repro_torch.kernels.qlstm import ops as qlstm_ops

    g4 = 4 * hid
    args = (_i8(torch, g, dev, (b, d_in)), torch.full((), 0.01, device=dev),
            _i8(torch, g, dev, (b, hid)), torch.full((), 0.01, device=dev),
            _i8(torch, g, dev, (d_in, g4)),
            torch.rand((1, g4), generator=g, device=dev) * 0.004,
            _i8(torch, g, dev, (hid, g4)),
            torch.rand((1, g4), generator=g, device=dev) * 0.004,
            torch.randn(g4, generator=g, device=dev) * 0.1,
            torch.randn((b, hid), generator=g, device=dev))
    nbytes = (b * d_in + b * hid + (d_in + hid) * g4 + 4 * (2 + 3 * g4)
              + 4 * b * hid + 8 * b * hid)
    # per hidden unit: 4 gates x (4 multiplies, 2 adds), 3 sigmoids and
    # 2 tanhs, the cell update (2 multiplies, 1 add) and h's multiply
    per_unit = (4 * 6 + 3 * vact_flops("sigmoid", n_iters)
                + 2 * vact_flops("tanh", n_iters) + 4)
    b_ms, b_by = bound_ms(nbytes, 2.0 * b * (d_in + hid) * g4,
                          b * hid * per_unit)
    return dict(
        shape=f"B={b} Din={d_in} H={hid} n={n_iters}",
        plan=cell_plan_text(b, d_in, hid),
        ms=device_ms(torch, lambda: qlstm_ops.qlstm_cell(*args,
                                                         n_iters=n_iters)),
        plain_ms=device_ms(torch, lambda: qlstm_ops.qlstm_cell_plain(
            *args, n_iters)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def time_kernels(torch, dev):
    """Phase 4: every kernel beside its plain version and a library call,
    at each shape the paths give it: the serving path at its largest
    bucket (32), the HRL path at its largest call (512 frames; the
    LSTM's 128 rows per step), the training paths' actors at 32 envs
    (cartpole's mlp, E2HRL on keydoor, the conv actor-critic on catch),
    and V-ACT's softmax and int8 kernels also past the path's sizes.  No single PyTorch call computes a CORDIC
    activation bit for bit: ``torch.tanh`` and ``torch.softmax`` are the
    approximate yardsticks of ``vact_ew`` and ``vact_softmax``; the int8
    kernel and the fused cell have none.  Each kernel's first row is the
    one the JSON line reports."""
    g = torch.Generator(device=dev).manual_seed(7)
    rows = {"qmac_i8": [], "qmac_i8_deq": [], "qconv_i8_taps": [],
            "vact_ew": [], "vact_ew_q8": [], "vact_softmax": [],
            "qlstm_cell": []}
    for m, k, n in ((32, 2048, 128), (32, 128, 4),      # DQN fc, Q head
                    (512, 512, 32), (512, 40, 4),       # HRL stem fc, head
                    (1, 2048, 128), (8, 2048, 128)):    # fc, buckets 1, 8
        i32, deq = _time_qmac(torch, g, dev, m, k, n)
        rows["qmac_i8"].append(i32)
        rows["qmac_i8_deq"].append(deq)
    for k, n in ((64, 64), (4, 64)):      # the fxp8 actor's fc2, fc1
        rows["qmac_i8"].append(_time_qmac(torch, g, dev, 32, k, n)[0])
    for bsz, h, c, nc in ((32, 32, 12, 16), (32, 16, 16, 32),  # DQN
                          (512, 32, 3, 16), (512, 16, 16, 32)):  # HRL
        rows["qconv_i8_taps"].append(_time_qconv(torch, g, dev, bsz, h, c,
                                                 nc))
    # the pixel runs' actor convs and products at the rollout's 32 envs
    for h, w, c, nc in PIXEL_CONVS:
        rows["qconv_i8_taps"].append(_time_qconv(torch, g, dev, 32, h, c,
                                                 nc, w))
    for k, n in PIXEL_KN:
        rows["qmac_i8"].append(_time_qmac(torch, g, dev, 32, k, n)[0])
    # the HRL path: sub-goal tanh [512, 8], LSTM gates [128, 32], the
    # action softmax of FC-HRL [512, 4] and of LSTM-HRL [128, 4], all at
    # FxP8's 6 iterations; then softmax and int8 past the path's sizes
    for m, n_col in ((512, 8), (128, 32)):
        ew, q8 = _time_vact(torch, g, dev, m, n_col, 6)
        rows["vact_ew"].append(ew)
        rows["vact_ew_q8"].append(q8)
    gate_slice, floor = time_gate_slice_and_floor(torch, g, dev)
    rows["vact_ew"].append(gate_slice)
    for m in (512, 128):
        rows["vact_softmax"].append(time_softmax(torch, torch.randn(
            (m, 4), generator=g, device=dev) * 2, 6, f"[{m}, 4]"))
    sm, q8 = time_vact_large(torch, g, dev)
    rows["vact_softmax"] += sm
    rows["vact_ew_q8"].append(q8)
    rows["qlstm_cell"].append(_time_qlstm(torch, g, dev, 128, 32, 32, 6))
    print(BOUND_TEXT)
    for name, shapes in rows.items():
        for r in shapes:
            print_row(name, r)
    print(f"launch floor under this timing: vact_ew on 1 element "
          f"{floor:.5f} ms")
    return rows


BOUND_TEXT = (
    "bound_ms = max(bytes / 3.35e12 B/s, int8 ops / 1.979e15 + fp32 ops / "
    "6.7e13) in ms; bytes = inputs read once + outputs written once; V-ACT "
    "fp32 ops per element: relu 1, sigmoid 14 + 5n, tanh 17 + 5n, softmax "
    "13 + 5n (n CORDIC iterations); vact_ew_q8: bytes only (n in, n out, "
    "the scale), since its output is a function of at most 256 codes a "
    "call and the least work is 256 evaluations and a gather, so a per-"
    "element operation count would let a table kernel read above its "
    "bound; Q-LSTM: int8 ops 2 B (Din + H) 4H, fp32 ops per hidden unit "
    "24 + 3 sigmoids + 2 tanhs + 4; library_ms marked approximate "
    "computes the same function in fp32 (torch.tanh, torch.softmax), "
    "not CORDIC bit for bit, and the port never calls it")


def print_row(name, r):
    lib = r["library_ms"]
    lib = "n/a" if lib is None else f"{lib:.5f}"
    if "library" in r:
        lib += f" ({r['library']})"
    print(f"{name:14s} {r['shape']}: kernel_ms {r['ms']:.5f}  plain_ms "
          f"{r['plain_ms']:.5f}  library_ms {lib}  bound_ms "
          f"{r['bound_ms']:.6f} ({r['bound_by']})"
          + (f"  [{r['plan']}]" if "plan" in r else ""))


SERVING_KERNELS = ("qmac_i8", "qmac_i8_deq", "qconv_i8_taps")
HRL_KERNELS = ("qmac_i8", "qconv_i8_taps", "vact_ew", "vact_softmax",
               "qlstm_cell")


def main_path(torch, dev, work):
    """Phase 5: serve a full-width conv DQN on keydoor at w8 and w4."""
    from repro_torch import kernels
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.serve_policy import serve_policy
    from repro_torch.rl.inference import build_env, make_value_agent
    from repro_torch.rl.rollout import init_envs
    from repro_torch.serve import load_policy

    env = build_env("keydoor", "conv", 4)
    agent = make_value_agent("dqn", env.spec,
                             gen=torch.Generator().manual_seed(0),
                             net="conv", device=dev)
    n_envs = 16
    est, obs = init_envs(env, 0, n_envs, dev)
    act_gen = torch.Generator().manual_seed(1)
    for _ in range(32):       # non-trivial Welford stats for the carry
        est, obs, *_ = env.step(est, env.action_space.sample(
            act_gen, n_envs, dev))
    ckpt = os.path.join(work, "ckpt")
    CheckpointManager(ckpt).save(
        1, (agent.params, None, None, None, est, obs),
        metadata={"algo": "dqn", "env": "keydoor", "net": "conv",
                  "frame_stack": 4, "n_envs": n_envs,
                  "schema": "trainstate/v1"})

    kernels.reset_launch_counts()
    served = {}
    for precision in ("w8", "w4"):
        st = serve_policy(ckpt, precision=precision, episodes=200,
                          n_slots=64, max_bucket=32, do_check_parity=True,
                          device=dev)
        if st.episodes < 200:
            raise AssertionError(f"{precision}: served only "
                                 f"{st.episodes} episodes")
        served[precision] = st
    launches = kernels.launch_counts()
    print(f"kernel launches on the serving path: {launches}")
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the serving "
                                 "path")

    # the served forward on the card against the plain path on the CPU,
    # same weights, same observations
    from repro_torch.core.fxp import QTensor
    from repro_torch.tree import tree_map
    policy = load_policy(ckpt, device=dev)
    _, obs = init_envs(policy.env, 3, 32, dev)
    for precision in ("w8", "w4"):
        packed, pol = policy.pack(precision)
        q_dev = policy.agent.qvals(packed, obs, pol)
        cpu = tree_map(lambda t: t.to("cpu"), packed,
                       is_leaf=lambda x: isinstance(x, QTensor))
        q_cpu = policy.agent.qvals(cpu, obs.cpu(), pol)
        if q_dev.shape != (32, 4) or not torch.isfinite(q_dev).all():
            raise AssertionError(f"{precision}: bad Q-values {q_dev.shape}")
        err = (q_dev.cpu() - q_cpu).abs().max().item()
        print(f"{precision}: served Q-values on the card vs the plain "
              f"path on the CPU: max abs err {err}")
        if not torch.equal(q_dev.cpu().view(torch.int32),
                           q_cpu.view(torch.int32)):
            raise AssertionError(f"{precision}: card and CPU Q-values "
                                 "differ")
    return launches, served


# the port's kernels in a trace, by name, and the wrappers that launch them
PORT_KERNELS = (("qmac_kernel", ("qmac_i8", "qmac_i8_deq")),
                ("qconv_kernel", ("qconv_i8_taps",)),
                ("vact_ew_kernel", ("vact_ew",)),
                ("vact_ew_q8_kernel", ("vact_ew_q8",)),
                (r"vact_softmax_\w*kernel", ("vact_softmax",)),
                ("qlstm_cell_kernel", ("qlstm_cell",)))
TRACE_TRIES = 3


def _port_kernel(name: str):
    """The index in PORT_KERNELS of the kernel a trace row names, or
    None for PyTorch's own kernels."""
    import re
    for i, (pattern, _) in enumerate(PORT_KERNELS):
        if re.search(rf"\b{pattern}\b", name):
            return i
    return None


def _profiled(torch, fn, n):
    """``n`` calls of ``fn`` (each ending in a synchronize) under
    ``torch.profiler``, after three calls the profiler traces and drops:
    (host wall ms per call, [(device ms per call, launches per call,
    kernel name)] sorted by time, device launches per call, and why that
    count is None; then each row holds the launches read in all ``n``
    calls).

    CUPTI can drop kernel records from a trace.  The port's launches are
    the wrappers' counters over the ``n`` traced calls; a trace is taken
    only when every kernel row counts a whole multiple of ``n`` launches
    and the port's rows count what the counters do.  Otherwise it traces
    again, up to ``TRACE_TRIES`` times, and then gives no launch count,
    only the rows as read and the port's launches by counter and by
    trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import kernels

    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=1, warmup=2, active=n)) as prof:
            for i in range(3 + n):
                if i == 3:
                    kernels.reset_launch_counts()
                    t0 = time.perf_counter()
                fn()
                if i == 2 + n:
                    wall_ms = (time.perf_counter() - t0) * 1e3 / n
                    counts = kernels.launch_counts()
                prof.step()
        rows, traced = [], [0] * len(PORT_KERNELS)
        for ev in prof.key_averages():
            # the kernels themselves (operators' rows would count them
            # twice; the schedule's step annotation spans the whole call)
            if (ev.device_type != DeviceType.CUDA
                    or ev.key.startswith("ProfilerStep")):
                continue
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = ev.cuda_time_total
            rows.append((dev_us / n / 1e3, ev.count, ev.key))
            k = _port_kernel(ev.key)
            if k is not None:
                traced[k] += ev.count
        rows.sort(reverse=True)
        want = [sum(counts[w] for w in wrappers)
                for _, wrappers in PORT_KERNELS]
        if all(c % n == 0 for _, c, _ in rows) and traced == want:
            return (wall_ms, [(ms, c // n, name) for ms, c, name in rows],
                    sum(c for _, c, _ in rows) // n, None)
    return (wall_ms, rows, None,
            f"trace not whole after {TRACE_TRIES} tries; the port's "
            f"kernels: {sum(want)} launches by the wrappers' counters, "
            f"{sum(traced)} in the trace; rows below: launches read in "
            f"{n} calls")


def _print_profile(what, wall_ms, rows, launches, why, top, per="forward"):
    busy_ms = sum(r[0] for r in rows)
    count = (f"{launches} device launches per {per}" if why is None else
             f"launches per {per}: not measured ({why})")
    print(f"{what}: wall {wall_ms:.4f} ms, device busy {busy_ms:.4f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, {count}")
    for ms, count, name in rows[:top if why is None else len(rows)]:
        print(f"  {ms:.5f} ms  x{count:g}  {name[:90]}")
    if not rows:
        print("  the profiler recorded no device time (not measured)")


def profile_forward(torch, dev, ckpt, n=50, what="served forward"):
    """Phase 6: where a served forward's time goes.  ``n`` w8 forwards of
    a full bucket (32) under ``torch.profiler``: device time per forward
    by kernel name, beside the host wall time per forward (each ``act``
    ends in a synchronize), so the device's idle share shows.  Phase 12
    profiles the value checkpoints' forwards the same way.  Returns the
    port's launches of one such forward, by the wrappers' counters."""
    from repro_torch import kernels
    from repro_torch.rl.rollout import init_envs
    from repro_torch.serve import PolicyServer, load_policy

    server = PolicyServer(load_policy(ckpt, device=dev), precision="w8",
                          max_bucket=32)
    _, obs = init_envs(server.policy.env, 4, 32, dev)
    server.warmup(32)
    kernels.reset_launch_counts()
    server.act(obs)
    per = {k: v for k, v in kernels.launch_counts().items() if v}
    wall, rows, launches, why = _profiled(torch, lambda: server.act(obs), n)
    _print_profile(f"{what}, bucket 32, w8", wall, rows, launches, why,
                   top=10)
    return per


def _keydoor_frames(torch, dev):
    """keydoor's own frames: 512 envs after a reset, and 128 envs'
    windows of their last 4 frames (random actions, seeded)."""
    from repro_torch.rl.envs import make
    from repro_torch.rl.rollout import init_envs

    env = make("keydoor")
    gen = torch.Generator().manual_seed(2)
    est, obs = init_envs(env, 0, 512, dev)
    west, wobs = init_envs(env, 1, 128, dev)
    frames = [wobs]
    for _ in range(3):
        west, wobs, *_ = env.step(west, env.action_space.sample(gen, 128,
                                                                dev))
        frames.append(wobs)
    return env, est, obs, torch.stack(frames, dim=1)


def hrl_path(torch, dev):
    """Phase 7: the E2HRL agent at its published width on keydoor."""
    from repro_torch import kernels
    from repro_torch.configs.e2hrl import HRLConfig
    from repro_torch.core.fxp import QTensor
    from repro_torch.core.policy import FXP8
    from repro_torch.core.quantizer import quantize_params
    from repro_torch.models import hrl
    from repro_torch.tree import tree_map

    env, est, obs, windows = _keydoor_frames(torch, dev)
    cfg_fc = HRLConfig(obs_shape=tuple(env.obs_shape),
                       n_actions=env.spec.n_actions)
    cfg_lstm = HRLConfig(obs_shape=tuple(env.obs_shape),
                         n_actions=env.spec.n_actions, subgoal_kind="lstm")
    pallas = FXP8.replace(backend="pallas", act_backend="cordic")
    xla = FXP8.replace(act_backend="cordic")
    p_fc = hrl.init(torch.Generator().manual_seed(0), cfg_fc, device="cpu")
    p_lstm = hrl.init(torch.Generator().manual_seed(0), cfg_lstm,
                      device="cpu")
    p_packed = quantize_params(p_fc, pallas)

    def to_dev(tree):
        return tree_map(lambda x: x.to(dev), tree,
                        is_leaf=lambda x: isinstance(x, QTensor))

    variants = [  # (name, cfg, cpu params, policy, observations)
        ("FC-HRL pallas", cfg_fc, p_fc, pallas, obs),
        ("LSTM-HRL pallas", cfg_lstm, p_lstm, pallas, windows),
        ("LSTM-HRL xla", cfg_lstm, p_lstm, xla, windows),
        ("FC-HRL packed w8", cfg_fc, p_packed, pallas, obs),
    ]
    dev_params = {name: to_dev(p) for name, _, p, _, _ in variants}

    kernels.reset_launch_counts()
    outs = {}
    for name, cfg, _, pol, o in variants:
        logits, value, _ = hrl.apply(dev_params[name], o, cfg, pol)
        outs[name] = (logits, value, hrl.action_probs(logits, pol))
    # act greedily on keydoor with FC-HRL
    returns = torch.zeros(obs.shape[0], device=dev)
    episodes = 0
    s, o = est, obs
    for _ in range(64):
        logits, _, _ = hrl.apply(dev_params["FC-HRL pallas"], o, cfg_fc,
                                 pallas)
        s, o, reward, done, trunc, _ = env.step(
            s, torch.argmax(logits, dim=-1).to(torch.int32))
        returns += reward
        episodes += int((done | trunc).sum().item())
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"kernel launches on the HRL path: {launches}")
    for k in HRL_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"{k} never launched on the HRL path")
    print(f"FC-HRL greedy on keydoor: 64 steps x 512 envs, {episodes} "
          f"episodes ended, mean return {returns.mean().item():.4f}")

    # the card against the plain path on the CPU, same weights and frames
    for name, cfg, p_cpu, pol, o in variants:
        logits, value, probs = outs[name]
        want_l, want_v, _ = hrl.apply(p_cpu, o.cpu(), cfg, pol)
        want_p = hrl.action_probs(want_l, pol)
        b = o.shape[0]
        if logits.shape != (b, cfg.n_actions) or value.shape != (b,) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"{name}: bad outputs {logits.shape} "
                                 f"{value.shape}")
        err_l = (logits.cpu() - want_l).abs().max().item()
        err_v = (value.cpu() - want_v).abs().max().item()
        err_p = (probs.cpu() - want_p).abs().max().item()
        print(f"{name}: card vs CPU plain path, logits max abs err {err_l}, "
              f"values {err_v}, probabilities {err_p}")
        if not (bits_equal(torch, logits.cpu(), want_l)
                and bits_equal(torch, value.cpu(), want_v)):
            raise AssertionError(f"{name}: card and CPU logits/values "
                                 "differ")
        if not torch.allclose(probs.cpu(), want_p, rtol=1e-6, atol=FLT_MIN):
            raise AssertionError(f"{name}: probabilities off by {err_p}")

    # frames/s per variant (the paper's Table V quantity): 512 frames a
    # call, 512 single frames for FC-HRL, 128 windows of 4 for LSTM-HRL
    fps = {}
    for name, cfg, _, pol, o in variants:
        def fwd():
            logits, _, _ = hrl.apply(dev_params[name], o, cfg, pol)
            return torch.argmax(logits, dim=-1)
        for _ in range(3):
            fwd()
        torch.cuda.synchronize()
        n_calls = 20
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fwd()
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / n_calls
        fps[name] = o.shape[0] * (o.shape[1] if o.ndim == 5 else 1) / sec
        print(f"{name}: {fps[name]:.1f} frames/s ({sec * 1e3:.4f} ms per "
              f"call of {o.shape[0]} {'windows' if o.ndim == 5 else 'frames'})")
    return launches, fps, (dev_params["LSTM-HRL pallas"], cfg_lstm,
                           {"pallas": pallas, "xla": xla}, windows)


def profile_hrl(torch, lstm, n=20):
    """Phase 8: where an LSTM-HRL forward's time goes (128 windows of 4
    frames, CORDIC at FxP8) at pallas (fused Q-LSTM) and at xla (Q-MAC
    gates + V-ACT on the gate slices), as ``profile_forward`` reads it,
    with the port's kernel launches of one forward.  Returns the device
    launches per forward by branch: a whole count, or "not measured" and
    why (``_profiled``)."""
    from repro_torch import kernels
    from repro_torch.models import hrl

    params, cfg, policies, windows = lstm
    per_forward = {}
    for branch, pol in policies.items():
        def fwd():
            hrl.apply(params, windows, cfg, pol)
            torch.cuda.synchronize()

        kernels.reset_launch_counts()
        fwd()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        wall, rows, launches, why = _profiled(torch, fwd, n)
        _print_profile(f"LSTM-HRL forward, 128 windows x 4 frames, {branch}",
                       wall, rows, launches, why, top=12)
        print(f"  the port's kernels in one {branch} forward: {counts}")
        per_forward[branch] = (launches if why is None
                               else f"not measured ({why})")
    return per_forward


# the JAX reference's default run (``repro.rl.trainer.onpolicy.
# OnPolicyTrainer("cartpole", iters=40, seed=s)`` then its
# ``eval_policy``: 16 envs, 625 greedy steps) at seeds 0-4, by
# tools/ref_greedy_returns.py on a CPU with jax 0.9.0; the training phase
# fails if the port's median over its seeds falls under half the median
REF_GREEDY_RETURNS = (500.0, 156.43637084960938, 170.3541717529297, 500.0,
                      158.69387817382812)
REF_GREEDY_MEDIAN = statistics.median(REF_GREEDY_RETURNS)
TRAIN_SEEDS = (0, 1, 2)


def _counting_trainer(torch, kernels):
    """``OnPolicyTrainer`` (what ``rl_train`` runs) reading the port's
    launch counters around each iteration and timing its phases on the
    host clock: the weight sync (``pack``), the rollout and the learner,
    each ended by a wait for the card so the time is the phase's own.
    ``step`` runs the iteration's own two phases, as its body does, and
    keeps the params at the end of each stage."""
    from repro_torch.obs import SpanClock
    from repro_torch.rl.rollout import episode_returns
    from repro_torch.rl.trainer import OnPolicyTrainer
    from repro_torch.rl.trainer.state import onpolicy_state

    class Counted(OnPolicyTrainer):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.per_iter, self.clock = [], SpanClock()
            self.stage_params = []

        def pack(self, state):
            with self.clock("sync"):
                packed = super().pack(state)
                torch.cuda.synchronize()
            return packed

        def step(self, iteration, state, packed, gen, g, stage_ctx, alive):
            before = kernels.launch_counts()
            draws = self.draws(gen)
            with self.clock("rollout"):
                res = iteration.rollout_phase(packed, draws, state.est,
                                              state.obs)
                torch.cuda.synchronize()
            with self.clock("learn"):
                params, opt = iteration.learn_phase(
                    state.params, state.opt, res, draws, stage_ctx, alive)
                torch.cuda.synchronize()
            ret, n_ep = episode_returns(res.traj)
            after = kernels.launch_counts()
            self.per_iter.append({k: after[k] - before[k] for k in after})
            if (g + 1) % self.iters == 0:
                self.stage_params.append(params)
            return (onpolicy_state(params, opt, res.final_env,
                                   res.final_obs), ret, n_ep)

    return Counted


def training_path(torch, dev, card):
    """Phase 9: the training main path, ``rl_train``'s default run (ppo
    on cartpole, the mlp agent at hidden 64, fxp8 actors, an 8-bit sync,
    40 iterations of 32 envs x 128 steps) on the card at three seeds:
    greedy return, env steps/s, the wall split between sync, rollout and
    learner, and the Q-MAC launches of every iteration, which must be
    exactly 4 x (128 + 1)."""
    from repro_torch import kernels

    trainer_cls = _counting_trainer(torch, kernels)
    totals = dict.fromkeys(kernels.WRAPPERS, 0)
    returns = []
    for seed in TRAIN_SEEDS:
        tr = trainer_cls(seed=seed, device=dev, verbose=False)
        t0 = time.perf_counter()
        state, history = tr.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = 4 * (tr.rollout_len + 1)
        qmac = [c["qmac_i8"] for c in tr.per_iter]
        if len(qmac) != tr.iters or any(q != want for q in qmac):
            raise AssertionError(f"seed {seed}: qmac_i8 launches per "
                                 f"iteration {sorted(set(qmac))}, not "
                                 f"{want} in each of {tr.iters}")
        others = {k: sum(c[k] for c in tr.per_iter) for k in totals
                  if k != "qmac_i8" and any(c[k] for c in tr.per_iter)}
        if others:
            raise AssertionError(f"seed {seed}: kernels off the training "
                                 f"path launched: {others}")
        for c in tr.per_iter:
            for k, v in c.items():
                totals[k] += v
        t1 = time.perf_counter()
        ret, n_ep = tr.eval_policy(state.params)
        eval_s = time.perf_counter() - t1
        if not all(torch.isfinite(x).all() for x in
                   _leaves(state.params)):
            raise AssertionError(f"seed {seed}: non-finite params")
        returns.append(ret)
        spans = tr.clock.drain()
        steps = tr.iters * tr.n_envs * tr.rollout_len
        split = ", ".join(f"{k} {v:.3f} s ({v / wall:.3f})"
                          for k, v in spans.items())
        print(f"training seed {seed} on {card}: greedy return {ret} over "
              f"{n_ep} episodes (eval {eval_s:.2f} s); last train return "
              f"{history[-1]:.2f}; {steps} env steps in {wall:.3f} s = "
              f"{steps / wall:.1f} env steps/s; wall split: {split}; "
              f"qmac_i8 {want} launches in each of {tr.iters} iterations")
    median = statistics.median(returns)
    bar = REF_GREEDY_MEDIAN / 2
    print(f"training: median greedy return {median} over seeds "
          f"{TRAIN_SEEDS} (bar {bar}: half the reference's median "
          f"{REF_GREEDY_MEDIAN} at seeds 0-4)")
    if median < bar:
        raise AssertionError(f"median greedy return {median} < {bar}")
    return totals


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _phases(torch, dev, device, g=0, **kw):
    """A trainer's first iteration on ``device`` (default: the default
    run's; ``kw`` the run's flags): the trainer, its state, the
    iteration and its inputs, with the draws of global step ``g`` made
    on the CPU (so every device gets the same ones)."""
    from repro_torch.rl.train_steps import IterationDraws, iteration_generator
    from repro_torch.rl.trainer import OnPolicyTrainer

    tr = OnPolicyTrainer(seed=0, device=device, verbose=False, **kw)
    cpu = OnPolicyTrainer(seed=0, device="cpu", verbose=False, **kw)
    draws = cpu.draws(iteration_generator(0, g, torch.device("cpu")))
    draws = IterationDraws(*(t.to(device) for t in draws))
    state = tr.init_state()
    return tr, state, tr.build_iteration(), tr.pack(state), draws


def _recorded_codes(torch, fn):
    """``fn()``'s output and the int8 codes of every activation the fxp8
    program quantized in it, by row: each product's and conv's
    row-quantized input and each activation's requantized output (on the
    tensor-wide grid ``activation`` puts it on), [B, n]."""
    from repro_torch.core import fxp, qmatmul, vact
    from repro_torch.nn import conv

    rec = []
    rowwise, fake_quant = qmatmul.quantize_rowwise, vact.fake_quant

    def record_rowwise(x, bits):
        q, scale = rowwise(x, bits)
        rec.append(q)
        return q, scale

    def record_requant(x, bits, channel_axis=None):
        rec.append(fxp.quantize(x, bits, channel_axis=channel_axis)[0])
        return fake_quant(x, bits, channel_axis)

    qmatmul.quantize_rowwise = conv.quantize_rowwise = record_rowwise
    vact.fake_quant = record_requant
    try:
        out = fn()
    finally:
        qmatmul.quantize_rowwise = conv.quantize_rowwise = rowwise
        vact.fake_quant = fake_quant
    b = (out if isinstance(out, torch.Tensor) else out[0]).shape[0]
    return out, torch.cat([r.reshape(b, -1).to(torch.int32) for r in rec],
                          -1)


def _rollout_codes(torch, tr, packed, traj):
    """The actor's int8 codes at every step of ``traj`` on its own
    device, [T, B, n], after checking that re-running the forward on the
    step's observations gives the rollout's log-probs and values bit for
    bit (so the codes are the rollout's own)."""
    from repro_torch.rl.actor_learner import unpack_weights

    params = unpack_weights(packed)
    codes = []
    with torch.no_grad():
        for t in range(traj.obs.shape[0]):
            (logits, value), c = _recorded_codes(
                torch, lambda: tr.apply_fn(params, traj.obs[t], tr.a_policy))
            logp = tr.dist.log_prob(logits.to(torch.float32),
                                    traj.actions[t])
            if not (torch.equal(logp, traj.log_probs[t])
                    and torch.equal(value, traj.values[t])):
                raise AssertionError(f"{traj.obs.device}: the actor's "
                                     f"forward at step {t} is not the "
                                     "rollout's")
            codes.append(c)
    return torch.stack(codes)


def card_vs_cpu_iteration(torch, dev):
    """Phase 9: one default iteration on the card against the plain path
    on the CPU, the same params, env states and draws.  Every action
    equal; observations within rtol 1e-5; log-probs and values within
    rtol 1e-5 + atol 1e-6 at every (step, env) whose actor forward has
    the same int8 codes on both devices (each product's row-quantized
    input and each requantized tanh output); a row whose codes differ (a libm ulp
    between the devices' tanh, cos or sin that lands on a rounding tie)
    is exempt and counted; the updated params within atol 1e-5 + rtol
    1e-4 (the learner's fp32 sums run in each device's order)."""
    alive = torch.ones(1, dtype=torch.bool)
    runs = {}
    for where in (dev, torch.device("cpu")):
        tr, state, it, packed, draws = _phases(torch, dev, where)
        res = it.rollout_phase(packed, draws, state.est, state.obs)
        codes = _rollout_codes(torch, tr, packed, res.traj)
        out = it(state.params, state.opt, state.est, state.obs, packed,
                 draws, None, alive)
        runs[where.type] = (res, codes, out)
    (rd, cd, od), (rc, cc, oc) = runs["cuda"], runs["cpu"]
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    same = (cpu(rd.traj.actions) == rc.traj.actions).float().mean().item()
    differ = cpu(cd) != cc
    flipped = differ.any(-1)                     # [T, B]
    errs, off = {}, {}
    for f in ("log_probs", "values", "obs"):
        a, b = cpu(getattr(rd.traj, f)), getattr(rc.traj, f)
        errs[f] = (a - b).abs().max().item()
        bad = ~torch.isclose(a, b, rtol=1e-5, atol=1e-6)
        if f != "obs":
            errs[f + " where codes agree"] = (
                ((a - b).abs() * ~flipped).max().item())
            bad = bad & ~flipped
        off[f] = int(bad.sum())
    worst_p, ok = 0.0, True
    for a, b in zip(_leaves(od[0]), _leaves(oc[0]), strict=True):
        a = cpu(a)
        worst_p = max(worst_p, (a - b).abs().max().item())
        ok &= bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5))
    errs["params"] = worst_p
    errs["adam mu"] = max((cpu(a) - b).abs().max().item() for a, b in zip(
        _leaves(od[1]["mu"]), _leaves(oc[1]["mu"]), strict=True))
    print(f"training iteration, card vs CPU (same params, states, draws): "
          f"actions equal {same:.6f}; int8 codes that differ "
          f"{int(differ.sum())} of {differ.numel()}, in "
          f"{int(flipped.sum())} of "
          f"{flipped.numel()} actor rows; largest abs errors {errs}; "
          f"entries past rtol 1e-5 outside those rows {off}")
    if same != 1.0:
        raise AssertionError("card and CPU rollouts chose different actions")
    for f, n in off.items():
        if n:
            raise AssertionError(
                f"card and CPU {f}: {n} entries past rtol 1e-5 where the "
                "actor's int8 codes agree")
    if not ok:
        raise AssertionError("card and CPU params differ past atol 1e-5 + "
                             "rtol 1e-4 after one iteration")


# the rollout length of a profiled rollout phase: an eighth of the runs'
# 128 steps, so its trace stays small enough to read (a step's launches
# and device time are the same at any length); the learner is traced on
# a whole 128-step rollout, the batch the runs train on
PROFILE_STEPS = 16


def profile_training(torch, dev, n=2, run=None):
    """Phases 9 and 10: where a training iteration's time goes, its
    rollout (``PROFILE_STEPS`` steps of the fxp8 actor and the env) and
    its learner (GAE, 4 epochs x 4 minibatches of fp32 forward, backward
    and AdamW, on a whole rollout of the run's length collected
    untraced) each traced as ``profile_forward`` traces a forward, from
    the same inputs each call; the port's launches by the wrappers'
    counters.  The iteration's wall and idle share add the rollout
    scaled to the run's length to the learner.  ``run`` names a phase-10
    run (default: phase 9's default run); a two-stage run is traced in
    its first stage."""
    from repro_torch import kernels

    flags = PIXEL_RUNS[run]["kw"] if run else {}
    what = PIXEL_RUNS[run]["flags"] if run else "default run"
    short = _phases(torch, dev, dev, rollout_len=PROFILE_STEPS, **flags)
    tr, state, it, packed, draws = _phases(torch, dev, dev, **flags)
    alive = torch.ones(1, dtype=torch.bool)
    ctx = tr.stage_setup(state, tr.stage_list[0])
    res = it.rollout_phase(packed, draws, state.est, state.obs)

    def rollout():
        _, s_state, s_it, s_packed, s_draws = short
        s_it.rollout_phase(s_packed, s_draws, s_state.est, s_state.obs)
        torch.cuda.synchronize()

    def learn():
        it.learn_phase(state.params, state.opt, res, draws, ctx, alive)
        torch.cuda.synchronize()

    out = {}
    for name, fn, steps in (("rollout", rollout, PROFILE_STEPS),
                            ("learner", learn, tr.rollout_len)):
        kernels.reset_launch_counts()
        fn()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        wall, rows, launches, why = _profiled(torch, fn, n)
        _print_profile(f"training iteration ({what}), {name} phase "
                       f"({tr.n_envs} envs x {steps} steps)",
                       wall, rows, launches, why,
                       top=8, per="phase")
        print(f"  the port's kernels in one {name} phase: {counts}")
        out[name] = (wall, sum(r[0] for r in rows), launches, counts)
    scale = {"rollout": tr.rollout_len / PROFILE_STEPS, "learner": 1}
    wall = sum(v[0] * scale[k] for k, v in out.items())
    busy = sum(v[1] * scale[k] for k, v in out.items())
    print(f"training iteration ({what}), {tr.rollout_len} steps (the "
          f"rollout's times x {scale['rollout']:g}): wall {wall:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}; "
          "device launches " + ", ".join(f"{k} {v[2]}"
                                         for k, v in out.items()))
    per_forward = PIXEL_RUNS[run]["per_forward"] if run else {"qmac_i8": 4}
    want = {k: v * (PROFILE_STEPS + 1) for k, v in per_forward.items()}
    if out["rollout"][3] != want:
        raise AssertionError(f"rollout phase launched {out['rollout'][3]}, "
                             f"not {want}")
    if out["learner"][3]:
        raise AssertionError(f"learner launched {out['learner'][3]}")
    return out


# ---------------------------------------------------------------------------
# phase 10: training from pixels
# ---------------------------------------------------------------------------

# the two pixel runs at their defaults (32 envs x 128 steps, fxp8
# actors, an 8-bit sync, lr 3e-3, 40 iterations a stage): the flags,
# the JAX reference's greedy returns at seeds 0-2 after training and of
# its untrained initial params (``tools/ref_greedy_returns.py --seeds 0
# 1 2`` with the flags, and with ``--iters 0``, on a CPU with jax
# 0.9.0), and each actor forward's launches of the port's kernels
PIXEL_RUNS = {
    "hrl_training": dict(
        flags="--env keydoor --agent hrl --two-stage",
        kw=dict(env_name="keydoor", agent="hrl", two_stage=True),
        ref=(0.14136387407779694, 0.45800018310546875,
             -0.00611087353900075),
        untrained=(-0.6399996876716614, -0.5774997472763062,
                   -0.4864703416824341),
        per_forward={"qconv_i8_taps": 3, "qmac_i8": 5}),
    "pixel_training": dict(
        flags="--env catch --net conv --frame-stack 4",
        kw=dict(env_name="catch", net="conv", frame_stack_k=4),
        ref=(-0.25, 0.125, 0.625), untrained=(0.625, -0.5, -0.5),
        per_forward={"qconv_i8_taps": 2, "qmac_i8": 3}),
}
WORKER_TIMEOUT_S = 600


def pixel_bar(run):
    """(bar, reference median, untrained median): half the way from the
    untrained policy's median greedy return to the trained reference's
    (the reference beats its untrained policy in both runs)."""
    cfg = PIXEL_RUNS[run]
    ref = statistics.median(cfg["ref"])
    u = statistics.median(cfg["untrained"])
    return u + 0.5 * (ref - u), ref, u


def train_seed(torch, dev, run, seed):
    """Phase 10 worker: one seed of one pixel run through the trainer
    ``rl_train`` runs, on the card: the port's launch counters read in
    every iteration (exactly ``per_forward`` x 129 each, nothing else),
    the wall split, the greedy return of the untrained params, after
    each stage and at the end."""
    from repro_torch import kernels

    cfg = PIXEL_RUNS[run]
    tr = _counting_trainer(torch, kernels)(seed=seed, device=dev,
                                           verbose=False, **cfg["kw"])
    untrained, _ = tr.eval_policy(tr._init_params)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = {k: v * (tr.rollout_len + 1)
            for k, v in cfg["per_forward"].items()}
    n_iters = tr.iters * len(tr.stage_list)
    got = [{k: v for k, v in c.items() if v} for c in tr.per_iter]
    if len(got) != n_iters or any(c != want for c in got):
        odd = sorted({json.dumps(c, sort_keys=True) for c in got})
        raise AssertionError(f"{run} seed {seed}: launches per iteration "
                             f"{odd} over {len(got)} iterations, not "
                             f"{want} in each of {n_iters}")
    if not all(torch.isfinite(x).all() for x in _leaves(state.params)):
        raise AssertionError(f"{run} seed {seed}: non-finite params")
    t1 = time.perf_counter()
    ret, n_ep = tr.eval_policy(state.params)
    stage_returns = [tr.eval_policy(p)[0] for p in tr.stage_params]
    return dict(seed=seed, ret=ret, n_ep=n_ep, untrained=untrained,
                stage_returns=stage_returns, eval_s=time.perf_counter() - t1,
                wall=wall, steps=n_iters * tr.n_envs * tr.rollout_len,
                iters=n_iters, spans=tr.clock.drain(), per_iter=want,
                totals={k: sum(c[k] for c in tr.per_iter)
                        for k in kernels.WRAPPERS},
                last_train_return=[history[(i + 1) * tr.iters - 1]
                                   for i in range(len(tr.stage_list))])


def _tree_to(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def _tree_copy(tree, device):
    """``tree`` on ``device``, every leaf a copy (the replay buffer is
    written in place)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device, copy=True), tree)


def _learner_updates_card_vs_cpu(torch, dev, cpu_run, rc, cpu_out):
    """The CPU learner's minibatch updates one at a time (the GAE batch,
    then per update the gradient with the stage mask, and AdamW with its
    clipping, as ``learn_phase`` runs them), each also run on the card
    from the CPU's state before it.  Per update: the card's gradient
    within rtol 1e-5 of each leaf's largest entry of the CPU's (the
    learners' fp32 sums, cuDNN's among them, run in another order),
    unless a ReLU of the forward passed on one device and not on the
    other (a pre-activation within those sums' error of zero: that
    sample's whole contribution through the unit switches), and such
    updates are exempt and counted; and AdamW on the card, given the
    CPU's gradient, within atol 1e-5 + rtol 1e-4 of the CPU's params and
    moments.  Adam divides each entry's
    step by its own gradient's scale, so where that scale is near
    ``eps`` a gradient's last bits move the step by a share of ``lr``:
    the params after the card's own gradient are reported, not held.
    The CPU's updates must end bitwise where its ``learn_phase`` did, so
    they are the learner's own.  Returns (largest abs errors, whether
    every update held)."""
    from repro_torch.core import vact
    from repro_torch.optim import adamw_update
    from repro_torch.rl.actor_learner import fleet_mask
    from repro_torch.rl.ppo import (apply_stage_mask, batch_from_traj,
                                    value_and_grad)

    where, tr, state, _, draws, ctx, _, _ = cpu_run

    def learner(p, o):
        return tr.apply_fn(p, o, None)

    pcfg = tr.pcfg
    params, opt = state.params, state.opt
    mask = fleet_mask(torch.ones(1, dtype=torch.bool),
                      rc.traj.rewards.shape[1])
    with torch.no_grad():
        batch = batch_from_traj(rc.traj, rc.last_value, pcfg,
                                actor_mask=mask,
                                value_fn=lambda o: learner(params, o)[1])

    def grad(p, idx, dv):
        """The masked gradient, and which ReLUs of the forward passed
        (each one's ``x > 0``, flattened)."""
        mb = {k: v[idx.to(dv)] for k, v in _tree_to(batch, dv).items()}
        gates = []

        def relu(x):
            gates.append((x > 0).reshape(-1).cpu())
            return torch.relu(x)

        vact._NATIVE["relu"] = relu
        try:
            (_, _), g = value_and_grad(tr.loss_fn, p, learner, mb, pcfg,
                                       tr.dist)
        finally:
            vact._NATIVE["relu"] = torch.relu
        g = g if ctx is None else apply_stage_mask(g, ctx)
        return g, torch.cat(gates)

    def adam(g, p, s):
        with torch.no_grad():
            p, s, _ = adamw_update(g, s, p, tr.sched, tr.ocfg)
        return p, s

    n = batch["obs"].shape[0]
    size = n // pcfg.minibatches
    worst = dict.fromkeys(("grads", "params", "mu", "nu",
                           "params from the card's gradient"), 0.0)
    ok, gated = True, []
    for e in range(pcfg.epochs):
        for i in range(pcfg.minibatches):
            idx = draws.perms[e, i * size:(i + 1) * size]
            p_dev, s_dev = _tree_to(params, dev), _tree_to(opt, dev)
            g_card, gates_card = grad(p_dev, idx, dev)
            g_cpu, gates_cpu = grad(params, idx, where)
            flips = int((gates_card != gates_cpu).sum())
            if flips:
                gated.append(flips)
            for a, b in zip(_leaves(g_card), _leaves(g_cpu), strict=True):
                a = a.cpu()
                if not flips:
                    worst["grads"] = max(worst["grads"],
                                         (a - b).abs().max().item())
                    ok &= bool(torch.allclose(
                        a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item()))
            p_card, s_card = adam(_tree_to(g_cpu, dev), p_dev, s_dev)
            p_own, _ = adam(g_card, p_dev, s_dev)
            params, opt = adam(g_cpu, params, opt)
            for name, a_tree, b_tree in (
                    ("params", p_card, params), ("mu", s_card["mu"],
                                                 opt["mu"]),
                    ("nu", s_card["nu"], opt["nu"])):
                for a, b in zip(_leaves(a_tree), _leaves(b_tree),
                                strict=True):
                    a = a.cpu()
                    worst[name] = max(worst[name],
                                      (a - b).abs().max().item())
                    ok &= bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5))
            key = "params from the card's gradient"
            worst[key] = max([worst[key]] + [
                (a.cpu() - b).abs().max().item() for a, b in zip(
                    _leaves(p_own), _leaves(params), strict=True)])
    for a, b in zip(_leaves((params, opt)), _leaves(cpu_out), strict=True):
        if not torch.equal(a, b):
            raise AssertionError("the learner's updates one by one do not "
                                 "end where its learn_phase does")
    worst["updates whose ReLU gates differ (gates)"] = gated
    return worst, ok


def pixel_card_vs_cpu(torch, dev, run):
    """Phase 10 worker: one iteration of a pixel run on the card against
    the plain path on the CPU, the same params, env states and draws
    (E2HRL: an iteration of stage "action" from the initial state, then
    one of stage "subgoal" from the CPU's state after it, so the mask and
    the carried Adam moments are in play).  The rollouts: every action
    equal, observations within rtol 1e-5, log-probs and values within
    rtol 1e-5 + atol 1e-6 at every (step, env) whose actor forward has
    the same int8 codes on both devices, the rows whose codes differ
    exempt and counted.  The learners, both from the CPU's rollout, each
    update held as ``_learner_updates_card_vs_cpu`` says; in stage
    "action" the sub-goal subtree bitwise unchanged on both devices."""
    torch.set_num_threads(2)
    cfg = PIXEL_RUNS[run]
    cpu = torch.device("cpu")
    alive = torch.ones(1, dtype=torch.bool)
    start, report = None, []
    # E2HRL: the first step of each stage at 40 iterations a stage
    stages = [("action", 0), ("subgoal", 40)] \
        if cfg["kw"].get("two_stage") else [(None, 0)]
    for stage, g in stages:
        runs = []
        for where in (dev, cpu):
            tr, state, it, packed, draws = _phases(torch, dev, where, g=g,
                                                   **cfg["kw"])
            if start is not None:
                state = _tree_to(start, where)
                packed = tr.pack(state)
            ctx = tr.stage_setup(state, stage)
            res = it.rollout_phase(packed, draws, state.est, state.obs)
            codes = _rollout_codes(torch, tr, packed, res.traj)
            runs.append((where, tr, state, it, draws, ctx, res, codes))
        (_, _, sd, *_, rd, cd), (_, _, sc, *_, rc, cc) = runs
        host = lambda t: t.detach().cpu()  # noqa: E731
        same = (host(rd.traj.actions) == rc.traj.actions).float().mean()
        differ = host(cd) != cc
        flipped = differ.any(-1)
        errs, off = {}, {}
        for f in ("log_probs", "values", "obs"):
            a, b = host(getattr(rd.traj, f)), getattr(rc.traj, f)
            errs[f] = (a - b).abs().max().item()
            bad = ~torch.isclose(a, b, rtol=1e-5, atol=1e-6)
            if f != "obs":
                bad = bad & ~flipped
            else:
                bad = bad.reshape(bad.shape[0], bad.shape[1], -1).any(-1)
            off[f] = int(bad.sum())
        # both learners from the CPU's rollout: [card, CPU]
        outs = [it.learn_phase(state.params, state.opt, _tree_to(rc, where),
                               draws, ctx, alive)
                for where, _, state, it, draws, ctx, _, _ in runs]
        free = {name: max((host(a) - b).abs().max().item() for a, b in zip(
            _leaves(pick(outs[0])), _leaves(pick(outs[1])), strict=True))
            for name, pick in (("params", lambda o: o[0]),
                               ("mu", lambda o: o[1]["mu"]),
                               ("nu", lambda o: o[1]["nu"]))}
        worst, ok = _learner_updates_card_vs_cpu(torch, dev, runs[1], rc,
                                                 outs[1])
        frozen = None
        if stage == "action":
            frozen = all(torch.equal(host(a), host(b)) for o, st in (
                (outs[0][0], sd.params), (outs[1][0], sc.params))
                for a, b in zip(_leaves(o["subgoal"]),
                                _leaves(st["subgoal"]), strict=True))
        report.append(dict(
            stage=stage or "all", actions_equal=float(same),
            codes_differ=int(differ.sum()), codes=differ.numel(),
            rows_flipped=int(flipped.sum()), rows=flipped.numel(),
            errs=errs, learner_errs=worst, learner_free=free,
            past_rtol=off, subgoal_frozen=frozen))
        print(f"{run} card vs CPU, stage {stage or 'all'} (g={g}): actions "
              f"equal {float(same):.6f}; int8 codes that differ "
              f"{int(differ.sum())} of {differ.numel()}, in "
              f"{int(flipped.sum())} of {flipped.numel()} actor rows; "
              f"largest abs errors {errs}; entries past rtol 1e-5 outside "
              f"those rows {off}; learner from the CPU's rollout, each of "
              f"its updates on the card from the CPU's state before it "
              f"(AdamW given the CPU's gradient), largest abs errors "
              f"{worst}; the two learners run through, largest abs errors "
              f"{free}"
              + ("" if frozen is None else
                 f"; sub-goal subtree unchanged on both: {frozen}"),
              flush=True)
        if float(same) != 1.0:
            raise AssertionError(f"{run}: card and CPU chose different "
                                 "actions")
        if any(off.values()):
            raise AssertionError(f"{run}: card and CPU past rtol 1e-5 "
                                 f"where the actor's codes agree: {off}")
        if not ok:
            raise AssertionError(f"{run}: a learner update on the card "
                                 "differs from the CPU's: gradients past "
                                 "rtol 1e-5 of the leaf's largest entry, "
                                 "or AdamW past atol 1e-5 + rtol 1e-4")
        if frozen is False:
            raise AssertionError(f"{run}: stage action moved the sub-goal "
                                 "subtree")
        start = type(sc)(outs[1][0], None, outs[1][1], None, rc.final_env,
                         rc.final_obs)
    return report


def _worker(torch, argv):
    """``chip_smoke.py --worker train|vtrain RUN SEED OUT``, ``--worker
    parity RUN OUT`` or ``--worker vparity all OUT``: one phase-10 or
    phase-11 job in a process of its own, its result as JSON in OUT."""
    kind, run, out = argv[0], argv[1], argv[-1]
    dev = torch.device("cuda", 0)
    if kind in ("train", "vtrain"):
        torch.set_num_threads(1)
        if kind == "train":
            result = train_seed(torch, dev, run, int(argv[2]))
        else:
            result = train_value_seed(torch, dev, run, int(argv[2]),
                                      os.path.dirname(out))
    elif kind == "parity":
        result = pixel_card_vs_cpu(torch, dev, run)
    else:
        result = value_card_vs_cpu(torch, dev)
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


def pixel_jobs():
    """Phase 10's worker jobs: three seeds of each pixel run and one
    card-vs-CPU iteration of each."""
    jobs = []
    for run in PIXEL_RUNS:
        jobs += [["train", run, str(s)] for s in TRAIN_SEEDS]
        jobs.append(["parity", run])
    return jobs


def _run_workers(torch, work, jobs):
    """Each job in a process of its own (``chip_smoke.py --worker ...``),
    all at once (the runs are host-bound: the processes share the host's
    cores and the card), within ``WORKER_TIMEOUT_S``: their results by
    job, the card-vs-CPU jobs' output printed."""
    os.makedirs(work, exist_ok=True)
    procs = []
    try:
        for args in jobs:
            out = os.path.join(work, "_".join(args) + ".json")
            log = open(out + ".log", "w")
            procs.append((args, out, log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 *args, out], stdout=log, stderr=subprocess.STDOUT)))
        deadline = time.perf_counter() + WORKER_TIMEOUT_S
        for args, out, log, p in procs:
            p.wait(timeout=max(deadline - time.perf_counter(), 1))
            log.close()
    finally:
        for *_, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    results, failed = {}, []
    for args, out, _, p in procs:
        with open(out + ".log") as f:
            text = f.read()
        if p.returncode != 0:
            failed.append(f"{' '.join(args)} exited {p.returncode}:\n"
                          + text[-4000:])
            continue
        if args[0] in ("parity", "vparity"):
            print(text.strip())
        with open(out) as f:
            results[tuple(args)] = json.load(f)
    if failed:
        raise AssertionError("worker jobs failed:\n" + "\n".join(failed))
    return results


def pixel_training(card, results):
    """Phase 10: the two pixel runs at their defaults, three seeds each,
    from the workers' results.  Per seed: greedy return, env steps/s,
    the wall split and the launches; per run the median greedy return
    against its bar."""
    totals = {}
    for run, cfg in PIXEL_RUNS.items():
        tot = dict.fromkeys(results[("train", run, "0")]["totals"], 0)
        returns = []
        for seed in TRAIN_SEEDS:
            r = results[("train", run, str(seed))]
            returns.append(r["ret"])
            for k, v in r["totals"].items():
                tot[k] += v
            split = ", ".join(f"{k} {v:.3f} s ({v / r['wall']:.3f})"
                              for k, v in r["spans"].items())
            stages = ""
            if len(r["stage_returns"]) > 1:
                stages = ("; greedy return after stage action "
                          f"{r['stage_returns'][0]}, after stage subgoal "
                          f"{r['stage_returns'][1]}; last train return by "
                          f"stage {r['last_train_return']}")
            print(f"{run} ({cfg['flags']}) seed {seed} on {card}: greedy "
                  f"return {r['ret']} over {r['n_ep']} episodes "
                  f"(untrained {r['untrained']}){stages}; {r['steps']} env "
                  f"steps in {r['wall']:.3f} s = {r['steps'] / r['wall']:.1f}"
                  f" env steps/s; wall split: {split}; launches "
                  f"{r['per_iter']} in each of {r['iters']} iterations")
        median = statistics.median(returns)
        bar, ref, u = pixel_bar(run)
        print(f"{run}: median greedy return {median} over seeds "
              f"{TRAIN_SEEDS}; the reference's median {ref}, untrained "
              f"{u}: bar {bar}")
        if median < bar:
            raise AssertionError(f"{run}: median greedy return {median} < "
                                 f"{bar}")
        totals[run] = tot
    return totals


# ---------------------------------------------------------------------------
# phase 11: the value family
# ---------------------------------------------------------------------------

# the value family's three runs at their defaults (32 envs x 8 steps,
# fxp8 behaviour actors, an 8-bit sync, lr 1e-3, 300 iterations, replay
# capacity 50,000, n-step 3, 4 updates an iteration): the flags, the
# JAX reference's greedy returns at seeds 0-2 after training and of its
# untrained initial params (``tools/ref_greedy_returns.py --seeds 0 1 2``
# with the flags, and with ``--iters 0``, on a CPU with jax 0.9.0;
# ``value_eval`` at 16 envs with fxp8 actors), and each behaviour
# forward's launches of the port's kernels
VALUE_RUNS = {
    "value_dqn": dict(
        flags="--algo dqn",
        kw=dict(algo="dqn", env_name="cartpole"),
        ref=(145.1290283203125, 259.625, 203.23529052734375),
        untrained=(13.48971176147461, 9.439696311950684,
                   10.620726585388184),
        per_forward={"qmac_i8": 3}),
    "value_qrdqn": dict(
        flags="--algo qrdqn --env catch --net conv --frame-stack 4",
        kw=dict(algo="qrdqn", env_name="catch", net="conv",
                frame_stack_k=4),
        ref=(1.0, 1.0, 1.0), untrained=(-0.375, -0.375, -0.375),
        per_forward={"qconv_i8_taps": 2, "qmac_i8": 2}),
    "value_ddpg": dict(
        flags="--algo ddpg --env pendulum",
        kw=dict(algo="ddpg", env_name="pendulum"),
        ref=(-1114.2596435546875, -1098.4505615234375, -1182.080322265625),
        untrained=(-1447.8057861328125, -1811.0133056640625,
                   -1514.0872802734375),
        per_forward={"qmac_i8": 3}),
}
# the value runs' iterations (their CLI default) and env steps (32 envs x
# 8 steps an iteration)
VALUE_ITERS = 300
VALUE_STEPS = VALUE_ITERS * 32 * 8
# the card-vs-CPU iterations: each run's, and dqn with prioritized
# replay and ddpg with TQC's truncated quantile critics
VALUE_PARITY = {
    "value_dqn": VALUE_RUNS["value_dqn"]["kw"],
    "value_dqn_per": dict(algo="dqn", env_name="cartpole", replay="per"),
    "value_qrdqn": VALUE_RUNS["value_qrdqn"]["kw"],
    "value_ddpg": VALUE_RUNS["value_ddpg"]["kw"],
    "value_ddpg_tqc": dict(algo="ddpg", env_name="pendulum", tqc_drop=2),
}
# Q-MAC's products of the value runs not among phase 3's other shapes:
# the ddpg actor's first layer and the QR-DQN quantile head
VALUE_KN = ((3, 64), (128, 96))
# the fused products the served value checkpoints run (phase 12): the
# DQN/QR-DQN mlp's [4, 64], [64, 64], [64, 2]; the ddpg actor's [3, 64],
# [64, 64], [64, 1]; the QR-DQN conv head's [192, 128], [128, 96]
SERVED_VALUE_KN = ((4, 64), (64, 64), (64, 2), (3, 64), (64, 1),
                   (192, 128), (128, 96))


def check_value_kernels(torch, dev, worst):
    """Phase 3, the value runs' products that no other check covers:
    Q-MAC at the ddpg actor's [M, 3] x [3, 64] and the QR-DQN head's
    [M, 128] x [128, 96], at the fleet's 32 rows and ragged rows,
    int32 equal to the plain version (the other products and Q-Conv's
    convs at catch's 10x5x4 frames are in the training and pixel
    checks); and the fused ``qmac_i8_deq`` at every product the served
    value checkpoints run, at serving's buckets, w8 and w4 weights
    (qmax 127 and 7) and per-channel and per-tensor weight scales,
    bitwise equal to the plain version."""
    from repro_torch.kernels.qmac import ops as qmac_ops

    g = torch.Generator(device=dev).manual_seed(97531)
    deq_cases = 0
    for m in (32, 1, 7, 16):
        for k, n in SERVED_VALUE_KN:
            for qmax in (127, 7):
                qx = _i8(torch, g, dev, (m, k))
                qw = torch.randint(-qmax, qmax + 1, (k, n), generator=g,
                                   device=dev,
                                   dtype=torch.int32).to(torch.int8)
                sx = torch.rand((m, 1), generator=g, device=dev) * 0.02 \
                    + 1e-4
                sw = torch.rand((n,), generator=g, device=dev) * 0.02 \
                    + 1e-4
                for s in (sw, sw[:1].contiguous()):
                    got = qmac_ops.qmac_i8_deq(qx, sx, qw, s)
                    want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, s)
                    err = (got - want).abs().max().item()
                    worst["qmac_i8_deq"] = max(worst["qmac_i8_deq"], err)
                    if not bits_equal(torch, got, want):
                        raise AssertionError(
                            f"qmac_i8_deq != plain at the served value "
                            f"products' M,K,N={m},{k},{n} qmax {qmax} "
                            f"sw {tuple(s.shape)} (max abs err {err})")
                    deq_cases += 1
    torch.cuda.synchronize()
    print(f"fused Q-MAC at the served value checkpoints' "
          f"{len(SERVED_VALUE_KN)} products: {deq_cases} cases, fp32 "
          "bitwise equal to the plain version")
    cases = 0
    for m in (32, 1, 7, 33, 64, 128):
        for k, n in VALUE_KN:
            qx, qw = _i8(torch, g, dev, (m, k)), _i8(torch, g, dev, (k, n))
            got = qmac_ops.qmac_i8(qx, qw)
            want = qmac_ops.qmac_i8_plain(qx, qw)
            worst["qmac_i8"] = max(worst["qmac_i8"], float(
                (got.long() - want.long()).abs().max().item()))
            if not bits_equal(torch, got, want):
                raise AssertionError(f"qmac_i8 != plain at the value runs' "
                                     f"M,K,N={m},{k},{n}")
            cases += 1
    torch.cuda.synchronize()
    print(f"Q-MAC at the value runs' {len(VALUE_KN)} other products: "
          f"{cases} cases, int32 equal to the plain version")
    return worst


def value_bar(run):
    """(bar, reference median, untrained median): half the way from the
    untrained policy's median greedy return to the trained reference's."""
    cfg = VALUE_RUNS[run]
    ref = statistics.median(cfg["ref"])
    u = statistics.median(cfg["untrained"])
    return u + 0.5 * (ref - u), ref, u


def _counting_value_trainer(torch, kernels):
    """``ValueTrainer`` (what ``rl_train --algo dqn|qrdqn|ddpg`` runs)
    reading the port's launch counters around each iteration and timing
    its phases on the host clock: the weight sync, the rollout and the
    learner (n-step targets, the replay add and the updates), each ended
    by a wait for the card.  ``step`` runs the iteration's own two
    phases, as its body does."""
    from repro_torch.obs import SpanClock
    from repro_torch.rl.rollout import episode_returns_from
    from repro_torch.rl.trainer import ValueTrainer
    from repro_torch.rl.trainer.state import value_state

    class Counted(ValueTrainer):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.per_iter, self.clock = [], SpanClock()

        def pack(self, state):
            with self.clock("sync"):
                packed = super().pack(state)
                torch.cuda.synchronize()
            return packed

        def step(self, iteration, state, packed, gen, g, stage_ctx, alive):
            before = kernels.launch_counts()
            draws = self.draws(gen, g)
            with self.clock("rollout"):
                (est, obs), traj = iteration.rollout_phase(
                    packed, draws, state.est, state.obs, g)
                torch.cuda.synchronize()
            with self.clock("learn"):
                p, t, o, b = iteration.learn_phase(
                    state.params, state.target, state.opt, state.replay,
                    traj, draws, g)
                torch.cuda.synchronize()
            _, _, R, D, Tr, _ = traj
            ret, n_ep = episode_returns_from(R, D | Tr)
            after = kernels.launch_counts()
            self.per_iter.append({k: after[k] - before[k] for k in after})
            return value_state(p, t, o, b, est, obs), ret, n_ep

    return Counted


def _value_eval(tr, state, params):
    """The run's greedy return at fxp8 (``value_eval``; over the pixel
    pipeline with the state's merged normalizer)."""
    from repro_torch.rl.envs.wrappers import merge_norm_stats, norm_stats_of
    stats = (merge_norm_stats(norm_stats_of(state.est))
             if tr.net == "conv" else None)
    return tr.eval_policy(params, actor_policy="fxp8", norm_stats=stats)


def train_value_seed(torch, dev, run, seed, work):
    """Phase 11 worker: one seed of one value run through the trainer
    ``rl_train`` runs, on the card: the port's launch counters read in
    every iteration (exactly ``per_forward`` x 8 each, nothing else), the
    wall split, the greedy return of the untrained params and at the
    end.  Seed 0 also writes its telemetry (``--metrics-dir``) and its
    last iteration's checkpoint (``--ckpt-dir``) under ``work``, which
    phase 12 reads and serves."""
    from repro_torch import kernels

    cfg = VALUE_RUNS[run]
    obs_kw = {}
    if seed == 0:
        obs_kw = dict(metrics_dir=os.path.join(work, f"metrics_{run}"),
                      ckpt_dir=os.path.join(work, f"ckpt_{run}"),
                      save_every=VALUE_ITERS - 1)
    tr = _counting_value_trainer(torch, kernels)(seed=seed, device=dev,
                                                 verbose=False, **obs_kw,
                                                 **cfg["kw"])
    untrained, _ = _value_eval(tr, tr.init_state(), tr.agent.params)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = {k: v * tr.rollout_len for k, v in cfg["per_forward"].items()}
    got = [{k: v for k, v in c.items() if v} for c in tr.per_iter]
    if len(got) != tr.iters or any(c != want for c in got):
        odd = sorted({json.dumps(c, sort_keys=True) for c in got})
        raise AssertionError(f"{run} seed {seed}: launches per iteration "
                             f"{odd} over {len(got)} iterations, not "
                             f"{want} in each of {tr.iters}")
    if not all(torch.isfinite(x).all() for x in _leaves(state.params)):
        raise AssertionError(f"{run} seed {seed}: non-finite params")
    t1 = time.perf_counter()
    ret, n_ep = _value_eval(tr, state, state.params)
    return dict(seed=seed, ret=ret, n_ep=n_ep, untrained=untrained,
                eval_s=time.perf_counter() - t1, wall=wall,
                steps=tr.iters * tr.n_envs * tr.rollout_len,
                iters=tr.iters, spans=tr.clock.drain(), per_iter=want,
                totals={k: sum(c[k] for c in tr.per_iter)
                        for k in kernels.WRAPPERS},
                last_train_return=history[-1])


def _value_phases(torch, device, **kw):
    """A value trainer's first iteration on ``device``: the trainer, its
    state, the iteration, the packed weights and the draws of step 0,
    made on the CPU (so every device gets the same ones)."""
    from repro_torch.rl.train_steps import ValueDraws, iteration_generator
    from repro_torch.rl.trainer import ValueTrainer

    tr = ValueTrainer(seed=0, device=device, verbose=False, **kw)
    cpu = ValueTrainer(seed=0, device="cpu", verbose=False, **kw)
    draws = cpu.draws(iteration_generator(0, 0, torch.device("cpu")), 0)
    draws = ValueDraws(*(None if t is None else t.to(device)
                         for t in draws))
    state = tr.init_state()
    return tr, state, tr.build_iteration(), tr.pack(state), draws


def _value_rollout_codes(torch, tr, packed, traj, draws, eps):
    """The behaviour actor's int8 codes at every step of ``traj`` on its
    own device, [T, B, n], after checking that re-running the behaviour
    policy on the step's observations and draws gives the rollout's
    actions bit for bit (so the codes are the rollout's own)."""
    from repro_torch.rl.actor_learner import unpack_weights

    agent = tr.agent
    params = unpack_weights(packed)
    fwd = agent.qvals if agent.discrete else agent.act
    codes = []
    with torch.no_grad():
        for t in range(traj[0].shape[0]):
            out, c = _recorded_codes(
                torch, lambda: fwd(params, traj[0][t], tr.a_policy))
            again = agent.behave(params, traj[0][t], draws.step(t), eps,
                                 tr.a_policy)
            if not torch.equal(again, traj[1][t]):
                raise AssertionError(f"{traj[0].device}: the behaviour "
                                     f"policy at step {t} is not the "
                                     "rollout's")
            codes.append(c)
    return torch.stack(codes)


def _value_grad(torch, tr, fn, p, args, where):
    """``fn``'s gradient with respect to ``p`` on ``where`` (args moved
    there), and which ReLUs of the forward passed."""
    from repro_torch.core import vact
    from repro_torch.rl.ppo import value_and_grad

    gates = []

    def relu(x):
        gates.append((x > 0).reshape(-1).cpu())
        return torch.relu(x)

    def moved(a):
        if isinstance(a, (torch.Tensor, dict, list, tuple)):
            return _tree_to(a, where)
        return a                      # the nets' applies and the config

    vact._NATIVE["relu"] = relu
    try:
        (_, aux), g = value_and_grad(fn, _tree_to(p, where),
                                     *(moved(a) for a in args))
    finally:
        vact._NATIVE["relu"] = torch.relu
    return g, aux, torch.cat(gates)


def _value_learner_card_vs_cpu(torch, dev, tr, it_fn, state, traj, draws,
                               it, cpu_out):
    """The CPU learner's updates one at a time (``it_fn.add_rollout``,
    then ``it_fn.update`` for each update, as ``learn_phase`` runs
    them), each gradient and AdamW also run on the card from the CPU's
    state before it.  Per gradient: within rtol 1e-5 of each leaf's
    largest entry of the CPU's, unless a ReLU of the forward passed on
    one device and not on the other (exempt and counted); AdamW on the
    card, given the CPU's gradient, within atol 1e-5 + rtol 1e-4 of the
    CPU's params and moments.  The CPU's updates must end bitwise where
    its ``learn_phase`` did.  Returns (largest abs errors, whether every
    update held)."""
    from repro_torch.optim import adamw_update
    from repro_torch.tree import tree_map

    def adam(g, p, s):
        with torch.no_grad():
            p, s, _ = adamw_update(g, s, p, tr.sched, tr.ocfg)
        return p, s

    worst = dict.fromkeys(("grads", "params", "mu", "nu"), 0.0)
    ok, gated = True, []

    def held(name, fn, p, s, args):
        """One gradient and AdamW step of subtree ``p`` held card vs CPU;
        returns the CPU's (params, state, aux)."""
        nonlocal ok
        g_card, _, gates_card = _value_grad(torch, tr, fn, p, args, dev)
        g_cpu, aux, gates_cpu = _value_grad(torch, tr, fn, p, args,
                                            torch.device("cpu"))
        flips = int((gates_card != gates_cpu).sum())
        if flips:
            gated.append((name, flips))
        for a, b in zip(_leaves(g_card), _leaves(g_cpu), strict=True):
            a = a.cpu()
            if not flips:
                worst["grads"] = max(worst["grads"],
                                     (a - b).abs().max().item())
                ok &= bool(torch.allclose(
                    a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item()))
        p_card, s_card = adam(_tree_to(g_cpu, dev), _tree_to(p, dev),
                              _tree_to(s, dev))
        p_new, s_new = adam(g_cpu, p, s)
        for key, a_tree, b_tree in (("params", p_card, p_new),
                                    ("mu", s_card["mu"], s_new["mu"]),
                                    ("nu", s_card["nu"], s_new["nu"])):
            for a, b in zip(_leaves(a_tree), _leaves(b_tree), strict=True):
                a = a.cpu()
                worst[key] = max(worst[key], (a - b).abs().max().item())
                ok &= bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5))
        return p_new, s_new, aux

    params, target, opt = state.params, state.target, state.opt
    buf = it_fn.add_rollout(tree_map(torch.clone, state.replay), traj)
    beta = it_fn.beta(it)
    for u in range(tr.updates_per_iter):
        params, target, opt, buf = it_fn.update(params, target, opt, buf,
                                                draws, u, beta, step=held)
    for a, b in zip(_leaves((params, target, opt, buf)), _leaves(cpu_out),
                    strict=True):
        if not torch.equal(a, b):
            raise AssertionError("the value learner's updates one by one "
                                 "do not end where its learn_phase does")
    worst["updates whose ReLU gates differ (net, gates)"] = gated
    return worst, ok


def _sum_tree_card_vs_cpu(torch, dev):
    """The sum tree at the default capacity (50,000 slots, 65,536
    leaves) on both devices from the same inputs: updates of 256 slots
    (an add's) and of 64 and 128 (an update's) with duplicate slots of
    different values, and stratified ``find`` queries, interval
    boundaries among them.  Every node bitwise, every slot equal."""
    from repro_torch.rl.replay import sum_tree

    g = torch.Generator().manual_seed(4242)
    cap = 50_000
    trees = {d: sum_tree.init(cap, d) for d in (dev, torch.device("cpu"))}
    dups = 0
    for m in (256, 64, 128, 64, 128, 256, 64):
        idx = torch.randint(0, cap, (m,), generator=g)
        idx[m // 2:m // 2 + 8] = idx[:8]            # duplicate slots
        dups += m - len(set(idx.tolist()))
        vals = torch.rand(m, generator=g) * 3
        for d in trees:
            trees[d] = sum_tree.update(trees[d], idx.to(d), vals.to(d))
    a, b = trees[dev].cpu(), trees[torch.device("cpu")]
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError("sum tree: card and CPU nodes differ after "
                             "the same updates")
    L = b.shape[0] // 2
    if not torch.equal(b[1:L], b[2:2 * L:2] + b[3:2 * L:2]):
        raise AssertionError("sum tree: an internal node is not the sum "
                             "of its children")
    u = torch.rand(4096, generator=g) * b[1]
    edges = torch.cumsum(b[L:L + cap].double(), 0).float()
    u = torch.cat([u, edges[edges < b[1]][:1024]])
    f_card = sum_tree.find(trees[dev], u.to(dev)).cpu()
    f_cpu = sum_tree.find(b, u)
    if not torch.equal(f_card, f_cpu):
        raise AssertionError("sum tree: card and CPU find different slots")
    print(f"sum tree card vs CPU: 7 updates ({dups} duplicate slots) at "
          f"capacity {cap}: all {b.numel()} nodes bitwise; find: "
          f"{u.numel()} queries, slots equal")
    return dict(duplicates=dups, nodes=b.numel(), queries=u.numel())


def value_card_vs_cpu(torch, dev):
    """Phase 11 worker: one iteration of each value run (and of dqn with
    PER and ddpg with TQC) on the card against the plain path on the
    CPU, the same params, env states and draws.  The rollouts: actions
    equal (ddpg: within rtol 1e-5) and observations, rewards and
    ``final_obs`` within rtol 1e-5 + atol 1e-6 in every env up to its
    first step whose behaviour forward has int8 codes that differ
    between the devices; such rows are counted and the env's later
    steps exempt.  The learners, both from the CPU's rollout: each
    update held as ``_value_learner_card_vs_cpu`` says.  Then the sum
    tree bitwise across the devices."""
    from repro_torch.rl.value import epsilon

    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    report = {}
    for name, kw in VALUE_PARITY.items():
        runs = []
        for where in (dev, cpu):
            tr, state, it, packed, draws = _value_phases(torch, where, **kw)
            eps = epsilon(0, tr.agent.cfg) if tr.agent.discrete else 0.0
            (est, obs), traj = it.rollout_phase(packed, draws, state.est,
                                                state.obs, 0)
            codes = _value_rollout_codes(torch, tr, packed, traj, draws,
                                         eps)
            runs.append((tr, state, it, draws, traj, codes))
        (_, _, _, _, td_, cd), (tr, sc, it, dc, tc, cc) = runs
        host = lambda t: t.detach().cpu()  # noqa: E731
        differ = host(cd) != cc
        flipped = differ.any(-1)                          # [T, B]
        diverged = torch.cumsum(flipped.int(), 0) > 0     # from there on
        before = torch.cat([torch.zeros_like(diverged[:1]),
                            diverged[:-1]])               # strictly before
        errs, off = {}, {}
        a_card, a_cpu = host(td_[1]), tc[1]
        if tr.agent.discrete:
            bad = (a_card != a_cpu) & ~diverged
        else:
            bad = (~torch.isclose(a_card, a_cpu, rtol=1e-5, atol=1e-6)
                   ).any(-1) & ~diverged
            errs["actions"] = (a_card - a_cpu).abs().max().item()
        off["actions"] = int(bad.sum())
        for i, f in ((0, "obs"), (2, "rewards"), (5, "final_obs")):
            a, b = host(td_[i]).float(), tc[i].float()
            errs[f] = (a - b).abs().max().item()
            close = torch.isclose(a, b, rtol=1e-5, atol=1e-6)
            close = close.reshape(close.shape[0], close.shape[1], -1).all(-1)
            mask = before if f == "obs" else diverged
            off[f] = int((~close & ~mask).sum())
        for i, f in ((3, "dones"), (4, "truncated")):
            off[f] = int(((host(td_[i]) != tc[i]) & ~diverged).sum())
        # both learners from the CPU's rollout: [card, CPU]
        outs = []
        for rtr, _, rit, dr, _, _ in runs:
            where = rtr.device
            outs.append(rit.learn_phase(
                *(_tree_copy(x, where) for x in (sc.params, sc.target,
                                                  sc.opt, sc.replay)),
                _tree_to(tc, where), dr, 0))
        free = max(((host(a) - b).abs().max().item() for a, b in zip(
            _leaves(outs[0][:3]), _leaves(outs[1][:3]), strict=True)),
            default=0.0)
        worst, ok = _value_learner_card_vs_cpu(
            torch, dev, tr, it, sc, tc, dc, 0, outs[1])
        report[name] = dict(codes_differ=int(differ.sum()),
                            codes=differ.numel(),
                            rows_flipped=int(flipped.sum()),
                            rows=flipped.numel(), errs=errs, past=off,
                            learner_errs=worst, learner_free=free)
        flags = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"{name} card vs CPU ({flags}): "
              f"int8 codes that differ {int(differ.sum())} of "
              f"{differ.numel()}, in {int(flipped.sum())} of "
              f"{flipped.numel()} behaviour rows; largest abs errors "
              f"{errs}; entries past the bars before those rows {off}; "
              f"learner from the CPU's rollout, each update on the card "
              f"from the CPU's state (AdamW given the CPU's gradient), "
              f"largest abs errors {worst}; the two learners run "
              f"through, largest abs error {free}", flush=True)
        if any(off.values()):
            raise AssertionError(f"{name}: card and CPU rollouts past the "
                                 f"bars where the codes agree: {off}")
        if not ok:
            raise AssertionError(f"{name}: a learner update on the card "
                                 "differs from the CPU's: gradients past "
                                 "rtol 1e-5 of the leaf's largest entry, "
                                 "or AdamW past atol 1e-5 + rtol 1e-4")
    report["sum_tree"] = _sum_tree_card_vs_cpu(torch, dev)
    return report


def profile_value(torch, dev, run, n=2):
    """Phase 11: where a value iteration's time goes, its rollout (8
    steps of the fxp8 behaviour actor and the env) and its learner
    (n-step targets, the replay add, 4 sampled updates of fp32 forward,
    backward, AdamW and polyak) each traced as ``profile_forward``
    traces a forward, from the same inputs each call; the port's
    launches by the wrappers' counters."""
    from repro_torch import kernels

    cfg = VALUE_RUNS[run]
    tr, state, it, packed, draws = _value_phases(torch, dev, **cfg["kw"])
    (est, obs), traj = it.rollout_phase(packed, draws, state.est, state.obs,
                                        0)

    def rollout():
        it.rollout_phase(packed, draws, state.est, state.obs, 0)
        torch.cuda.synchronize()

    def learn():
        it.learn_phase(state.params, state.target, state.opt, state.replay,
                       traj, draws, 0)
        torch.cuda.synchronize()

    out = {}
    for name, fn in (("rollout", rollout), ("learner", learn)):
        kernels.reset_launch_counts()
        fn()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        wall, rows, launches, why = _profiled(torch, fn, n)
        _print_profile(f"value iteration ({cfg['flags']}), {name} phase "
                       "(32 envs x 8 steps, 4 updates)", wall, rows,
                       launches, why, top=8, per="phase")
        print(f"  the port's kernels in one {name} phase: {counts}")
        out[name] = (wall, sum(r[0] for r in rows), launches, counts)
    wall = sum(v[0] for v in out.values())
    busy = sum(v[1] for v in out.values())
    print(f"value iteration ({cfg['flags']}): wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}; device "
          "launches " + ", ".join(f"{k} {v[2]}" for k, v in out.items()))
    want = {k: v * tr.rollout_len for k, v in cfg["per_forward"].items()}
    if out["rollout"][3] != want:
        raise AssertionError(f"{run} rollout phase launched "
                             f"{out['rollout'][3]}, not {want}")
    if out["learner"][3]:
        raise AssertionError(f"{run} learner launched {out['learner'][3]}")
    return out


def value_jobs():
    """Phase 11's worker jobs: three seeds of each value run and the
    card-vs-CPU iterations."""
    return [["vtrain", run, str(s)] for run in VALUE_RUNS
            for s in TRAIN_SEEDS] + [["vparity", "all"]]


def value_training(card, results):
    """Phase 11: the three value runs at their defaults, three seeds
    each, from the workers' results.  Per seed: greedy return, env
    steps/s, the wall split and the launches; per run the median greedy
    return against its bar."""
    totals = {}
    for run, cfg in VALUE_RUNS.items():
        tot = dict.fromkeys(results[("vtrain", run, "0")]["totals"], 0)
        returns = []
        for seed in TRAIN_SEEDS:
            r = results[("vtrain", run, str(seed))]
            returns.append(r["ret"])
            for k, v in r["totals"].items():
                tot[k] += v
            split = ", ".join(f"{k} {v:.3f} s ({v / r['wall']:.3f})"
                              for k, v in r["spans"].items())
            print(f"{run} ({cfg['flags']}) seed {seed} on {card}: greedy "
                  f"return {r['ret']} over {r['n_ep']} episodes "
                  f"(untrained {r['untrained']}); last train return "
                  f"{r['last_train_return']}; {r['steps']} env steps in "
                  f"{r['wall']:.3f} s = {r['steps'] / r['wall']:.1f} env "
                  f"steps/s; wall split: {split}; launches {r['per_iter']} "
                  f"in each of {r['iters']} iterations")
        median = statistics.median(returns)
        bar, ref, u = value_bar(run)
        print(f"{run}: median greedy return {median} over seeds "
              f"{TRAIN_SEEDS}; the reference's median {ref}, untrained "
              f"{u}: bar {bar}")
        if median < bar:
            raise AssertionError(f"{run}: median greedy return {median} < "
                                 f"{bar}")
        totals[run] = tot
    return totals


# ---------------------------------------------------------------------------
# phase 12: telemetry, profiler windows and serving the value checkpoints
# ---------------------------------------------------------------------------

# the served forward's launches of the port's kernels: the behaviour
# forward's (``VALUE_RUNS``), with the packed weights' fused product
SERVED_PER_FORWARD = {
    run: {("qmac_i8_deq" if k == "qmac_i8" else k): v
          for k, v in cfg["per_forward"].items()}
    for run, cfg in VALUE_RUNS.items()}
SERVE_EPISODES = 64
# the profiled PPO window: two steps of the default run at an eighth of
# its rollout (a 128-step trace is slow to write and read)
PROFILE_WINDOW_ROLLOUT = 16


def value_telemetry(work):
    """Phase 12: the ``train.jsonl`` of each value run's seed-0 job (phase
    11), read with the port's reader: step windows tiling [0, 300), env
    steps summing to 76,800, ``steps_per_s`` in every window."""
    from repro_torch.obs import read_records, render, summarize
    for run in VALUE_RUNS:
        recs = read_records(os.path.join(work, f"metrics_{run}",
                                         "train.jsonl"))
        steps = [r for r in recs if r["kind"] == "step"]
        windows = [r["window"] for r in steps]
        tiled = (windows and windows[0][0] == 0
                 and windows[-1][1] == VALUE_ITERS
                 and all(a[1] == b[0] for a, b in zip(windows, windows[1:])))
        total = sum(r["metrics"]["env_steps"] for r in steps)
        if not tiled or total != VALUE_STEPS or not all(
                "steps_per_s" in r["metrics"] for r in steps):
            raise AssertionError(f"{run} telemetry: windows {windows}, "
                                 f"env steps {total}")
        print(f"{run} telemetry: {len(steps)} step windows tiling [0, "
              f"{VALUE_ITERS}), env steps {total}")
        print(render(summarize(recs)))


def serve_value_checkpoints(torch, dev, card, work):
    """Phase 12: each value run's checkpoint (phase 11, seed 0) served on
    the card through ``serve_policy`` at w8 with ``--check-parity``
    (which raises on any mismatching row) and at w4, each with
    ``--metrics-dir``: actions/s, p50/p99, the served mean return.
    Returns the port's launches on this path, and holds each served
    forward's launches (a full bucket, after the path's count is read)
    to ``SERVED_PER_FORWARD``."""
    from repro_torch import kernels
    from repro_torch.launch.serve_policy import serve_policy
    from repro_torch.obs import fmt_metrics, read_records

    ckpts = {run: os.path.join(work, "phase11", f"ckpt_{run}")
             for run in VALUE_RUNS}
    kernels.reset_launch_counts()
    served = {}
    for run, ck in ckpts.items():
        for precision in ("w8", "w4"):
            mdir = os.path.join(work, "phase12", f"serve_{run}_{precision}")
            st = serve_policy(ck, precision=precision,
                              episodes=SERVE_EPISODES, n_slots=64,
                              max_bucket=32,
                              do_check_parity=precision == "w8",
                              metrics_dir=mdir, verbose=False, device=dev)
            served[(run, precision)] = (st, mdir)
    launches = kernels.launch_counts()
    print(f"kernel launches serving the value checkpoints: {launches}")
    for (run, precision), (st, mdir) in served.items():
        s = st.server
        recs = read_records(os.path.join(mdir, "serve.jsonl"))
        n_serve = sum(r["kind"] == "serve" for r in recs)
        print(f"{run} served at {precision} on {card}: " + fmt_metrics(
            {"actions_per_s": s["actions_per_s"], "p50_ms": s["p50_ms"],
             "p99_ms": s["p99_ms"], "mean_return": st.mean_return,
             "episodes": st.episodes, "serve_records": n_serve},
            ("actions_per_s", "p50_ms", "p99_ms", "mean_return",
             "episodes", "serve_records"), precision=4))
        if st.episodes < SERVE_EPISODES or not n_serve:
            raise AssertionError(f"{run} {precision}: {st.episodes} "
                                 f"episodes, {n_serve} serve records")
    print("w8 parity on the card: 0 mismatching rows for each of "
          f"{list(ckpts)} (serve_policy's --check-parity raises on any)")
    for run, ck in ckpts.items():
        per = profile_forward(torch, dev, ck, n=20,
                              what=f"{run} served forward")
        print(f"{run}: the port's launches per served forward {per}")
        if per != SERVED_PER_FORWARD[run]:
            raise AssertionError(f"{run}: served forward launched {per}, "
                                 f"not {SERVED_PER_FORWARD[run]}")
    return launches


def _params_bitwise(torch, a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def telemetry_leaves_training_alone(torch, dev, card, work):
    """Phase 12: PPO cartpole and DQN cartpole, 6 iterations each on the
    card, with and without ``--metrics-dir``: history and params bitwise
    equal; then a ``--profile-dir`` window of 2 steps of PPO cartpole
    (at ``PROFILE_WINDOW_ROLLOUT`` steps a rollout), whose trace must
    hold a ``qmac`` kernel row."""
    from repro_torch.obs import read_records
    from repro_torch.rl.trainer import rl_train, value_train

    for name, fn in (("ppo", lambda **kw: rl_train("cartpole", **kw)),
                     ("dqn", lambda **kw: value_train("dqn", "cartpole",
                                                      **kw))):
        t0 = time.perf_counter()
        p0, h0 = fn(iters=6, verbose=False, device=dev)
        mdir = os.path.join(work, f"metrics_{name}")
        p1, h1 = fn(iters=6, verbose=False, device=dev, metrics_dir=mdir)
        same = h0 == h1 and _params_bitwise(torch, p0, p1)
        steps = [r for r in read_records(os.path.join(mdir, "train.jsonl"))
                 if r["kind"] == "step"]
        print(f"{name} cartpole, 6 iterations on {card} with and without "
              f"--metrics-dir: history and params bitwise "
              f"{'equal' if same else 'DIFFERENT'}; {len(steps)} step "
              f"windows, {sum(r['metrics']['env_steps'] for r in steps)} "
              f"env steps ({time.perf_counter() - t0:.1f} s)")
        if not same:
            raise AssertionError(f"{name}: telemetry changed training")
    pdir = os.path.join(work, "profile")
    mdir = os.path.join(work, "metrics_profile")
    rl_train("cartpole", iters=4, rollout_len=PROFILE_WINDOW_ROLLOUT,
             verbose=False, device=dev, metrics_dir=mdir, profile_dir=pdir,
             profile_start=1, profile_steps=2)
    rec = [r for r in read_records(os.path.join(mdir, "train.jsonl"))
           if r["kind"] == "profile"]
    with open(os.path.join(pdir, "trace_1_3.json")) as f:
        events = json.load(f)["traceEvents"]
    kern = [e["name"] for e in events if e.get("cat") == "kernel"]
    qmac = [k for k in kern if "qmac" in k]
    print(f"profile window {rec[0]['window'] if rec else None} of PPO "
          f"cartpole ({PROFILE_WINDOW_ROLLOUT}-step rollouts) on {card}: "
          f"{len(kern)} kernel rows, {len(qmac)} of them qmac "
          f"({sorted(set(qmac))})")
    if not qmac or [r["window"] for r in rec] != [[1, 3]]:
        raise AssertionError("the profile window's trace holds no qmac "
                             "kernel row, or no [1, 3] profile record")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    if sys.argv[1:2] == ["--worker"]:
        return _worker(torch, sys.argv[2:])

    t_start = time.perf_counter()
    laps = [t_start]

    def lap(what):
        """Print the seconds since the last phase ended."""
        laps.append(time.perf_counter())
        print(f"{what} took {laps[-1] - laps[-2]:.1f} s", flush=True)

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {[os.path.basename(p) for p in libs]} in "
          f"{time.perf_counter() - t0:.1f}s")

    worst = check_kernels(torch, dev)
    for check in (check_hrl_kernels, check_split_and_band_edges,
                  check_ew_and_cell_edges, check_softmax_and_q8_edges,
                  check_training_kernels, check_pixel_kernels,
                  check_value_kernels):
        worst = check(torch, dev, worst)
    lap("phases 1-3 (the build and the kernel checks)")
    rows = time_kernels(torch, dev)
    lap("phase 4 (kernel timing)")

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    serve_launches, served = main_path(torch, dev, work)
    profile_forward(torch, dev, os.path.join(work, "ckpt"))
    for precision, st in served.items():
        s = st.server
        print(f"{precision} on {card}: {s['actions_per_s']:.1f} actions/s, "
              f"p50 {s['p50_ms']:.4f} ms, p99 {s['p99_ms']:.4f} ms, "
              f"{st.episodes} episodes")
    lap("phases 5-6 (serving)")
    hrl_launches, fps, lstm = hrl_path(torch, dev)
    per_forward = profile_hrl(torch, lstm)
    print("LSTM-HRL device launches per forward: " + ", ".join(
        f"{b} {v}" for b, v in per_forward.items()))
    for name, v in fps.items():
        print(f"{name} on {card}: {v:.1f} frames/s")
    lap("phases 7-8 (the HRL forward)")
    train_launches = training_path(torch, dev, card)
    card_vs_cpu_iteration(torch, dev)
    profile_training(torch, dev)
    lap("phase 9 (PPO training on cartpole)")
    # phase 10's jobs, then phase 11's: each phase's processes share the
    # host's cores only among themselves
    results = _run_workers(torch, os.path.join(work, "phase10"),
                           pixel_jobs())
    lap("phase 10's jobs")
    pixel_launches = pixel_training(card, results)
    results = _run_workers(torch, os.path.join(work, "phase11"),
                           value_jobs())
    lap("phase 11's jobs")
    value_launches = value_training(card, results)
    for run in PIXEL_RUNS:
        profile_training(torch, dev, run=run)
    lap("phase 10's profiles")
    for run in VALUE_RUNS:
        profile_value(torch, dev, run)
    lap("phase 11's profiles")
    value_telemetry(os.path.join(work, "phase11"))
    vserve_launches = serve_value_checkpoints(torch, dev, card, work)
    telemetry_leaves_training_alone(torch, dev, card,
                                    os.path.join(work, "phase12"))
    lap("phase 12 (telemetry, profiler window, serving the value "
        "checkpoints)")

    kdir = "src/repro_torch/kernels"
    source = {"qmac_i8": f"{kdir}/qmac/csrc/qmac.cu",
              "qmac_i8_deq": f"{kdir}/qmac/csrc/qmac.cu",
              "qconv_i8_taps": f"{kdir}/qconv/csrc/qconv.cu",
              "vact_ew": f"{kdir}/vact/csrc/vact.cu",
              "vact_ew_q8": f"{kdir}/vact/csrc/vact.cu",
              "vact_softmax": f"{kdir}/vact/csrc/vact.cu",
              "qlstm_cell": f"{kdir}/qlstm/csrc/qlstm.cu"}
    replaces = {"qmac_i8": "src/repro/kernels/qmac/qmac.py:62",
                "qmac_i8_deq": "src/repro/kernels/qmac/qmac.py:84",
                "qconv_i8_taps": "src/repro/kernels/qconv/qconv.py:66",
                "vact_ew": "src/repro/kernels/vact/vact.py:86",
                "vact_ew_q8": "src/repro/kernels/vact/vact.py:103",
                "vact_softmax": "src/repro/kernels/vact/vact.py:123",
                "qlstm_cell": "src/repro/kernels/qlstm/qlstm.py:52"}
    out = []
    for name, shapes in rows.items():
        r = shapes[0]                      # the largest call of the path
        by_path = {"serving": serve_launches[name],
                   "hrl": hrl_launches[name],
                   "training": train_launches[name],
                   "hrl_training": pixel_launches["hrl_training"][name],
                   "pixel_training": pixel_launches["pixel_training"][name],
                   **{run: value_launches[run][name] for run in VALUE_RUNS},
                   "value_serving": vserve_launches[name]}
        launches = sum(by_path.values())
        out.append({"name": name, "route": "cuda", "source": source[name],
                    "replaces": replaces[name], "launches": launches,
                    "launches_by_path": by_path,
                    "max_abs_err": worst[name], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "shape": r["shape"],
                    "shapes": shapes})
        print(f"{name}: launches {launches} {by_path}, kernel_ms "
              f"{r['ms']:.5f}, plain_ms {r['plain_ms']:.5f}, library_ms "
              f"{r['library_ms']} at {r['shape']} on {card}")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
