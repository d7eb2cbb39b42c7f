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
   the serving path's shapes (B in {1, 7, 32}) and at ragged ones:
   int32 outputs equal, fp32 outputs bitwise equal;
4. time each kernel beside its plain version and, where one exists, a
   single PyTorch call computing the same function (CUDA events, median
   of 60 launches queued behind a device sleep so host overhead does not
   enter), and compute each kernel's bound on an H100;
5. the main path: build a conv DQN for keydoor at full width (seed 0),
   save it as a checkpoint, and serve it through
   ``repro_torch.launch.serve_policy`` at w8 and at w4 with parity
   checks, counting kernel launches; then hold the served Q-values on
   the card against the plain path on the CPU;
6. profile served forwards of a full bucket (device time by kernel,
   host wall time, idle share);
7. print the kernels' JSON line, then the device line last.
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

    worst = {"qmac_i8": 0.0, "qmac_i8_deq": 0.0, "qconv_i8_taps": 0.0}
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
    b_ms, b_by = bound_ms(m * k + k * n + 4 * m * n, 2.0 * m * n * k)
    i32 = dict(
        shape=shape, ms=device_ms(torch, lambda: qmac_ops.qmac_i8(qx, qw)),
        plain_ms=device_ms(torch, lambda: qmac_ops.qmac_i8_plain(qx, qw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=_yardstick(torch, lambda: torch._int_mm(qx, qw),
                              "torch._int_mm"))
    b_ms, b_by = bound_ms(m * k + k * n + 4 * m + 4 * n + 4 * m * n,
                          2.0 * m * n * k, 2.0 * m * n)
    deq = dict(
        shape=shape,
        ms=device_ms(torch, lambda: qmac_ops.qmac_i8_deq(qx, sx, qw, sw)),
        plain_ms=device_ms(torch, lambda: qmac_ops.qmac_i8_deq_plain(
            qx, sx, qw, sw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return i32, deq


def _time_qconv(torch, g, dev, bsz, h, c, nc):
    """Q-Conv at one stride-2 SAME 3x3 layer of the stem."""
    import torch.nn.functional as F
    from repro_torch.kernels.qconv import ops as qconv_ops

    cx = _i8(torch, g, dev, (bsz, h, h, c))
    cw = _i8(torch, g, dev, (3, 3, c, nc))
    csx = torch.rand((bsz, h, h, 1), generator=g, device=dev) * 0.01
    csw = torch.rand((nc,), generator=g, device=dev) * 0.01
    cb = torch.rand((nc,), generator=g, device=dev) * 0.1
    kw = dict(stride=2, padding="SAME", fuse_relu=True)
    mo = bsz * (h // 2) ** 2
    b_ms, b_by = bound_ms(bsz * h * h * c + 4 * bsz * h * h + 9 * c * nc
                          + 8 * nc + 4 * mo * nc,
                          2.0 * mo * nc * 9 * c, mo * nc * (2 * 9 + 3))
    # the yardstick: one fp32 cuDNN convolution (TF32 off) of the
    # dequantized input with the dequantized filters, operands laid out
    # and padded (SAME at stride 2 pads (0, 1)) beforehand
    xd = F.pad((cx.float() * csx).permute(0, 3, 1, 2), (0, 1, 0, 1))
    wd = (cw.float() * csw).permute(3, 2, 0, 1).contiguous()
    return dict(
        shape=f"x[{bsz},{h},{h},{c}] w[3,3,{c},{nc}] stride 2 SAME",
        ms=device_ms(torch, lambda: qconv_ops.qconv2d_i8(
            cx, csx, cw, csw, cb, **kw)),
        plain_ms=device_ms(torch, lambda: qconv_ops.qconv2d_i8_plain(
            cx, csx, cw, csw, cb, **kw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=_yardstick(
            torch, lambda: F.conv2d(xd, wd, cb, stride=2), "F.conv2d"))


def time_kernels(torch, dev):
    """Phase 4: every kernel beside its plain version and a library call,
    at each shape the main path gives it at its largest bucket (32)."""
    g = torch.Generator(device=dev).manual_seed(7)
    rows = {"qmac_i8": [], "qmac_i8_deq": [], "qconv_i8_taps": []}
    for m, k, n in ((32, 2048, 128), (32, 128, 4)):      # fc, Q head
        i32, deq = _time_qmac(torch, g, dev, m, k, n)
        rows["qmac_i8"].append(i32)
        rows["qmac_i8_deq"].append(deq)
    for bsz, h, c, nc in ((32, 32, 12, 16), (32, 16, 16, 32)):  # conv1, 2
        rows["qconv_i8_taps"].append(_time_qconv(torch, g, dev, bsz, h, c,
                                                 nc))
    for name, shapes in rows.items():
        for r in shapes:
            lib = r["library_ms"]
            print(f"{name:14s} {r['shape']}: kernel_ms {r['ms']:.5f}  "
                  f"plain_ms {r['plain_ms']:.5f}  library_ms "
                  f"{'n/a' if lib is None else f'{lib:.5f}'}  bound_ms "
                  f"{r['bound_ms']:.6f} ({r['bound_by']})")
    return rows


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
    print(f"kernel launches on the main path: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched on the main path")

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


def profile_forward(torch, dev, ckpt, n=50):
    """Phase 6: where a served forward's time goes.  ``n`` w8 forwards of
    a full bucket (32) under ``torch.profiler``: device time per forward
    by kernel name, beside the host wall time per forward (each ``act``
    ends in a synchronize), so the device's idle share shows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.rl.rollout import init_envs
    from repro_torch.serve import PolicyServer, load_policy

    server = PolicyServer(load_policy(ckpt, device=dev), precision="w8",
                          max_bucket=32)
    _, obs = init_envs(server.policy.env, 4, 32, dev)
    server.warmup(32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            server.act(obs)
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for ev in prof.key_averages():
        # the kernels themselves (operators' rows would count them twice)
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        rows.append((dev_us / n / 1e3, ev.count // n, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"served forward, bucket 32, w8: wall {wall_ms:.4f} ms, device "
          f"busy {busy_ms:.4f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {sum(r[1] for r in rows)} device "
          "launches per forward")
    for ms, count, name in rows[:10]:
        print(f"  {ms:.5f} ms  x{count}  {name[:90]}")
    if not rows:
        print("  the profiler recorded no device time (not measured)")


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
    rows = time_kernels(torch, dev)

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    launches, served = main_path(torch, dev, work)
    profile_forward(torch, dev, os.path.join(work, "ckpt"))
    for precision, st in served.items():
        s = st.server
        print(f"{precision} on {card}: {s['actions_per_s']:.1f} actions/s, "
              f"p50 {s['p50_ms']:.4f} ms, p99 {s['p99_ms']:.4f} ms, "
              f"{st.episodes} episodes")

    source = {"qmac_i8": "src/repro_torch/kernels/qmac/csrc/qmac.cu",
              "qmac_i8_deq": "src/repro_torch/kernels/qmac/csrc/qmac.cu",
              "qconv_i8_taps": "src/repro_torch/kernels/qconv/csrc/qconv.cu"}
    replaces = {"qmac_i8": "src/repro/kernels/qmac/qmac.py:62",
                "qmac_i8_deq": "src/repro/kernels/qmac/qmac.py:84",
                "qconv_i8_taps": "src/repro/kernels/qconv/qconv.py:66"}
    out = []
    for name, shapes in rows.items():
        r = shapes[0]                      # the largest call of the path
        out.append({"name": name, "route": "cuda", "source": source[name],
                    "replaces": replaces[name],
                    "launches": launches[name],
                    "max_abs_err": worst[name], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "shape": r["shape"],
                    "shapes": shapes})
        print(f"{name}: launches {launches[name]}, kernel_ms {r['ms']:.5f}, "
              f"plain_ms {r['plain_ms']:.5f}, library_ms {r['library_ms']} "
              f"at {r['shape']} on {card}")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
