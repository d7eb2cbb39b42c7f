#!/usr/bin/env python3
"""Probes of the port's two redesigned kernels on one CUDA card.

    python3 tools/kernel_probe.py split    # Q-MAC ms against K slices
    python3 tools/kernel_probe.py stages   # Q-Conv block stage cycles

Run from a checkout on the machine with the card (it needs ``nvcc``).

``split`` times the fused Q-MAC at the serving and HRL shapes for every
number of K slices from 1 to 64 that cuts K into 16-byte multiples,
next to what ``split_plan`` picks, each held bitwise against the plain
version.  ``stages`` builds a copy of ``qconv.cu`` that stamps
``clock64`` after each stage of every block (input staged; scales and
weights staged, after the barrier; taps and output done) into
``build/kernel_probe/``, runs it at the four stem shapes of
``chip_smoke.py`` phase 4 and prints the median and largest cycles of
each stage over the blocks.  Both print the card's name and power
limit first.
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


def main() -> int:
    import torch
    import chip_smoke as cs

    if len(sys.argv) != 2 or sys.argv[1] not in ("split", "stages"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA card", file=sys.stderr)
        return 2
    print(cs.card_line())
    dev = torch.device("cuda", 0)
    {"split": split, "stages": stages}[sys.argv[1]](torch, cs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
