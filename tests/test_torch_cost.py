"""The port's cost model (``repro_torch.launch.hlo_analysis``) on the op
recorder, against the reference's cost cases (``tests/test_hlo_analysis.py``,
with the same numbers) and against the reference's ``CostModel`` of the
same reduced steps, lowered by XLA on a one-device mesh.

The reference's parser cases (HLO text, while-loop trip counts) have no
counterpart: the port records each op as often as it runs.  Q-MAC's
meta shape rules, which the dry run's trace needs, are held here too.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import trace_audit as ta
from repro_torch.configs.registry import get_arch
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.policy import W8, W8A8, get_policy
from repro_torch.core.qmatmul import q_matmul
from repro_torch.distributed import sharding as tsh
from repro_torch.kernels import launch_counts
from repro_torch.kernels.qmac import ops as qmac_ops
from repro_torch.kernels.vact import ops as vact_ops
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import steps as tsteps
from repro_torch.nn.conv import conv2d_init, qconv_block

CPU = torch.device("cpu")


def _x_w(device):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((16, 32), generator=g).to(device)
    w = (torch.randn((32, 24), generator=g) * 0.1).to(device)
    return x, w


# ---------------------------------------------------------------------------
# the reference's cost cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_w8a8_matmul_counts_int_ops_and_no_flops(device):
    """W8A8 [16, 32] x [32, 24]: the contraction is one Q-MAC call, 2 M N K
    integer ops, and no fp product anywhere (its plain version's fp64
    product on the CPU is charged as the kernel)."""
    x, w = _x_w(device)
    t = H.cost_terms(H.trace(lambda x, w: q_matmul(x, w, W8A8), (x, w)))
    assert t["int_ops"] == 2 * 16 * 24 * 32
    assert t["flops"] == 0.0
    # at least the kernel's boundary: int8 operands, int32 accumulators
    assert t["bytes"] >= 16 * 32 + 32 * 24 + 16 * 24 * 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_w8_matmul_counts_fp_flops(device):
    """Weight-only W8 dequantizes and takes the fp product."""
    x, w = _x_w(device)
    t = H.cost_terms(H.trace(lambda x, w: q_matmul(x, w, W8), (x, w)))
    assert t["flops"] == 2 * 16 * 24 * 32
    assert t["flops_by_dtype"] == {"float32": 2 * 16 * 24 * 32}
    assert t["int_ops"] == 0.0


def test_qconv_block_flops_from_kernel_volume():
    """A stride-2 SAME conv [2, 8, 8, 3] -> [2, 4, 4, 8] at W8: 2 * out *
    (3 * 3 * 3), and at least its boundary bytes."""
    p = conv2d_init(torch.Generator().manual_seed(2), 3, 8, 3)
    x = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(3))
    prog = H.trace(lambda p, x: qconv_block(p, x, stride=2, policy=W8),
                   (p, x))
    t = H.cost_terms(prog)
    assert t["flops"] == 2 * (2 * 4 * 4 * 8) * (3 * 3 * 3)
    assert t["int_ops"] == 0.0
    assert t["bytes"] >= (2 * 8 * 8 * 3 + 3 * 3 * 3 * 8 + 2 * 4 * 4 * 8) * 4
    assert H.op_histogram(prog, ["aten.convolution"]) == {
        "aten.convolution": 1}


def test_qconv_block_w8a8_is_one_qconv_record():
    """At W8A8 the same conv runs the integer program: one Q-Conv call,
    charged 2 * out * (3 * 3 * 3) integer operations, and no fp
    product."""
    p = conv2d_init(torch.Generator().manual_seed(2), 3, 8, 3)
    x = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(3))
    prog = H.trace(lambda p, x: qconv_block(p, x, stride=2, policy=W8A8),
                   (p, x))
    t = H.cost_terms(prog)
    assert t["int_ops"] == 2 * (2 * 4 * 4 * 8) * (3 * 3 * 3)
    assert t["flops"] == 0.0
    assert H.op_histogram(prog, ["qconv_i8_taps", "aten.convolution"]) == {
        "qconv_i8_taps": 1, "aten.convolution": 0}


def test_convolution_backward_counts_each_gradient():
    x = torch.randn((2, 3, 8, 8), requires_grad=True)
    w = torch.randn((8, 3, 3, 3), requires_grad=True)

    def step(x, w):
        y = torch.nn.functional.conv2d(x, w, stride=2, padding=1)
        return torch.autograd.grad(y.sum(), (x, w))

    t = H.cost_terms(H.trace(step, (x, w)))
    # the forward, then the input's and the weight's gradients
    assert t["flops"] == 3 * 2 * (2 * 8 * 4 * 4) * (3 * 3 * 3)


def test_byte_conventions():
    """Every op reads its operands and writes its outputs; views and
    bare allocations move nothing; a kernel call is charged its
    operands and output, its plain version's ops nothing."""
    a = torch.ones((8, 16))

    def elementwise(a):
        return a + a

    def views(a):
        return a.t().reshape(16, 8)[:4].unsqueeze(0)

    assert H.cost_terms(H.trace(elementwise, (a,)))["bytes"] == 3 * 8 * 16 * 4
    # a broadcast operand is read once: [8, 16] + [16]
    bias = torch.ones(16)
    assert H.cost_terms(H.trace(torch.add, (a, bias)))["bytes"] == \
        (8 * 16 + 16 + 8 * 16) * 4
    assert H.cost_terms(H.trace(views, (a,)))["bytes"] == 0
    assert H.cost_terms(H.trace(lambda: torch.empty((64, 64)), ()))[
        "bytes"] == 0
    q = torch.ones((16, 32), dtype=torch.int8)
    qw = torch.ones((32, 24), dtype=torch.int8)
    prog = H.trace(qmac_ops.qmac_i8, (q, qw))
    assert [(r.kind, r.name) for r in prog.ops] == [("kernel", "qmac_i8")]
    assert H.cost_terms(prog)["bytes"] == 16 * 32 + 32 * 24 + 16 * 24 * 4


def test_collective_bytes_are_what_the_rank_receives():
    """``psum`` over 4 slots of a MeshShape (the dry run's one-process
    mesh) is one all-reduce of 3 peers' copies; the MoE exchange and the
    other gathers are all-gathers."""
    mesh = tsh.MeshShape(("data", "model"), (4, 2))
    x = torch.ones((8, 8))
    prog = H.trace(lambda x: tsh.psum(x, mesh), (x,))
    c = H.collective_bytes(prog)
    assert c["all-reduce"] == 3 * 8 * 8 * 4
    assert c["total"] == c["all-reduce"]
    prog = H.trace(lambda x: tsh.gather_over(x, mesh, ("model",)), (x,))
    assert H.collective_bytes(prog)["all-gather"] == 1 * 8 * 8 * 4
    # one slot: a gather over one peer moves nothing
    one = tsh.MeshShape(("data", "model"), (1, 1))
    prog = H.trace(lambda x: tsh.psum(x, one), (x,))
    assert H.collective_bytes(prog)["total"] == 0.0
    assert H.op_histogram(prog)["all-reduce"] == 1
    # the sum over the slots is charged where it runs, on the device
    prog = H.trace(lambda x: tsh.psum(x, mesh), (x,))
    assert H.op_histogram(prog)["aten.add"] == 3


def test_op_histogram_keys():
    mesh = tsh.MeshShape(("data", "model"), (2, 1))
    x, w = _x_w(CPU)

    def step(x, w):
        return tsh.psum(q_matmul(x, w, W8A8) @ w.t(), mesh)

    prog = H.trace(step, (x, w))
    hist = H.op_histogram(prog)
    assert hist["qmac_i8"] == 1 and hist["all-reduce"] == 1
    assert hist["aten.mm"] == 1
    assert H.op_histogram(prog, ("qmac_i8", "all-gather")) == {
        "qmac_i8": 1, "all-gather": 0}
    text = prog.as_text()
    assert "kernel qmac_i8(int8[16, 32], int8[32, 24]) -> (int32[16, 24])" \
        in text
    assert len(text.splitlines()) == len(prog.ops)


def test_memory_stats_peak_and_saved_tensors():
    """temp is the peak of the live bytes the step allocated (a tensor
    autograd saves stays live until the graph is freed); the reference's
    keys are all there."""
    n = 1024 * 4                              # one [1024] fp32 buffer

    def chain(x):
        a = x + 1
        b = a * 2
        del a
        return b * 3                           # b and this live at once

    m = H.memory_stats(H.trace(chain, (torch.ones(1024),)))
    assert m["temp_size_in_bytes"] == 2 * n
    assert m["argument_size_in_bytes"] == n
    assert m["output_size_in_bytes"] == n
    assert m["total_bytes"] == 3 * n
    for k in ("generated_code_size_in_bytes", "alias_size_in_bytes",
              "layout_argument_bytes"):
        assert m[k] == 0.0

    def saved(x):
        y = x.sin()                            # saved by cos's backward
        z = y.cos().sum()
        del y
        (g,) = torch.autograd.grad(z, x)
        return g

    x = torch.ones(1024, requires_grad=True)
    m = H.memory_stats(H.trace(saved, (x,)))
    # sin's output stays live beside cos's while the forward runs
    assert m["temp_size_in_bytes"] >= 2 * n


# ---------------------------------------------------------------------------
# Q-MAC on the meta device: a shape rule, no launch
# ---------------------------------------------------------------------------


def test_qmac_meta_rules_launch_nothing():
    before = launch_counts()
    qx = torch.empty((5, 64), dtype=torch.int8, device="meta")
    qw = torch.empty((64, 24), dtype=torch.int8, device="meta")
    sx = torch.empty((5, 1), device="meta")
    sw = torch.empty((1, 24), device="meta")
    out = qmac_ops.qmac_i8(qx, qw)
    assert (out.shape, out.dtype, out.device.type) == (
        (5, 24), torch.int32, "meta")
    out = qmac_ops.qmac_i8_deq(qx, sx, qw, sw)
    assert (out.shape, out.dtype, out.device.type) == (
        (5, 24), torch.float32, "meta")
    bx = torch.empty((3, 5, 64), dtype=torch.int8, device="meta")
    bw = torch.empty((3, 64, 24), dtype=torch.int8, device="meta")
    out = qmac_ops.qmac_i8_deq_bmm(bx, torch.empty((3, 5, 1), device="meta"),
                                   bw, torch.empty((3, 1, 24), device="meta"))
    assert (out.shape, out.dtype) == ((3, 5, 24), torch.float32)
    assert launch_counts() == before
    # the operands are checked as on the card
    with pytest.raises(TypeError):
        qmac_ops.qmac_i8(qx.to(torch.float32), qw)
    with pytest.raises(ValueError):
        qmac_ops.qmac_i8(qx, qw[:32])
    with pytest.raises(ValueError):
        qmac_ops.qmac_i8_deq(qx, sx[:4], qw, sw)
    # a wrapper without a meta rule keeps raising
    with pytest.raises(ValueError, match="meta"):
        vact_ops.vact_ew(torch.empty((4, 8), device="meta"), "tanh", 6)


def test_qmac_meta_and_cpu_records_agree():
    """The same call records the same kernel on the meta device and on
    the CPU (its plain version), with 2 M N K integer ops."""
    x, w = _x_w(CPU)
    xm, wm = x.to("meta"), w.to("meta")
    cpu = H.trace(lambda x, w: q_matmul(x, w, W8A8), (x, w))
    meta = H.trace(lambda x, w: q_matmul(x, w, W8A8), (xm, wm))
    assert [r[:4] for r in cpu.ops] == [r[:4] for r in meta.ops]
    assert H.cost_terms(cpu) == H.cost_terms(meta)
    assert H.memory_stats(cpu) == H.memory_stats(meta)


# ---------------------------------------------------------------------------
# against the reference's CostModel of the same reduced steps
# ---------------------------------------------------------------------------

# the port's fp flops of a training step against the reference's:
# measured 0.33 % (tinyllama) and 0.29 % (qwen3-moe) more in the port
# with remat off, 0.32 % and 0.29 % with it on; prefill and decode are
# equal
TRAIN_FLOPS_RTOL = 5e-3
CROSS_SHAPE = (16, 4)                    # seq_len, global batch


def _reference_cost(arch, kind, remat=True):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import registry as jreg
    from repro.configs.shapes import ShapeConfig as JShape
    from repro.core.policy import get_policy as jpolicy
    from repro.launch import hlo_analysis as JH
    from repro.launch import steps as jsteps
    from repro.models.registry import input_specs

    cfg = jreg.get_arch(arch).reduced().replace(remat=remat)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    shape = JShape("t", *CROSS_SHAPE, kind)
    pol = jpolicy("qforce8")
    if cfg.is_moe and kind != "train":
        # the port serves an MoE with fp weights (the reference's packed
        # experts fail its own scan): lower the reference's step so
        specs = input_specs(cfg, shape)
        p, _ = jsteps.abstract_params(cfg, mesh, serve=kind == "decode")
        if kind == "prefill":
            low = jax.jit(jsteps.make_prefill_step(cfg, mesh, pol, 8)).lower(
                p, specs)
        else:
            c, _ = jsteps.abstract_caches(cfg, shape, mesh, 8)
            low = jax.jit(jsteps.make_decode_step(cfg, mesh, pol, 8)).lower(
                p, c, specs["token"], jax.ShapeDtypeStruct((), jnp.int32))
    else:
        low, _ = jsteps.lower_cell(cfg, shape, mesh, pol)
    return JH.cost_terms(low.compile())


def _down_recomputed(cfg, kind, remat):
    """The integer ops the port's rematerialised training step runs that
    the reference's does not: each dense block's last product, the FFN's
    down projection, again.  The backward reads that product's input,
    not its output, so XLA drops its recompute as dead code; PyTorch's
    checkpoint recomputes a block up to the last tensor it saved, which
    that product saves after its launch.  An MoE block ends in the
    combine, which reads the experts' outputs: none is dropped there."""
    if kind != "train" or not remat or cfg.is_moe:
        return 0
    tokens = CROSS_SHAPE[0] * CROSS_SHAPE[1]
    return cfg.n_layers * 2 * tokens * cfg.d_ff * cfg.d_model


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("kind,remat", [("prefill", True), ("decode", True),
                                        ("train", False), ("train", True)],
                         ids=["prefill", "decode", "train", "train_remat"])
def test_costs_match_the_references(arch, kind, remat):
    """Both packages' steps at the same ``cfg.remat`` (serving steps
    checkpoint nothing, so only training is lowered both ways)."""
    cfg = get_arch(arch).reduced().replace(remat=remat)
    mesh = tsh.MeshShape(("data", "model"), (1, 1))
    prog, meta = tsteps.lower_cell(cfg, ShapeConfig("t", *CROSS_SHAPE, kind),
                                   mesh, get_policy("qforce8"))
    got, want = H.cost_terms(prog), _reference_cost(arch, kind, remat)
    assert got["int_ops"] == want["int_ops"] + _down_recomputed(
        cfg, kind, remat) > 0
    if kind == "train":
        assert got["flops"] == pytest.approx(want["flops"],
                                             rel=TRAIN_FLOPS_RTOL)
    else:
        assert got["flops"] == want["flops"]
    assert got["collective_bytes"] == 0.0     # one device


def test_recorder_without_costing_keeps_no_records():
    rec = ta.OpRecorder()
    with ta.recording(rec):
        torch.ones(3) * 2.0
    assert rec.records == [] and rec.peak_bytes == 0 and rec.ops == 2
