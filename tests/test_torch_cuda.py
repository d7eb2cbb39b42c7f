"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips, with its reason, where no card is
visible (the decision is taken inside the fixture, never at import).
On the machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

The kernels are built from ``src/repro_torch/kernels/*/csrc`` at first
use.  Integer outputs must be equal and fp32 outputs bitwise equal: the
kernels keep every multiply and add separate (``--fmad=false``, ``_rn``
intrinsics), in the plain version's order.  V-ACT's softmax is the one
exception, at rtol=1e-6: its row sum runs in another order.  The
full-width E2HRL agent on the card is held bitwise against the CPU.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import policy as tpolicy
from repro_torch.core.qmatmul import q_matmul
from repro_torch.kernels.qconv import ops as qconv_ops
from repro_torch.kernels.qmac import ops as qmac_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _i8(gen, dev, shape):
    return torch.randint(-128, 128, shape, generator=gen, device=dev,
                         dtype=torch.int32).to(torch.int8)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("m,k,n", [(1, 2048, 128), (32, 2048, 128),
                                   (7, 128, 4), (33, 17, 9), (5, 12, 1)])
def test_qmac_kernels_equal_plain(dev, m, k, n):
    gen = torch.Generator(device=dev).manual_seed(m * k + n)
    qx, qw = _i8(gen, dev, (m, k)), _i8(gen, dev, (k, n))
    sx = torch.rand((m, 1), generator=gen, device=dev) + 1e-3
    sw = torch.rand((1, n), generator=gen, device=dev) + 1e-3
    before = qmac_ops.qmac_i8.launches
    assert torch.equal(qmac_ops.qmac_i8(qx, qw),
                       qmac_ops.qmac_i8_plain(qx, qw))
    assert qmac_ops.qmac_i8.launches == before + 1
    got = qmac_ops.qmac_i8_deq(qx, sx, qw, sw)
    want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, sw)
    assert torch.equal(_bits(got), _bits(want))
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,h,w,c,n,k,stride,padding", [
    (7, 32, 32, 12, 16, 3, 2, "SAME"), (7, 16, 16, 16, 32, 3, 2, "SAME"),
    (3, 15, 13, 5, 7, 3, 1, "SAME"), (2, 17, 9, 20, 33, 2, 2, "VALID")])
def test_qconv_kernel_equals_plain(dev, b, h, w, c, n, k, stride, padding):
    gen = torch.Generator(device=dev).manual_seed(b * h + n)
    qx, qw = _i8(gen, dev, (b, h, w, c)), _i8(gen, dev, (k, k, c, n))
    sx = torch.rand((b, h, w, 1), generator=gen, device=dev) * 0.01
    sw = torch.rand((n,), generator=gen, device=dev) * 0.01
    bias = torch.randn((n,), generator=gen, device=dev) * 0.1
    for relu in (False, True):
        kw = dict(stride=stride, padding=padding, fuse_relu=relu)
        got = qconv_ops.qconv2d_i8(qx, sx, qw, sw, bias, **kw)
        want = qconv_ops.qconv2d_i8_plain(qx, sx, qw, sw, bias, **kw)
        assert torch.equal(_bits(got), _bits(want))
    torch.cuda.synchronize()


def test_wrappers_refuse_what_the_kernel_does_not_take(dev):
    qx = torch.zeros((8, 16), dtype=torch.int8, device=dev)
    qw = torch.zeros((16, 4), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        qmac_ops.qmac_i8(qx, qw.t().contiguous().t())
    with pytest.raises(ValueError, match="operands on"):
        qmac_ops.qmac_i8(qx, qw.cpu())


def test_q_matmul_on_the_card_equals_the_cpu(dev):
    """The evaluation (fp weights) and serving (QTensor) products."""
    from repro_torch.core.fxp import QTensor
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((32, 2048), generator=gen)
    w = torch.randn((2048, 128), generator=gen) * 0.02
    pol = tpolicy.FXP8
    kernels.reset_launch_counts()
    for wt in (w, QTensor.quant(w, 8, channel_axis=1)):
        want = q_matmul(x, wt, pol)
        got = q_matmul(x.to(dev), wt.to(dev), pol).cpu()
        assert torch.equal(_bits(got), _bits(want))
    counts = kernels.launch_counts()
    assert counts["qmac_i8"] == 1 and counts["qmac_i8_deq"] == 1


def _special(gen, dev, shape):
    """Normal draws x4 with the CORDIC's edge inputs written in."""
    x = torch.randn(shape, generator=gen, device=dev) * 4
    flat = x.view(-1)
    edge = torch.tensor([0.0, 1e-8, -1e-8, 30.0, -30.0, 100.0, -100.0],
                        device=dev)
    k = min(edge.numel(), flat.numel())
    flat[:k] = edge[:k]
    return x


@pytest.mark.parametrize("shape", [(512, 8), (128, 32), (1, 1), (7, 33),
                                   (300, 301)])
@pytest.mark.parametrize("n", [6, 13])
def test_vact_kernels_equal_plain(dev, shape, n):
    from repro_torch.kernels.vact import ops as vact_ops
    gen = torch.Generator(device=dev).manual_seed(shape[0] * 7 + n)
    x = _special(gen, dev, shape)
    for kind in ("relu", "sigmoid", "tanh"):
        before = vact_ops.vact_ew.launches
        got = vact_ops.vact(x, kind, n)
        assert vact_ops.vact_ew.launches == before + 1
        assert torch.equal(_bits(got), _bits(vact_ops.vact_ew_plain(
            x, kind, n)))
        qx = _i8(gen, dev, shape)
        sx = torch.rand((), generator=gen, device=dev) * 0.05
        assert torch.equal(vact_ops.vact_q8(qx, sx, kind, n),
                           vact_ops.vact_q8_plain(qx, sx, kind, n))
    got = vact_ops.vact(x, "softmax", n)
    want = vact_ops.vact_softmax_plain(x, n)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("b", [1, 7, 128])
@pytest.mark.parametrize("d_in,h", [(32, 32), (8, 8), (40, 24)])
def test_qlstm_kernel_equals_plain(dev, b, d_in, h):
    from repro_torch.kernels.qlstm import ops as qlstm_ops
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + d_in + h)
    qx, qh = _i8(gen, dev, (b, d_in)), _i8(gen, dev, (b, h))
    qw, qu = _i8(gen, dev, (d_in, 4 * h)), _i8(gen, dev, (h, 4 * h))
    sx = torch.rand((), generator=gen, device=dev) * 0.02
    sh = torch.rand((), generator=gen, device=dev) * 0.02
    sw = torch.rand((1, 4 * h), generator=gen, device=dev) * 0.004
    su = torch.rand((1, 4 * h), generator=gen, device=dev) * 0.004
    bias = torch.randn((4 * h,), generator=gen, device=dev) * 0.1
    c = torch.randn((b, h), generator=gen, device=dev)
    args = (qx, sx, qh, sh, qw, sw, qu, su, bias, c)
    before = qlstm_ops.qlstm_cell.launches
    got = qlstm_ops.qlstm_cell(*args, n_iters=6)
    assert qlstm_ops.qlstm_cell.launches == before + 1
    want = qlstm_ops.qlstm_cell_plain(*args, 6)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["fc", "lstm"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_hrl_apply_on_the_card_equals_the_cpu(dev, kind, backend):
    """The full-width agent (32x32x3, channels (16, 32, 32)) through
    Q-Conv, Q-MAC, V-ACT and, for LSTM-HRL at pallas, Q-LSTM."""
    from repro_torch.configs.e2hrl import HRLConfig
    from repro_torch.models import hrl
    from repro_torch.tree import tree_map
    cfg = HRLConfig(obs_shape=(32, 32, 3), n_actions=4, subgoal_kind=kind)
    pol = tpolicy.FXP8.replace(backend=backend, act_backend="cordic")
    params = hrl.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    window = (4,) if kind == "lstm" else ()
    obs = torch.rand((16,) + window + cfg.obs_shape,
                     generator=torch.Generator().manual_seed(1))
    kernels.reset_launch_counts()
    logits, value, _ = hrl.apply(tree_map(lambda t: t.to(dev), params),
                                 obs.to(dev), cfg, pol)
    probs = hrl.action_probs(logits, pol)
    counts = kernels.launch_counts()
    want_logits, want_value, _ = hrl.apply(params, obs, cfg, pol)
    assert torch.equal(_bits(logits.cpu()), _bits(want_logits))
    assert torch.equal(_bits(value.cpu()), _bits(want_value))
    torch.testing.assert_close(probs.cpu(), hrl.action_probs(want_logits,
                                                             pol),
                               rtol=1e-6, atol=0)
    assert counts["vact_ew"] > 0 and counts["vact_softmax"] == 1
    assert counts["qconv_i8_taps"] > 0 and counts["qmac_i8"] > 0
    assert (counts["qlstm_cell"] > 0) == (kind == "lstm"
                                          and backend == "pallas")


# --- the split-K Q-MAC and the band-staged Q-Conv at their edges -------

QMAC_K = [1, 15, 16, 17, 40, 2047, 2048, 2049, 131072]
QMAC_M = [1, 2, 31, 32, 33, 512]
QMAC_N = [1, 4, 33, 128]


def _qmac_case(gen, dev, m, k, n):
    qx, qw = _i8(gen, dev, (m, k)), _i8(gen, dev, (k, n))
    sx = torch.rand((m, 1), generator=gen, device=dev) + 1e-3
    sw = torch.rand((1, n), generator=gen, device=dev) + 1e-3
    return qx, qw, sx, sw


def _assert_qmac_equal(qx, qw, sx, sw):
    assert torch.equal(qmac_ops.qmac_i8(qx, qw),
                       qmac_ops.qmac_i8_plain(qx, qw))
    for s in (sw, sw[:, :1].contiguous()):       # per-channel, per-tensor
        got = qmac_ops.qmac_i8_deq(qx, sx, qw, s)
        want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, s)
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k", QMAC_K)
def test_qmac_split_k_edges_equal_plain(dev, k):
    """Every M and N of the grid at this K: slices that end mid-word,
    mid-chunk and past the 16-byte loads, one and many splits."""
    gen = torch.Generator(device=dev).manual_seed(k)
    for m in QMAC_M:
        for n in QMAC_N:
            _assert_qmac_equal(*_qmac_case(gen, dev, m, k, n))
    torch.cuda.synchronize()


def test_qmac_split_counters_reset_and_streams(dev):
    """The same split call twice gives the same bits (the counters went
    back to 0); calls at other shapes in between, and a call on a second
    stream with its own workspace, give the same bits too."""
    gen = torch.Generator(device=dev).manual_seed(11)
    fc = _qmac_case(gen, dev, 32, 2048, 128)
    other = _qmac_case(gen, dev, 512, 512, 32)
    head = _qmac_case(gen, dev, 8, 4096, 4)
    qx, qw, sx, sw = fc
    assert qmac_ops.split_plan(32, 2048, 128).splits > 1
    first = qmac_ops.qmac_i8_deq(qx, sx, qw, sw)
    again = qmac_ops.qmac_i8_deq(qx, sx, qw, sw)
    assert torch.equal(_bits(first), _bits(again))
    want = qmac_ops.qmac_i8_deq_plain(qx, sx, qw, sw)
    assert torch.equal(_bits(first), _bits(want))
    for _ in range(3):
        for case in (other, fc, head):
            cx, cw, csx, csw = case
            got = qmac_ops.qmac_i8_deq(cx, csx, cw, csw)
            assert torch.equal(_bits(got), _bits(
                qmac_ops.qmac_i8_deq_plain(cx, csx, cw, csw)))
            assert torch.equal(qmac_ops.qmac_i8(cx, cw),
                               qmac_ops.qmac_i8_plain(cx, cw))
    # both streams run the split product at once: a shared counter or
    # workspace would mix their partials
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    on_main = [qmac_ops.qmac_i8_deq(qx, sx, qw, sw) for _ in range(8)]
    with torch.cuda.stream(side):
        on_side = [qmac_ops.qmac_i8_deq(qx, sx, qw, sw) for _ in range(8)]
    main.wait_stream(side)
    torch.cuda.synchronize()
    for got in on_main + on_side:
        assert torch.equal(_bits(got), _bits(want))
    keys = [key for key in qmac_ops._workspaces if key[0] == dev.index]
    assert len(keys) >= 2


QCONV_C = [3, 5, 12, 16, 40, 130]


@pytest.mark.parametrize("c", QCONV_C)
def test_qconv_band_edges_equal_plain(dev, c):
    """Strides 1-3, SAME and VALID, 2x2/3x3/5x5 kernels, N in {3, 16, 33,
    48}, images whose rows and columns are not multiples of a band."""
    gen = torch.Generator(device=dev).manual_seed(c)
    i = 0
    for stride in (1, 2, 3):
        for k in (2, 3, 5):
            for padding in ("SAME", "VALID"):
                n = (3, 16, 33, 48)[i % 4]
                b, h, w = 1 + i % 3, 13 + i % 4, 11 + 2 * (i % 3)
                i += 1
                qx, qw = _i8(gen, dev, (b, h, w, c)), _i8(gen, dev,
                                                          (k, k, c, n))
                sx = torch.rand((b, h, w, 1), generator=gen,
                                device=dev) * 0.01
                sw = torch.rand((n,), generator=gen, device=dev) * 0.01
                bias = torch.randn((n,), generator=gen, device=dev) * 0.1
                kw = dict(stride=stride, padding=padding,
                          fuse_relu=bool(i % 2))
                got = qconv_ops.qconv2d_i8(qx, sx, qw, sw, bias, **kw)
                want = qconv_ops.qconv2d_i8_plain(qx, sx, qw, sw, bias,
                                                  **kw)
                assert torch.equal(_bits(got), _bits(want)), (
                    b, h, w, c, k, n, stride, padding)
    torch.cuda.synchronize()


def test_qconv_band_past_48kb_and_row_past_227kb(dev):
    """A band over 48 KB runs in dynamic shared memory (the launcher
    accepts only the shared memory its own layout takes, so the planner's
    count is checked at every launch); a shape whose one output row needs
    more than 227 KB raises and launches nothing."""
    gen = torch.Generator(device=dev).manual_seed(5)
    b, h, w, c, n = 1, 8, 512, 40, 16
    plan = qconv_ops.band_plan(b, h, w, c, 3, 3, n, 1, "SAME")
    assert plan.smem > 48 * 1024
    qx, qw = _i8(gen, dev, (b, h, w, c)), _i8(gen, dev, (3, 3, c, n))
    sx = torch.rand((b, h, w, 1), generator=gen, device=dev) * 0.01
    sw = torch.rand((n,), generator=gen, device=dev) * 0.01
    bias = torch.randn((n,), generator=gen, device=dev) * 0.1
    got = qconv_ops.qconv2d_i8(qx, sx, qw, sw, bias)
    assert torch.equal(_bits(got), _bits(qconv_ops.qconv2d_i8_plain(
        qx, sx, qw, sw, bias)))
    big = torch.zeros((1, 4, 2048, 40), dtype=torch.int8, device=dev)
    before = qconv_ops.qconv2d_i8.launches
    with pytest.raises(ValueError, match="shared memory"):
        qconv_ops.qconv2d_i8(big, torch.ones((1, 4, 2048, 1), device=dev),
                             torch.zeros((3, 3, 40, 16), dtype=torch.int8,
                                         device=dev),
                             torch.ones(16, device=dev),
                             torch.zeros(16, device=dev))
    assert qconv_ops.qconv2d_i8.launches == before
    torch.cuda.synchronize()


# --- V-ACT's strided elementwise kernel and the Q-LSTM cell at edges ----

@pytest.mark.parametrize("numel", [1, 3, 4095, 4096, 4097])
@pytest.mark.parametrize("n", [1, 6, 13, 24])
def test_vact_ew_iterations_and_sizes_equal_plain(dev, numel, n):
    """Every kind at the two unrolled counts (6, 13) and the generic
    instance (1, 24), at sizes around the path's 4096-element calls."""
    from repro_torch.kernels.vact import ops as vact_ops
    gen = torch.Generator(device=dev).manual_seed(numel * 31 + n)
    x = _special(gen, dev, (numel,))
    for kind in ("relu", "sigmoid", "tanh"):
        before = vact_ops.vact_ew.launches
        got = vact_ops.vact_ew(x, kind, n)
        assert vact_ops.vact_ew.launches == before + 1
        assert torch.equal(_bits(got), _bits(vact_ops.vact_ew_plain(
            x, kind, n)))
    torch.cuda.synchronize()


def _strided_cases(gen, dev):
    """(what, view): the LSTM's gate slices of [B, 4H] at each gate
    offset, a view off 16-byte alignment, a row stride not a multiple of
    4, a 3-D view whose leading axes fold."""
    cases = []
    for b, h in ((128, 32), (7, 3), (129, 33)):
        gates = _special(gen, dev, (b, 4 * h))
        cases += [(f"gate {g} of [{b}, {4 * h}]", gates[:, g * h:(g + 1) * h])
                  for g in range(4)]
    flat = _special(gen, dev, (4099,))
    cases += [("offset 4 B, contiguous", flat[1:4098]),
              ("offset 4 B, rows of 40", flat[1:4001].view(100, 40)[:, :32]),
              ("row stride 130", _special(gen, dev, (128, 130))[:, 2:34]),
              ("3-D", _special(gen, dev, (4, 32, 12))[:, :, 4:12])]
    return cases


@pytest.mark.parametrize("n", [6, 13])
def test_vact_ew_reads_strided_views_in_place(dev, n):
    from repro_torch.kernels.vact import ops as vact_ops
    gen = torch.Generator(device=dev).manual_seed(n)
    for what, x in _strided_cases(gen, dev):
        assert not x.is_contiguous() or x.data_ptr() % 16, what
        assert vact_ops.ew_operand(tuple(x.shape), x.stride()) is not None
        for kind in ("relu", "sigmoid", "tanh"):
            got = vact_ops.vact_ew(x, kind, n)
            assert got.is_contiguous() and got.shape == x.shape
            want = vact_ops.vact_ew_plain(x.contiguous(), kind, n)
            assert torch.equal(_bits(got), _bits(want)), (what, kind)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [6, 13])
def test_vact_ew_past_one_wave_and_the_grid_cap(dev, n):
    """Past one wave of one-element threads (132 x 256) and past the
    grid's cap, where each thread strides over rows: a contiguous row, a
    gate-like slice, a row stride of 130 and rows 4 B off alignment."""
    from repro_torch.kernels.vact import ops as vact_ops
    gen = torch.Generator(device=dev).manual_seed(100 + n)
    wave = vact_ops.SMS * vact_ops.EW_MAX_THREADS
    rows = -(-vact_ops.EW_MAX_BLOCKS * vact_ops.EW_MAX_THREADS // 32) + 100
    assert rows * 32 > vact_ops.EW_MAX_BLOCKS * vact_ops.EW_MAX_THREADS
    wide = _special(gen, dev, (rows * 40 + 1,))
    cases = [("contiguous", _special(gen, dev, (wave + 3,))),
             ("slice of [rows, 128]",
              _special(gen, dev, (rows, 128))[:, 32:64]),
             ("row stride 130", _special(gen, dev, (rows, 130))[:, 2:34]),
             ("offset 4 B, rows of 40", wide[1:].view(rows, 40)[:, :32])]
    for what, x in cases:
        assert vact_ops.ew_operand(tuple(x.shape), x.stride()) is not None
        for kind in ("relu", "sigmoid", "tanh"):
            got = vact_ops.vact_ew(x, kind, n)
            assert got.is_contiguous() and got.shape == x.shape
            want = vact_ops.vact_ew_plain(x.contiguous(), kind, n)
            assert torch.equal(_bits(got), _bits(want)), (what, kind)
    torch.cuda.synchronize()


def _cell_args(gen, dev, b, d_in, h, offset=0):
    """Cell operands; ``offset`` > 0 puts qw and qu at that many bytes
    into their storage, off 4-byte alignment."""
    def i8_at(shape):
        flat = _i8(gen, dev, (offset + shape[0] * shape[1],))
        return flat[offset:].view(shape)
    return (_i8(gen, dev, (b, d_in)),
            torch.rand((), generator=gen, device=dev) * 0.02,
            _i8(gen, dev, (b, h)),
            torch.rand((), generator=gen, device=dev) * 0.02,
            i8_at((d_in, 4 * h)),
            torch.rand((1, 4 * h), generator=gen, device=dev) * 0.004,
            i8_at((h, 4 * h)),
            torch.rand((1, 4 * h), generator=gen, device=dev) * 0.004,
            torch.randn((4 * h,), generator=gen, device=dev) * 0.1,
            torch.randn((b, h), generator=gen, device=dev))


@pytest.mark.parametrize("b", [1, 7, 128, 129, 512])
@pytest.mark.parametrize("h", [1, 3, 32, 33, 64])
def test_qlstm_cell_edges_equal_plain(dev, b, h):
    """Batch and hidden edges of the (row group x unit group) grid, Din
    equal to H and Din = 37 (not a multiple of 4), the unrolled counts
    and the generic instance, and a weight stripe off 4-byte alignment
    (staged by bytes)."""
    from repro_torch.kernels.qlstm import ops as qlstm_ops
    gen = torch.Generator(device=dev).manual_seed(b * 100 + h)
    for d_in, n, offset in ((h, 6, 0), (37, 13, 0), (37, 24, 1)):
        args = _cell_args(gen, dev, b, d_in, h, offset)
        before = qlstm_ops.qlstm_cell.launches
        got = qlstm_ops.qlstm_cell(*args, n_iters=n)
        assert qlstm_ops.qlstm_cell.launches == before + 1
        want = qlstm_ops.qlstm_cell_plain(*args, n)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w)), (b, d_in, h, n, offset)
    torch.cuda.synchronize()


def test_qlstm_cell_refuses_past_227kb_without_a_launch(dev):
    from repro_torch.kernels.qlstm import ops as qlstm_ops
    gen = torch.Generator(device=dev).manual_seed(3)
    args = _cell_args(gen, dev, 4, 8192, 8)
    before = qlstm_ops.qlstm_cell.launches
    with pytest.raises(ValueError, match="shared memory"):
        qlstm_ops.qlstm_cell(*args, n_iters=6)
    assert qlstm_ops.qlstm_cell.launches == before
    torch.cuda.synchronize()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_lstm_cell_on_the_card_equals_the_cpu(dev, backend):
    """Four steps of ``nn/lstm.lstm_cell`` at the agent's width (B = 128,
    Din = H = 32) under FxP8 with CORDIC gates: the xla branch's gate
    activations read column slices of the gate tensor in place."""
    from repro_torch.nn import lstm
    pol = tpolicy.FXP8.replace(backend=backend, act_backend="cordic")
    p = lstm.lstm_init(torch.Generator().manual_seed(0), 32, 32)
    xs = torch.randn((128, 4, 32), generator=torch.Generator().manual_seed(1))
    p_dev = {k: v.to(dev) for k, v in p.items()}
    kernels.reset_launch_counts()
    hs, (h, c) = lstm.lstm_apply(p_dev, xs.to(dev), pol)
    counts = kernels.launch_counts()
    want_hs, (want_h, want_c) = lstm.lstm_apply(p, xs, pol)
    for got, want in ((hs, want_hs), (h, want_h), (c, want_c)):
        assert torch.equal(_bits(got.cpu()), _bits(want))
    if backend == "xla":
        assert counts["vact_ew"] == 4 * 5 and counts["qlstm_cell"] == 0
    else:
        assert counts["qlstm_cell"] == 4 and counts["vact_ew"] == 0


# --- V-ACT's softmax kernels and its int8 table kernel at edges ---------

FLT_MIN = 1.1754944e-38        # smallest normal fp32
# the rows kernel's lane counts, the bound between the rows and block
# kernels, the block kernel's one-warp bound, its shared-memory limit,
# and a row past it
SOFTMAX_COLS = [1, 2, 3, 4, 5, 31, 32, 33, 1023, 1024, 1025, 58079, 58080,
                58081, 65536]


def _softmax_close(got, want, what):
    """rtol 1e-6 (the row sum runs in another order), atol the smallest
    normal fp32 (a subnormal quotient keeps fewer significant bits), NaN
    where the plain version gives NaN."""
    assert got.shape == want.shape and got.is_contiguous(), what
    torch.testing.assert_close(got, want, rtol=1e-6, atol=FLT_MIN,
                               equal_nan=True, msg=what)


def _device_kernels(fn):
    """The names of the device kernels one call of ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.key for ev in prof.key_averages()
            for _ in range(ev.count) if ev.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("cols", SOFTMAX_COLS)
@pytest.mark.parametrize("n", [1, 6, 13, 24])
def test_vact_softmax_regimes_equal_plain(dev, cols, n):
    """Each kernel (rows, block, and the block kernel past shared
    memory) at its bounds, the unrolled counts and the generic instance,
    over 1, 7, 512 and 1000 rows."""
    from repro_torch.kernels.vact import ops as vact_ops
    gen = torch.Generator(device=dev).manual_seed(cols * 31 + n)
    for rows in (1, 7, 512, 1000):
        x = _special(gen, dev, (rows, cols))
        before = vact_ops.vact_softmax.launches
        got = vact_ops.vact_softmax(x, n)
        assert vact_ops.vact_softmax.launches == before + 1
        plan = vact_ops.softmax_plan(rows, cols)
        _softmax_close(got, vact_ops.vact_softmax_plain(x, n),
                       f"[{rows}, {cols}] n={n} {plan}")
    torch.cuda.synchronize()


# past each kernel's grid cap, where its rows stride over the grid: the
# rows kernel at 1, 4 and 32 lanes (540,672, 135,168 and 16,896 rows),
# the block kernel at one warp, staging a whole row and past shared
# memory (2,112 rows), so staged shared memory is reused row after row
SOFTMAX_STRIDED = [(600000, 1), (200000, 4), (20000, 32), (20000, 100),
                   (4096, 1025), (4096, 8192), (2113, 58081)]


@pytest.mark.parametrize("rows,cols", SOFTMAX_STRIDED)
@pytest.mark.parametrize("n", [6, 13])
def test_vact_softmax_past_the_grid_cap(dev, rows, cols, n):
    from repro_torch.kernels.vact import ops as vact_ops
    plan = vact_ops.softmax_plan(rows, cols)
    lanes = max(plan.lanes, 1)
    rows_a_grid = (plan.blocks * plan.threads // 32 * (32 // lanes)
                   if plan.regime == "rows" else plan.blocks)
    assert rows > rows_a_grid, plan
    gen = torch.Generator(device=dev).manual_seed(rows + cols + n)
    x = _special(gen, dev, (rows, cols))
    _softmax_close(vact_ops.vact_softmax(x, n),
                   vact_ops.vact_softmax_plain(x, n),
                   f"[{rows}, {cols}] n={n} {plan}")
    torch.cuda.synchronize()


@pytest.mark.parametrize("cols", [4, 33, 1000, 2048, 65536])
def test_vact_softmax_rows_with_infinities_and_huge_entries(dev, cols):
    """Rows holding some -inf entries (their exponentials are the plain
    version's, not zero: x - max is -inf, the CORDIC's reduction NaN)
    and rows with entries near +-3e38 (x - max overflows to -inf)."""
    from repro_torch.kernels.vact import ops as vact_ops
    gen = torch.Generator(device=dev).manual_seed(cols)
    x = _special(gen, dev, (64, cols))
    x[0::4, 0] = -float("inf")
    x[1::4, -1] = -float("inf")
    x[2::4, 0] = 3e38
    x[2::4, -1] = -3e38
    x[3::4] = torch.where(torch.rand((16, cols), generator=gen, device=dev)
                          < 0.5, 3.3e38, -3.3e38)
    x[3::4, 0] = 3.4e38
    for n in (6, 13):
        _softmax_close(vact_ops.vact_softmax(x, n),
                       vact_ops.vact_softmax_plain(x, n), f"cols {cols}")
    torch.cuda.synchronize()


def test_vact_softmax_reads_row_strided_views_in_place(dev):
    """A view whose leading axes fold into one row stride is read at that
    stride by every kernel: one device launch, the softmax kernel, no
    copy before it."""
    from repro_torch.kernels.vact import ops as vact_ops
    gen = torch.Generator(device=dev).manual_seed(5)
    views = [("[128, 32] at row stride 130",
              _special(gen, dev, (128, 130))[:, 2:34]),
             ("3-D, leading axes folded",
              _special(gen, dev, (4, 32, 12))[:, :, 4:8]),
             ("[64, 100] at row stride 257, 4 B off alignment",
              _special(gen, dev, (64, 257))[:, 1:101]),
             ("[64, 1000] at row stride 1024",
              _special(gen, dev, (64, 1024))[:, 8:1008]),
             ("[16, 4096] at row stride 8192",
              _special(gen, dev, (16, 8192))[:, 4096:]),
             ("[4, 65536] at row stride 65540",
              _special(gen, dev, (4, 65540))[:, 4:])]
    for what, x in views:
        assert not x.is_contiguous()
        op = vact_ops.softmax_operand(tuple(x.shape), x.stride())
        assert op is not None and op[2] == x.stride(-2), what
        got = vact_ops.vact_softmax(x, 6)
        _softmax_close(got, vact_ops.vact_softmax_plain(x.contiguous(), 6),
                       what)
        names = _device_kernels(lambda: vact_ops.vact_softmax(x, 6))
        assert len(names) == 1 and "vact_softmax" in names[0], (what, names)
    torch.cuda.synchronize()


def _all_codes(dev, reps=3):
    """Every int8 code, -128 included, ``reps`` times over."""
    return torch.arange(-128, 128, device=dev,
                        dtype=torch.int32).to(torch.int8).repeat(reps)


@pytest.mark.parametrize("scale", [1e-30, 0.003, 0.05, 3.0])
@pytest.mark.parametrize("kind", ["relu", "sigmoid", "tanh"])
def test_vact_q8_every_code_equals_plain(dev, scale, kind):
    from repro_torch.kernels.vact import ops as vact_ops
    qx = _all_codes(dev)
    sx = torch.tensor(scale, device=dev)
    for n in (1, 6, 13, 24):
        before = vact_ops.vact_q8.launches
        got = vact_ops.vact_q8(qx, sx, kind, n)
        assert vact_ops.vact_q8.launches == before + 1
        assert torch.equal(got, vact_ops.vact_q8_plain(qx, sx, kind, n)), n
    torch.cuda.synchronize()


@pytest.mark.parametrize("numel", [1, 15, 16, 17, 4095, 4096, (1 << 26) + 3])
def test_vact_q8_sizes_and_offsets_equal_plain(dev, numel):
    """Sizes around the 16-byte chunks, the grid's cap, and the same
    sizes read from a view at byte offset 1 (its head taken alone)."""
    from repro_torch.kernels.vact import ops as vact_ops
    gen = torch.Generator(device=dev).manual_seed(numel % 1000)
    flat = _i8(gen, dev, (numel + 1,))
    sx = torch.tensor(0.05, device=dev)
    for what, qx in (("aligned", flat[:numel]), ("offset 1", flat[1:])):
        assert qx.is_contiguous()
        for kind in ("relu", "sigmoid", "tanh"):
            got = vact_ops.vact_q8(qx, sx, kind, 6)
            assert got.is_contiguous() and got.shape == qx.shape
            assert torch.equal(got, vact_ops.vact_q8_plain(qx, sx, kind, 6)), \
                (what, kind)
    torch.cuda.synchronize()


@pytest.mark.parametrize("flags", [
    dict(env_name="keydoor", agent="hrl", two_stage=True, iters=1),
    dict(env_name="catch", net="conv", frame_stack_k=4, iters=2)])
def test_pixel_training_on_the_card_is_reproducible(dev, flags):
    """Two runs of the same seed end bit for bit in the same state: the
    learner's cuDNN convolutions are held to deterministic algorithms."""
    from repro_torch.rl.trainer import OnPolicyTrainer
    from repro_torch.tree import tree_leaves

    runs = [OnPolicyTrainer(device=dev, verbose=False, n_envs=8,
                            rollout_len=32, **flags).train()[0]
            for _ in range(2)]
    for a, b in zip(tree_leaves(tuple(runs[0])), tree_leaves(tuple(runs[1])),
                    strict=True):
        assert torch.equal(a, b)


def test_sum_tree_on_the_card_equals_the_cpu_with_duplicates(dev):
    """Updates with duplicate slots of different values (the last one
    kept) leave every node bitwise the CPU's, and ``find`` lands on the
    same slots: the dedupe keeps the card's scatter order out of it."""
    from repro_torch.rl.replay import sum_tree

    gen = torch.Generator().manual_seed(7)
    cpu, card = sum_tree.init(3000), sum_tree.init(3000, dev)
    for m in (256, 64, 128, 64):
        idx = torch.randint(0, 3000, (m,), generator=gen)
        idx[m // 2:] = idx[:m - m // 2]          # every slot twice
        vals = torch.rand(m, generator=gen) * 3
        cpu = sum_tree.update(cpu, idx, vals)
        card = sum_tree.update(card, idx.to(dev), vals.to(dev))
    assert torch.equal(_bits(card.cpu()), _bits(cpu))
    u = torch.rand(1024, generator=gen) * cpu[1]
    assert torch.equal(sum_tree.find(card, u.to(dev)).cpu(),
                       sum_tree.find(cpu, u))


@pytest.mark.parametrize("flags", [
    dict(algo="dqn", env_name="cartpole", replay="per"),
    dict(algo="qrdqn", env_name="catch", net="conv", frame_stack_k=4),
    dict(algo="ddpg", env_name="pendulum", tqc_drop=2)])
def test_value_training_on_the_card_is_reproducible(dev, flags):
    """Two runs of the same seed of each value algo end bit for bit in
    the same state (params, targets, optimizer, replay), and the
    behaviour actors launch only the port's kernels' planned counts."""
    from repro_torch.rl.trainer import ValueTrainer
    from repro_torch.tree import tree_leaves

    kernels.reset_launch_counts()
    runs = [ValueTrainer(device=dev, verbose=False, iters=3, n_envs=8,
                         rollout_len=8, learn_start=32, **flags).train()[0]
            for _ in range(2)]
    per_step = 2 if flags["algo"] == "qrdqn" else 3
    assert kernels.launch_counts()["qmac_i8"] == 2 * 3 * 8 * per_step
    for a, b in zip(tree_leaves(tuple(runs[0])), tree_leaves(tuple(runs[1])),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("e,c,k,n", [(128, 4, 2048, 768),
                                     (128, 10, 768, 2048),
                                     (3, 37, 2049, 40), (2, 5, 4096, 24),
                                     (1, 7, 2048, 128)])
def test_qmac_batched_equals_plain(dev, e, c, k, n, qmax):
    """The fused product over experts at qwen3-moe's decode and prefill
    shapes, a ragged C and K, a split K over two experts, and one expert
    (the unbatched product), with w8 and w4 codes: bitwise, one launch."""
    gen = torch.Generator(device=dev).manual_seed(e * c + k + n)
    qx = _i8(gen, dev, (e, c, k))
    qw = torch.randint(-qmax, qmax + 1, (e, k, n), generator=gen,
                       device=dev, dtype=torch.int32).to(torch.int8)
    sx = torch.rand((e, c, 1), generator=gen, device=dev) + 1e-3
    sw = torch.rand((e, 1, n), generator=gen, device=dev) + 1e-3
    before = qmac_ops.qmac_i8_deq_bmm.launches
    got = qmac_ops.qmac_i8_deq_bmm(qx, sx, qw, sw)
    assert qmac_ops.qmac_i8_deq_bmm.launches == before + 1
    want = qmac_ops.qmac_i8_deq_bmm_plain(qx, sx, qw, sw)
    assert torch.equal(_bits(got), _bits(want))
    if e == 1:
        one = qmac_ops.qmac_i8_deq(qx[0], sx[0], qw[0], sw[0])
        assert torch.equal(_bits(got[0]), _bits(one))
    torch.cuda.synchronize()


def test_q_batched_matmul_on_the_card_equals_the_cpu(dev):
    """The int8 branch quantizes on the card as on the CPU and launches
    the batched kernel once."""
    from repro_torch.core.qmatmul import q_batched_matmul
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((16, 6, 256), generator=gen)
    x[:, 2] = 0.0                                   # empty capacity rows
    w = torch.randn((16, 256, 96), generator=gen) * 0.05
    for name in ("w8a8", "w4a8"):
        pol = tpolicy.get_policy(name)
        before = qmac_ops.qmac_i8_deq_bmm.launches
        got = q_batched_matmul(x.to(dev), w.to(dev), pol).cpu()
        assert qmac_ops.qmac_i8_deq_bmm.launches == before + 1
        assert torch.equal(_bits(got), _bits(q_batched_matmul(x, w, pol)))


def test_lm_training_on_the_card_launches_qmac(dev):
    """Two steps of reduced TinyLlama on the card: every forward product
    through ``qmac_i8`` (7 a layer and the head, a step), none through
    the fused kernels, finite losses, and the first step's loss the
    CPU's (the forwards quantize to the same codes)."""
    from repro_torch.launch.train import train

    kernels.reset_launch_counts()
    _, losses = train("tinyllama-1.1b", steps=2, seq_len=32, batch=4,
                      log_every=1, device=dev)
    counts = kernels.launch_counts()
    assert counts["qmac_i8"] == 2 * (7 * 4 + 1)
    assert counts["qmac_i8_deq"] == counts["qmac_i8_deq_bmm"] == 0
    assert len(losses) == 2 and all(torch.isfinite(torch.tensor(losses)))
    _, cpu_losses = train("tinyllama-1.1b", steps=2, seq_len=32, batch=4,
                          log_every=1, device="cpu")
    torch.testing.assert_close(losses[0], cpu_losses[0], rtol=1e-6, atol=0)
