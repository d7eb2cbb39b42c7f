"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips, with its reason, where no card is
visible (the decision is taken inside the fixture, never at import).
On the machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

The kernels are built from ``src/repro_torch/kernels/*/csrc`` at first
use.  Integer outputs must be equal and fp32 outputs bitwise equal: the
kernels keep every multiply and add separate (``--fmad=false``, ``_rn``
intrinsics), in the plain version's order.
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
