"""QF201 fixture: host syncs on tensors in step-reachable code."""
import torch


def bad_branch_apply(x):
    if x.sum() > 0:               # QF201 positive: tensor in `if`
        return x
    return -x


def bad_item_apply(x):
    y = torch.tanh(x)
    return y.max().item()         # QF201 positive: .item() host sync


def bad_len_apply(x):
    y = torch.tanh(x)
    return len(y)                 # QF201 positive: len() on a tensor


class _Flip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        if bool(x.any()):         # QF201 positive: Function.forward
            return x
        return -x

    @staticmethod
    def backward(ctx, g):
        return g


def compiled_body(carry):
    if carry.sum() > 0:           # QF201 positive: via torch.compile
        return carry
    return -carry


stepper = torch.compile(compiled_body)


def iteration(x):
    return _helper(x)


def _helper(x):
    y = torch.exp(x)
    return y.cpu()                # QF201 positive: reachable from a root


def good_static_apply(x, n: int):
    if x.shape[0] > n:            # negative: shape is host metadata
        return x * 2.0
    return x


def good_none_guard_apply(x, mask=None):
    if mask is None:              # negative: `is None` is a host value
        return x
    return x * mask


def table_lookup(x):
    y = torch.abs(x)
    if y.mean() > 0:              # negative: not step-reachable
        return y
    return -y
