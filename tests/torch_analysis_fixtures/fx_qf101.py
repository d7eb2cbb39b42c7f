"""QF101 fixture: raw contractions in a quantized data-path module."""
import torch
import torch.nn.functional as F


def bad_head(w, x):
    return torch.matmul(x, w)     # QF101 positive: raw contraction


def bad_operator(w, x):
    return x @ w                  # QF101 positive: MatMult


def bad_linear(w, x):
    return F.linear(x, w)         # QF101 positive: functional linear


def bad_int8(qw, qx):
    return torch._int_mm(qx, qw)  # QF101 positive: int8 product off Q-MAC


def good_elementwise(w, x):
    return torch.add(x, w)        # negative: not a contraction
