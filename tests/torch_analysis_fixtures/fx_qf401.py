"""QF401 fixture: step code threading state through a whole copy."""
import torch


@torch.compile
def bad_update(params, buf):
    buf = buf.clone()
    buf[0] = params["w"].sum()
    return params, buf            # QF401 positive: a whole copy of buf


@torch.compile
def bad_moments(grads, opt):
    opt = {k: v.clone() for k, v in opt.items()}
    return grads, opt             # QF401 positive: a dict of clones


@torch.compile
def good_update(params, buf):
    buf[0] = params["w"].sum()
    return params, buf            # negative: written in place


def host_snapshot(buf):
    buf = buf.clone()
    return buf                    # negative: not step-reachable
