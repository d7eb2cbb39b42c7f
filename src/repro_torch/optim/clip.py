"""Gradient clipping and finiteness guards (port of ``repro.optim.clip``).

Leaves are taken in the reference's order (sorted dict keys), so the
global norm sums them in the same order.  Nothing here reads a value
back to the host.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in leaves))


def clip_by_global_norm(tree, max_norm: float) -> Tuple:
    """Returns (clipped_tree, pre_clip_norm)."""
    norm = global_norm(tree)
    # a tensor divides: a Python number over a tensor is a reciprocal
    # times the number in PyTorch, one ulp off the quotient
    scale = torch.clamp_max(
        torch.full_like(norm, max_norm) / torch.clamp_min(norm, 1e-12), 1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), tree), norm


def zero_nonfinite(tree):
    """Replace non-finite grads with 0 (skip-step semantics per leaf);
    returns (tree, any_nonfinite flag) so the loop can count skips."""
    flags = [torch.all(torch.isfinite(leaf)) for leaf in tree_leaves(tree)]
    ok = torch.stack(flags).all() if flags else torch.tensor(True)
    cleaned = tree_map(
        lambda g: torch.where(torch.isfinite(g), g,
                              torch.zeros((), dtype=g.dtype,
                                          device=g.device)), tree)
    return cleaned, ~ok
