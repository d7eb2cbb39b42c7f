"""Gradient clipping and finiteness guards (port of ``repro.optim.clip``).

Leaves are taken in the reference's order (sorted dict keys), so the
global norm sums them in the same order.  Nothing here reads a value
back to the host.

On a laid-out step each rank holds its blocks of the gradient
(``mesh``, and ``split``: the mesh axes each leaf is split over, in
leaf order): a leaf's sum of squares is its blocks' summed over those
axes in rank order (a leaf whole on the rank counted once), and the
non-finite flag is any rank's.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import axes_size, mesh_shape, pmax, psum
from repro_torch.tree import tree_leaves, tree_map


def global_norm(tree, mesh=None,
                split: Optional[Sequence[Tuple[str, ...]]] = None
                ) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(
            leaf.to(torch.float32))) for leaf in leaves))
    sums = [torch.sum(torch.square(leaf.to(torch.float32)))
            for leaf in leaves]
    # one sum over the peers for the leaves of each set of axes
    by_axes = {}
    for i, axes in enumerate(split):
        if axes_size(mesh, axes) > 1:
            by_axes.setdefault(tuple(axes), []).append(i)
    for axes, idx in by_axes.items():
        total = psum(torch.stack([sums[i] for i in idx]), mesh, axes)
        for j, i in enumerate(idx):
            sums[i] = total[j]
    return torch.sqrt(sum(sums))


def clip_by_global_norm(tree, max_norm: float, mesh=None,
                        split=None) -> Tuple:
    """Returns (clipped_tree, pre_clip_norm)."""
    norm = global_norm(tree, mesh, split)
    # a tensor divides: a Python number over a tensor is a reciprocal
    # times the number in PyTorch, one ulp off the quotient
    scale = torch.clamp_max(
        torch.full_like(norm, max_norm) / torch.clamp_min(norm, 1e-12), 1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), tree), norm


def zero_nonfinite(tree, mesh=None):
    """Replace non-finite grads with 0 (skip-step semantics per leaf);
    returns (tree, any_nonfinite flag) so the loop can count skips (on a
    ``mesh``, any rank's)."""
    flags = [torch.all(torch.isfinite(leaf)) for leaf in tree_leaves(tree)]
    ok = torch.stack(flags).all() if flags else torch.tensor(True)
    if mesh is not None and mesh_shape(mesh).size > 1:
        ok = pmax((~ok).to(torch.int32), mesh,
                  mesh_shape(mesh).axis_names) == 0
    cleaned = tree_map(
        lambda g: torch.where(torch.isfinite(g), g,
                              torch.zeros((), dtype=g.dtype,
                                          device=g.device)), tree)
    return cleaned, ~ok
