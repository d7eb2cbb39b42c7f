"""The sum tree behind prioritized replay (port of
``repro.rl.replay.sum_tree``).

One flat ``[2L]`` fp32 heap with ``L`` a power of two: node 1 is the
root, node ``i`` has children ``2i`` and ``2i + 1``, the leaves occupy
``[L, 2L)``, and node 0 is read by no query (``update`` parks duplicate
writes there).  Leaf ``j`` holds the priority mass of replay slot ``j``.

Internal sums are recomputed from the children at every refreshed node,
never moved by a delta, so ``tree[i] == tree[2i] + tree[2i+1]`` holds
bitwise after any update.  Duplicate indices in one ``update`` resolve
to the last occurrence, so the tree is the same on every device even
where a scatter to one slot twice would land in no defined order.
"""
from __future__ import annotations

import torch

from repro_torch.core.fxp import div_scalar

Tensor = torch.Tensor


def leaf_count(capacity: int) -> int:
    """Smallest power of two >= capacity (the tree's leaf width)."""
    if capacity < 1:
        raise ValueError(f"sum tree needs capacity >= 1, got {capacity}")
    return 1 << (capacity - 1).bit_length()


def depth_of(tree: Tensor) -> int:
    """Levels between a leaf and the root (log2 of the leaf width)."""
    return (tree.shape[0] // 2).bit_length() - 1


def init(capacity: int, device="cpu") -> Tensor:
    """All-zero tree for ``capacity`` slots (leaves beyond ``capacity``
    stay zero, so they carry no sampling mass)."""
    return torch.zeros(2 * leaf_count(capacity), dtype=torch.float32,
                       device=device)


def total(tree: Tensor) -> Tensor:
    """Total sampling mass (the root)."""
    return tree[1]


def get(tree: Tensor, idx: Tensor) -> Tensor:
    """Leaf values at slot indices ``idx``."""
    return tree[idx + tree.shape[0] // 2]


def update(tree: Tensor, idx: Tensor, values: Tensor) -> Tensor:
    """The tree with leaves ``idx`` ([m] slots) set to ``values`` and
    their ancestors recomputed bottom-up, written in place (the replay is
    donated, as the reference's jitted iteration donates it, so the tree
    is never copied to update a batch).  Earlier duplicates of a slot
    are redirected to node 0 with value 0 (an O(m^2) mask), so the last
    occurrence wins; every level then writes each touched parent the sum
    of its children, duplicates writing the same sum."""
    L = tree.shape[0] // 2
    m = idx.shape[0]
    idx = idx.to(torch.int64)
    if m > 1:
        pos = torch.arange(m, device=idx.device)
        last = torch.where(idx[None, :] == idx[:, None], pos[None, :],
                           -1).amax(dim=1)
        win = pos == last
        node = torch.where(win, idx + L, 0)
        values = torch.where(win, values, 0.0)
    else:
        node = idx + L
    tree[node] = values.to(tree.dtype)
    for _ in range(depth_of(tree)):
        node = node // 2
        tree[node] = tree[2 * node] + tree[2 * node + 1]
    return tree


def find(tree: Tensor, u: Tensor) -> Tensor:
    """Inverse-CDF lookup: for each prefix-sum query ``u`` in
    ``[0, total)`` the leaf slot whose interval contains it, all queries
    descending from the root in lockstep.  The branch rule is ``go right
    iff u >= left-child sum``, so a query on an interval boundary lands
    on the first leaf with mass and zero-mass leaves are unreachable
    while ``u < total``."""
    node = torch.ones(u.shape, dtype=torch.int64, device=u.device)
    u = u.to(tree.dtype)
    for _ in range(depth_of(tree)):
        left = tree[2 * node]
        go_right = u >= left
        node = 2 * node + go_right.to(torch.int64)
        u = torch.where(go_right, u - left, u)
    return node - tree.shape[0] // 2


def stratified_sample(tree: Tensor, uniforms: Tensor):
    """Draw ``n = len(uniforms)`` slots in proportion to their leaf mass,
    stratified: query ``i`` is ``(i + uniforms[i]) / n * total``, so
    every 1/n-quantile of the mass is hit once.  Returns ``(idx [n],
    mass [n])``, ``mass`` the unnormalized leaf value."""
    n = uniforms.shape[0]
    t = total(tree)
    u = torch.arange(n, dtype=torch.float32, device=tree.device) \
        + uniforms.to(device=tree.device, dtype=torch.float32)
    u = div_scalar(u, float(n)) * t
    # float guard: u == total would walk off the right edge
    u = torch.minimum(u, t * (1.0 - 1e-7))
    idx = find(tree, u)
    return idx, get(tree, idx)
