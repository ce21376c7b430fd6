"""Adam with per-group learning rates and surgery-friendly state (port of
`gaussianavatars_tpu/train/optim.py`).

The reference's `torch.optim.Adam(..., eps=1e-15)` semantics
(scene/gaussian_model.py:222): eps is added outside the sqrt, and the bias
correction uses one step count for the optimizer. The moments are plain
tensors shaped like the parameters, in the parameters' own tree (dicts and
NamedTuples), so the densification surgery of the host loop can cut, grow
and zero them row by row; `torch.optim.Adam` is not used for that reason.
"""

from __future__ import annotations

import numpy as np
import torch

B1 = 0.9
B2 = 0.999
EPS = 1e-15


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts (sorted keys) and tuples (in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        mapped = [tree_map(fn, v) for v in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") \
            else type(tree)(mapped)
    return fn(tree)


def init(params) -> tuple:
    """(mu, nu, count): zero moments shaped like `params`, count 0."""
    return tree_map(torch.zeros_like, params), \
        tree_map(torch.zeros_like, params), 0


@torch.no_grad()
def apply(params, grads, mu, nu, count: int, lrs):
    """One Adam step, IN PLACE: the tensors of `params`, `mu` and `nu` are
    updated where they lie and returned.

    Args:
      params/grads/mu/nu: trees of one structure.
      count: the step count before this step (a Python int).
      lrs: a tree of float learning rates of the same structure.
    Returns:
      (params, mu, nu, count + 1).
    """
    count = count + 1
    # bias corrections in float32, as the JAX package computes them
    c1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count))
    for p, g, m, v, lr in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(mu), tree_leaves(nu),
                              tree_leaves(lrs)):
        m.mul_(B1).add_(g, alpha=1.0 - B1)
        v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
        p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + EPS))
    return params, mu, nu, count
