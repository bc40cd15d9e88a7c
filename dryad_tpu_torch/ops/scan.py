"""Log-step inclusive scan over pytrees of tensors — the port's
``jax.lax.associative_scan``.

``associative_scan(combine, elems)`` runs ceil(log2 n) Hillis–Steele
passes: pass d replaces element i >= d by ``combine(x[i - d], x[i])``, the
earlier operand first.  For an associative ``combine`` the result is the
inclusive scan; the order of the additions is fixed by n alone, so it is
deterministic.  Each pass is a handful of elementwise PyTorch calls over
the whole array (no Python loop over rows).

One mechanism serves every scan of the port's plain code: the
compensated prefix's plain version (``hopper_kernels.prefix_sum2_plain``),
the segmented-scan group lowering and the user-defined decomposable
aggregates (``ops/kernels.py``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

__all__ = ["associative_scan"]


def associative_scan(combine: Callable[[Any, Any], Any], elems: Any) -> Any:
    """Inclusive scan of ``elems`` (a pytree of tensors sharing their
    leading dimension n) along dim 0 under ``combine(a, b)``, which maps
    two pytrees of the same structure (``a`` the earlier rows) to one."""
    leaves, spec = pytree.tree_flatten(elems)
    if not leaves:
        return elems
    n = leaves[0].shape[0]
    d = 1
    while d < n:
        a = pytree.tree_unflatten([l[:-d] for l in leaves], spec)
        b = pytree.tree_unflatten([l[d:] for l in leaves], spec)
        c = pytree.tree_leaves(combine(a, b))
        leaves = [torch.cat([l[:d], x.to(l.dtype)]) for l, x in
                  zip(leaves, c)]
        d *= 2
    return pytree.tree_unflatten(leaves, spec)
