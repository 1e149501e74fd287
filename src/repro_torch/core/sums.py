"""A sum whose order is fixed by the shape of one row, not of the batch.

The genome memo needs a row's result to be independent of how many other
rows train beside it (``repro.core.trainer`` pins the same property).  A
``torch.sum`` on the card picks its reduction split from the whole
tensor's shape, so the rounding of one row's sum can change with the
population size P.  :func:`fixed_sum` adds in a pairwise tree made only of
elementwise adds along ``dim``: every element goes through the same adds
in the same order whatever the other dimensions are.
"""

from __future__ import annotations

import torch

__all__ = ["fixed_sum"]


def fixed_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum ``x`` over ``dim`` in a pairwise tree; the dimension is removed."""
    dim = dim % x.ndim
    while x.shape[dim] > 1:
        n = x.shape[dim]
        h = n // 2
        head = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
        x = torch.cat([head, x.narrow(dim, 2 * h, 1)], dim) if n % 2 else head
    return x.squeeze(dim)
