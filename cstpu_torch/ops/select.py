"""Atom-selection (acquisition) primitives (PyTorch counterpart of
cstpu.ops.select).

The per-instance solvers in cstpu_torch.models use these; the batched OMP
path selects inside the select kernel of cstpu_torch.ops.fused_solve.
"""

from __future__ import annotations

import torch


def abs_correlate(A, r):
    """|A' r| computed as |r @ A|, A consumed in its stored layout."""
    return torch.abs(r @ A)


def top1(scores):
    """(index, value) of the largest score; first index wins ties, and a
    NaN score counts as the largest (as `jnp.argmax`)."""
    i = torch.argmax(scores)
    return i, scores[i]


def topl(scores, l: int):
    """Indices of the l largest scores, descending, ties to the lowest
    index (as `lax.top_k`). `torch.topk` promises no order among ties,
    so this rides a stable descending sort; NaN sorts first, as in
    `lax.top_k`."""
    return torch.sort(scores, descending=True, stable=True).indices[..., :l]
