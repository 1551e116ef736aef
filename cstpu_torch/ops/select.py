"""Atom-selection (acquisition) primitives (PyTorch counterpart of
cstpu.ops.select).

Each works over the last axis, so a batch of rows (B, n) or (B, m) is
selected row by row in one call: the batched bodies of cstpu_torch.models
use these; the kernel paths select inside the select kernels of
cstpu_torch.ops.fused_solve.
"""

from __future__ import annotations

import torch

from cstpu_torch.ops.util import take


def abs_correlate(A, r):
    """|A' r| computed as |r @ A|, A consumed in its stored layout; r (n,)
    or rows (B, n)."""
    return torch.abs(r @ A)


def top1(scores):
    """(index, value) of the largest score over the last axis; first index
    wins ties, and a NaN score counts as the largest (as `jnp.argmax`)."""
    i = torch.argmax(scores, dim=-1)
    return i, take(scores, i)


def topl(scores, l: int):
    """Indices of the l largest scores, descending, ties to the lowest
    index (as `lax.top_k`). `torch.topk` promises no order among ties,
    so this rides a stable descending sort; NaN sorts first, as in
    `lax.top_k`."""
    return torch.sort(scores, descending=True, stable=True).indices[..., :l]
