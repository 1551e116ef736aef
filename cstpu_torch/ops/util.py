"""Small helpers shared by all solvers (PyTorch counterpart of
cstpu.ops.util)."""

from __future__ import annotations

import torch


def masked_argmax(scores, valid):
    """(argmax, max) of `scores` restricted to `valid` slots.

    Lowest index wins ties (`torch.argmax` returns the first maximum, as
    `jnp.argmax` does); a NaN among the valid scores is the maximum.
    """
    s = torch.where(valid, scores, -torch.inf)
    i = torch.argmax(s)
    return i, s[i]


def masked_argmin(scores, valid):
    """(argmin, min) of `scores` restricted to `valid` slots."""
    s = torch.where(valid, scores, torch.inf)
    i = torch.argmin(s)
    return i, s[i]


def norm2(x):
    """Squared l2 norm."""
    return torch.sum(x * x)


def padded_to_dense(idx, val, mask, m: int):
    """Dense (..., m) tensor from a padded (idx, val, mask) support triplet;
    masked slots scatter into a dropped pad column."""
    safe = torch.where(mask, idx, m).long()
    out = torch.zeros(val.shape[:-1] + (m + 1,), dtype=val.dtype,
                      device=val.device)
    out.scatter_add_(-1, safe, torch.where(mask, val, 0))
    return out[..., :m]
