"""Small helpers shared by all solvers (PyTorch counterpart of
cstpu.ops.util)."""

from __future__ import annotations

import contextlib

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


def cholesky_nan(G):
    """Lower Cholesky factor of G (..., k, k); a matrix that is not
    positive definite gives an all-NaN factor instead of an exception, as
    jnp.linalg.cholesky does, so that a batch goes on and the instance's
    NaN state reports the failure."""
    L, info = torch.linalg.cholesky_ex(G)
    return torch.where((info > 0)[..., None, None], torch.nan, L)


@contextlib.contextmanager
def true_f32():
    """f32 matrix products in full f32 (no TF32) inside the block; the
    caller's setting is put back afterwards. The backward family's deletion
    deltas are decisions: over ~m dependent steps reduced-precision
    products change the recovered support."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
