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


def solve_nan(C, X):
    """torch.linalg.solve(C, X) for a batch C (B, k, k), X (B, k) or
    (B, k, r), without its error check (which also waits for the device): a
    singular C gives a NaN solution, as jnp.linalg.solve gives inf/NaN,
    instead of an exception."""
    out, info = torch.linalg.solve_ex(C, X)
    bad = (info > 0).view(-1, *([1] * (out.ndim - 1)))
    return torch.where(bad, torch.nan, out)


def as_inputs(A, Bs):
    """The dictionary and the measurements as tensors. A tensor keeps its
    device: that is how a caller asks for the CPU. What is not a tensor
    goes where the other argument lies when that one is a tensor, else to
    the CUDA device; without one this raises instead of solving on the
    CPU unasked."""
    given = [x.device for x in (A, Bs) if isinstance(x, torch.Tensor)]
    if not given and not torch.cuda.is_available():
        raise RuntimeError(
            "cstpu_torch: the inputs are not tensors and no CUDA device is "
            "available; pass CPU tensors (torch.as_tensor(...)) to solve "
            "on the CPU")
    dev = given[0] if given else torch.device("cuda")
    return tuple(x if isinstance(x, torch.Tensor)
                 else torch.as_tensor(x, device=dev) for x in (A, Bs))


@contextlib.contextmanager
def true_f32(allow_tf32: bool = False):
    """f32 matrix products in full f32 (no TF32) inside the block, or in
    TF32 where `allow_tf32`; the caller's setting is put back afterwards.
    The backward family's deletion deltas are decisions: over ~m dependent
    steps reduced-precision products change the recovered support."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
