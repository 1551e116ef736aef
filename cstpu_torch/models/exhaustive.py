"""Exhaustive k-subset search — the brute-force oracle (PyTorch counterpart
of cstpu.models.exhaustive).

All C(m, k) candidate supports are solved as one batched problem: the
(C, n, k) stack of candidate columns goes through one batched SVD, and each
candidate's least-squares residual is computed from it with numpy's and
jnp.linalg.lstsq's rule (singular values below eps max(n, k) times the
largest are dropped). A candidate with dependent columns (a repeated atom)
then scores as its column span does, which `torch.linalg.lstsq` cannot give
on CUDA (its only routine there, gels, assumes full column rank). The stack
is cut into chunks of at most CHUNK_BYTES; ties go to the lowest candidate
index, as `jnp.argmin`'s do.
"""

from __future__ import annotations

import math
from itertools import combinations

import numpy as np
import torch

from cstpu_torch.ops.util import as_inputs, true_f32

CHUNK_BYTES = 1 << 30     # most bytes of one chunk of the (C, n, k) stack


def _residuals(cols, b):
    """||b - cols x||^2 per candidate, x the minimum-norm least-squares
    solution through the SVD of each (n, k) candidate."""
    n, k = cols.shape[-2:]
    U, s, Vh = torch.linalg.svd(cols, full_matrices=False)
    rcond = torch.finfo(cols.dtype).eps * max(n, k)
    mask = (s > 0) & (s >= rcond * s[:, :1])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)
    uTb = torch.einsum("cnk,n->ck", U, b)
    x = torch.einsum("ckj,ck->cj", Vh, s_inv * uTb)
    r = b - torch.einsum("cnk,ck->cn", cols, x)
    return torch.sum(r * r, dim=1)


def _best_subset(A, b, combos):
    """Index of the candidate support with the least LS residual."""
    n = A.shape[0]
    C, k = combos.shape
    per = max(1, CHUNK_BYTES // max(1, n * k * A.element_size()))
    mins, args = [], []
    with true_f32():
        for c0 in range(0, C, per):
            idx = combos[c0:c0 + per]
            cols = A[:, idx].permute(1, 0, 2)       # (c, n, k)
            r2 = _residuals(cols, b)
            i = torch.argmin(r2)
            mins.append(r2[i])
            args.append(c0 + i)
    # the first chunk's minimum wins a tie, as argmin's first index does
    return int(torch.stack(args)[torch.argmin(torch.stack(mins))])


def exhaustive(A, b, k: int, max_candidates: int = 500_000):
    """Return the k-subset of columns minimizing the LS residual norm,
    as a sorted index array."""
    A, b = as_inputs(A, b)
    b = torch.as_tensor(b, dtype=A.dtype, device=A.device)
    n, m = A.shape
    # validate BEFORE enumerating: list(combinations) of an oversized
    # problem consumes unbounded memory long before any guard could fire
    total = math.comb(m, int(k))
    if total > max_candidates:
        raise ValueError(f"C({m},{k}) = {total} exceeds max_candidates")
    combos = np.array(list(combinations(range(m), int(k))), dtype=np.int32)
    i = _best_subset(A, b, torch.as_tensor(combos, dtype=torch.long,
                                              device=A.device))
    return np.sort(combos[i])
