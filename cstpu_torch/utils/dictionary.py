"""Dictionary analysis and preconditioning (PyTorch counterpart of
cstpu.utils.dictionary): coherence, the Babel function and its cumulative
form, column normalization, the mean-centering preconditioner (Bruckstein
2008) and the SVD whitening preconditioner.

The Babel function is one symmetric product |A'A|, a per-row top-k and a
cumulative sum, as in cstpu.
"""

from __future__ import annotations

import torch

from cstpu_torch.ops.util import as_inputs


def colnorms(A):
    """l2 norm of every column of A."""
    (A,) = as_inputs(A)
    return torch.sqrt(torch.sum(A * A, dim=0))


def normalize_columns(A):
    """Return A with unit-l2-norm columns."""
    (A,) = as_inputs(A)
    return A / colnorms(A)[None, :]


def cumbabel(A, k: int):
    """All Babel function values mu_1(1..k) of dictionary A.

    mu_1(j) = max_i max_{|Lambda|=j, i not in Lambda} sum_{l in Lambda}
    |<a_i, a_l>| (Tropp, "Greed is Good").
    """
    (A,) = as_inputs(A)
    G = torch.abs(A.T @ A)
    m = G.shape[0]
    G = G * (1.0 - torch.eye(m, dtype=G.dtype, device=G.device))
    top = torch.topk(G, k, dim=1).values       # per-row k largest, descending
    return torch.amax(torch.cumsum(top, dim=1), dim=0)


def babel(A, k: int):
    """Babel function mu_1(k)."""
    return cumbabel(A, k)[k - 1]


def coherence(A):
    """Mutual coherence = mu_1(1)."""
    return babel(A, 1)


def mean_preconditioner(eps: float):
    """Mean-centering preconditioner y = x - (1-eps) * mean(x, axis=0).

    Returns a function usable on the dictionary and on measurement
    vectors or matrices alike.
    """
    def apply(x):
        (x,) = as_inputs(x)
        if x.ndim == 1:
            mu = torch.mean(x)
        else:
            mu = torch.mean(x, dim=0, keepdim=True)
        return x - (1.0 - eps) * mu
    return apply


def svd_preconditioner(A, min_sigma: float = 1e-6):
    """SVD whitening preconditioner P = U diag(1/max(S, min_sigma)) U'.

    Applying it to the dictionary (and the measurements) flattens the
    spectrum, which helps greedy selection on coherent dictionaries.
    """
    (A,) = as_inputs(A)
    U, S, _ = torch.linalg.svd(A, full_matrices=False)
    Sinv = 1.0 / torch.clamp(S, min=min_sigma)

    def apply(x):
        x = torch.as_tensor(x, device=U.device)
        if x.ndim == 1:
            return U @ (Sinv * (U.T @ x))
        return U @ (Sinv[:, None] * (U.T @ x))
    return apply


def precondition(A, min_sigma: float = 1e-6):
    """Return the SVD-whitened dictionary P @ A."""
    return svd_preconditioner(A, min_sigma)(A)
