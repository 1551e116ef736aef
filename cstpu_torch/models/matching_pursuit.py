"""Matching pursuit family: MP, OMP, GOMP and the oblivious one-shot
(PyTorch counterpart of cstpu.models.matching_pursuit).

Each solver is a Python loop over the fixed-shape active set of
cstpu_torch.ops.active_set, one instance at a time.

Semantics of cstpu that are kept:
  * OMP stalls (returns unchanged) when the argmax atom is already active.
  * epsilon stopping checks the post-update residual norm.
  * GOMP runs floor(k/l) l-atom steps plus one unconditional remainder step.
  * `oblivious` takes the k atoms most correlated with b and LS-fits them.
"""

from __future__ import annotations

import torch

from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops.select import abs_correlate, top1, topl
from cstpu_torch.utils.sparse import SparseSolution


def mp(A, b, k: int):
    """Matching pursuit: k greedy coefficient updates x[i] += <a_i, r>.

    Requires unit-norm columns. Returns a dense (m,) vector.
    """
    x = torch.zeros((A.shape[1],), dtype=A.dtype, device=A.device)
    for _ in range(int(k)):
        p = (b - A @ x) @ A
        i = torch.argmax(torch.abs(p))
        x[i] += p[i]
    return x


def omp(A, b, k: int | None = None, max_residual: float = 0.0) -> SparseSolution:
    """Orthogonal matching pursuit with LS refit of the active set.

    `k` caps the sparsity (default min(n, m)); `max_residual` is the epsilon
    stopping rule on the post-step residual norm.
    """
    n, m = A.shape
    k = int(min(k if k is not None else n, n, m))
    early_exit = float(max_residual) > 0.0
    st = aset.empty(n, k, m, A.dtype, A.device)
    r = b
    for _ in range(k):
        i, _ = top1(abs_correlate(A, r))
        present = bool(aset.contains(st, i))
        full = int(st.k) >= min(n, k)
        st = aset.refit(aset.append_gated(A, b, st, i,
                                          not present and not full))
        r = aset.residual(st, b)
        if early_exit and (present or full
                           or bool(torch.linalg.norm(r) < max_residual)):
            break
    return aset.finalize(st, m)


def _add_absent(A, b, st, indices, cap: int):
    """Append each index in `indices` unless present or at capacity `cap`;
    one refit afterwards."""
    for i in indices:
        ok = not bool(aset.contains(st, i)) and int(st.k) < cap
        st = aset.append_gated(A, b, st, i, ok)
    return aset.refit(st)


def gomp(A, b, l: int, k: int | None = None,
         max_residual: float = 0.0) -> SparseSolution:
    """Generalized OMP: add the top-l correlated atoms per iteration."""
    n, m = A.shape
    k = int(min(k if k is not None else m, m))
    l = int(l)
    cap = min(n, k)
    st = aset.empty(n, k, m, A.dtype, A.device)
    r = b
    for _ in range(k // l):
        if int(st.k) >= n:
            break
        st = _add_absent(A, b, st, topl(abs_correlate(A, r), l), cap)
        r = aset.residual(st, b)
        if bool(torch.linalg.norm(r) < max_residual):
            break
    if k % l > 0 and int(st.k) < n:   # unconditional remainder step
        r = aset.residual(st, b)
        st = _add_absent(A, b, st, topl(abs_correlate(A, r), k % l), cap)
    return aset.finalize(st, m)


def oblivious(A, b, k: int) -> SparseSolution:
    """One-shot thresholding: LS fit on the k atoms most correlated with b.
    Requires 0 < k <= min(n, m)."""
    n, m = A.shape
    if not 0 < k <= min(n, m):
        raise ValueError(f"oblivious needs 0 < k <= min(n, m) = "
                         f"{min(n, m)}, got k = {k}")
    idx = topl(torch.abs(b @ A), int(k))
    mask = torch.ones((int(k),), dtype=torch.bool, device=A.device)
    return aset.finalize(aset.refit(aset.rebuild(A, b, idx, mask)), m)
