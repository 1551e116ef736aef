"""Matching pursuit family: MP, OMP, GOMP and the oblivious one-shot
(PyTorch counterpart of cstpu.models.matching_pursuit).

Batched first. Each solver is one body over measurement rows Bs (B, n) on
the batched active set of cstpu_torch.ops.active_set (`_mp_rows`,
`_omp_rows`, `_gomp_rows`, `_oblivious_rows`), with the semantics of
cstpu's `jax.vmap` of its loop: a row that stops is frozen bit for bit
while the others run on, and the loop ends when every row has stopped,
read once a step (`ops.util.stopped`). `omp(A, b)` and the other
per-instance solvers are the body on one row; the `*_batch` entry points
of cstpu_torch.models.batched call it with the whole batch. MP, OMP
without a residual stop and GOMP within its cap run a fixed trip count
and read nothing.

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
from cstpu_torch.ops.util import LOOP_COUNTS, as_inputs, stopped
from cstpu_torch.utils.sparse import SparseSolution


def row_solution(sol: SparseSolution, b: int = 0) -> SparseSolution:
    """Row b of a batched SparseSolution."""
    return SparseSolution(idx=sol.idx[b], val=sol.val[b], mask=sol.mask[b],
                          m=sol.m)


def _mp_rows(A, Bs, k: int):
    """`mp` over the rows of Bs: (B, m)."""
    B, (n, m) = Bs.shape[0], A.shape
    X = torch.zeros((B, m), dtype=A.dtype, device=A.device)
    At = A.T.expand(B, m, n)   # A x a row at a time: a row's rounding
    for _ in range(int(k)):    # does not depend on the batch
        P = (Bs - torch.bmm(X[:, None, :], At)[:, 0]) @ A
        i, p = top1(torch.abs(P))
        X.scatter_add_(1, i[:, None], P.gather(1, i[:, None]))
    return X


def mp(A, b, k: int):
    """Matching pursuit: k greedy coefficient updates x[i] += <a_i, r>.

    Requires unit-norm columns. Returns a dense (m,) vector.
    """
    A, b = as_inputs(A, b)
    return _mp_rows(A, b[None], k)[0]


def _omp_rows(A, Bs, k: int | None = None,
              max_residual: float = 0.0) -> SparseSolution:
    """`omp` over the rows of Bs: a batched SparseSolution."""
    n, m = A.shape
    k = int(min(k if k is not None else n, n, m))
    early_exit = float(max_residual) > 0.0
    st = aset.empty_batched(Bs.shape[0], n, k, m, A.dtype, A.device)
    r = Bs
    done = torch.zeros(Bs.shape[0], dtype=torch.bool, device=A.device)
    for t in range(k):
        if early_exit and t and stopped(done):
            break
        LOOP_COUNTS["steps"] += 1
        i, _ = top1(abs_correlate(A, r))
        present = aset.contains_batched(st, i)
        full = st.k >= min(n, k)
        st2 = aset.refit_batched(aset.append_gated_batched(
            A, Bs, st, i, ~present & ~full))
        r2 = aset.residual_batched(st2, Bs)
        if early_exit:
            live = ~done
            st = aset.where_rows(live, st2, st)
            r = torch.where(live[:, None], r2, r)
            done = done | present | full | (torch.linalg.norm(r2, dim=1)
                                             < max_residual)
        else:   # a stalled row's steps are exact no-ops
            st, r = st2, r2
    return aset.finalize_batched(st, m)


def omp(A, b, k: int | None = None, max_residual: float = 0.0) -> SparseSolution:
    """Orthogonal matching pursuit with LS refit of the active set.

    `k` caps the sparsity (default min(n, m)); `max_residual` is the epsilon
    stopping rule on the post-step residual norm.
    """
    A, b = as_inputs(A, b)
    return row_solution(_omp_rows(A, b[None], k, max_residual))


def _add_absent_rows(A, Bs, st, indices, cap: int):
    """Append each column of indices (B, l) to its row unless present or at
    capacity `cap`; one refit afterwards."""
    for j in range(indices.shape[1]):
        i = indices[:, j]
        ok = ~aset.contains_batched(st, i) & (st.k < cap)
        st = aset.append_gated_batched(A, Bs, st, i, ok)
    return aset.refit_batched(st)


def _gomp_rows(A, Bs, l: int, k: int | None = None,
               max_residual: float = 0.0) -> SparseSolution:
    """`gomp` over the rows of Bs. The floor(k/l) steps read the latch only
    where a row can stop before them (a residual stop, or k beyond n)."""
    n, m = A.shape
    k = int(min(k if k is not None else m, m))
    l = int(l)
    cap = min(n, k)
    early_exit = float(max_residual) > 0.0 or k > n
    st = aset.empty_batched(Bs.shape[0], n, k, m, A.dtype, A.device)
    r = Bs
    done = torch.zeros(Bs.shape[0], dtype=torch.bool, device=A.device)
    for t in range(k // l):
        if early_exit and t and stopped(done):
            break
        LOOP_COUNTS["steps"] += 1
        live = ~done & (st.k < n)
        st = aset.where_rows(live, _add_absent_rows(
            A, Bs, st, topl(abs_correlate(A, r), l), cap), st)
        r = aset.residual_batched(st, Bs)
        done = ~live | (torch.linalg.norm(r, dim=1) < max_residual)
    if k % l > 0:   # unconditional remainder step
        st = aset.where_rows(st.k < n, _add_absent_rows(
            A, Bs, st, topl(abs_correlate(A, r), k % l), cap), st)
    return aset.finalize_batched(st, m)


def gomp(A, b, l: int, k: int | None = None,
         max_residual: float = 0.0) -> SparseSolution:
    """Generalized OMP: add the top-l correlated atoms per iteration."""
    A, b = as_inputs(A, b)
    return row_solution(_gomp_rows(A, b[None], l, k, max_residual))


def _oblivious_rows(A, Bs, k: int) -> SparseSolution:
    """`oblivious` over the rows of Bs."""
    n, m = A.shape
    if not 0 < k <= min(n, m):
        raise ValueError(f"oblivious needs 0 < k <= min(n, m) = "
                         f"{min(n, m)}, got k = {k}")
    idx = topl(torch.abs(Bs @ A), int(k))
    mask = torch.ones(idx.shape, dtype=torch.bool, device=A.device)
    return aset.finalize_batched(aset.refit_batched(
        aset.rebuild_batched(A, Bs, idx, mask)), m)


def oblivious(A, b, k: int) -> SparseSolution:
    """One-shot thresholding: LS fit on the k atoms most correlated with b.
    Requires 0 < k <= min(n, m)."""
    A, b = as_inputs(A, b)
    return row_solution(_oblivious_rows(A, b[None], k))
