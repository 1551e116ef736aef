"""Backward elimination: BR, fast BR (Gram-inverse downdates) and LACE
(PyTorch counterpart of cstpu.models.backward).

All start from the full least-squares solution (A must have full column
rank, m <= n) and greedily delete atoms, one instance at a time:

  * BR drops the atom whose removal increases the squared residual norm
    least, delta_i^2 = coef_i^2 / gamma_i with gamma = diag((A_i'A_i)^-1),
    or, with `naive`, by re-solving each leave-one-out problem.
  * FBR tracks (A'A)^-1 explicitly with rank-one Schur-complement
    downdates; numerically less robust, so a per-instance `failed` flag
    reports a state that went indefinite or NaN, and the returned
    coefficients come from an exact refit on the surviving support.
  * LACE deletes the minimum-|coefficient| atom when the refit after the
    deletion passes the accept test.

The batched FBR and LACE run on the deletion kernels of
cstpu_torch.ops.fused_backward. No product here runs in TF32: the f32
paths pin `torch.backends.cuda.matmul.allow_tf32` off for their duration
(`ops.util.true_f32`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops.util import (
    cholesky_nan, masked_argmin, norm2, true_f32)
from cstpu_torch.utils.sparse import SparseSolution


def backward_deltas(b, st, m: int, naive: bool = False):
    """Squared residual-norm increase for deleting each active slot (inf
    on the inactive ones), from the cached state alone."""
    if not naive:
        return torch.where(st.mask, st.coef * st.coef / aset.gamma(st),
                           torch.inf)
    base = norm2(aset.residual(st, b))
    d2 = torch.full_like(st.coef, torch.inf)
    for p in torch.nonzero(st.mask)[:, 0].tolist():
        cand = aset.refit(aset.delete(st, p, m))
        d2[p] = norm2(aset.residual(cand, b)) - base
    return d2


def backward_step(A, b, st, max_eps, max_delta, m: int, naive: bool = False):
    """One backward step; returns (state, accepted).

    Deletes the least-increase atom iff an atom is active, the residual
    norm after the deletion stays below `max_eps`, and the increase is
    below `max_delta^2`; otherwise returns the state unchanged. The same
    routine serves BR and the backward stages of SRR, RMP and FoBa.
    """
    normr2 = norm2(aset.residual(st, b))
    pos, mind2 = masked_argmin(backward_deltas(b, st, m, naive), st.mask)
    new_norm = torch.sqrt(torch.clamp(mind2 + normr2, min=0))
    accept = bool((st.k > 0) & (new_norm < max_eps)
                  & (mind2 < max_delta * max_delta))
    if not accept:
        return st, False
    return aset.refit(aset.delete(st, int(pos), m)), True


def _full_state(A, b):
    """The full least-squares state: every atom active, refit."""
    m = A.shape[1]
    return aset.refit(aset.rebuild(
        A, b, torch.arange(m, dtype=torch.int32, device=A.device),
        torch.ones((m,), dtype=torch.bool, device=A.device)))


def _delete_loop(A, b, k: int, step):
    """Up to m - k calls of step(state) -> (state, accepted), from the full
    LS state, stopping at the first rejection."""
    m = A.shape[1]
    with true_f32():
        st = _full_state(A, b)
        for _ in range(m - k):
            st, accepted = step(st)
            if not accepted:
                break
        return aset.finalize(st, m)


def br(A, b, max_residual: float = math.inf, max_increase: float = math.inf,
       sparsity: int = 0, naive: bool = False) -> SparseSolution:
    """Backward regression from the full LS solution: delete the
    least-increase atom while more than `sparsity` are active, the residual
    norm stays below `max_residual` and the increase below
    `max_increase^2`. `naive` re-solves the leave-one-out problems."""
    n, m = A.shape
    if m > n:
        raise ValueError(f"backward regression needs m <= n, got ({n}, {m})")
    return _delete_loop(A, b, int(sparsity), lambda st: backward_step(
        A, b, st, max_residual, max_increase, m, naive=bool(naive)))


# ---------------------------------------------------------------------------
# Fast backward regression: explicit (A'A)^-1 with Schur downdates
# ---------------------------------------------------------------------------

class FBRState(NamedTuple):
    idx: torch.Tensor     # i32[kmax]
    mask: torch.Tensor    # bool[kmax]
    k: torch.Tensor       # i32[]
    cols: torch.Tensor    # f[n, kmax]
    AAinv: torch.Tensor   # f[kmax, kmax], (A_i'A_i)^-1, identity-padded
    Ab: torch.Tensor      # f[kmax]
    coef: torch.Tensor    # f[kmax]
    failed: torch.Tensor  # bool[] numerical-instability flag


def _fbr_init(A, b) -> FBRState:
    m = A.shape[1]
    dev = A.device
    # a rank-deficient Gram gives a NaN state (and so the failed flag), not
    # an exception
    L = cholesky_nan(A.T @ A)
    AAinv = torch.cholesky_solve(torch.eye(m, dtype=A.dtype, device=dev), L)
    Ab = b @ A
    return FBRState(
        idx=torch.arange(m, dtype=torch.int32, device=dev),
        mask=torch.ones((m,), dtype=torch.bool, device=dev),
        k=torch.tensor(m, dtype=torch.int32, device=dev),
        cols=A, AAinv=AAinv, Ab=Ab, coef=AAinv @ Ab,
        failed=torch.zeros((), dtype=torch.bool, device=dev))


def _fbr_delete(st: FBRState, pos, m: int) -> FBRState:
    """Schur-complement downdate of (A'A)^-1, then left-compaction."""
    kmax = st.idx.shape[0]
    dev = st.idx.device
    g = st.AAinv[pos, :]
    AA = st.AAinv - torch.outer(g, g) / st.AAinv[pos, pos]
    ar = torch.arange(kmax, device=dev)
    src = torch.clamp(torch.where(ar >= pos, ar + 1, ar), max=kmax - 1)
    newmask = ar < (st.k - 1)
    AA = torch.where(newmask[:, None] & newmask[None, :], AA[src][:, src],
                     torch.eye(kmax, dtype=AA.dtype, device=dev))
    Ab = torch.where(newmask, st.Ab[src], 0)
    return FBRState(
        idx=torch.where(newmask, st.idx[src], m).to(torch.int32),
        mask=newmask, k=st.k - 1,
        cols=torch.where(newmask[None, :], st.cols[:, src], 0),
        AAinv=AA, Ab=Ab, coef=torch.where(newmask, AA @ Ab, 0),
        failed=st.failed)


def _fbr(A, b, k: int, max_eps, max_delta):
    m = A.shape[1]
    with true_f32():
        st = _fbr_init(A, b)
        for _ in range(m - k):
            normr2 = norm2(b - st.cols @ st.coef)
            d2 = torch.where(st.mask, st.coef * st.coef
                             / torch.diagonal(st.AAinv), torch.inf)
            pos, mind2 = masked_argmin(d2, st.mask)
            # a negated >= : a NaN state (rank-deficient Gram, NaN Cholesky
            # init) latches the failure flag instead of comparing False
            fail = ~((mind2 + normr2) >= 0)
            new_norm = torch.sqrt(torch.clamp(mind2 + normr2, min=0))
            accept = bool((st.k > 0) & ~fail & (new_norm < max_eps)
                          & (mind2 < max_delta * max_delta))
            failed = st.failed | fail
            if accept:
                st = _fbr_delete(st, int(pos), m)
            st = st._replace(failed=failed)
            if not accept:
                break
        # exact final refit on the surviving support: the Schur downdates
        # leave coefficient drift, so the returned values come from a fresh
        # masked normal-equation solve while the deletion decisions rode
        # the maintained inverse. A failed state keeps its drifted values:
        # the flag is the contract there.
        Gf = st.cols.T @ st.cols + torch.diag((~st.mask).to(A.dtype))
        Lf = cholesky_nan(Gf)
        exact = torch.cholesky_solve(
            torch.where(st.mask, st.Ab, 0)[:, None], Lf)[:, 0]
        exact = torch.where(st.mask, exact, 0)
        st = st._replace(coef=torch.where(st.failed, st.coef, exact))
    # FBRState carries the fields finalize reads (idx, mask, coef)
    return aset.finalize(st, m), st.failed


def fbr(A, b, max_residual: float = math.inf, max_increase: float = math.inf,
        sparsity: int = 0, return_failed: bool = False):
    """Fast backward regression on a cached Gram inverse. With
    `return_failed=True` also returns the numerical-instability flag."""
    n, m = A.shape
    if m > n:
        raise ValueError(
            f"fast backward regression needs m <= n, got ({n}, {m})")
    sol, failed = _fbr(A, b, int(sparsity), max_residual, max_increase)
    return (sol, failed) if return_failed else sol


# ---------------------------------------------------------------------------
# LACE
# ---------------------------------------------------------------------------

def lace_step(A, b, st, max_eps, max_delta, m: int):
    """Delete the min-|coefficient| atom if the refit after the deletion
    passes the accept test; returns (state, accepted)."""
    normr2_old = norm2(aset.residual(st, b))
    pos, _ = masked_argmin(torch.abs(st.coef), st.mask)
    cand = aset.refit(aset.delete(st, int(pos), m))
    normr2_new = norm2(aset.residual(cand, b))
    accept = bool((st.k > 0) & (torch.sqrt(normr2_new) < max_eps)
                  & (normr2_new - normr2_old < max_delta * max_delta))
    return (cand, True) if accept else (st, False)


def lace(A, b, max_residual: float = math.inf,
         max_increase: float = math.inf, sparsity: int = 0) -> SparseSolution:
    """Least absolute coefficient elimination (A must be overdetermined)."""
    n, m = A.shape
    if n < m:
        raise ValueError(f"A must be overdetermined but is ({n}, {m})")
    return _delete_loop(A, b, int(sparsity), lambda st: lace_step(
        A, b, st, max_residual, max_increase, m))
