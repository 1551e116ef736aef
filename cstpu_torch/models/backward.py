"""Backward elimination: BR, fast BR (Gram-inverse downdates) and LACE
(PyTorch counterpart of cstpu.models.backward).

All start from the full least-squares solution (A must have full column
rank, m <= n) and greedily delete atoms:

  * BR drops the atom whose removal increases the squared residual norm
    least, delta_i^2 = coef_i^2 / gamma_i with gamma = diag((A_i'A_i)^-1),
    or, with `naive`, by re-solving each leave-one-out problem.
  * FBR tracks (A'A)^-1 explicitly with rank-one Schur-complement
    downdates; numerically less robust, so a per-row `failed` flag
    reports a state that went indefinite or NaN, and the returned
    coefficients come from an exact refit on the surviving support.
  * LACE deletes the minimum-|coefficient| atom when the refit after the
    deletion passes the accept test.

Batched first: `_br_rows`, `_fbr_rows` and `_lace_rows` run every row of
Bs (B, n) in one body, each row stopping at its own first rejection and
frozen after it, the loop ending when every row has stopped (one latch
read a step, `ops.util.stopped`), as cstpu's vmapped while loop; the
per-instance solvers are the bodies on one row. `backward_step_rows` is
the step SRR, RMP and FoBa share; `backward_step`, `backward_deltas` and
`lace_step` are the per-instance forms. The batched FBR and LACE on the
card run on the deletion kernels of cstpu_torch.ops.fused_backward. No
product here runs in TF32: the f32 paths pin
`torch.backends.cuda.matmul.allow_tf32` off for their duration
(`ops.util.true_f32`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cstpu_torch.models.matching_pursuit import row_solution
from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops.util import (
    LOOP_COUNTS, as_inputs, cholesky_nan, masked_argmin, norm2, stopped,
    true_f32)
from cstpu_torch.utils.sparse import SparseSolution


def backward_deltas_rows(Bs, st, m: int, naive: bool = False,
                         slots: int | None = None):
    """(B, kmax): every row's squared residual-norm increase for deleting
    each active slot (inf on the inactive ones), from the cached state
    alone; with `naive` by re-solving each leave-one-out problem, one for
    each of the first `slots` slots (default kmax; a caller that knows
    that every row it needs holds at most s atoms passes s)."""
    kmax = st.idx.shape[1]
    if not naive:
        return torch.where(st.mask, st.coef * st.coef
                           / aset.gamma_batched(st), torch.inf)
    base = norm2(aset.residual_batched(st, Bs))
    d2 = torch.full(st.coef.shape, torch.inf, dtype=st.coef.dtype,
                    device=st.coef.device)
    for p in range(kmax if slots is None else min(slots, kmax)):
        cand = aset.refit_batched(aset.delete_batched(
            st, torch.full_like(st.k, p), m))
        d2[:, p] = norm2(aset.residual_batched(cand, Bs)) - base
    return torch.where(st.mask, d2, torch.inf)


def backward_deltas(b, st, m: int, naive: bool = False):
    """`backward_deltas_rows` for one instance: (kmax,)."""
    b = as_inputs(b, st.coef)[0]
    return backward_deltas_rows(b[None], aset.one_row(st), m, naive)[0]


def _backward_cand_rows(Bs, st, max_eps, max_delta, m: int,
                        naive: bool = False, slots: int | None = None):
    """(every row's refit state after deleting its least-increase atom,
    accepted (B,)): the deletion whether or not the row accepts it."""
    normr2 = norm2(aset.residual_batched(st, Bs))
    pos, mind2 = masked_argmin(
        backward_deltas_rows(Bs, st, m, naive, slots), st.mask)
    new_norm = torch.sqrt(torch.clamp(mind2 + normr2, min=0))
    accept = ((st.k > 0) & (new_norm < max_eps)
              & (mind2 < max_delta * max_delta))
    return aset.refit_batched(aset.delete_batched(st, pos, m)), accept


def backward_step_rows(A, Bs, st, max_eps, max_delta, m: int,
                       naive: bool = False):
    """One backward step of every row; returns (state, accepted (B,)).

    Row b deletes its least-increase atom iff an atom is active, the
    residual norm after the deletion stays below `max_eps`, and the
    increase is below `max_delta^2` (numbers, or one a row); otherwise
    it keeps its state. The same routine serves BR and the backward
    stages of SRR, RMP and FoBa.
    """
    st2, accept = _backward_cand_rows(Bs, st, max_eps, max_delta, m, naive)
    return aset.where_rows(accept, st2, st), accept


def backward_step(A, b, st, max_eps, max_delta, m: int, naive: bool = False):
    """`backward_step_rows` for one instance: (state, accepted); a
    rejected step returns the state it was given."""
    A, b = as_inputs(A, b, st.coef)[:2]
    st2, accept = backward_step_rows(A, b[None], aset.one_row(st), max_eps,
                                     max_delta, m, naive)
    return (aset.row_of(st2), True) if bool(accept[0]) else (st, False)


def _full_state_rows(A, Bs):
    """Every row's full least-squares state: every atom active, refit."""
    B, m = Bs.shape[0], A.shape[1]
    idx = torch.arange(m, dtype=torch.int32, device=A.device).expand(B, m)
    return aset.refit_batched(aset.rebuild_batched(
        A, Bs, idx, torch.ones((B, m), dtype=torch.bool, device=A.device)))


def _delete_rows(A, Bs, k: int, cand):
    """Up to m - k deletions of every row from its full LS state, each row
    stopping at its first rejection and frozen after it (one `where_rows`
    a step); the loop ends when every row has stopped, read once a step
    from the second on. cand(state, slots) -> (every row's state after its
    deletion, accepted): slots = m - t, the atoms that every row still
    deleting at step t holds."""
    m = A.shape[1]
    with true_f32():
        st = _full_state_rows(A, Bs)
        stop = torch.zeros(Bs.shape[0], dtype=torch.bool, device=A.device)
        for t in range(m - k):
            if t and stopped(stop):
                break
            LOOP_COUNTS["steps"] += 1
            st2, acc = cand(st, m - t)
            acc = acc & ~stop
            st = aset.where_rows(acc, st2, st)
            stop = stop | ~acc
        return aset.finalize_batched(st, m)


def _br_rows(A, Bs, max_residual: float = math.inf,
             max_increase: float = math.inf, sparsity: int = 0,
             naive: bool = False) -> SparseSolution:
    """`br` over the rows of Bs: a batched SparseSolution."""
    n, m = A.shape
    if m > n:
        raise ValueError(f"backward regression needs m <= n, got ({n}, {m})")
    return _delete_rows(A, Bs, int(sparsity), lambda st, s: (
        _backward_cand_rows(Bs, st, max_residual, max_increase, m,
                            naive=bool(naive), slots=s)))


def br(A, b, max_residual: float = math.inf, max_increase: float = math.inf,
       sparsity: int = 0, naive: bool = False) -> SparseSolution:
    """Backward regression from the full LS solution: delete the
    least-increase atom while more than `sparsity` are active, the residual
    norm stays below `max_residual` and the increase below
    `max_increase^2`. `naive` re-solves the leave-one-out problems."""
    A, b = as_inputs(A, b)
    return row_solution(_br_rows(A, b[None], max_residual, max_increase,
                                 sparsity, naive))


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


def _fbr_init_rows(A, Bs) -> FBRState:
    """Every row's full state, with a leading batch axis on each field; the
    Gram inverse is factorized once for the batch."""
    B, m = Bs.shape[0], A.shape[1]
    dev = A.device
    # a rank-deficient Gram gives a NaN state (and so the failed flag), not
    # an exception
    L = cholesky_nan(A.T @ A)
    AAinv = torch.cholesky_solve(torch.eye(m, dtype=A.dtype, device=dev), L)
    cols, AAinv = A.expand(B, *A.shape), AAinv.expand(B, m, m)
    Ab = aset.vm_rows(Bs, cols)
    return FBRState(
        idx=torch.arange(m, dtype=torch.int32, device=dev).expand(B, m),
        mask=torch.ones((B, m), dtype=torch.bool, device=dev),
        k=torch.full((B,), m, dtype=torch.int32, device=dev),
        cols=cols, AAinv=AAinv, Ab=Ab, coef=aset.mv_rows(AAinv, Ab),
        failed=torch.zeros((B,), dtype=torch.bool, device=dev))


def _fbr_init(A, b) -> FBRState:
    """One instance's full state."""
    return aset.row_of(_fbr_init_rows(A, b[None]))


def _fbr_delete_rows(st: FBRState, pos, m: int) -> FBRState:
    """Every row's Schur-complement downdate of (A'A)^-1 at its slot
    pos[b], then left-compaction."""
    B, n, kmax = st.cols.shape
    dev = st.idx.device
    g = st.AAinv.gather(1, pos.view(B, 1, 1).expand(B, 1, kmax))[:, 0]
    gp = g.gather(1, pos.view(B, 1))
    AA = st.AAinv - g[:, :, None] * g[:, None, :] / gp[:, :, None]
    ar = torch.arange(kmax, device=dev).expand(B, kmax)
    src = torch.clamp(torch.where(ar >= pos[:, None], ar + 1, ar),
                      max=kmax - 1)
    newmask = ar < (st.k - 1)[:, None]
    AA = AA.gather(1, src[:, :, None].expand(B, kmax, kmax))
    AA = AA.gather(2, src[:, None, :].expand(B, kmax, kmax))
    AA = torch.where(newmask[:, :, None] & newmask[:, None, :], AA,
                     torch.eye(kmax, dtype=AA.dtype, device=dev))
    Ab = torch.where(newmask, st.Ab.gather(1, src), 0)
    return FBRState(
        idx=torch.where(newmask, st.idx.gather(1, src), m).to(torch.int32),
        mask=newmask, k=st.k - 1,
        cols=torch.where(newmask[:, None, :], st.cols.gather(
            2, src[:, None, :].expand(B, n, kmax)), 0),
        AAinv=AA, Ab=Ab,
        coef=torch.where(newmask, aset.mv_rows(AA, Ab), 0),
        failed=st.failed)


def _fbr_delete(st: FBRState, pos, m: int) -> FBRState:
    """One instance's downdate at slot pos."""
    pos = torch.as_tensor(pos, device=st.idx.device).view(1)
    return aset.row_of(_fbr_delete_rows(aset.one_row(st), pos, m))


def _fbr_rows(A, Bs, max_residual: float = math.inf,
              max_increase: float = math.inf, sparsity: int = 0):
    """`fbr` over the rows of Bs: (batched SparseSolution, failed (B,))."""
    n, m = A.shape
    if m > n:
        raise ValueError(
            f"fast backward regression needs m <= n, got ({n}, {m})")
    max_eps, max_delta = max_residual, max_increase
    with true_f32():
        st = _fbr_init_rows(A, Bs)
        done = torch.zeros(Bs.shape[0], dtype=torch.bool, device=A.device)
        for t in range(m - int(sparsity)):
            if t and stopped(done):
                break
            LOOP_COUNTS["steps"] += 1
            normr2 = norm2(Bs - aset.mv_rows(st.cols, st.coef))
            d2 = torch.where(st.mask, st.coef * st.coef / torch.diagonal(
                st.AAinv, dim1=1, dim2=2), torch.inf)
            pos, mind2 = masked_argmin(d2, st.mask)
            # a negated >= : a NaN state (rank-deficient Gram, NaN Cholesky
            # init) latches the failure flag instead of comparing False
            fail = ~((mind2 + normr2) >= 0)
            new_norm = torch.sqrt(torch.clamp(mind2 + normr2, min=0))
            accept = ((st.k > 0) & ~fail & (new_norm < max_eps)
                      & (mind2 < max_delta * max_delta))
            live = ~done
            st2 = aset.where_rows(accept & live, _fbr_delete_rows(st, pos, m),
                                  st)
            st = st2._replace(failed=st.failed | (fail & live))
            done = done | ~accept
        # exact final refit on the surviving support: the Schur downdates
        # leave coefficient drift, so the returned values come from a fresh
        # masked normal-equation solve while the deletion decisions rode
        # the maintained inverse. A failed state keeps its drifted values:
        # the flag is the contract there.
        Gf = (st.cols.transpose(1, 2) @ st.cols
              + torch.diag_embed((~st.mask).to(A.dtype)))
        Lf = cholesky_nan(Gf)
        exact = torch.cholesky_solve(
            torch.where(st.mask, st.Ab, 0)[:, :, None], Lf)[:, :, 0]
        exact = torch.where(st.mask, exact, 0)
        st = st._replace(coef=torch.where(st.failed[:, None], st.coef,
                                          exact))
    # FBRState carries the fields finalize reads (idx, mask, coef)
    return aset.finalize_batched(st, m), st.failed


def fbr(A, b, max_residual: float = math.inf, max_increase: float = math.inf,
        sparsity: int = 0, return_failed: bool = False):
    """Fast backward regression on a cached Gram inverse. With
    `return_failed=True` also returns the numerical-instability flag."""
    A, b = as_inputs(A, b)
    sol, failed = _fbr_rows(A, b[None], max_residual, max_increase,
                            sparsity)
    sol, failed = row_solution(sol), failed[0]
    return (sol, failed) if return_failed else sol


# ---------------------------------------------------------------------------
# LACE
# ---------------------------------------------------------------------------

def _lace_cand_rows(Bs, st, max_eps, max_delta, m: int):
    """(every row's refit state after deleting its min-|coefficient| atom,
    accepted (B,)): the deletion whether or not the row accepts it."""
    normr2_old = norm2(aset.residual_batched(st, Bs))
    pos, _ = masked_argmin(torch.abs(st.coef), st.mask)
    cand = aset.refit_batched(aset.delete_batched(st, pos, m))
    normr2_new = norm2(aset.residual_batched(cand, Bs))
    accept = ((st.k > 0) & (torch.sqrt(normr2_new) < max_eps)
              & (normr2_new - normr2_old < max_delta * max_delta))
    return cand, accept


def lace_step_rows(A, Bs, st, max_eps, max_delta, m: int):
    """Every row deletes its min-|coefficient| atom if the refit after the
    deletion passes the accept test; returns (state, accepted (B,))."""
    cand, accept = _lace_cand_rows(Bs, st, max_eps, max_delta, m)
    return aset.where_rows(accept, cand, st), accept


def lace_step(A, b, st, max_eps, max_delta, m: int):
    """`lace_step_rows` for one instance: (state, accepted); a rejected
    step returns the state it was given."""
    A, b = as_inputs(A, b, st.coef)[:2]
    st2, accept = lace_step_rows(A, b[None], aset.one_row(st), max_eps,
                                 max_delta, m)
    return (aset.row_of(st2), True) if bool(accept[0]) else (st, False)


def _lace_rows(A, Bs, max_residual: float = math.inf,
               max_increase: float = math.inf,
               sparsity: int = 0) -> SparseSolution:
    """`lace` over the rows of Bs: a batched SparseSolution."""
    n, m = A.shape
    if n < m:
        raise ValueError(f"A must be overdetermined but is ({n}, {m})")
    return _delete_rows(A, Bs, int(sparsity), lambda st, s: _lace_cand_rows(
        Bs, st, max_residual, max_increase, m))


def lace(A, b, max_residual: float = math.inf,
         max_increase: float = math.inf, sparsity: int = 0) -> SparseSolution:
    """Least absolute coefficient elimination (A must be overdetermined)."""
    A, b = as_inputs(A, b)
    return row_solution(_lace_rows(A, b[None], max_residual, max_increase,
                                   sparsity))
