"""Two-stage / replacement algorithms: subspace pursuit, OMP with
replacement and stepwise regression with replacement (PyTorch counterpart
of cstpu.models.twostage).

Thin drivers over the batched active-set engine and the forward and
backward steps: expand the support, refit, prune, iterate until the
residual stops improving. Batched first: `_sp_rows`, `_ompr_rows` and
`_srr_rows` run every row of Bs (B, n) in one body, a row that stops
frozen while the others run on and the loop ending when every row has
stopped (one latch read a step, `ops.util.stopped`), as cstpu's vmapped
while loop; the per-instance solvers are the bodies on one row. SRR's
inner loops (up to l forward steps, then deletions back to k, at most l)
run l times with a stop flag a row and read nothing. The batched paths
on the card run on the kernels of cstpu_torch.ops.fused_twostage.
"""

from __future__ import annotations

import torch

from cstpu_torch.models.backward import backward_step_rows
from cstpu_torch.models.forward import forward_deltas_rows, forward_step_rows
from cstpu_torch.models.matching_pursuit import _add_absent_rows, row_solution
from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops.select import abs_correlate, top1, topl
from cstpu_torch.ops.util import (LOOP_COUNTS, as_inputs, masked_argmax,
                                  masked_argmin, padded_to_dense, stopped)
from cstpu_torch.utils.sparse import SparseSolution


def _support_state(A, Bs, idx, kmax: int):
    """The supports idx (B, k), LS-fitted, in capacity-kmax states."""
    B, k = idx.shape
    pad = torch.full((B, kmax - k), A.shape[1], dtype=torch.int32,
                     device=A.device)
    mask = (torch.arange(kmax, device=A.device) < k).expand(B, kmax)
    return aset.refit_batched(aset.rebuild_batched(
        A, Bs, torch.cat([idx.to(torch.int32), pad], dim=1), mask))


def _oblivious_state(A, Bs, k: int, kmax: int):
    """Every row's k atoms most correlated with it, LS-fitted, in a
    capacity-kmax state (the reference's `oblivious_acquisition!`)."""
    return _support_state(A, Bs, topl(torch.abs(Bs @ A), k), kmax)


def _resnorm(st, Bs):
    return torch.linalg.norm(aset.residual_batched(st, Bs), dim=1)


def _improve_loop(Bs, st, maxiter: int, delta, step):
    """The outer loop the three share: `step(state)` -> (state, bail (B,)),
    kept on the rows still running, until the residual norm is <= delta or
    stops improving, or `step` bails out, at most maxiter steps."""
    res = _resnorm(st, Bs)
    done = torch.zeros(Bs.shape[0], dtype=torch.bool, device=Bs.device)
    for t in range(maxiter):
        if t and stopped(done):
            break
        LOOP_COUNTS["steps"] += 1
        st2, bail = step(st)
        new_res = _resnorm(st2, Bs)
        live = ~done
        st = aset.where_rows(live, st2, st)
        res_was = res
        res = torch.where(live, new_res, res)
        done = done | bail | (new_res <= delta) | (res_was <= new_res)
    return st


# --------------------------------------------------------------------------
# Subspace pursuit
# --------------------------------------------------------------------------

def _sp_rows(A, Bs, k: int, delta: float = 1e-12,
             maxiter: int | None = None) -> SparseSolution:
    """`sp` over the rows of Bs: a batched SparseSolution."""
    n, m = A.shape
    k = int(k)
    if 2 * k > n:
        raise ValueError(f"2k = {2 * k} > {n} = len(b) is invalid for SP")
    maxiter = int(maxiter if maxiter is not None else 16 * k)
    kmax = 2 * k
    no_bail = torch.zeros(Bs.shape[0], dtype=torch.bool, device=A.device)

    def step(st):
        cand = topl(abs_correlate(A, aset.residual_batched(st, Bs)), k)
        st = _add_absent_rows(A, Bs, st, cand, kmax)
        scores = torch.where(st.mask, torch.abs(st.coef), -torch.inf)
        keep = st.idx.gather(1, topl(scores, k))
        return _support_state(A, Bs, keep, kmax), no_bail

    st = _improve_loop(Bs, _oblivious_state(A, Bs, k, kmax), maxiter, delta,
                       step)
    return aset.finalize_batched(st, m)


def sp(A, b, k: int, delta: float = 1e-12,
       maxiter: int | None = None) -> SparseSolution:
    """Subspace pursuit: expand by the top-k correlations, LS, prune to the
    k largest |coefficients|, while the residual norm improves and exceeds
    `delta`. As the reference, 2k <= n is required, maxiter defaults to
    16k, and the last pruned iterate is kept even if it did not improve.
    """
    A, b = as_inputs(A, b)
    return row_solution(_sp_rows(A, b[None], k, delta, maxiter))


# --------------------------------------------------------------------------
# OMP with replacement
# --------------------------------------------------------------------------

def _ompr_rows(A, Bs, k: int, delta: float, eta: float = 1.0,
               maxiter: int | None = None) -> SparseSolution:
    """`ompr` over the rows of Bs: a batched SparseSolution."""
    n, m = A.shape
    k = int(k)
    maxiter = int(maxiter if maxiter is not None else n)

    def step(st):
        r = aset.residual_batched(st, Bs)
        Ar = padded_to_dense(st.idx, st.coef, st.mask, m) + eta * (r @ A)
        i, best = masked_argmax(torch.abs(Ar),
                                ~aset.active_marker_batched(st, m))
        nochange = ~(best > 0)    # the reference's bail-out
        st2 = aset.append_col_batched(A[:, i].T.contiguous(), Bs, st, i)
        grad = Ar.gather(1, torch.where(st2.mask, st2.idx, 0).long())
        st2 = st2._replace(coef=torch.where(st2.mask, grad, 0))
        pos, _ = masked_argmin(torch.abs(st2.coef), st2.mask)
        st3 = aset.refit_batched(aset.delete_batched(st2, pos, m))
        return aset.where_rows(nochange, st, st3), nochange

    st = _improve_loop(Bs, _oblivious_state(A, Bs, k, k + 1), maxiter,
                       delta, step)
    return aset.finalize_batched(st, m)


def ompr(A, b, k: int, delta: float, eta: float = 1.0,
         maxiter: int | None = None) -> SparseSolution:
    """OMP with replacement: add the best passive atom by the gradient score
    |x + eta A'r|, gradient-step the active coefficients, drop the smallest
    |coefficient|, LS refit; stop when no passive atom scores above 0, the
    residual norm is <= delta, or it does not improve. maxiter defaults to
    n."""
    A, b = as_inputs(A, b)
    return row_solution(_ompr_rows(A, b[None], k, delta, eta, maxiter))


# --------------------------------------------------------------------------
# Stepwise regression with replacement
# --------------------------------------------------------------------------

def _forward_init(A, Bs, k: int, kmax: int, colnorm2):
    """k forward-regression adds a row with no accept test beyond capacity
    and the gated append's degeneracy check (initialization 2)."""
    n, m = A.shape
    st = aset.refit_batched(aset.empty_batched(Bs.shape[0], n, kmax, m,
                                               A.dtype, A.device))
    for _ in range(k):
        d2, _ = forward_deltas_rows(A, Bs, st, colnorm2, m)
        i, _ = top1(d2)
        ok = (st.k < n) & (st.k < kmax)
        st = aset.refit_batched(aset.append_gated_batched(A, Bs, st, i, ok))
    return st


def _random_support(A, B: int, k: int, key):
    """k atoms a row drawn with the torch.Generator `key`, one randperm a
    row in row order (initialization 3)."""
    m = A.shape[1]
    return torch.stack([torch.randperm(m, generator=key, device=key.device)[:k]
                        for _ in range(B)]).to(A.device)


def _srr_rows(A, Bs, k: int, delta: float = 1e-12, maxiter: int | None = None,
              initialization: int = 1, l: int = 1,
              key=None) -> SparseSolution:
    """`srr` over the rows of Bs: a batched SparseSolution."""
    n, m = A.shape
    k, l = int(k), int(l)
    maxiter = int(maxiter if maxiter is not None else 4 * k)
    kmax = min(k + l, m)
    colnorm2 = torch.sum(A * A, dim=0)
    if initialization == 1:
        st = _oblivious_state(A, Bs, k, kmax)
    elif initialization == 2:
        st = _forward_init(A, Bs, k, kmax, colnorm2)
    else:
        if key is None:
            raise ValueError("random initialization requires a "
                             "torch.Generator `key`")
        st = _support_state(A, Bs, _random_support(A, Bs.shape[0], k, key),
                            kmax)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    no_bail = torch.zeros(Bs.shape[0], dtype=torch.bool, device=A.device)

    def step(st):
        # up to l forward steps, each row stopping at its rejection; the
        # capacity k + l bounds the deletions back to k atoms by l too
        stop = no_bail
        for _ in range(l):
            st2, acc, _ = forward_step_rows(A, Bs, st, zero, zero, colnorm2,
                                            m)
            st = aset.where_rows(~stop, st2, st)
            stop = stop | ~acc
        stop = no_bail
        for _ in range(l):
            stop = stop | (st.k <= k)
            st2, acc = backward_step_rows(A, Bs, st, torch.inf, torch.inf, m)
            st = aset.where_rows(~stop, st2, st)
            stop = stop | ~acc
        return st, no_bail

    st = _improve_loop(Bs, st, maxiter, delta, step)
    return aset.finalize_batched(st, m)


def srr(A, b, k: int, delta: float = 1e-12, maxiter: int | None = None,
        initialization: int = 1, l: int = 1, key=None) -> SparseSolution:
    """Stepwise regression with replacement: a k-atom start, then up to l
    forward-regression steps and backward deletions back to k atoms, while
    the residual norm improves and exceeds `delta`. maxiter defaults to 4k.

    `initialization`: 1 = the k atoms most correlated with b, 2 = k
    forward-regression adds, 3 = k atoms drawn at random with `key`, a
    torch.Generator (required; its draws are torch's, not cstpu's).
    """
    A, b = as_inputs(A, b)
    return row_solution(_srr_rows(A, b[None], k, delta, maxiter,
                                  initialization, l, key))
