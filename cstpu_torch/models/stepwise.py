"""Relevance matching pursuit (zero-noise limit) and FoBa (PyTorch
counterpart of cstpu.models.stepwise).

RMP alternates a forward stage run to exhaustion with a backward stage
(delta- or k-bounded), optionally iterated with change detection; FoBa
(Zhang's adaptive forward-backward) permits backward steps only while
their norm increase is at most half the last forward decrease. Both are
compositions of the forward and backward steps.

Batched first: `_stepwise_rows` is one body for both over the rows of Bs
(B, n). Each row walks its own sequence of stages (forward, backward,
done) and takes one step of its current stage a batched step: rows in a
forward stage take a forward step and rows in a backward stage a backward
step in the same step, each leaving its stage at its own rejection, so
the loop runs as long as the slowest row's own steps. One latch read a
step fetches "every row done" with "some row forward", "some row
backward" and "some row starts a backward stage", and a step computes
only the stages some row is in. A backward stage starts from an exact
Gram inverse: the bordered updates of the forward stage before it are
replaced by a recompute from the Gram (`refresh_batched`, what every
deletion does after it), so that the first deletion does not follow
their drift. Near full rank in f32 (an exhaustion-mode forward stage at
kmax = n) that drift otherwise decides which atom goes first. The
per-instance `rmp(A, b)` and `foba(A, b)` are the body on one row; the
batched paths on the card run on the kernels of
cstpu_torch.ops.fused_twostage.
"""

from __future__ import annotations

import torch

from cstpu_torch.models.backward import backward_step_rows
from cstpu_torch.models.forward import exhaustion_floor, forward_step_rows
from cstpu_torch.models.matching_pursuit import row_solution
from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops.util import (LOOP_COUNTS, as_inputs, padded_to_dense,
                                  read_latch)
from cstpu_torch.utils.sparse import SparseSolution

FORWARD, BACKWARD, DONE = 0, 1, 2


def _dense(st, m):
    return padded_to_dense(st.idx, st.coef, st.mask, m)


def _approx_eq(x, y):
    """||x - y|| <= sqrt(eps) * max(||x||, ||y||) over the last axis, the
    reference's `isapprox` on vectors (one answer a row)."""
    rtol = torch.finfo(x.dtype).eps ** 0.5
    norm = torch.linalg.norm
    return norm(x - y, dim=-1) <= rtol * torch.maximum(norm(x, dim=-1),
                                                       norm(y, dim=-1))


def _empty_state(A, B: int):
    n, m = A.shape
    return aset.refit_batched(aset.empty_batched(B, n, min(n, m), m,
                                                 A.dtype, A.device))


def _stepwise_rows(A, Bs, st, rule: str, delta=0.0, maxiter: int = 1,
                   min_k: int = 0):
    """The forward and backward stages of every row from state st.

    rule "rmp": forward stages at marginal tolerance delta (at most n steps
    each), backward stages at delta, up to maxiter rounds, a row stopping
    where a stage leaves its x stationary; "rmp_k": one forward stage to
    exhaustion, one backward stage down to min_k atoms; "foba": a forward
    step, then the backward steps whose increase is at most half its
    decrease, at most n rounds, a row stopping at its first rejected
    forward step. Forward stages stop at the exhaustion floor; a row
    entering a backward stage with a bordered Gram inverse (`stale`) gets
    it recomputed and refit first."""
    n, m = A.shape
    B, kmax = st.idx.shape
    dev = A.device
    colnorm2 = torch.sum(A * A, dim=0)
    floor = exhaustion_floor(A, Bs)
    rounds = n if rule == "foba" else maxiter
    min_delta = 0.0 if rule == "rmp_k" else delta
    phase = torch.full((B,), FORWARD, dtype=torch.int8, device=dev)
    j = torch.zeros(B, dtype=torch.int32, device=dev)  # a stage's fwd steps
    t = torch.zeros(B, dtype=torch.int32, device=dev)  # rounds finished
    xt = _dense(st, m)   # the (refit) start, the reference's copy of x
    xf = xt
    bwd_delta = torch.full((B,), torch.inf if rule == "rmp_k" else delta,
                           dtype=A.dtype, device=dev)
    # Ginv bordered by an append since it was last computed from G
    stale = torch.zeros(B, dtype=torch.bool, device=dev)

    def end_backward(st, ended, phase, t, j, xt, xf):
        """The rows `ended` leave their backward stage: a round ends."""
        t = t + ended.to(torch.int32)
        last = t >= rounds
        if rule == "rmp":
            xb = _dense(st, m)
            last = last | _approx_eq(xf, xb)
            xt = torch.where(ended[:, None], xb, xt)
        elif rule == "rmp_k":
            last = torch.ones_like(ended)
        phase = torch.where(ended, torch.where(last, DONE, FORWARD), phase)
        return phase.to(torch.int8), t, torch.where(ended, 0, j), xt

    cap = rounds * (n + kmax + 2)
    for s in range(cap):
        if s:
            done, any_f, any_b, any_stale = read_latch(
                (phase == DONE).all(), (phase == FORWARD).any(),
                (phase == BACKWARD).any(), ((phase == BACKWARD) & stale).any())
            if done:
                break
        else:
            any_f, any_b, any_stale = True, False, False
        LOOP_COUNTS["steps"] += 1
        in_b = phase == BACKWARD
        if any_f:
            in_f = phase == FORWARD
            st2, acc, d2 = forward_step_rows(A, Bs, st, floor, min_delta,
                                             colnorm2, m)
            st = aset.where_rows(in_f, st2, st)
            stale = stale | (in_f & acc)
            if rule == "foba":
                # the largest delta^2 of the step is the accepted forward
                # decrease
                gain = torch.sqrt(torch.clamp(torch.max(d2, dim=1).values,
                                              min=0))
                bwd_delta = torch.where(in_f, gain / 2, bwd_delta)
                to_b = in_f & acc
                phase = torch.where(in_f & ~acc, DONE, phase)
            else:
                j = j + in_f.to(torch.int32)
                ended = in_f & (~acc | (j >= n))
                xf = torch.where(ended[:, None], _dense(st, m), xf)
                # the reference breaks before the backward stage when the
                # forward stage left x stationary: a warm start the forward
                # stage cannot improve comes back as its own LS refit
                still = (ended & _approx_eq(xt, xf) if rule == "rmp"
                         else torch.zeros_like(ended))
                phase = torch.where(still, DONE, phase)
                to_b = ended & ~still
            phase = torch.where(to_b, BACKWARD, phase).to(torch.int8)
            # a backward stage entered at or below min_k atoms takes no step
            phase, t, j, xt = end_backward(st, to_b & (st.k <= min_k), phase,
                                           t, j, xt, xf)
        if any_b:
            if any_stale:
                fix = in_b & stale
                st = aset.where_rows(
                    fix, aset.refit_batched(aset.refresh_batched(st)), st)
                stale = stale & ~fix
            st2, acc = backward_step_rows(A, Bs, st, torch.inf, bwd_delta, m)
            st = aset.where_rows(in_b, st2, st)
            phase, t, j, xt = end_backward(
                st, in_b & (~acc | (st.k <= min_k)), phase, t, j, xt, xf)
    return st


def _warm_state(A, Bs, idx0, mask0):
    """Every row's state on its warm-start support (idx0, mask0) (B, s),
    refit. A padded support wider than min(n, m) (a GOMP solution over an
    overcomplete dictionary, say) cannot carry more than min(n, m) active
    atoms: the active entries go to the front, in order, and the padding
    is cut."""
    n, m = A.shape
    kmax = min(n, m)
    if idx0.shape[1] > kmax:
        order = torch.argsort((~mask0).to(torch.int8), dim=1, stable=True)
        idx0 = idx0.gather(1, order)[:, :kmax]
        mask0 = mask0.gather(1, order)[:, :kmax]
    pad = kmax - idx0.shape[1]
    F = torch.nn.functional
    return aset.refit_batched(aset.rebuild_batched(
        A, Bs, F.pad(idx0.to(torch.int32), (0, pad), value=m),
        F.pad(mask0, (0, pad))))


def _warm_support(x0, device):
    """(idx0, mask0) of a warm start: a SparseSolution's support, a dense
    float coefficient vector's support, or integer support indices."""
    if isinstance(x0, SparseSolution):
        return x0.idx.to(device), x0.mask.to(device)
    x0 = torch.as_tensor(x0, device=device)
    idx0 = (torch.nonzero(x0)[:, 0] if x0.is_floating_point()
            else x0).to(torch.int32)
    return idx0, torch.ones(idx0.shape, dtype=torch.bool, device=device)


def _rmp_rows(A, Bs, k: int | None = None, delta: float | None = None,
              maxiter: int = 1, x0=None) -> SparseSolution:
    """`rmp` over the rows of Bs, every row warm-started from x0 where
    given: a batched SparseSolution."""
    if (k is None) == (delta is None):
        raise ValueError("specify exactly one of k or delta")
    B, m = Bs.shape[0], A.shape[1]
    if delta is None:
        st = _stepwise_rows(A, Bs, _empty_state(A, B), "rmp_k",
                            min_k=int(k))
    else:
        if x0 is None:
            st = _empty_state(A, B)
        else:
            idx0, mask0 = _warm_support(x0, A.device)
            st = _warm_state(A, Bs, idx0.expand(B, -1), mask0.expand(B, -1))
        st = _stepwise_rows(A, Bs, st, "rmp", delta, int(maxiter))
    return aset.finalize_batched(st, m)


def rmp(A, b, k: int | None = None, delta: float | None = None,
        maxiter: int = 1, x0=None) -> SparseSolution:
    """Relevance matching pursuit (zero-noise limit).

    Two calling conventions:
      * rmp(A, b, delta=d[, maxiter=t]): forward stage to exhaustion at
        marginal tolerance d, backward stage at d, iterated with
        stationarity detection;
      * rmp(A, b, k=s): forward to exhaustion, backward down to s atoms.
        When b is spanned to rounding by fewer than s atoms the result
        carries only those: the exhaustion stops at the rounding floor.
    `x0` warm-starts the delta variant from a solution's support: a
    SparseSolution, a dense float coefficient vector (its support is
    taken), or an integer array of support indices. An integer-typed
    coefficient vector would be read as indices: pass coefficients as
    floats.
    """
    A, b = as_inputs(A, b)
    return row_solution(_rmp_rows(A, b[None], k, delta, maxiter, x0))


def _foba_rows(A, Bs, delta: float) -> SparseSolution:
    """`foba` over the rows of Bs: a batched SparseSolution."""
    st = _stepwise_rows(A, Bs, _empty_state(A, Bs.shape[0]), "foba", delta)
    return aset.finalize_batched(st, A.shape[1])


def foba(A, b, delta: float) -> SparseSolution:
    """Adaptive forward-backward greedy (Zhang's FoBa): after each accepted
    forward step, backward steps are taken only while their residual
    increase is at most half the forward decrease; at most n iterations,
    ending at the first rejected forward step."""
    A, b = as_inputs(A, b)
    return row_solution(_foba_rows(A, b[None], delta))
