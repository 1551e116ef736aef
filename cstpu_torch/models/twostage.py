"""Two-stage / replacement algorithms: subspace pursuit, OMP with
replacement and stepwise regression with replacement (PyTorch counterpart
of cstpu.models.twostage).

Thin drivers over the active-set engine and the forward and backward steps,
one instance at a time: expand the support, refit, prune, iterate until
the residual stops improving. The batched paths run on the kernels of
cstpu_torch.ops.fused_twostage.
"""

from __future__ import annotations

import torch

from cstpu_torch.models.backward import backward_step
from cstpu_torch.models.forward import forward_deltas, forward_step
from cstpu_torch.models.matching_pursuit import _add_absent
from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops.select import abs_correlate, top1, topl
from cstpu_torch.ops.util import masked_argmax, masked_argmin, padded_to_dense
from cstpu_torch.utils.sparse import SparseSolution


def _oblivious_state(A, b, k: int, kmax: int):
    """The k atoms most correlated with b, LS-fitted, in a capacity-kmax
    state (the reference's `oblivious_acquisition!`)."""
    m = A.shape[1]
    idx = topl(torch.abs(b @ A), k).to(torch.int32)
    idx_full = torch.cat([idx, torch.full((kmax - k,), m, dtype=torch.int32,
                                          device=A.device)])
    mask = torch.arange(kmax, device=A.device) < k
    return aset.refit(aset.rebuild(A, b, idx_full, mask))


def _resnorm(st, b):
    return torch.linalg.norm(aset.residual(st, b))


# --------------------------------------------------------------------------
# Subspace pursuit
# --------------------------------------------------------------------------

def sp(A, b, k: int, delta: float = 1e-12,
       maxiter: int | None = None) -> SparseSolution:
    """Subspace pursuit: expand by the top-k correlations, LS, prune to the
    k largest |coefficients|, while the residual norm improves and exceeds
    `delta`. As the reference, 2k <= n is required, maxiter defaults to
    16k, and the last pruned iterate is kept even if it did not improve.
    """
    n, m = A.shape
    k = int(k)
    if 2 * k > n:
        raise ValueError(f"2k = {2 * k} > {n} = len(b) is invalid for SP")
    maxiter = int(maxiter if maxiter is not None else 16 * k)
    kmax = 2 * k
    st = _oblivious_state(A, b, k, kmax)
    res = _resnorm(st, b)
    mask = torch.arange(kmax, device=A.device) < k
    pad = torch.full((kmax - k,), m, dtype=torch.int32, device=A.device)
    for _ in range(maxiter):
        cand = topl(abs_correlate(A, aset.residual(st, b)), k)
        st = _add_absent(A, b, st, cand, kmax)
        scores = torch.where(st.mask, torch.abs(st.coef), -torch.inf)
        keep = topl(scores, k)
        st = aset.refit(aset.rebuild(A, b, torch.cat([st.idx[keep], pad]),
                                     mask))
        new_res = _resnorm(st, b)
        done = bool((new_res <= delta) | (res <= new_res))
        res = new_res
        if done:
            break
    return aset.finalize(st, m)


# --------------------------------------------------------------------------
# OMP with replacement
# --------------------------------------------------------------------------

def ompr(A, b, k: int, delta: float, eta: float = 1.0,
         maxiter: int | None = None) -> SparseSolution:
    """OMP with replacement: add the best passive atom by the gradient score
    |x + eta A'r|, gradient-step the active coefficients, drop the smallest
    |coefficient|, LS refit; stop when no passive atom scores above 0, the
    residual norm is <= delta, or it does not improve. maxiter defaults to
    n."""
    n, m = A.shape
    k = int(k)
    maxiter = int(maxiter if maxiter is not None else n)
    st = _oblivious_state(A, b, k, k + 1)
    res = _resnorm(st, b)
    for _ in range(maxiter):
        r = aset.residual(st, b)
        Ar = padded_to_dense(st.idx, st.coef, st.mask, m) + eta * (r @ A)
        i, best = masked_argmax(torch.abs(Ar), ~aset.active_marker(st, m))
        if not bool(best > 0):    # the reference's bail-out
            break
        st2 = aset.append(A, b, st, i)
        grad = Ar[torch.where(st2.mask, st2.idx, 0).long()]
        st2 = st2._replace(coef=torch.where(st2.mask, grad, 0))
        pos, _ = masked_argmin(torch.abs(st2.coef), st2.mask)
        st = aset.refit(aset.delete(st2, int(pos), m))
        new_res = _resnorm(st, b)
        done = bool((new_res <= delta) | (res <= new_res))
        res = new_res
        if done:
            break
    return aset.finalize(st, m)


# --------------------------------------------------------------------------
# Stepwise regression with replacement
# --------------------------------------------------------------------------

def _forward_init(A, b, k: int, kmax: int, colnorm2):
    """k forward-regression adds with no accept test beyond capacity and
    the gated append's degeneracy check (initialization 2)."""
    n, m = A.shape
    st = aset.refit(aset.empty(n, kmax, m, A.dtype, A.device))
    for _ in range(k):
        d2, _ = forward_deltas(A, b, st, colnorm2, m)
        i, _ = top1(d2)
        ok = int(st.k) < n and int(st.k) < kmax
        st = aset.refit(aset.append_gated(A, b, st, i, ok))
    return st


def srr(A, b, k: int, delta: float = 1e-12, maxiter: int | None = None,
        initialization: int = 1, l: int = 1, key=None) -> SparseSolution:
    """Stepwise regression with replacement: a k-atom start, then up to l
    forward-regression steps and backward deletions back to k atoms, while
    the residual norm improves and exceeds `delta`. maxiter defaults to 4k.

    `initialization`: 1 = the k atoms most correlated with b, 2 = k
    forward-regression adds, 3 = k atoms drawn at random with `key`, a
    torch.Generator (required; its draws are torch's, not cstpu's).
    """
    n, m = A.shape
    k, l = int(k), int(l)
    maxiter = int(maxiter if maxiter is not None else 4 * k)
    kmax = min(k + l, m)
    colnorm2 = torch.sum(A * A, dim=0)
    if initialization == 1:
        st = _oblivious_state(A, b, k, kmax)
    elif initialization == 2:
        st = _forward_init(A, b, k, kmax, colnorm2)
    else:
        if key is None:
            raise ValueError("random initialization requires a "
                             "torch.Generator `key`")
        idx = torch.randperm(m, generator=key, device=key.device)[:k]
        idx_full = torch.cat([idx.to(A.device, torch.int32),
                              torch.full((kmax - k,), m, dtype=torch.int32,
                                         device=A.device)])
        st = aset.refit(aset.rebuild(
            A, b, idx_full, torch.arange(kmax, device=A.device) < k))
    res = _resnorm(st, b)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    for _ in range(maxiter):
        for _ in range(l):    # up to l forward steps, stop on a rejection
            st, accepted, _ = forward_step(A, b, st, zero, zero, colnorm2, m)
            if not bool(accepted):
                break
        while int(st.k) > k:  # back to k atoms, stop on a rejection
            st, accepted = backward_step(A, b, st, torch.inf, torch.inf, m)
            if not accepted:
                break
        new_res = _resnorm(st, b)
        done = bool((new_res <= delta) | (res <= new_res))
        res = new_res
        if done:
            break
    return aset.finalize(st, m)
