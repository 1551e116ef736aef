"""Relevance matching pursuit (zero-noise limit) and FoBa (PyTorch
counterpart of cstpu.models.stepwise).

RMP alternates a forward stage run to exhaustion with a backward stage
(delta- or k-bounded), optionally iterated with change detection; FoBa
(Zhang's adaptive forward-backward) permits backward steps only while
their norm increase is at most half the last forward decrease. Both are
compositions of the forward and backward steps, one instance at a time;
the batched paths run on the kernels of cstpu_torch.ops.fused_twostage.
"""

from __future__ import annotations

import torch

from cstpu_torch.models.backward import backward_step
from cstpu_torch.models.forward import exhaustion_floor, forward_step
from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops.util import padded_to_dense
from cstpu_torch.utils.sparse import SparseSolution


def _dense(st, m):
    return padded_to_dense(st.idx, st.coef, st.mask, m)


def _approx_eq(x, y) -> bool:
    """||x - y|| <= sqrt(eps) * max(||x||, ||y||), the reference's
    `isapprox` on vectors."""
    rtol = torch.finfo(x.dtype).eps ** 0.5
    return bool(torch.linalg.norm(x - y) <= rtol * torch.maximum(
        torch.linalg.norm(x), torch.linalg.norm(y)))


def _forward_stage(A, b, st, max_eps, min_delta, colnorm2, m, nsteps):
    """Run forward steps until rejection (at most nsteps)."""
    for _ in range(nsteps):
        st, accepted, _ = forward_step(A, b, st, max_eps, min_delta,
                                       colnorm2, m)
        if not bool(accepted):
            break
    return st


def _backward_stage(A, b, st, max_eps, max_delta, m, min_k: int = 0):
    """Run backward steps until rejection or support size min_k."""
    while int(st.k) > min_k:
        st, accepted = backward_step(A, b, st, max_eps, max_delta, m)
        if not accepted:
            break
    return st


def _empty_state(A):
    n, m = A.shape
    return aset.refit(aset.empty(n, min(n, m), m, A.dtype, A.device))


def _rmp_delta(A, b, delta, maxiter: int, idx0=None, mask0=None):
    n, m = A.shape
    kmax = min(n, m)
    colnorm2 = torch.sum(A * A, dim=0)
    if idx0 is None:
        st = _empty_state(A)
    else:  # warm start from a given support
        if idx0.shape[0] > kmax:
            # a padded support wider than min(n, m) (a GOMP solution over
            # an overcomplete dictionary, say) cannot carry more than kmax
            # active atoms: the active entries go to the front, in order,
            # and the padding is cut
            order = torch.argsort((~mask0).to(torch.int8), stable=True)
            idx0, mask0 = idx0[order][:kmax], mask0[order][:kmax]
        pad = kmax - idx0.shape[0]
        st = aset.refit(aset.rebuild(
            A, b, torch.nn.functional.pad(idx0.to(torch.int32), (0, pad),
                                          value=m),
            torch.nn.functional.pad(mask0, (0, pad))))
    floor = exhaustion_floor(A, b)
    xt = _dense(st, m)   # the (refit) warm start, the reference's copy of x
    for _ in range(maxiter):
        st = _forward_stage(A, b, st, floor, delta, colnorm2, m, n)
        xf = _dense(st, m)
        # the reference breaks before the backward stage when the forward
        # stage left x stationary: a warm start the forward stage cannot
        # improve comes back as its own LS refit, not pruned
        if _approx_eq(xt, xf):
            break
        st = _backward_stage(A, b, st, torch.inf, delta, m)
        xt = _dense(st, m)
        if _approx_eq(xf, xt):
            break
    return aset.finalize(st, m)


def _rmp_k(A, b, k: int):
    n, m = A.shape
    colnorm2 = torch.sum(A * A, dim=0)
    st = _forward_stage(A, b, _empty_state(A), exhaustion_floor(A, b), 0.0,
                        colnorm2, m, n)
    st = _backward_stage(A, b, st, torch.inf, torch.inf, m, min_k=k)
    return aset.finalize(st, m)


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
    if (k is None) == (delta is None):
        raise ValueError("specify exactly one of k or delta")
    if delta is None:
        return _rmp_k(A, b, int(k))
    idx0 = mask0 = None
    if isinstance(x0, SparseSolution):
        idx0, mask0 = x0.idx.to(A.device), x0.mask.to(A.device)
    elif x0 is not None:
        x0 = torch.as_tensor(x0, device=A.device)
        idx0 = (torch.nonzero(x0)[:, 0] if x0.is_floating_point()
                else x0).to(torch.int32)
        mask0 = torch.ones(idx0.shape, dtype=torch.bool, device=A.device)
    return _rmp_delta(A, b, delta, int(maxiter), idx0, mask0)


def foba(A, b, delta: float) -> SparseSolution:
    """Adaptive forward-backward greedy (Zhang's FoBa): after each accepted
    forward step, backward steps are taken only while their residual
    increase is at most half the forward decrease; at most n iterations,
    ending at the first rejected forward step."""
    n, m = A.shape
    colnorm2 = torch.sum(A * A, dim=0)
    st = _empty_state(A)
    floor = exhaustion_floor(A, b)
    for _ in range(n):
        st, accepted, d2 = forward_step(A, b, st, floor, delta, colnorm2, m)
        if not bool(accepted):
            break
        # the largest delta^2 of the step is the accepted forward decrease
        max_delta = torch.sqrt(torch.clamp(torch.max(d2), min=0))
        st = _backward_stage(A, b, st, torch.inf, max_delta / 2, m)
    return aset.finalize(st, m)
