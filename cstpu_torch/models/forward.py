"""Forward stepwise regression, a.k.a. OLS / OOMP / ORMP (PyTorch
counterpart of cstpu.models.forward).

Greedy selection of the atom with the largest decrease in squared residual
norm, delta_j^2 = <a_j, r>^2 / (||a_j||^2 - ||proj_active a_j||^2), with
dual stopping (residual tolerance `max_residual`, least marginal decrease
`min_decrease`) and a sparsity cap. Each step is one (k x m) product and a
solve against the active Gram inverse (`active_set.ols_rescaling`), one
instance at a time; the batched path runs on the FR kernels of
cstpu_torch.ops.fused_solve.
"""

from __future__ import annotations

import torch

from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops.select import top1
from cstpu_torch.utils.sparse import SparseSolution


def forward_deltas(A, b, st, colnorm2, m: int):
    """(delta^2 for every atom, ||r||): the squared-residual decrease if
    the atom were added. Active atoms score 0; atoms numerically inside
    the active span (rescaling <= 8 n eps ||a_j||^2, eps of A's dtype)
    score -inf so they are never selected."""
    r = aset.residual(st, b)
    q = r @ A
    resc = aset.ols_rescaling(A, st, colnorm2)
    rtol = 8.0 * A.shape[0] * torch.finfo(A.dtype).eps
    d2 = torch.where(resc > rtol * colnorm2, q * q / resc, -torch.inf)
    act = aset.active_marker(st, m)
    return torch.where(act, 0.0, d2), torch.linalg.norm(r)


def exhaustion_floor(A, b):
    """Residual floor for exhaustion-mode forward stages: 8 sqrt(n) ulps of
    ||b||, the backward-error scale of an n-dimensional LS residual. Below
    it the fit is exact to rounding and further additions would pick
    degenerate atoms."""
    n = A.shape[0]
    return (8.0 * torch.sqrt(torch.tensor(float(n), dtype=A.dtype,
                                          device=A.device))
            * torch.finfo(A.dtype).eps * torch.linalg.norm(b))


def forward_step(A, b, st, max_eps, min_delta, colnorm2, m: int):
    """One forward step; returns (state, accepted, deltas).

    Accepts the best atom iff nnz < n, capacity remains, the residual norm
    still exceeds `max_eps`, and the best squared decrease beats
    `min_delta^2`. `accepted` reports what happened: the gated append can
    still reject a wanted atom as degenerate. Exhaustion-mode callers pass
    `exhaustion_floor(A, b)` as max_eps, not zero.
    """
    n = A.shape[0]
    kmax = st.idx.shape[0]
    max_eps = torch.as_tensor(max_eps, dtype=A.dtype, device=A.device)
    min_delta = torch.as_tensor(min_delta, dtype=A.dtype, device=A.device)
    d2, normr = forward_deltas(A, b, st, colnorm2, m)
    i, maxd2 = top1(d2)
    want = ((st.k < n) & (st.k < kmax) & (normr > max_eps)
            & (min_delta * min_delta < maxd2))
    st2 = aset.refit(aset.append_gated(A, b, st, i, want))
    accepted = want & (st2.k > st.k)
    return st2, accepted, d2


def _fr(A, b, k: int, max_eps, min_delta) -> SparseSolution:
    n, m = A.shape
    colnorm2 = torch.sum(A * A, dim=0)
    st = aset.refit(aset.empty(n, k, m, A.dtype, A.device))
    for _ in range(k):
        st, accepted, _ = forward_step(A, b, st, max_eps, min_delta,
                                       colnorm2, m)
        if not bool(accepted):
            break
    return aset.finalize(st, m)


def fr(A, b, max_residual: float = 0.0, min_decrease: float = 0.0,
       sparsity: int | None = None) -> SparseSolution:
    """Forward (stepwise) regression.

    Stops at whichever comes first: `sparsity` atoms, residual norm below
    `max_residual`, or best marginal decrease below `min_decrease`.
    Without `sparsity` the run is exhaustion-mode and the residual stop is
    floored at `exhaustion_floor`; with it, exactly k atoms are accepted
    when the criteria allow, as on the kernel path.
    """
    n, m = A.shape
    k = int(min(sparsity if sparsity is not None else m, n, m))
    max_eps = torch.as_tensor(max_residual, dtype=A.dtype, device=A.device)
    if sparsity is None:
        max_eps = torch.maximum(max_eps, exhaustion_floor(A, b))
    return _fr(A, b, k, max_eps, min_decrease)


# the reference's aliases
ols = fr
oomp = fr
ormp = fr
stepwise_regression = fr


def fr_warm(A, b, nzind) -> SparseSolution:
    """Restricted LS fit on a given support, the warm-start constructor
    `FR(A, b, nzind)` of the reference."""
    nz = torch.as_tensor(nzind, dtype=torch.int32, device=A.device)
    st = aset.refit(aset.rebuild(A, b, nz, torch.ones(nz.shape, dtype=torch.bool,
                                                      device=A.device)))
    return aset.finalize(st, A.shape[1])
