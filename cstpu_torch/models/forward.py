"""Forward stepwise regression, a.k.a. OLS / OOMP / ORMP (PyTorch
counterpart of cstpu.models.forward).

Greedy selection of the atom with the largest decrease in squared residual
norm, delta_j^2 = <a_j, r>^2 / (||a_j||^2 - ||proj_active a_j||^2), with
dual stopping (residual tolerance `max_residual`, least marginal decrease
`min_decrease`) and a sparsity cap. Each step is one (k x m) product per
row and a solve against the active Gram inverse
(`active_set.ols_rescaling_batched`). `_fr_rows` is the one body, over
measurement rows with a per-row stop latch read once a step, as cstpu's
vmapped while loop; `fr(A, b)` is that body on one row. The batched path
with a sparsity cap runs on the FR kernels of cstpu_torch.ops.fused_solve.
`forward_step_rows` is the step SRR, RMP and FoBa share; `forward_step`
and `forward_deltas` are its per-instance forms.
"""

from __future__ import annotations

import torch

from cstpu_torch.models.matching_pursuit import row_solution
from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops.select import top1
from cstpu_torch.ops.util import LOOP_COUNTS, as_inputs, stopped
from cstpu_torch.utils.sparse import SparseSolution


def forward_deltas_rows(A, Bs, st, colnorm2, m: int):
    """(delta^2 (B, m), ||r|| (B,)) for every row: the squared-residual
    decrease if the atom were added. Active atoms score 0; atoms
    numerically inside the active span (rescaling <= 8 n eps ||a_j||^2,
    eps of A's dtype) score -inf so they are never selected."""
    r = aset.residual_batched(st, Bs)
    q = r @ A
    resc = aset.ols_rescaling_batched(A, st, colnorm2)
    rtol = 8.0 * A.shape[0] * torch.finfo(A.dtype).eps
    d2 = torch.where(resc > rtol * colnorm2, q * q / resc, -torch.inf)
    act = aset.active_marker_batched(st, m)
    return torch.where(act, 0.0, d2), torch.linalg.norm(r, dim=1)


def forward_deltas(A, b, st, colnorm2, m: int):
    """`forward_deltas_rows` for one instance: (delta^2 (m,), ||r||)."""
    A, b, colnorm2 = as_inputs(A, b, colnorm2)
    d2, normr = forward_deltas_rows(A, b[None], aset.one_row(st), colnorm2, m)
    return d2[0], normr[0]


def exhaustion_floor(A, b):
    """Residual floor for exhaustion-mode forward stages: 8 sqrt(n) ulps of
    ||b||, the backward-error scale of an n-dimensional LS residual. Below
    it the fit is exact to rounding and further additions would pick
    degenerate atoms. b (n,) or rows (B, n) (then one floor a row)."""
    A, b = as_inputs(A, b)
    n = A.shape[0]
    return (8.0 * torch.sqrt(torch.tensor(float(n), dtype=A.dtype,
                                          device=A.device))
            * torch.finfo(A.dtype).eps * torch.linalg.norm(b, dim=-1))


def forward_step_rows(A, Bs, st, max_eps, min_delta, colnorm2, m: int):
    """One forward step of every row; returns (state, accepted (B,),
    deltas (B, m)).

    Row b accepts its best atom iff nnz < n, capacity remains, its
    residual norm still exceeds max_eps (a number or one a row), and the
    best squared decrease beats `min_delta^2`. `accepted` reports what
    happened: the gated append can still reject a wanted atom as
    degenerate. Exhaustion-mode callers pass `exhaustion_floor(A, Bs)` as
    max_eps, not zero.
    """
    n = A.shape[0]
    kmax = st.idx.shape[1]
    max_eps = torch.as_tensor(max_eps, dtype=A.dtype, device=A.device)
    min_delta = torch.as_tensor(min_delta, dtype=A.dtype, device=A.device)
    d2, normr = forward_deltas_rows(A, Bs, st, colnorm2, m)
    i, maxd2 = top1(d2)
    want = ((st.k < n) & (st.k < kmax) & (normr > max_eps)
            & (min_delta * min_delta < maxd2))
    st2 = aset.refit_batched(aset.append_gated_batched(A, Bs, st, i, want))
    accepted = want & (st2.k > st.k)
    return st2, accepted, d2


def forward_step(A, b, st, max_eps, min_delta, colnorm2, m: int):
    """`forward_step_rows` for one instance: (state, accepted, deltas)."""
    A, b, colnorm2 = as_inputs(A, b, colnorm2)
    st2, accepted, d2 = forward_step_rows(A, b[None], aset.one_row(st),
                                          max_eps, min_delta, colnorm2, m)
    return aset.row_of(st2), accepted[0], d2[0]


def forward_stage_rows(A, Bs, st, max_eps, min_delta, colnorm2, m: int,
                       nsteps: int, stop):
    """Forward steps of every row not in `stop` (B,) until its own
    rejection, at most nsteps: each row leaves at its rejection and is
    frozen after it; the loop ends when every row has left, read once a
    step from the second on."""
    for t in range(nsteps):
        if t and stopped(stop):
            break
        LOOP_COUNTS["steps"] += 1
        st2, acc, _ = forward_step_rows(A, Bs, st, max_eps, min_delta,
                                        colnorm2, m)
        st = aset.where_rows(~stop, st2, st)
        stop = stop | ~acc
    return st


def _fr_rows(A, Bs, max_residual: float = 0.0, min_decrease: float = 0.0,
             sparsity: int | None = None) -> SparseSolution:
    """`fr` over the rows of Bs: a batched SparseSolution."""
    n, m = A.shape
    k = int(min(sparsity if sparsity is not None else m, n, m))
    max_eps = torch.as_tensor(max_residual, dtype=A.dtype, device=A.device)
    if sparsity is None:
        max_eps = torch.maximum(max_eps, exhaustion_floor(A, Bs))
    colnorm2 = torch.sum(A * A, dim=0)
    st = aset.refit_batched(aset.empty_batched(Bs.shape[0], n, k, m,
                                               A.dtype, A.device))
    stop = torch.zeros(Bs.shape[0], dtype=torch.bool, device=A.device)
    st = forward_stage_rows(A, Bs, st, max_eps, min_decrease, colnorm2, m,
                            k, stop)
    return aset.finalize_batched(st, m)


def fr(A, b, max_residual: float = 0.0, min_decrease: float = 0.0,
       sparsity: int | None = None) -> SparseSolution:
    """Forward (stepwise) regression.

    Stops at whichever comes first: `sparsity` atoms, residual norm below
    `max_residual`, or best marginal decrease below `min_decrease`.
    Without `sparsity` the run is exhaustion-mode and the residual stop is
    floored at `exhaustion_floor`; with it, exactly k atoms are accepted
    when the criteria allow, as on the kernel path.
    """
    A, b = as_inputs(A, b)
    return row_solution(_fr_rows(A, b[None], max_residual, min_decrease,
                                 sparsity))


# the reference's aliases
ols = fr
oomp = fr
ormp = fr
stepwise_regression = fr


def _fr_warm_rows(A, Bs, nzind) -> SparseSolution:
    """`fr_warm` over the rows of Bs: nzind (B, s), one support a row."""
    nz = torch.as_tensor(nzind, dtype=torch.int32, device=A.device)
    st = aset.refit_batched(aset.rebuild_batched(
        A, Bs, nz, torch.ones(nz.shape, dtype=torch.bool, device=A.device)))
    return aset.finalize_batched(st, A.shape[1])


def fr_warm(A, b, nzind) -> SparseSolution:
    """Restricted LS fit on a given support, the warm-start constructor
    `FR(A, b, nzind)` of the reference."""
    A, b = as_inputs(A, b)
    nz = torch.as_tensor(nzind, dtype=torch.int32, device=A.device)
    return row_solution(_fr_warm_rows(A, b[None], nz[None]))
