"""Structured per-iteration solver diagnostics (PyTorch counterpart of
cstpu.utils.diagnostics).

A traced solve returns, beside its result, a fixed-shape trace of tensors
padded past the step where the solver stopped: `SolveTrace` for the greedy
solvers (`omp_traced`, `fr_traced`, here), `SBLTrace` and `RMPSTrace` for
the SBL family (`fsbl_traced`, `rmps_traced` in cstpu_torch.models.sbl).
Each loop here is a Python loop over one instance, as the port's `omp` and
`fr` are.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cstpu_torch.models.forward import exhaustion_floor, forward_step
from cstpu_torch.ops import active_set as aset
from cstpu_torch.ops.select import abs_correlate, top1
from cstpu_torch.ops.util import as_inputs


class SolveTrace(NamedTuple):
    """Fixed-shape per-step history of a greedy solve (padded past the
    step where the solver stopped)."""
    residual_norm: torch.Tensor  # f[k] residual norm after each step
    selected: torch.Tensor       # i32[k] atom chosen at each step (-1 if none)
    accepted: torch.Tensor       # bool[k] whether the step changed the state
    score: torch.Tensor          # f[k] selection score (|<a,r>| for OMP)


class RMPSTrace(NamedTuple):
    """Per-OUTER-iteration history of the staged RMPS coordinate ascent
    (acquisition stage to exhaustion, then deletion/update). Padded past
    convergence."""
    n_active: torch.Tensor   # i32[T] active atoms after the iteration
    n_added: torch.Tensor    # i32[T] acquisitions this iteration
    n_deleted: torch.Tensor  # i32[T] deletions this iteration
    n_updated: torch.Tensor  # i32[T] re-estimated (changed) alphas


class SBLTrace(NamedTuple):
    """Fixed-shape per-action history of a marginal-likelihood ascent
    (fsbl): the marginal-likelihood change of each greedy action, and
    which atom and action."""
    likelihood_delta: torch.Tensor  # f[T] marginal-likelihood change
    selected: torch.Tensor          # i32[T] atom acted on (-1 if none)
    action: torch.Tensor            # i32[T] 0 add / 1 delete / 2 update / -1
    n_active: torch.Tensor          # i32[T] active-set size after the step


def _empty_trace(k: int, A) -> SolveTrace:
    return SolveTrace(
        residual_norm=torch.zeros((k,), dtype=A.dtype, device=A.device),
        selected=torch.full((k,), -1, dtype=torch.int32, device=A.device),
        accepted=torch.zeros((k,), dtype=torch.bool, device=A.device),
        score=torch.zeros((k,), dtype=A.dtype, device=A.device),
    )


def _record(tr: SolveTrace, t: int, rn, i, acc, score) -> None:
    tr.residual_norm[t] = rn
    tr.selected[t] = torch.where(acc, i, -1)
    tr.accepted[t] = acc
    tr.score[t] = score


def omp_traced(A, b, k: int | None = None, max_residual: float = 0.0):
    """OMP returning (solution, SolveTrace): cstpu_torch.omp plus
    observability."""
    A, b = as_inputs(A, b)
    n, m = A.shape
    k = int(min(k if k is not None else n, n, m))
    eps = torch.as_tensor(max_residual, dtype=A.dtype, device=A.device)
    st = aset.empty(n, k, m, A.dtype, A.device)
    tr = _empty_trace(k, A)
    for t in range(k):
        r = aset.residual(st, b)
        i, sc = top1(abs_correlate(A, r))
        present = aset.contains(st, i)
        full = st.k >= min(n, k)
        ok = ~present & ~full
        st2 = aset.refit(aset.append_gated(A, b, st, i, ok))
        # what actually happened: the append's degeneracy gate can reject
        # a wanted atom
        acc = ok & (st2.k > st.k)
        rn = torch.linalg.norm(aset.residual(st2, b))
        _record(tr, t, rn, i, acc, sc)
        st = st2
        if not bool(acc) or bool(rn < eps):
            break
    return aset.finalize(st, m), tr


def fr_traced(A, b, sparsity: int | None = None, max_residual: float = 0.0,
              min_decrease: float = 0.0):
    """Forward regression returning (solution, SolveTrace): the `score`
    channel is the best squared residual decrease delta^2 per step.
    Without an explicit sparsity the run is exhaustion-mode and the
    residual stop is floored at `exhaustion_floor`, as in cstpu_torch.fr."""
    A, b = as_inputs(A, b)
    n, m = A.shape
    k = int(min(sparsity if sparsity is not None else n, n, m))
    max_eps = torch.as_tensor(max_residual, dtype=A.dtype, device=A.device)
    if sparsity is None:
        max_eps = torch.maximum(max_eps, exhaustion_floor(A, b))
    colnorm2 = torch.sum(A * A, dim=0)
    st = aset.refit(aset.empty(n, k, m, A.dtype, A.device))
    tr = _empty_trace(k, A)
    for t in range(k):
        st, ok, d2 = forward_step(A, b, st, max_eps, min_decrease, colnorm2, m)
        i, maxd2 = top1(d2)
        rn = torch.linalg.norm(aset.residual(st, b))
        _record(tr, t, rn, i, ok, maxd2)
        if not bool(ok):
            break
    return aset.finalize(st, m), tr
