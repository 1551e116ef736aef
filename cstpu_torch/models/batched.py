"""Batched-first entry points (PyTorch counterpart of the greedy and
two-stage parts of cstpu.models.batched).

A shared dictionary with a batch of measurements is the high-throughput
workload. On CUDA, `omp_batch`, `mp_batch`, `gomp_batch` and `fr_batch` run
the kernels of cstpu_torch.ops.fused_solve, and `sp_batch`, `ompr_batch`
and `srr_batch` those of cstpu_torch.ops.fused_twostage; elsewhere, and for
options or shapes the kernels do not serve, they run the per-instance
solver over the rows (`batch`, where cstpu runs `vmap`). cstpu's one-device-mesh hybrids
(`_stream_ok` -> `*_sharded_fused`) have no counterpart: the port's select
kernels stream the dictionary tile by tile at any m, so one kernel path
serves both regimes.
"""

from __future__ import annotations

import torch

from cstpu_torch.models.forward import fr
from cstpu_torch.models.matching_pursuit import gomp, mp, omp
from cstpu_torch.models.twostage import ompr, sp, srr
from cstpu_torch.ops import fused_solve, fused_twostage
from cstpu_torch.utils.sparse import SparseSolution


def _stack(results):
    """Stack per-row results along a new leading batch dimension."""
    first = results[0]
    if isinstance(first, SparseSolution):
        return SparseSolution(
            idx=torch.stack([s.idx for s in results]),
            val=torch.stack([s.val for s in results]),
            mask=torch.stack([s.mask for s in results]),
            m=first.m,
        )
    return torch.stack(results)


def batch(solver, **fixed):
    """Run `solver(A, b, ...)` on every row of Bs and stack the results.

    Example: `batch(omp, k=8)(A, Bs)` solves all rows of Bs.
    """
    def batched(A, Bs, **kw):
        merged = {**fixed, **kw}
        return _stack([solver(A, bb, **merged) for bb in Bs])
    return batched


def _cdt(precision):
    """Correlation dtype for a `precision` option (None/'bf16' -> bf16)."""
    return torch.float32 if precision == "f32" else torch.bfloat16


def _kernels_ok(A, Bs, precision) -> bool:
    """The option, dtype and device conditions every kernel path shares:
    a kernel precision, a float32 dictionary, 2-D measurements, CUDA."""
    return (precision in (None, "bf16", "f32") and A.dtype == torch.float32
            and Bs.ndim == 2 and A.is_cuda and Bs.is_cuda)


def omp_batch(A, Bs, k=None, max_residual: float = 0.0, precision=None):
    """Batched OMP over measurement rows Bs (B, n).

    With a float32 dictionary on CUDA and a fixed step count
    (max_residual == 0) this runs the select and append kernels.
    `precision` picks the dictionary dtype inside them: None/'bf16'
    (default) or 'f32' (true f32, no TF32); 'highest' takes the
    per-instance path. Everything else (inverse Gram, coefficients,
    residual) is f32. Otherwise, or for shapes the kernels do not take,
    the rows run through the per-instance `omp`.
    """
    A = torch.as_tensor(A)
    Bs = torch.as_tensor(Bs)
    kk = int(min(k if k is not None else A.shape[0], *A.shape))
    if _kernels_ok(A, Bs, precision) and float(max_residual) == 0.0:
        cdt = _cdt(precision)
        if fused_solve.supported(A, Bs, kk, cdt):
            sol, _ = fused_solve.omp_fused_solve(A, Bs, kk, corr_dtype=cdt)
            return sol
        if fused_solve.supported_stream(A, Bs, kk, cdt):
            # dictionary beyond the L2 cache: streamed from device memory
            sol, _ = fused_solve.omp_stream_solve(A, Bs, kk, corr_dtype=cdt)
            return sol
    return batch(omp, k=k, max_residual=max_residual)(A, Bs)


def fr_batch(A, Bs, max_residual: float = 0.0, min_decrease: float = 0.0,
             sparsity=None, precision=None):
    """Batched forward regression over measurement rows Bs (B, n).

    With a sparsity cap, on CUDA, this runs the fr_select and fr_append
    kernels: the OLS rescaling is kept order-recursively instead of being
    re-derived from a (k x m) product per step. `precision` as in
    omp_batch. Otherwise the rows run through the per-instance `fr`.
    """
    A = torch.as_tensor(A)
    Bs = torch.as_tensor(Bs)
    if (_kernels_ok(A, Bs, precision) and sparsity is not None
            and fused_solve.supported_fr(A, Bs, int(sparsity),
                                         _cdt(precision))):
        sol, _ = fused_solve.fr_fused_solve(
            A, Bs, int(sparsity), max_residual, min_decrease,
            corr_dtype=_cdt(precision))
        return sol
    return batch(fr, max_residual=max_residual, min_decrease=min_decrease,
                 sparsity=sparsity)(A, Bs)


def mp_batch(A, Bs, k: int, precision=None):
    """Batched matching pursuit; returns the dense solutions (B, m).

    On CUDA this runs the signed select and the mp_update kernel;
    otherwise the rows run through the per-instance `mp`.
    """
    A = torch.as_tensor(A)
    Bs = torch.as_tensor(Bs)
    if _kernels_ok(A, Bs, precision) and fused_solve.supported_mp(A, Bs):
        x, _ = fused_solve.mp_fused_solve(A, Bs, int(k),
                                          corr_dtype=_cdt(precision))
        return x
    return batch(mp, k=k)(A, Bs)


def gomp_batch(A, Bs, l, k=None, max_residual: float = 0.0, precision=None):
    """Batched generalized OMP over measurement rows Bs (B, n).

    On CUDA this runs the select_topl and gomp_append kernels (top-l
    acquisitions per iteration). `precision` as in omp_batch. Otherwise
    the rows run through the per-instance `gomp`. The slot width is
    min(k, m) on every path.
    """
    A = torch.as_tensor(A)
    Bs = torch.as_tensor(Bs)
    kk = int(min(k if k is not None else A.shape[1], A.shape[1]))
    if (_kernels_ok(A, Bs, precision)
            and fused_solve.supported_gomp(A, Bs, int(l), kk)):
        sol, _ = fused_solve.gomp_fused_solve(A, Bs, int(l), kk,
                                              max_residual,
                                              corr_dtype=_cdt(precision))
        # the kernel path clamps its slot width to min(kk, n); pad back to
        # the per-instance path's width, so that the returned width does
        # not depend on the path
        pad = kk - sol.idx.shape[1]
        if pad > 0:
            F = torch.nn.functional
            sol = SparseSolution(
                idx=F.pad(sol.idx, (0, pad), value=sol.m),
                val=F.pad(sol.val, (0, pad)),
                mask=F.pad(sol.mask, (0, pad)), m=sol.m)
        return sol
    return batch(gomp, l=l, k=k, max_residual=max_residual)(A, Bs)


def sp_batch(A, Bs, k, delta: float = 1e-12, maxiter=None, precision=None):
    """Batched subspace pursuit over measurement rows Bs (B, n).

    On CUDA this runs the select_topl and sp_round kernels (2k slots: the
    kept block's exact inverse, the acquired block by its Schur
    complement). `precision` as in omp_batch. Otherwise the rows run
    through the per-instance `sp`.
    """
    A = torch.as_tensor(A)
    Bs = torch.as_tensor(Bs)
    if (_kernels_ok(A, Bs, precision)
            and fused_twostage.supported_sp(A, Bs, int(k), _cdt(precision))):
        sol, _ = fused_twostage.sp_fused_solve(A, Bs, int(k), delta, maxiter,
                                               corr_dtype=_cdt(precision))
        return sol
    return batch(sp, k=k, delta=delta, maxiter=maxiter)(A, Bs)


def srr_batch(A, Bs, k: int, delta: float = 1e-12, maxiter=None,
              l: int = 1, initialization: int = 1, precision=None):
    """Batched stepwise regression with replacement over rows Bs (B, n).

    On CUDA with the default oblivious initialization this runs the
    engine kernels (forward OLS steps and backward deletions, the
    rescaling kept through both). `precision` as in omp_batch. Other
    initializations, and shapes the kernels do not take, run the rows
    through the per-instance `srr`.
    """
    A = torch.as_tensor(A)
    Bs = torch.as_tensor(Bs)
    if (_kernels_ok(A, Bs, precision) and initialization == 1
            and fused_twostage.supported_srr(A, Bs, int(k), int(l),
                                             _cdt(precision))):
        sol, _ = fused_twostage.srr_fused_solve(
            A, Bs, int(k), delta, maxiter, int(l), corr_dtype=_cdt(precision))
        return sol
    return batch(srr, k=k, delta=delta, maxiter=maxiter,
                 initialization=initialization, l=l)(A, Bs)


def ompr_batch(A, Bs, k: int, delta: float, eta: float = 1.0,
               maxiter=None, precision=None):
    """Batched OMP with replacement over measurement rows Bs (B, n).

    On CUDA this runs the engine kernels (the passive-atom select with the
    active mask, the gradient step, the Schur-downdate delete).
    `precision` as in omp_batch. Otherwise the rows run through the
    per-instance `ompr`.
    """
    A = torch.as_tensor(A)
    Bs = torch.as_tensor(Bs)
    if (_kernels_ok(A, Bs, precision)
            and fused_twostage.supported_ompr(A, Bs, int(k),
                                              _cdt(precision))):
        sol, _ = fused_twostage.ompr_fused_solve(
            A, Bs, int(k), delta, eta, maxiter, corr_dtype=_cdt(precision))
        return sol
    return batch(ompr, k=k, delta=delta, eta=eta, maxiter=maxiter)(A, Bs)
