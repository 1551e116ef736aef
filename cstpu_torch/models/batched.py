"""Batched-first entry points (PyTorch counterpart of the OMP part of
cstpu.models.batched).

A shared dictionary with a batch of measurements is the high-throughput
workload. On CUDA, `omp_batch` runs the select and append kernels of
cstpu_torch.ops.fused_solve; elsewhere, and for options the kernels do not
serve, it runs the per-instance `omp` over the rows.
"""

from __future__ import annotations

import torch

from cstpu_torch.models.matching_pursuit import omp
from cstpu_torch.ops import fused_solve
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
    fused_ok = (
        precision in (None, "bf16", "f32")
        and float(max_residual) == 0.0
        and A.dtype == torch.float32
        and Bs.ndim == 2
        and A.is_cuda
    )
    if fused_ok:
        cdt = _cdt(precision)
        if fused_solve.supported(A, Bs, kk, cdt):
            sol, _ = fused_solve.omp_fused_solve(A, Bs, kk, corr_dtype=cdt)
            return sol
        if fused_solve.supported_stream(A, Bs, kk, cdt):
            # dictionary beyond the L2 cache: streamed from device memory
            sol, _ = fused_solve.omp_stream_solve(A, Bs, kk, corr_dtype=cdt)
            return sol
    return batch(omp, k=k, max_residual=max_residual)(A, Bs)
