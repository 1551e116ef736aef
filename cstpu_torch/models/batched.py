"""Batched-first entry points (PyTorch counterpart of cstpu.models.batched:
the greedy, two-stage, stepwise, backward and SBL entry points).

A shared dictionary with a batch of measurements is the high-throughput
workload. On CUDA, `omp_batch`, `mp_batch`, `gomp_batch` and `fr_batch` run
the kernels of cstpu_torch.ops.fused_solve, `sp_batch`, `ompr_batch`,
`srr_batch`, `rmp_batch` and `foba_batch` those of
cstpu_torch.ops.fused_twostage, and `fbr_batch` and `lace_batch` those of
cstpu_torch.ops.fused_backward. For CPU tensors, and for options or shapes
the kernels do not serve, they run the solver's batched body over all the
rows at once (`_omp_rows`, `_fr_rows`, ... of cstpu_torch.models: one
program for the batch with vmap's semantics, where cstpu runs `vmap`),
never a loop over rows; `br_batch` always does. Tensors are solved where
they lie; inputs that are not tensors (numpy arrays, lists) go to the
card, and without one that raises: a CPU run is asked for with CPU
tensors.

Between the two lies cstpu's middle route: where a solver's own kernel gate
fails (k beyond the append kernels' 128 slots, a top-k beyond select_topl's
32 picks) and the streaming gate `stream_select.supported_select` passes,
`fr_batch`, `mp_batch`, `sp_batch`, `gomp_batch`, `srr_batch` and
`ompr_batch` run the column-sharded solver of cstpu_torch.parallel.sharded
on a one-shard mesh on the dictionary's device (CUDA only), instead of the
batched body.

The SBL family has no kernel. `fsbl_batch` and `rmps_batch` take the
atom-sharded solvers of cstpu_torch.parallel.sharded_sbl on a one-shard
mesh under cstpu's gate read for CUDA (CUDA tensors, a float32 dictionary,
2-D measurements, a scalar or (n, n) noise; for `rmps_batch` only the
sharded solver's keyword arguments); everything else, and `sbl_batch` and
`rmps_estimate_noise_batch` on either device, runs the batched bodies of
cstpu_torch.models.sbl, never the loop over rows.

`batch(solver, **fixed)` maps the package's own solvers to their bodies;
any other callable it runs once a row.
"""

from __future__ import annotations

import torch

from cstpu_torch.models.backward import (_br_rows, _fbr_rows, _lace_rows, br,
                                         fbr, lace)
from cstpu_torch.models.forward import _fr_rows, fr
from cstpu_torch.models import sbl
from cstpu_torch.models.matching_pursuit import (
    _gomp_rows, _mp_rows, _oblivious_rows, _omp_rows, gomp, mp, oblivious,
    omp)
from cstpu_torch.models.stepwise import _foba_rows, _rmp_rows, foba, rmp
from cstpu_torch.models.twostage import (_ompr_rows, _sp_rows, _srr_rows,
                                         ompr, sp, srr)
from functools import lru_cache

from cstpu_torch.ops import fused_backward, fused_solve, fused_twostage
from cstpu_torch.ops import stream_select
from cstpu_torch.ops.util import as_inputs as _inputs, true_f32
from cstpu_torch.parallel import sharded, sharded_sbl
from cstpu_torch.parallel.mesh import Mesh
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


def _fbr_rows_out(A, Bs, return_failed: bool = False, **kw):
    """`fbr`'s body with fbr's `return_failed` switch."""
    sol, failed = _fbr_rows(A, Bs, **kw)
    return (sol, failed) if return_failed else sol


# the package's per-instance solvers and their batched bodies, which take
# (A, Bs) and the solver's keyword arguments
_BODIES = {omp: _omp_rows, mp: _mp_rows, gomp: _gomp_rows,
           oblivious: _oblivious_rows, fr: _fr_rows, sp: _sp_rows,
           ompr: _ompr_rows, srr: _srr_rows, rmp: _rmp_rows,
           foba: _foba_rows, br: _br_rows, fbr: _fbr_rows_out,
           lace: _lace_rows, sbl.sbl: sbl._sbl_rows,
           sbl.rmps: sbl._rmps_rows,
           sbl.fsbl: lambda A, Bs, *a, **kw: sbl._fsbl_rows(A, Bs, *a,
                                                           **kw)[0]}


def batch(solver, **fixed):
    """Solve every row of Bs with `solver(A, b, ...)` and stack the
    results.

    Example: `batch(omp, k=8)(A, Bs)` solves all rows of Bs. A solver of
    this package (omp, mp, gomp, oblivious, fr and its aliases, sp, ompr,
    srr, rmp, foba, br, fbr, lace, sbl, fsbl, rmps) runs as its batched
    body, one
    program for all the rows with vmap's semantics. Any other callable
    runs once a row: torch cannot vmap a loop that reads the device.
    """
    body = _BODIES.get(solver)

    def batched(A, Bs, **kw):
        A, Bs = _inputs(A, Bs)
        merged = {**fixed, **kw}
        if body is not None:
            return body(A, Bs, **merged)
        return _stack([solver(A, bb, **merged) for bb in Bs])
    return batched


def _cdt(precision):
    """Correlation dtype for a `precision` option (None/'bf16' -> bf16)."""
    return torch.float32 if precision == "f32" else torch.bfloat16


def _kernels_ok(A, Bs, precision) -> bool:
    """The option, dtype and device conditions every kernel path shares:
    a kernel precision, a float32 dictionary, 2-D measurements, CUDA."""
    return (precision in (None, "bf16", "f32") and A.dtype == torch.float32
            and Bs.ndim == 2 and _on_card(A, Bs))


def _on_card(A, Bs) -> bool:
    return A.is_cuda and Bs.is_cuda


@lru_cache(maxsize=8)
def _one_shard_mesh(device) -> Mesh:
    """The trivial (1, 1) mesh on `device`: lets the entry points use the
    sharded solvers, whose results do not depend on the shard count, as the
    path for shapes beyond their own kernels' gates."""
    return Mesh(((device,),))


def _stream_ok(A, Bs, precision) -> bool:
    """Gate of the middle route: the conditions of every kernel path, and a
    streamable tile at the width of the dtype the dictionary is streamed
    in."""
    return (_kernels_ok(A, Bs, precision)
            and stream_select.supported_select(A, Bs.shape[0],
                                               _cdt(precision)))


def omp_batch(A, Bs, k=None, max_residual: float = 0.0, precision=None):
    """Batched OMP over measurement rows Bs (B, n).

    With a float32 dictionary on CUDA and a fixed step count
    (max_residual == 0) this runs the select and append kernels.
    `precision` picks the dictionary dtype inside them: None/'bf16'
    (default) or 'f32' (true f32, no TF32); 'highest' takes the
    batched body in true f32. Everything else (inverse Gram,
    coefficients, residual) is f32. Otherwise, or for shapes the kernels
    do not take, the batched body `_omp_rows` solves all the rows.
    """
    A, Bs = _inputs(A, Bs)
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
    if precision == "highest":
        with true_f32():
            return _omp_rows(A, Bs, k, max_residual)
    return _omp_rows(A, Bs, k, max_residual)


def fr_batch(A, Bs, max_residual: float = 0.0, min_decrease: float = 0.0,
             sparsity=None, precision=None):
    """Batched forward regression over measurement rows Bs (B, n).

    With a sparsity cap, on CUDA, this runs the fr_select and fr_append
    kernels: the OLS rescaling is kept order-recursively instead of being
    re-derived from a (k x m) product per step. `precision` as in
    omp_batch. Otherwise the batched body `_fr_rows` solves all the rows.
    """
    A, Bs = _inputs(A, Bs)
    if (_kernels_ok(A, Bs, precision) and sparsity is not None
            and fused_solve.supported_fr(A, Bs, int(sparsity),
                                         _cdt(precision))):
        sol, _ = fused_solve.fr_fused_solve(
            A, Bs, int(sparsity), max_residual, min_decrease,
            corr_dtype=_cdt(precision))
        return sol
    if sparsity is not None and _stream_ok(A, Bs, precision):
        return sharded.fr_sharded_fused(
            A, Bs, int(sparsity), _one_shard_mesh(A.device), max_residual,
            min_decrease, corr_dtype=_cdt(precision))
    return _fr_rows(A, Bs, max_residual, min_decrease, sparsity)


def mp_batch(A, Bs, k: int, precision=None):
    """Batched matching pursuit; returns the dense solutions (B, m).

    On CUDA this runs the signed select and the mp_update kernel;
    otherwise the batched body `_mp_rows`.
    """
    A, Bs = _inputs(A, Bs)
    if _kernels_ok(A, Bs, precision) and fused_solve.supported_mp(A, Bs):
        x, _ = fused_solve.mp_fused_solve(A, Bs, int(k),
                                          corr_dtype=_cdt(precision))
        return x
    if _stream_ok(A, Bs, precision):
        return sharded.mp_sharded_fused(A, Bs, int(k),
                                        _one_shard_mesh(A.device),
                                        corr_dtype=_cdt(precision))
    return _mp_rows(A, Bs, k)


def gomp_batch(A, Bs, l, k=None, max_residual: float = 0.0, precision=None):
    """Batched generalized OMP over measurement rows Bs (B, n).

    On CUDA this runs the select_topl and gomp_append kernels (top-l
    acquisitions per iteration). `precision` as in omp_batch. Otherwise
    the batched body `_gomp_rows`. The slot width is min(k, m) on every
    path.
    """
    A, Bs = _inputs(A, Bs)
    kk = int(min(k if k is not None else A.shape[1], A.shape[1]))
    if (_kernels_ok(A, Bs, precision)
            and fused_solve.supported_gomp(A, Bs, int(l), kk)):
        sol, _ = fused_solve.gomp_fused_solve(A, Bs, int(l), kk,
                                              max_residual,
                                              corr_dtype=_cdt(precision))
        # the kernel path clamps its slot width to min(kk, n); pad back to
        # the batched body's width, so that the returned width does
        # not depend on the path
        pad = kk - sol.idx.shape[1]
        if pad > 0:
            F = torch.nn.functional
            sol = SparseSolution(
                idx=F.pad(sol.idx, (0, pad), value=sol.m),
                val=F.pad(sol.val, (0, pad)),
                mask=F.pad(sol.mask, (0, pad)), m=sol.m)
        return sol
    if _stream_ok(A, Bs, precision):
        return sharded.gomp_sharded_fused(
            A, Bs, int(l), kk, _one_shard_mesh(A.device), max_residual,
            corr_dtype=_cdt(precision))
    return _gomp_rows(A, Bs, l, k, max_residual)


def sp_batch(A, Bs, k, delta: float = 1e-12, maxiter=None, precision=None):
    """Batched subspace pursuit over measurement rows Bs (B, n).

    On CUDA this runs the select_topl and sp_round kernels (2k slots: the
    kept block's exact inverse, the acquired block by its Schur
    complement). `precision` as in omp_batch. Otherwise the batched body
    `_sp_rows`.
    """
    A, Bs = _inputs(A, Bs)
    if (_kernels_ok(A, Bs, precision)
            and fused_twostage.supported_sp(A, Bs, int(k), _cdt(precision))):
        sol, _ = fused_twostage.sp_fused_solve(A, Bs, int(k), delta, maxiter,
                                               corr_dtype=_cdt(precision))
        return sol
    if _stream_ok(A, Bs, precision):
        return sharded.sp_sharded_fused(
            A, Bs, int(k), _one_shard_mesh(A.device), delta, maxiter,
            corr_dtype=_cdt(precision))
    return _sp_rows(A, Bs, k, delta, maxiter)


def srr_batch(A, Bs, k: int, delta: float = 1e-12, maxiter=None,
              l: int = 1, initialization: int = 1, precision=None):
    """Batched stepwise regression with replacement over rows Bs (B, n).

    On CUDA with the default oblivious initialization this runs the
    engine kernels (forward OLS steps and backward deletions, the
    rescaling kept through both). `precision` as in omp_batch. Other
    initializations, and shapes the kernels do not take, run the batched
    body `_srr_rows`.
    """
    A, Bs = _inputs(A, Bs)
    if (_kernels_ok(A, Bs, precision) and initialization == 1
            and fused_twostage.supported_srr(A, Bs, int(k), int(l),
                                             _cdt(precision))):
        sol, _ = fused_twostage.srr_fused_solve(
            A, Bs, int(k), delta, maxiter, int(l), corr_dtype=_cdt(precision))
        return sol
    if initialization == 1 and int(l) == 1 and _stream_ok(A, Bs, precision):
        return sharded.srr_sharded_fused(
            A, Bs, int(k), _one_shard_mesh(A.device), delta, maxiter,
            corr_dtype=_cdt(precision))
    return _srr_rows(A, Bs, k, delta, maxiter, initialization, l)


def ompr_batch(A, Bs, k: int, delta: float, eta: float = 1.0,
               maxiter=None, precision=None):
    """Batched OMP with replacement over measurement rows Bs (B, n).

    On CUDA this runs the engine kernels (the passive-atom select with the
    active mask, the gradient step, the Schur-downdate delete).
    `precision` as in omp_batch. Otherwise the batched body `_ompr_rows`.
    """
    A, Bs = _inputs(A, Bs)
    if (_kernels_ok(A, Bs, precision)
            and fused_twostage.supported_ompr(A, Bs, int(k),
                                              _cdt(precision))):
        sol, _ = fused_twostage.ompr_fused_solve(
            A, Bs, int(k), delta, eta, maxiter, corr_dtype=_cdt(precision))
        return sol
    if _stream_ok(A, Bs, precision):
        return sharded.ompr_sharded_fused(
            A, Bs, int(k), _one_shard_mesh(A.device), delta, eta, maxiter,
            corr_dtype=_cdt(precision))
    return _ompr_rows(A, Bs, k, delta, eta, maxiter)


def _merge_solution_rows(sol, redo, rows, m: int):
    """`sol` (batched SparseSolution) with its `rows` replaced by the rows
    of `redo`, both padded to the wider slot width (idx m, val 0, mask
    False)."""
    def pad_to(x, w):
        pad = w - x.idx.shape[1]
        if pad <= 0:
            return x
        F = torch.nn.functional
        return SparseSolution(idx=F.pad(x.idx, (0, pad), value=m),
                              val=F.pad(x.val, (0, pad)),
                              mask=F.pad(x.mask, (0, pad)), m=m)

    w = max(sol.idx.shape[1], redo.idx.shape[1])
    sol, redo = pad_to(sol, w), pad_to(redo, w)
    out = [x.clone() for x in (sol.idx, sol.val, sol.mask)]
    for dst, src in zip(out, (redo.idx, redo.val, redo.mask)):
        dst[rows] = src.to(dst.dtype)
    return SparseSolution(idx=out[0], val=out[1], mask=out[2], m=m)


def _resolve_capped(sol, capped, A, Bs, solver):
    """The rows the kernels report as capped (their forward stage wanted
    an atom beyond the kmax slots) solved again, all in one call of the
    uncapped batched body `solver`, and merged in, so that the cap never
    changes a result."""
    rows = torch.nonzero(capped)[:, 0]
    if rows.numel() == 0:
        return sol
    return _merge_solution_rows(sol, solver(A, Bs[rows]), rows, A.shape[1])


def rmp_batch(A, Bs, k=None, delta=None, maxiter: int = 1, kmax: int = 32,
              precision=None):
    """Batched RMP over measurement rows Bs (B, n); exactly one of k and
    delta.

    On CUDA both variants run the RMP kernels with a `kmax`-slot active
    set; rows whose forward stage outgrows the cap are reported by the
    kernels and solved again by the batched body `_rmp_rows`, so the cap
    only decides where the work is done. (The k variant's forward stage
    runs to exhaustion: where that support exceeds kmax the body does the
    work; raise kmax to keep it on the kernels.) `precision` as in
    omp_batch. Otherwise the body solves all the rows.
    """
    if (k is None) == (delta is None):
        raise ValueError("specify exactly one of k or delta")
    A, Bs = _inputs(A, Bs)
    def each(A_, Bs_):
        return _rmp_rows(A_, Bs_, k, delta, maxiter)
    if (_kernels_ok(A, Bs, precision) and (k is None or int(k) <= int(kmax))
            and fused_twostage.supported_rmp(A, Bs, int(kmax),
                                             _cdt(precision))):
        sol, _, capped = fused_twostage.rmp_fused_solve(
            A, Bs, k=k, delta=delta, maxiter=maxiter, kmax=int(kmax),
            corr_dtype=_cdt(precision))
        return _resolve_capped(sol, capped, A, Bs, each)
    return each(A, Bs)


def foba_batch(A, Bs, delta: float, kmax: int = 32, precision=None):
    """Batched FoBa over measurement rows Bs (B, n).

    On CUDA this runs the FoBa kernels (per iteration a forward step and
    the deletions its gain allows), with rmp_batch's kmax cap and
    re-solve of capped rows. Otherwise the batched body `_foba_rows`.
    """
    A, Bs = _inputs(A, Bs)
    def each(A_, Bs_):
        return _foba_rows(A_, Bs_, delta)
    if (_kernels_ok(A, Bs, precision)
            and fused_twostage.supported_rmp(A, Bs, int(kmax),
                                             _cdt(precision))):
        sol, _, capped = fused_twostage.foba_fused_solve(
            A, Bs, delta, kmax=int(kmax), corr_dtype=_cdt(precision))
        return _resolve_capped(sol, capped, A, Bs, each)
    return each(A, Bs)


def _stops(max_residual, max_increase) -> dict:
    """The stopping thresholds that were given (None: the solver's own
    default, no bound)."""
    given = {"max_residual": max_residual, "max_increase": max_increase}
    return {key: v for key, v in given.items() if v is not None}


def br_batch(A, Bs, max_residual=None, max_increase=None, sparsity: int = 0,
             naive: bool = False):
    """Batched backward regression: the batched body `_br_rows` (BR
    re-solves its state at every deletion; it has no kernel path)."""
    A, Bs = _inputs(A, Bs)
    return _br_rows(A, Bs, sparsity=sparsity, naive=naive,
                    **_stops(max_residual, max_increase))


def _unpack_failed(out, return_failed: bool):
    sol, failed = out
    return (sol, failed) if return_failed else sol


def fbr_batch(A, Bs, max_residual=None, max_increase=None, sparsity: int = 0,
              return_failed: bool = False):
    """Batched fast backward regression. With `return_failed=True` also
    returns the per-row (B,) instability flags.

    On CUDA this runs the deletion kernels of
    cstpu_torch.ops.fused_backward: the Gram inverse is factorized once
    for the batch, and every row downdates its own copy. Otherwise the
    batched body `_fbr_rows`.
    """
    A, Bs = _inputs(A, Bs)
    kw = _stops(max_residual, max_increase)
    if _on_card(A, Bs) and fused_backward.supported_backward(A, Bs):
        out = fused_backward.fbr_fused_solve(A, Bs, sparsity=sparsity, **kw)
    else:
        out = _fbr_rows(A, Bs, sparsity=sparsity, **kw)
    return _unpack_failed(out, return_failed)


def lace_batch(A, Bs, max_residual=None, max_increase=None,
               sparsity: int = 0, return_failed: bool = False):
    """Batched LACE. On CUDA this runs the deletion kernels with the
    min-|coefficient| selection (cstpu_torch.ops.fused_backward); otherwise
    the batched body `_lace_rows`.

    With `return_failed=True` also returns per-row (B,) flags that mean
    "numerical instability was met while solving this row" on both paths:
    the kernels' downdate guard (the row stops deleting), or, on the
    batched body, whose refits are exact solves with no tracked
    factor to go indefinite, a non-finite active coefficient.
    """
    A, Bs = _inputs(A, Bs)
    kw = _stops(max_residual, max_increase)
    if _on_card(A, Bs) and fused_backward.supported_backward(A, Bs):
        out = fused_backward.lace_fused_solve(A, Bs, sparsity=sparsity, **kw)
    else:
        sol = _lace_rows(A, Bs, sparsity=sparsity, **kw)
        out = sol, torch.any(~torch.isfinite(sol.val) & sol.mask, dim=-1)
    return _unpack_failed(out, return_failed)


# --------------------------------------------------------------------------
# The SBL family
# --------------------------------------------------------------------------

def _sbl_shard_ok(A, Bs, sigma) -> bool:
    """cstpu's gate of the atom-sharded SBL route, read for CUDA: tensors on
    the card, a float32 dictionary, 2-D measurements, a scalar or (n, n)
    noise."""
    return (_on_card(A, Bs) and A.dtype == torch.float32 and Bs.ndim == 2
            and torch.as_tensor(sigma).ndim in (0, 2))


def sbl_batch(A, Bs, sigma, maxiter=None, min_change: float = 1e-6):
    """Batched Tipping-EM SBL over measurement rows Bs (B, n): the batched
    EM body of cstpu_torch.models.sbl on either device (the family's
    parity baseline; throughput lives in fsbl_batch/rmps_batch)."""
    A, Bs = _inputs(A, Bs)
    return sbl._sbl_rows(A, Bs, sigma, maxiter, min_change)


def rmps_batch(A, Bs, sigma, **kw):
    """Batched RMPS over measurement rows Bs (B, n); dense (B, m) out.

    On CUDA, with a float32 dictionary, a scalar or (n, n) noise and only
    the keyword arguments the sharded solver takes, this runs the
    atom-sharded RMPS (cstpu_torch.parallel.sharded_sbl) on a one-shard
    mesh: the same staged ascent, with the posterior mean from
    mu = Gamma A' C^-1 b instead of an (m, m) build. Otherwise the batched
    single-device body of cstpu_torch.models.sbl.
    """
    A, Bs = _inputs(A, Bs)
    shard_kw = {k_: v for k_, v in kw.items()
                if k_ in ("maxiter", "maxiter_acquisition",
                          "maxiter_deletion", "min_increase")}
    if _sbl_shard_ok(A, Bs, sigma) and shard_kw == kw:
        return sharded_sbl.rmps_sharded(A, Bs, sigma,
                                        _one_shard_mesh(A.device), **kw)
    return sbl._rmps_rows(A, Bs, sigma, **kw)


def rmps_estimate_noise_batch(A, Bs, sigma2_init: float = 1e-2,
                              a_sigma2: float = 0.0, b_sigma2: float = 0.0,
                              maxiter=None, min_increase: float = 1e-6,
                              maxouteriter: int = 16,
                              min_change: float = 1e-12):
    """Batched RMPS noise-variance learning over measurement rows Bs
    (B, n): the outer EM loop re-estimating sigma^2 per row under an
    Inverse-Gamma(a, b) prior. A row that converged leaves the batch, so
    later EM iterations solve only the rows still running.
    Returns (X (B, m), sigma2 (B,))."""
    A, Bs = _inputs(A, Bs)
    return sbl._rmps_noise_rows(A, Bs, sigma2_init, a_sigma2, b_sigma2,
                                maxiter, min_increase, maxouteriter,
                                min_change)


def fsbl_batch(A, Bs, sigma, maxiter=None, min_increase: float = 1e-6):
    """Batched fast SBL over measurement rows Bs (B, n); dense (B, m) out.

    On CUDA, with a float32 dictionary and a scalar or (n, n) noise, this
    runs the atom-sharded FSBL on a one-shard mesh (the posterior mean from
    mu = Gamma A' C^-1 b, no (m, m) build); otherwise the batched
    single-device body of cstpu_torch.models.sbl.
    """
    A, Bs = _inputs(A, Bs)
    if _sbl_shard_ok(A, Bs, sigma):
        return sharded_sbl.fsbl_sharded(A, Bs, sigma,
                                        _one_shard_mesh(A.device), maxiter,
                                        min_increase)
    return sbl._fsbl_rows(A, Bs, sigma, maxiter, min_increase)[0]
