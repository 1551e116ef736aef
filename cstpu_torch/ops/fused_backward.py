"""Batched backward elimination on hand-written CUDA kernels (PyTorch
counterpart of cstpu.ops.fused_backward): FBR and LACE.

The backward family starts from the full least-squares solution and
deletes atoms one at a time. The O(m^3) init (the Cholesky inverse of A'A,
shared by the batch, and the full LS coefficients) and the exact final
refit are torch products, as cstpu leaves them to XLA; the deletion loop
is cstpu's `_bw_kernel`. That kernel keeps one instance's (m, m) Gram
inverse in VMEM for all deletions. Here every row's private inverse stays
in device memory, (B, m, m) f32, and a deletion step is two launches
(cstpu_torch/csrc):

  bw_select    per row: the scores coef^2 / diag, the masked argmin (FBR:
               the score, LACE: |coef|), the accept test with the fail
               latch, the staging of row p and column p of the inverse as
               they were, and the coef, diag, alive and ||r||^2 updates
  bw_downdate  the rank-one Schur downdate G -= gcol (g ginvs)' of every
               row that stepped, tiled over the matrices

The step loop runs on the host, up to m - sparsity steps, and reads the
"some row still running" latch every CHECK_EVERY steps; a row that has
stopped is skipped by both kernels, and a rejected step (ginvs = 0) leaves
a finite state exactly as it was. Everything is true f32: no TF32, pinned
around the init and the refit whatever the caller's global setting.

Each kernel has its plain PyTorch version beside it (`_bw_select_ref`,
`_bw_downdate_ref`), which makes the same roundings, one per tensor
operation; each `*_fused_solve_ref` is the whole solve on them. A wrapper
runs the plain version only for tensors on the CPU; on CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cstpu_torch.ops import _build
from cstpu_torch.ops.fused_solve import (
    _F32, INT_MAX, LAUNCHES, _expect, _f32, _on_cpu, _stream)
from cstpu_torch.ops.util import cholesky_nan, true_f32
from cstpu_torch.utils.sparse import SparseSolution

LAUNCHES.update(bw_select=0, bw_downdate=0)

CHECK_EVERY = 32          # deletion steps between two reads of the latch
STATE_BYTES_MAX = 2 << 30  # most bytes of the (B, m, m) f32 state


class _BwState(NamedTuple):
    """State of the deletion loop (cstpu's `_bw_kernel` scratch, per row)."""
    G: torch.Tensor       # (B, m, m) f32 private Gram inverses
    coef: torch.Tensor    # (B, m) f32
    diag: torch.Tensor    # (B, m) f32 diag(G), kept incrementally
    alive: torch.Tensor   # (B, m) f32, 1 on atoms not deleted
    nr2: torch.Tensor     # (B,) f32 ||r||^2 by the Schur identity
    run: torch.Tensor     # (B,) f32 latch, 0 once a step was rejected
    failed: torch.Tensor  # (B,) f32 instability latch
    g: torch.Tensor       # (B, m) f32 staged row p of G
    gcol: torch.Tensor    # (B, m) f32 staged column p of G
    sc: torch.Tensor      # (B, 2) f32 (ginvs, stepped in the last select)


def _bw_init(A, Bs) -> _BwState:
    """The full-LS init (`_bw_fused_call` :170-181): one Cholesky inverse of
    A'A for the batch, symmetrised, the coefficients and ||r0||^2."""
    B = Bs.shape[0]
    m = A.shape[1]
    A = A.to(torch.float32)
    Bs = Bs.to(torch.float32)
    dev = Bs.device
    with true_f32():
        L = cholesky_nan(A.T @ A)
        AAinv = torch.cholesky_solve(torch.eye(m, device=dev), L)
        AAinv = 0.5 * (AAinv + AAinv.T)
        coef0 = (Bs @ A) @ AAinv
        r0 = Bs - coef0 @ A.T

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return _BwState(
        G=AAinv[None].repeat(B, 1, 1), coef=coef0.contiguous(),
        diag=torch.diagonal(AAinv)[None].repeat(B, 1),
        alive=torch.ones((B, m), device=dev),
        nr2=torch.sum(r0 * r0, dim=1), run=torch.ones((B,), device=dev),
        failed=zeros(B), g=zeros(B, m), gcol=zeros(B, m), sc=zeros(B, 2))


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _bw_select_ref(st: _BwState, max_eps2: float, max_delta2: float,
                   select_abs: bool):
    """Plain bw_select: the body of `_bw_kernel` (:79-146) but its (m, m)
    update, on the rows that are still running, in place."""
    B, m = st.coef.shape
    dev = st.coef.device
    act = st.run > 0.5
    live = st.alive > 0
    d2 = torch.where(live, st.coef * st.coef / st.diag, torch.inf)
    sel = torch.where(live, torch.abs(st.coef), torch.inf) if select_abs \
        else d2
    cols = torch.arange(m, device=dev)
    minv = sel.amin(dim=1, keepdim=True)
    p = torch.where(sel == minv, cols, INT_MAX).amin(dim=1)
    valid = p < m
    pc = p.clamp(max=m - 1)
    rows = torch.arange(B, device=dev)
    d2p = torch.where(valid, d2[rows, pc], 0.0)
    gpp = torch.where(valid, st.diag[rows, pc], 0.0)
    coefp = torch.where(valid, st.coef[rows, pc], 0.0)
    tot = d2p + st.nr2
    fail = ~(tot >= 0) | ~valid
    newnr2 = torch.clamp(tot, min=0)
    acc = (act & valid & ~fail & (newnr2 < _f32(max_eps2))
           & (d2p < _f32(max_delta2)))
    accf = acc.float()
    ginvs = accf / torch.where(gpp != 0, gpp, 1.0)
    g = st.G[rows, pc, :]
    gcol = st.G[rows, :, pc]
    hit = (cols[None, :] == p[:, None]).float() * accf[:, None]
    keep = 1.0 - hit
    a2 = act[:, None]
    st.coef.copy_(torch.where(
        a2, (st.coef - g * (coefp * ginvs)[:, None]) * keep, st.coef))
    st.diag.copy_(torch.where(
        a2, (st.diag - g * g * ginvs[:, None]) * keep + hit, st.diag))
    st.alive.copy_(torch.where(a2, st.alive * keep, st.alive))
    st.g.copy_(torch.where(a2, g, st.g))
    st.gcol.copy_(torch.where(a2, gcol, st.gcol))
    st.failed.copy_(torch.maximum(st.failed, (fail & act).float()))
    st.nr2.copy_(torch.where(acc, newnr2, st.nr2))
    st.run.copy_(accf)
    st.sc[:, 0] = torch.where(act, ginvs, st.sc[:, 0])
    st.sc[:, 1] = act.float()


def _bw_downdate_ref(st: _BwState):
    """Plain bw_downdate: G -= gcol (g ginvs)' on the rows that stepped."""
    upd = st.gcol[:, :, None] * (st.g * st.sc[:, :1])[:, None, :]
    act = st.sc[:, 1] > 0.5
    if bool(act.all()):
        st.G.sub_(upd)
    else:
        st.G.copy_(torch.where(act[:, None, None], st.G - upd, st.G))


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _expect_bw(name: str, st: _BwState):
    B, m = st.coef.shape if st.coef.ndim == 2 else (0, 0)
    if m < 4 or m % 4:
        raise ValueError(f"{name}: m={m} must be a positive multiple of 4")
    _expect(name, st.coef.device, (st.G, _F32, (B, m, m)),
            (st.coef, _F32, (B, m)), (st.diag, _F32, (B, m)),
            (st.alive, _F32, (B, m)), (st.nr2, _F32, (B,)),
            (st.run, _F32, (B,)), (st.failed, _F32, (B,)),
            (st.g, _F32, (B, m)), (st.gcol, _F32, (B, m)),
            (st.sc, _F32, (B, 2)))
    return B, m


def bw_select(st: _BwState, max_eps2: float, max_delta2: float,
              select_abs: bool):
    """The selection of one deletion step, updating `st` in place (all but
    G). On CUDA tensors this launches csrc/bw_select.cu."""
    if _on_cpu(*st):
        return _bw_select_ref(st, max_eps2, max_delta2, select_abs)
    B, m = _expect_bw("bw_select", st)
    lib = _build.load()
    with torch.cuda.device(st.coef.device):
        err = lib.cstpu_bw_select(
            st.G.data_ptr(), st.coef.data_ptr(), st.diag.data_ptr(),
            st.alive.data_ptr(), st.nr2.data_ptr(), st.run.data_ptr(),
            st.failed.data_ptr(), st.g.data_ptr(), st.gcol.data_ptr(),
            st.sc.data_ptr(), B, m, float(max_eps2), float(max_delta2),
            int(bool(select_abs)), _stream())
    _build.check(err, "cstpu_bw_select")
    LAUNCHES["bw_select"] += 1


def bw_downdate(st: _BwState):
    """The Schur downdate of one deletion step, updating st.G in place from
    what bw_select staged. On CUDA tensors this launches
    csrc/bw_downdate.cu."""
    if _on_cpu(*st):
        return _bw_downdate_ref(st)
    B, m = _expect_bw("bw_downdate", st)
    lib = _build.load()
    with torch.cuda.device(st.coef.device):
        err = lib.cstpu_bw_downdate(
            st.G.data_ptr(), st.g.data_ptr(), st.gcol.data_ptr(),
            st.sc.data_ptr(), B, m, _stream())
    _build.check(err, "cstpu_bw_downdate")
    LAUNCHES["bw_downdate"] += 1


# --------------------------------------------------------------------------
# The solves
# --------------------------------------------------------------------------

def _to_solution(coef, alive, m: int) -> SparseSolution:
    """Dense (B, m) coefficients and alive mask -> SparseSolution of width
    m, slot j = atom j (deleted slots: idx m, val 0)."""
    mask = alive > 0.5
    iota = torch.arange(m, dtype=torch.int32, device=coef.device)
    return SparseSolution(idx=torch.where(mask, iota[None, :], m),
                          val=torch.where(mask, coef, 0.0), mask=mask,
                          m=int(m))


def _exact_refit(A, Bs, coef, alive, failed):
    """Exact LS refit on each row's surviving support (masked normal
    equations, one shared Gram and a Cholesky per row): the returned values
    shed the deletion chain's f32 drift while the support decisions rode
    the maintained inverse. Failed rows keep their drifted values; the flag
    is the contract there."""
    A = A.to(torch.float32)
    Bs = Bs.to(torch.float32)
    with true_f32():
        occ = alive > 0.5
        occf = occ.float()
        Gm = ((A.T @ A)[None] * occf[:, :, None] * occf[:, None, :]
              + torch.diag_embed(1.0 - occf))
        rhs = occf * (Bs @ A)
        sol = torch.cholesky_solve(rhs[:, :, None], cholesky_nan(Gm))[:, :, 0]
    return torch.where(failed[:, None], coef, torch.where(occ, sol, 0.0))


def _bw(A, Bs, sparsity: int, max_residual, max_increase, select_abs: bool,
        select, downdate):
    m = A.shape[1]
    max_eps2 = float(max_residual) ** 2
    max_delta2 = float(max_increase) ** 2
    st = _bw_init(A, Bs)
    nsteps = max(m - int(sparsity), 0)
    t = 0
    while t < nsteps:
        if t and t % CHECK_EVERY == 0 and not bool((st.run.cpu() > 0.5).any()):
            break
        select(st, max_eps2, max_delta2, select_abs)
        downdate(st)
        t += 1
    fail = st.failed > 0.5
    coef = _exact_refit(A, Bs, st.coef, st.alive, fail)
    return _to_solution(coef, st.alive, m), fail, t


def _result(out, return_iters: bool):
    sol, fail, t = out
    return (sol, fail, t) if return_iters else (sol, fail)


def _need_overdetermined(A, what: str):
    n, m = A.shape
    if m > n:
        raise ValueError(f"{what} needs m <= n, got ({n}, {m})")


def fbr_fused_solve(A, Bs, max_residual: float = math.inf,
                    max_increase: float = math.inf, sparsity: int = 0,
                    return_iters: bool = False):
    """Batched fast backward regression on the bw_select and bw_downdate
    kernels. A: (n, m) dictionary, m <= n; Bs: (B, n) measurements.
    Returns (SparseSolution of width m, failed (B,) bool), and with
    return_iters the deletion steps launched; `failed` marks rows whose
    maintained inverse went indefinite or NaN."""
    _need_overdetermined(A, "fast backward regression")
    return _result(_bw(A, Bs, sparsity, max_residual, max_increase, False,
                       bw_select, bw_downdate), return_iters)


def fbr_fused_solve_ref(A, Bs, max_residual: float = math.inf,
                        max_increase: float = math.inf, sparsity: int = 0,
                        return_iters: bool = False):
    """fbr_fused_solve on the plain versions of its kernels."""
    _need_overdetermined(A, "fast backward regression")
    return _result(_bw(A, Bs, sparsity, max_residual, max_increase, False,
                       _bw_select_ref, _bw_downdate_ref), return_iters)


def lace_fused_solve(A, Bs, max_residual: float = math.inf,
                     max_increase: float = math.inf, sparsity: int = 0,
                     return_iters: bool = False):
    """Batched LACE on the same kernels with the min-|coefficient|
    selection. The accept test's increase is the Schur identity
    coef_p^2 / G_pp, equal in exact arithmetic to the per-instance path's
    delete-and-refit increase; near a threshold the two may decide
    differently by rounding. Returns as fbr_fused_solve; a failed row
    stops deleting."""
    _need_overdetermined(A, "LACE")
    return _result(_bw(A, Bs, sparsity, max_residual, max_increase, True,
                       bw_select, bw_downdate), return_iters)


def lace_fused_solve_ref(A, Bs, max_residual: float = math.inf,
                         max_increase: float = math.inf, sparsity: int = 0,
                         return_iters: bool = False):
    """lace_fused_solve on the plain versions of its kernels."""
    _need_overdetermined(A, "LACE")
    return _result(_bw(A, Bs, sparsity, max_residual, max_increase, True,
                       _bw_select_ref, _bw_downdate_ref), return_iters)


def supported_backward(A, Bs) -> bool:
    """Shape gate of the deletion kernels: an f32 dictionary with m <= n
    and m a multiple of 4 (bw_downdate's float4 rows), 2-D measurements,
    and the (B, m, m) f32 state within STATE_BYTES_MAX (the exact refit
    holds two more arrays of that size for a moment)."""
    n, m = A.shape
    if (A.dtype != torch.float32 or Bs.ndim != 2 or Bs.shape[1] != n
            or Bs.shape[0] < 1 or m > n or m < 4 or m % 4):
        return False
    return Bs.shape[0] * m * m * 4 <= STATE_BYTES_MAX
