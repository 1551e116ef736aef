"""Batched two-stage solvers on hand-written CUDA kernels (PyTorch
counterpart of cstpu.ops.fused_twostage): subspace pursuit (SP), OMP with
replacement (OMPR), stepwise regression with replacement (SRR), relevance
matching pursuit (RMP) and FoBa.

cstpu runs each whole solve in one Pallas launch (`_sp_kernel`,
`_ompr_kernel`, `_srr_kernel`, `_rmp_kernel`, `_foba_kernel`), its outer
loop an in-kernel while loop over a per-row done latch. Here the outer loop runs on the host: after each
outer iteration it reads the done latch (one small device-to-host copy) and
stops when every row is done or maxiter is reached, so the returned
`iters` is cstpu's. Each iteration launches a select kernel, which sweeps
the dictionary, and update kernels, one block per row, or for engine_init,
rmp_append and srr_append a thread-block cluster per row (`_engine_plan`;
ompr_swap `_ompr_plan`; cstpu_torch/csrc):

  SP    select_topl    per-tile top-k of |round_cdt(r) . A|     (B, T, k)
        sp_round       the k acquisitions into slots k..2k-1, the blocks
                       G12, G22, W = Ginv11 G12, S = G22 - G12'W, the S_jj
                       pre-gate, the union coefficients by masked CG, the
                       prune to k, the stability flag, the stable compaction,
                       the exact bordered rebuild of Ginv11 with its pivot
                       rejections, the refit and the latch
  OMPR  select_argmax  with the active mask: where(active, -inf, |eta q|)
        ompr_swap      the gated first-free-slot append, the gradient step
                       from the pre-append coefficients and residual, the
                       delete of the min |coef| slot, the refit, the latch
  SRR   fr_select      the pending rank-one terms into resc, then the OLS
                       score q^2 / resc (active 0, degenerate -inf)
        srr_append     the gated append (residual, gain and size gates), the
                       refit, the append's rescaling term for the next select
        engine_delete  the l backward deletions (min coef^2 / gamma) back to
                       k atoms, each leaving its restore term, and the latch
  init  select_topl + engine_init for OMPR and SRR: the top-k of
        |round_cdt(b) . A| and k gated appends in that order (cstpu's
        `oblivious_init`), the refit and the first residual norm
  RMP   fr_select      as SRR's, from the empty state
        rmp_append     one forward step: the append gated by the exhaustion
                       floor, the gain delta^2 and the size; `capped` where
                       only the K-slot cap stood in the way; run by the
                       host until every row has rejected (one read of the
                       forward gates per step)
        engine_backward  the whole backward stage in one launch, a loop per
                       row (delta variant: while the increase < delta^2; k
                       variant: down to k atoms), and the pass's latch: a
                       row is done when neither stage accepted a step
  FoBa  fr_select + rmp_append with its `foba` flag: the forward step and,
        after an accepted one, the deletions while the increase stays
        below a quarter of the step's gain, in one launch per iteration

OMPR and SRR share cstpu's slot engine (`_Engine`): an append goes to each
row's first free slot, so after deletions the occupied slots need not be
contiguous, and the bordered append's cross terms run over all slots
(csrc/engine_cluster.cuh). A deletion is the Schur downdate Ginv -= q q'/q_p,
which restores the identity pad at slot p. SRR keeps cstpu's rescaling
through appends and deletions; a deletion never reads it, so each term
(u, w) waits in a small pending buffer and the next select applies all of
them, resc_j += w (round_cdt(u) . a_j)^2, in the order cstpu applies
them, in its single pass over A. RMP's and FoBa's backward stages can
leave up to K such terms (slots 1..K of K+1; slot 0 is the append's), each
row its own count, so the select after a stage that deleted d atoms makes
d + 1 passes over A, d the largest count of the batch; the slots a row did
not fill carry weight 0 and add nothing.

SP keeps what `_sp_kernel` decides (acquisition order, pre-gate, CG with
its 8-eps lift and noise-floor exit, prune ties, pivot rejections, the
stability and residual latch) but not its TPU arithmetic routes: the
kept-block inverse is always the exact bordered rebuild (no Newton-Schulz,
no incremental upkeep), the compaction moves columns by index (no one-hot
permutation GEMMs, no f32 index lanes, no m < 2^24 cap), and the CG exits
per row at its own noise floor instead of at the batch's. A row whose
prune keeps its support is left as it was (cstpu rebuilds it unless the
whole batch is stable, to the same support).

Precision is cstpu's: the dictionary and every vector that meets it in a
product (r, aperp, the deletion vectors v) are rounded to `corr_dtype`
(bf16 by default, f32 on request, never TF32); everything else is f32.
Slots come back in engine order and go through `_sorted_solution`.

Every kernel has its plain PyTorch version beside it (`_engine_init_ref`,
`_ompr_swap_ref`, `_srr_append_ref`, `_engine_delete_ref`,
`_sp_round_ref`, `_rmp_append_ref`, `_engine_backward_ref`); each `*_fused_solve_ref` is the whole solve on them. A
wrapper runs the plain version only for tensors on the CPU; on CUDA
tensors it launches its kernel or raises. A row that is done is left
exactly as it is by every kernel and every plain version.
"""

from __future__ import annotations

import ctypes
from functools import partial
from typing import NamedTuple

import torch

from cstpu_torch.ops import _build
from cstpu_torch.ops.fused_solve import (
    _CDTS, _F32, _I32, _U8, KMAX, LAUNCHES, LMAX, SMEM_MAX, TILE,
    _AppendPlan, _bordered_append_ref, _check_cdt, _degeneracy_rtol,
    _expect, _f32,
    _merge_topl_vals, _on_cpu, _prepare, _reduce_partials,
    _rescaled_select_ref, _select_ref, _slot_state, _sorted_solution,
    _stream, _topl_ref, rescaled_select, select_argmax, select_topl)

LAUNCHES.update(engine_init=0, ompr_swap=0, srr_append=0, engine_delete=0,
                sp_round=0, rmp_append=0, engine_backward=0)

EPS8 = 8.0 * 1.1920929e-07   # SP's CG lift and noise floor, 8 f32 ulps


class _EngState(NamedTuple):
    """Slot-engine state of OMPR, SRR, RMP and FoBa (cstpu's `_Engine`
    buffers and the latches of its loops)."""
    cols: torch.Tensor   # (B, K, n) f32, slot s = column of atom idx[s]
    Ginv: torch.Tensor   # (B, K, K) f32, identity on free slots
    coef: torch.Tensor   # (B, K) f32
    idx: torch.Tensor    # (B, K) i32, m on free slots
    Atb: torch.Tensor    # (B, K) f32, a_s . b (0 on free slots)
    r: torch.Tensor      # (B, n) f32 residual
    amask: torch.Tensor  # (B, m) u8, 1 on active atoms
    done: torch.Tensor   # (B,) f32 latch (1 = stopped)
    prev: torch.Tensor   # (B,) f32 ||r||^2 of the last iteration
    resc: torch.Tensor | None = None    # SRR: (B, m) f32 rescalings
    pend_u: torch.Tensor | None = None  # SRR: (P, B, n) f32 pending vectors
    pend_w: torch.Tensor | None = None  # SRR: (P, B) f32 pending weights
    fgate: torch.Tensor | None = None   # SRR: (B,) f32 forward gate
    acc: torch.Tensor | None = None     # RMP: (B,) f32 a step was accepted
    capped: torch.Tensor | None = None  # RMP: (B,) f32 the slot cap hit
    ndel: torch.Tensor | None = None    # RMP: (B,) f32 deletions, last stage


class _SpState(NamedTuple):
    """SP state: slots 0..k-1 the kept block, k..2k-1 the acquired one."""
    cols: torch.Tensor   # (B, 2k, n) f32
    Ginv: torch.Tensor   # (B, k, k) f32 inverse Gram of the kept block
    coef: torch.Tensor   # (B, 2k) f32 (0 on slots k..2k-1)
    idx: torch.Tensor    # (B, 2k) i32, m on empty slots
    Atb: torch.Tensor    # (B, 2k) f32
    r: torch.Tensor      # (B, n) f32
    done: torch.Tensor   # (B,) f32
    prev: torch.Tensor   # (B,) f32


def _engine_smem(n: int, K: int) -> int:
    """Dynamic shared memory, bytes, that the one-block-per-row engine
    kernels of the first port took (the row's column, Ginv and eight K-sized
    arrays). Every engine wrapper admits n and K only where it fits
    SMEM_MAX; the cluster kernels' plans (`_engine_plan`) take any n it
    admits."""
    return (n + K * K + 7 * K) * 4 + K * 4


def _rnorm2(r):
    return torch.sum(r * r, dim=1)


def _live_any(done) -> bool:
    """True while some row is not done: reads the latch to the host."""
    return bool((done.cpu() < 0.5).any())


def _keep_rows(st, live, fn):
    """fn() updates `st` in place on every row; afterwards the rows where
    `live` is False get every field back as it was (the pending terms
    excepted: the callers zero those), so a done row is left exactly as it
    is. Returns fn()'s result."""
    saved = [None if x is None else x.clone() for x in st]
    out = fn()
    for name, x, old in zip(st._fields, st, saved):
        if x is None or name in ("pend_u", "pend_w"):
            continue
        x.copy_(torch.where(live.view(-1, *([1] * (x.ndim - 1))), x, old))
    return out


def _lowest(hit, K: int):
    """Per row the lowest slot where `hit` (B, K) is True, K if none."""
    slots = torch.arange(K, device=hit.device)
    return torch.where(hit, slots, K).amin(dim=1)


# --------------------------------------------------------------------------
# The slot engine, plain (cstpu/ops/fused_twostage.py::_Engine)
# --------------------------------------------------------------------------

def _engine_append_ref(Ac, Bs, st, sel, gate):
    """`_Engine.append`: atom sel (B,) into each row's first free slot,
    gated by gate (B,), the duplicate test, capacity and d > rtol * ata;
    updates Ginv, coef, idx, cols, Atb and amask in place. Returns (ok,
    acol, u, dinv); aperp = acol - cols' u after the append."""
    m = Ac.shape[1]
    K = st.idx.shape[1]
    slot = _lowest(st.idx >= m, K)
    ok, acol, u, dinv = _bordered_append_ref(Ac, Bs, st, sel, slot,
                                             gate & (slot < K))
    et = ((torch.arange(K, device=Bs.device)[None, :] == slot[:, None])
          .float() * ok.float()[:, None])
    st.Atb.add_(torch.sum(acol * Bs, dim=1, keepdim=True) * et)
    rows = torch.nonzero(ok & (sel < m))[:, 0]
    st.amask[rows, sel[rows].long()] = 1
    return ok, acol, u, dinv


def _delete_ep_ref(st, p, hasf, m: int):
    """`_Engine.delete_ep` at slot p (B,) (K: none) where hasf (B,): the
    Schur downdate Ginv -= q q'/q_p + the identity pad at p, and idx, Atb,
    cols and amask cleared there. Returns (v, inv) = (cols' q, hasf/q_p),
    the rescaling restore term resc += inv (v . a_j)^2."""
    K = st.idx.shape[1]
    ep = ((torch.arange(K, device=p.device)[None, :] == p[:, None]).float()
          * hasf.float()[:, None])
    qv = torch.sum(st.Ginv * ep[:, None, :], dim=2)
    qpp = torch.sum(qv * ep, dim=1, keepdim=True)
    inv = hasf.float()[:, None] / torch.where(qpp > 0, qpp, 1.0)
    v = torch.sum(st.cols * qv[:, :, None], dim=1)
    di = torch.sum(st.idx * (ep > 0), dim=1)
    rows = torch.nonzero(hasf)[:, 0]
    st.amask[rows, di[rows].long()] = 0
    st.Ginv.copy_(st.Ginv - inv[:, :, None] * qv[:, :, None] * qv[:, None, :]
                  + ep[:, :, None] * ep[:, None, :])
    st.idx.copy_(torch.where(ep > 0, m, st.idx))
    st.Atb.mul_(1.0 - ep)
    st.cols.mul_((1.0 - ep)[:, :, None])
    return v, inv[:, 0]


def _refit_ref(Bs, st):
    """`_Engine.refit_residual`: coef = Ginv Atb, r = b - cols' coef."""
    st.coef.copy_(torch.sum(st.Ginv * st.Atb[:, None, :], dim=2))
    st.r.copy_(Bs - torch.sum(st.cols * st.coef[:, :, None], dim=1))


def _engine_init_ref(pval, pidx, Ac, Bs, st: _EngState):
    """Plain engine_init on the empty state: the row's top-cnt of the
    select_topl partials (B, T, cnt), cnt gated appends in that order
    (gate: a finite pick), with SRR's rescaling terms into pending slots
    0..cnt-1, the refit, prev = ||r||^2, done = 0 (and fgate = 1)."""
    vals, picks = _merge_topl_vals(pval, pidx, pval.shape[2])
    for j in range(picks.shape[1]):
        _, acol, u, dinv = _engine_append_ref(Ac, Bs, st, picks[:, j],
                                              vals[:, j] > -torch.inf)
        if st.resc is not None:
            st.pend_u[j].copy_(acol - torch.sum(st.cols * u[:, :, None],
                                                dim=1))
            st.pend_w[j].copy_(-dinv)
    _refit_ref(Bs, st)
    st.prev.copy_(_rnorm2(st.r))
    st.done.zero_()
    if st.fgate is not None:
        st.fgate.fill_(1.0)


def _ompr_swap_ref(pval, pidx, Ac, Bs, st: _EngState, eta: float,
                   delta2: float):
    """Plain OMPR iteration (`_ompr_kernel` body_inner, :997-1032) from
    the masked select partials, on the rows that are not done."""
    m = Ac.shape[1]
    K = st.idx.shape[1]

    def step():
        best, i = _reduce_partials(pval, pidx)
        change = best > 0
        coef_pre = st.coef * (st.idx < m)
        r_pre = st.r.clone()
        ok = _engine_append_ref(Ac, Bs, st, i, change)[0]
        act = st.idx < m
        gr = torch.sum(st.cols * r_pre[:, None, :], dim=2)
        gcoef = torch.where(ok[:, None], (coef_pre + _f32(eta) * gr) * act,
                            st.coef)
        d2 = torch.where(act & ok[:, None], torch.abs(gcoef), torch.inf)
        dmin = d2.amin(dim=1)
        p = _lowest(d2 == dmin[:, None], K)
        _delete_ep_ref(st, p, ok & (dmin < torch.inf), m)
        _refit_ref(Bs, st)
        res = torch.where(ok, _rnorm2(st.r), st.prev)
        st.done.copy_(torch.where(~change | (res <= _f32(delta2))
                                  | (st.prev <= res), 1.0, st.done))
        st.prev.copy_(res)

    _keep_rows(st, st.done < 0.5, step)


def _srr_append_ref(pval, pidx, Ac, Bs, st: _EngState):
    """Plain SRR forward step (`_srr_kernel` forward_step, :1135-1144)
    from the rescaled select partials, on the rows whose forward gate is
    open; writes the append's term (aperp, -dinv) into pending slot 0
    (zero on the other rows)."""
    n, m = Ac.shape
    live = (st.done < 0.5) & (st.fgate > 0.5)

    def step():
        dmax, i = _reduce_partials(pval, pidx)
        gate = ((_rnorm2(st.r) > 0) & (dmax > 0)
                & ((st.idx < m).sum(dim=1) < min(n, m)))
        ok, acol, u, dinv = _engine_append_ref(Ac, Bs, st, i, gate)
        aperp = acol - torch.sum(st.cols * u[:, :, None], dim=1)
        _refit_ref(Bs, st)
        st.fgate.mul_(ok.float())
        return aperp, dinv

    aperp, dinv = _keep_rows(st, live, step)
    st.pend_u[0].copy_(torch.where(live[:, None], aperp, 0.0))
    st.pend_w[0].copy_(torch.where(live, -dinv, 0.0))


def _engine_delete_ref(Bs, st: _EngState, k: int, l: int, delta2: float):
    """Plain SRR backward stage (`_srr_kernel` :1162-1171): l gated
    deletions of the min coef^2 / gamma slot while more than k atoms are
    active, each followed by the refit, their restore terms into pending
    slots 1..l, then the latch on ||r||^2 and fgate = not done."""
    m = st.amask.shape[1]
    K = st.idx.shape[1]
    live = st.done < 0.5

    def step():
        terms = []
        for _ in range(l):
            act = st.idx < m
            gam = torch.clamp(torch.diagonal(st.Ginv, dim1=1, dim2=2),
                              min=1e-30)
            d2 = torch.where(act, st.coef * st.coef / gam, torch.inf)
            dmin = d2.amin(dim=1)
            p = _lowest(d2 == dmin[:, None], K)
            hasf = (act.sum(dim=1) > k) & (dmin < torch.inf)
            terms.append(_delete_ep_ref(st, p, hasf, m))
            _refit_ref(Bs, st)
        res = _rnorm2(st.r)
        st.done.copy_(torch.where((res <= _f32(delta2)) | (st.prev <= res),
                                  1.0, st.done))
        st.prev.copy_(res)
        st.fgate.copy_((st.done < 0.5).float())
        return terms

    for j, (v, inv) in enumerate(_keep_rows(st, live, step)):
        st.pend_u[1 + j].copy_(torch.where(live[:, None], v, 0.0))
        st.pend_w[1 + j].copy_(torch.where(live, inv, 0.0))


def _backward_loop_ref(Bs, st: _EngState, gate, thr, kfinal: int):
    """The backward stage loop of `_rmp_kernel` (:1301-1336) and
    `_foba_kernel` (:1461-1475): batch-wide steps with a per-row gate that
    closes at the row's first rejection, at most K + 1, of which the last
    accepts nothing (a row that made K deletions has no atom left; its
    refit changes nothing), so K are run. A step deletes the
    min coef^2 / gamma slot where the rule accepts (kfinal >= 0: more than
    kfinal atoms and a finite score; else score < thr, thr a number or
    (B,)) and refits. Deletion j of a row leaves its restore term in
    pending slot 1 + j; the weights of the slots a row did not fill are 0
    (every slot of a row whose gate is closed: its vectors stay as they
    were). Returns each row's deletion count (B,) f32."""
    m = st.amask.shape[1]
    K = st.idx.shape[1]
    g = gate.clone()
    nd = torch.zeros_like(st.done)
    st.pend_w[1:].zero_()
    for j in range(K):
        if not bool(g.any()):
            break
        act = st.idx < m
        gam = torch.clamp(torch.diagonal(st.Ginv, dim1=1, dim2=2), min=1e-30)
        d2 = torch.where(act, st.coef * st.coef / gam, torch.inf)
        dmin = d2.amin(dim=1)
        p = _lowest(d2 == dmin[:, None], K)
        if kfinal >= 0:
            acc = g & (act.sum(dim=1) > kfinal) & (dmin < torch.inf)
        else:
            acc = g & (dmin < thr)
        v, inv = _delete_ep_ref(st, p, acc, m)
        _refit_ref(Bs, st)
        st.pend_u[1 + j].copy_(torch.where(acc[:, None], v, st.pend_u[1 + j]))
        st.pend_w[1 + j].copy_(inv)
        nd += acc.float()
        g = acc
    return nd


def _rmp_append_ref(pval, pidx, Ac, Bs, st: _EngState, delta2: float,
                    floor2, foba: bool):
    """Plain RMP forward step (`_rmp_kernel` forward_step, :1287-1299) or,
    with `foba`, FoBa iteration (`_foba_kernel` body, :1447-1476) from the
    rescaled select partials, on the rows whose forward gate is open; the
    append's term goes to pending slot 0, FoBa's deletions to slots 1..
    (zero weights on the other rows)."""
    n, m = Ac.shape
    K = st.idx.shape[1]
    live = (st.done < 0.5) & (st.fgate > 0.5)

    def step():
        dmax, i = _reduce_partials(pval, pidx)
        nat = (st.idx < m).sum(dim=1)
        wanted = ((_rnorm2(st.r) > floor2) & (dmax > _f32(delta2))
                  & (nat < min(n, m)))
        full = nat >= K
        st.capped.copy_(torch.maximum(st.capped, (wanted & full).float()))
        ok, acol, u, dinv = _engine_append_ref(Ac, Bs, st, i, wanted & ~full)
        aperp = acol - torch.sum(st.cols * u[:, :, None], dim=1)
        _refit_ref(Bs, st)
        st.fgate.mul_(ok.float())
        st.acc.copy_(torch.maximum(st.acc, ok.float()))
        if foba:
            st.ndel.copy_(_backward_loop_ref(
                Bs, st, ok & live, torch.clamp(dmax, min=0.0) * 0.25, -1))
        return aperp, dinv

    aperp, dinv = _keep_rows(st, live, step)
    st.pend_u[0].copy_(torch.where(live[:, None], aperp, 0.0))
    st.pend_w[0].copy_(torch.where(live, -dinv, 0.0))
    if foba:   # a closed row made no deletion
        st.ndel.mul_(live.float())


def _engine_backward_ref(Bs, st: _EngState, delta2: float, kfinal: int):
    """Plain RMP backward stage and outer latch (`_rmp_kernel` :1301-1344)
    on the rows that are not done: the deletion loop, then done where
    neither stage of the pass accepted a step, fgate = not done, acc = 0."""
    live = st.done < 0.5

    def step():
        nd = _backward_loop_ref(Bs, st, live, _f32(delta2), int(kfinal))
        progressed = (st.acc > 0.5) | (nd > 0)
        st.done.copy_(torch.where(progressed, st.done, 1.0))
        st.fgate.copy_(progressed.float())
        st.acc.zero_()
        st.ndel.copy_(nd)

    _keep_rows(st, live, step)
    st.ndel.mul_(live.float())


# --------------------------------------------------------------------------
# SP, plain (cstpu/ops/fused_twostage.py::_sp_kernel)
# --------------------------------------------------------------------------

def _union_coefs_ref(st: _SpState, W, S, alive, k: int, m: int):
    """`union_coefs_cg` (:477-535): x2 solves S x2 = a2 - W'a1 by masked CG
    with the 8-eps lift, each row stopping at its own noise floor, then
    x1 = Ginv11 a1 - W x2. Returns the union coefficients (B, 2k)."""
    av = (st.idx < m).float() * st.Atb
    a1, a2 = av[:, :k], av[:, k:]
    al2 = alive.float()
    v = al2 * (a2 - torch.sum(W * a1[:, :, None], dim=1))
    lift = _f32(EPS8) * torch.amax(torch.diagonal(S, dim1=1, dim2=2), dim=1,
                                   keepdim=True)
    rs = torch.sum(v * v, dim=1, keepdim=True)
    thr = _f32(EPS8 * EPS8) * rs
    x2, rv, p = torch.zeros_like(v), v.clone(), v.clone()
    run = (rs - thr > 0)[:, 0]
    for _ in range(k):
        if not bool(run.any()):
            break
        Sp = al2 * (torch.sum(S * p[:, None, :], dim=2) + lift * p)
        al = rs / torch.clamp(torch.sum(p * Sp, dim=1, keepdim=True),
                              min=1e-30)
        rn = rv - al * Sp
        rsn = torch.sum(rn * rn, dim=1, keepdim=True)
        beta = rsn / torch.clamp(rs, min=1e-30)
        upd = run[:, None]
        x2 = torch.where(upd, x2 + al * p, x2)
        p = torch.where(upd, rn + beta * p, p)
        rv = torch.where(upd, rn, rv)
        rs = torch.where(upd, rsn, rs)
        run = run & (rs - thr > 0)[:, 0]
    x2 = al2 * x2
    x1 = (torch.sum(st.Ginv * a1[:, None, :], dim=2)
          - torch.sum(W * x2[:, None, :], dim=2))
    return torch.cat([x1, x2], dim=1)


def _prune_ref(ucoef, active, k: int):
    """`prune_keep` (:537-552): the k largest |coef| active slots, lowest
    slot on ties; a NaN maximum keeps nothing more."""
    K2 = ucoef.shape[1]
    slots = torch.arange(K2, device=ucoef.device)
    cs = torch.where(active, torch.abs(ucoef), -torch.inf)
    keep = torch.zeros_like(active)
    for _ in range(k):
        cmax = cs.amax(dim=1, keepdim=True)
        sel = (slots == _lowest(cs == cmax, K2)[:, None]) & (cmax > -torch.inf)
        cs = torch.where(sel, -torch.inf, cs)
        keep |= sel
    return keep


def _compact_ref(st: _SpState, keep, m: int):
    """Stable compaction (`make_perm` + `compact`, :554-602): the kept
    slots, in slot order, to slots 0..cnt-1; every other slot empty."""
    B, K2, n = st.cols.shape
    src = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    dest_ok = (torch.arange(K2, device=keep.device)[None, :]
               < keep.sum(dim=1, keepdim=True))
    st.idx.copy_(torch.where(dest_ok, st.idx.gather(1, src), m))
    st.Atb.copy_(torch.where(dest_ok, st.Atb.gather(1, src), 0.0))
    st.cols.copy_(torch.where(dest_ok[:, :, None], st.cols.gather(
        1, src[:, :, None].expand(B, K2, n)), 0.0))


def _rebuild_kept_ref(Bs, st: _SpState, m: int, rtol: float):
    """`rebuild_kept` on its exact route (`invert_spd`, :416-463, and
    :661-670): the kept block's Gram, its bordered inversion with the
    per-atom pivot test d > rtol * ||a||^2, the rejected slots emptied
    (index and column), then the refit of coef and r."""
    B, k, _ = st.Ginv.shape
    C1 = st.cols[:, :k]
    S = torch.matmul(C1, C1.transpose(1, 2))
    occ = st.idx[:, :k] < m
    floor = torch.where(occ, rtol * torch.diagonal(S, dim1=1, dim2=2),
                        torch.inf)
    eye = torch.eye(k, device=Bs.device)
    Minv = eye.repeat(B, 1, 1)
    inmask = torch.zeros((B, k), device=Bs.device)
    rej = torch.zeros((B, k), dtype=torch.bool, device=Bs.device)
    for j in range(k):
        g = S[:, :, j] * inmask
        u = torch.sum(Minv * g[:, None, :], dim=2)
        d = S[:, j, j] - torch.sum(g * u, dim=1)
        ok = d > floor[:, j]
        okf = ok.float()
        et = eye[j][None, :] * okf[:, None]
        dinv = okf / torch.where(d > 0, d, 1.0)
        w = u - et
        Minv = (Minv + dinv[:, None, None] * w[:, :, None] * w[:, None, :]
                - et[:, :, None] * et[:, None, :])
        inmask = inmask + et
        rej[:, j] = ~ok
    st.idx[:, :k] = torch.where(rej & occ, m, st.idx[:, :k])
    live = st.idx[:, :k] < m
    st.cols[:, :k] *= live[:, :, None]
    st.Ginv.copy_(Minv)
    x1 = torch.sum(Minv * (live * st.Atb[:, :k])[:, None, :], dim=2)
    st.coef.copy_(torch.cat([x1, torch.zeros_like(x1)], dim=1))
    st.r.copy_(Bs - torch.sum(st.cols * st.coef[:, :, None], dim=1))


def _sp_round_ref(pval, pidx, Ac, Bs, st: _SpState, delta2: float,
                  init: bool):
    """Plain SP round (`sp_round`, :767-845, and the latch, :860-870) from
    the select_topl partials (B, T, k), on the rows that are not done. The
    init round (cstpu's :848-858 on the empty state) sets prev = ||r||^2
    and latches nothing."""
    n, m = Ac.shape
    k = st.Ginv.shape[1]
    rtol = _degeneracy_rtol(n)

    def step():
        act_pre = st.idx[:, :k] < m
        vals, picks = _merge_topl_vals(pval, pidx, k)
        for j in range(k):
            i = picks[:, j]
            ok = ((vals[:, j] > -torch.inf)
                  & ~torch.any(st.idx == i[:, None], dim=1))
            okf = ok.float()
            acol = Ac[:, i.clamp(max=m - 1).long()].T.float()
            st.cols[:, k + j] = acol * okf[:, None]
            st.Atb[:, k + j] = torch.sum(acol * Bs, dim=1) * okf
            st.idx[:, k + j] = torch.where(ok, i, m)
        C1, C2 = st.cols[:, :k], st.cols[:, k:]
        G12 = torch.matmul(C1, C2.transpose(1, 2))
        G22 = torch.matmul(C2, C2.transpose(1, 2))
        W = torch.matmul(st.Ginv, G12)
        S = G22 - torch.matmul(G12.transpose(1, 2), W)
        occ2 = st.idx[:, k:] < m
        alive = occ2 & (torch.diagonal(S, dim1=1, dim2=2)
                        > rtol * torch.diagonal(G22, dim1=1, dim2=2))
        st.idx[:, k:] = torch.where(occ2 & ~alive, m, st.idx[:, k:])
        keep = _prune_ref(_union_coefs_ref(st, W, S, alive, k, m),
                          st.idx < m, k)
        stable = (keep[:, :k] == act_pre).all(dim=1) & ~keep[:, k:].any(dim=1)
        # the compaction and rebuild on the rows whose support moved; a
        # stable row keeps its state and drops its acquisitions
        _keep_rows(st, ~stable, lambda: (_compact_ref(st, keep, m),
                                         _rebuild_kept_ref(Bs, st, m, rtol)))
        st.idx[:, k:] = m
        res = _rnorm2(st.r)
        if not init:
            st.done.copy_(torch.where((res <= _f32(delta2)) | (st.prev <= res)
                                      | stable, 1.0, st.done))
        st.prev.copy_(res)

    _keep_rows(st, st.done < 0.5, step)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _expect_engine(name: str, st: _EngState, Bs, Ac=None):
    """Check the engine state (and Ac when given) for a launch; returns
    (B, K, n, m)."""
    B, K, n = st.cols.shape if st.cols.ndim == 3 else (0, 0, 0)
    m = st.amask.shape[1] if st.amask.ndim == 2 else 0
    if not 1 <= K <= KMAX or _engine_smem(n, K) > SMEM_MAX:
        raise ValueError(f"{name}: K={K}, n={n} outside the kernel's limits "
                         f"(K <= {KMAX}, shared memory)")
    if Ac is not None:
        _expect(name, Bs.device, (Ac, _CDTS, (n, m)))
    _expect(name, Bs.device, (Bs, _F32, (B, n)),
            (st.cols, _F32, (B, K, n)), (st.Ginv, _F32, (B, K, K)),
            (st.coef, _F32, (B, K)), (st.idx, _I32, (B, K)),
            (st.Atb, _F32, (B, K)), (st.r, _F32, (B, n)),
            (st.amask, _U8, (B, m)), (st.done, _F32, (B,)),
            (st.prev, _F32, (B,)))
    if st.resc is not None:
        P = st.pend_u.shape[0] if st.pend_u.ndim == 3 else -1
        _expect(name, Bs.device, (st.resc, _F32, (B, m)),
                (st.pend_u, _F32, (P, B, n)), (st.pend_w, _F32, (P, B)),
                (st.fgate, _F32, (B,)))
    if st.acc is not None:
        _expect(name, Bs.device, (st.acc, _F32, (B,)),
                (st.capped, _F32, (B,)), (st.ndel, _F32, (B,)))
    return B, K, n, m


def _ptr(x):
    return None if x is None else x.data_ptr()


def _engine_plan(B: int, n: int, K: int, cnt: int = 0) -> _AppendPlan:
    """The launch plan of rmp_append and srr_append (cnt = 0) and
    engine_init (cnt picks) for B rows, n and K slots, as
    csrc/engine_cluster.cuh::engine_plan decides it: C blocks a row, slices
    of n, the slot columns (engine_init: the picked ones) staged or
    streamed, the dynamic shared memory."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.load().cstpu_engine_plan(B, n, K, cnt, out),
                 "cstpu_engine_plan")
    C, slice_, staged, smem = out
    return _AppendPlan(C, slice_, bool(staged), smem)


def _ompr_plan(B: int, n: int, K: int) -> _AppendPlan:
    """The launch plan of ompr_swap for B rows, n and K slots, as
    csrc/gomp_ompr_cluster.cuh::ompr_plan decides it: C blocks a row,
    slices of n, the slot columns staged or streamed, the dynamic
    shared memory."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.load().cstpu_ompr_plan(B, n, K, out),
                 "cstpu_ompr_plan")
    C, slice_, staged, smem = out
    return _AppendPlan(C, slice_, bool(staged), smem)


def _state_ptrs(st: _EngState):
    """Pointers to the engine state of the C entry points: cols, Ginv,
    coef, idx, Atb, r, amask, done, prev."""
    return (st.cols.data_ptr(), st.Ginv.data_ptr(), st.coef.data_ptr(),
            st.idx.data_ptr(), st.Atb.data_ptr(), st.r.data_ptr(),
            st.amask.data_ptr(), st.done.data_ptr(), st.prev.data_ptr())


def engine_init(pval, pidx, Ac, Bs, st: _EngState):
    """OMPR's and SRR's init from the select_topl partials (B, T, cnt) of
    |round_cdt(b) . A|: cnt gated appends into the empty state, the refit
    and the first ||r||^2, updating `st` in place (SRR: cnt pending terms,
    fgate = 1). On CUDA tensors this launches csrc/engine_init.cu, a
    thread-block cluster per row (`_engine_plan` with cnt)."""
    if _on_cpu(pval, pidx, Ac, Bs, *st):
        return _engine_init_ref(pval, pidx, Ac, Bs, st)
    B, K, n, m = _expect_engine("engine_init", st, Bs, Ac)
    T = -(-m // TILE)
    cnt = pval.shape[2] if pval.ndim == 3 else 0
    P = 0 if st.resc is None else st.pend_u.shape[0]
    if not 1 <= cnt <= min(LMAX, K) or (st.resc is not None and cnt > P):
        raise ValueError(f"engine_init: cnt={cnt} outside 1..{min(LMAX, K)} "
                         f"or beyond the {P} pending slots")
    _expect("engine_init", Bs.device, (pval, _F32, (B, T, cnt)),
            (pidx, _I32, (B, T, cnt)))
    lib = _build.load()
    with torch.cuda.device(Bs.device):
        err = lib.cstpu_engine_init(
            pval.data_ptr(), pidx.data_ptr(), T, cnt, Ac.data_ptr(),
            int(Ac.dtype == torch.bfloat16), Bs.data_ptr(), *_state_ptrs(st),
            _ptr(st.pend_u), _ptr(st.pend_w), _ptr(st.fgate), B, n, m, K,
            _degeneracy_rtol(n), _stream())
    _build.check(err, "cstpu_engine_init")
    LAUNCHES["engine_init"] += 1


def ompr_swap(pval, pidx, Ac, Bs, st: _EngState, eta: float, delta2: float):
    """One OMPR iteration from the masked select partials (B, T): append,
    gradient step, delete, refit and latch, updating `st` in place. On
    CUDA tensors this launches csrc/ompr_swap.cu, a thread-block cluster
    per row (`_ompr_plan`)."""
    if _on_cpu(pval, pidx, Ac, Bs, *st):
        return _ompr_swap_ref(pval, pidx, Ac, Bs, st, eta, delta2)
    B, K, n, m = _expect_engine("ompr_swap", st, Bs, Ac)
    T = -(-m // TILE)
    _expect("ompr_swap", Bs.device, (pval, _F32, (B, T)),
            (pidx, _I32, (B, T)))
    lib = _build.load()
    with torch.cuda.device(Bs.device):
        err = lib.cstpu_ompr_swap(
            pval.data_ptr(), pidx.data_ptr(), T, Ac.data_ptr(),
            int(Ac.dtype == torch.bfloat16), Bs.data_ptr(), *_state_ptrs(st),
            B, n, m, K, _degeneracy_rtol(n), float(eta), float(delta2),
            _stream())
    _build.check(err, "cstpu_ompr_swap")
    LAUNCHES["ompr_swap"] += 1


def srr_append(pval, pidx, Ac, Bs, st: _EngState):
    """One SRR forward step from the rescaled select partials (B, T): the
    gated append, the refit and the append's pending term (slot 0),
    updating `st` in place. On CUDA tensors this launches
    csrc/srr_append.cu, a thread-block cluster per row (`_engine_plan`,
    rmp_append's plan)."""
    if _on_cpu(pval, pidx, Ac, Bs, *st):
        return _srr_append_ref(pval, pidx, Ac, Bs, st)
    B, K, n, m = _expect_engine("srr_append", st, Bs, Ac)
    T = -(-m // TILE)
    if st.resc is None:
        raise ValueError("srr_append: needs SRR's rescaling state")
    _expect("srr_append", Bs.device, (pval, _F32, (B, T)),
            (pidx, _I32, (B, T)))
    lib = _build.load()
    with torch.cuda.device(Bs.device):
        err = lib.cstpu_srr_append(
            pval.data_ptr(), pidx.data_ptr(), T, Ac.data_ptr(),
            int(Ac.dtype == torch.bfloat16), Bs.data_ptr(),
            *_state_ptrs(st)[:8], st.pend_u.data_ptr(), st.pend_w.data_ptr(),
            st.fgate.data_ptr(), B, n, m, K, _degeneracy_rtol(n), _stream())
    _build.check(err, "cstpu_srr_append")
    LAUNCHES["srr_append"] += 1


def engine_delete(Bs, st: _EngState, k: int, l: int, delta2: float):
    """SRR's backward stage: l gated deletions back to k atoms with their
    restore terms (pending slots 1..l), the refits, the latch and fgate,
    updating `st` in place. On CUDA tensors this launches
    csrc/engine_delete.cu, a thread-block cluster per row (`_engine_plan`,
    rmp_append's plan)."""
    if _on_cpu(Bs, *st):
        return _engine_delete_ref(Bs, st, k, l, delta2)
    if st.resc is None or not 1 <= l < st.pend_u.shape[0]:
        raise ValueError(f"engine_delete: needs SRR's state with more than "
                         f"l={l} pending slots")
    B, K, n, m = _expect_engine("engine_delete", st, Bs)
    lib = _build.load()
    with torch.cuda.device(Bs.device):
        err = lib.cstpu_engine_delete(
            Bs.data_ptr(), st.cols.data_ptr(), st.Ginv.data_ptr(),
            st.coef.data_ptr(), st.idx.data_ptr(), st.Atb.data_ptr(),
            st.r.data_ptr(), st.amask.data_ptr(), st.done.data_ptr(),
            st.prev.data_ptr(), st.pend_u.data_ptr(), st.pend_w.data_ptr(),
            st.fgate.data_ptr(), B, n, m, K, int(k), int(l), float(delta2),
            _stream())
    _build.check(err, "cstpu_engine_delete")
    LAUNCHES["engine_delete"] += 1


def _expect_stepwise(name: str, st: _EngState):
    """RMP's and FoBa's kernels need the rescaling state, the latches and
    K + 1 pending slots."""
    K = st.idx.shape[1]
    if st.resc is None or st.acc is None or st.pend_u.shape[0] < K + 1:
        raise ValueError(f"{name}: needs RMP's state (rescaling, latches, "
                         f"{K + 1} pending slots)")


def rmp_append(pval, pidx, Ac, Bs, st: _EngState, delta2: float, floor2,
               foba: bool):
    """One RMP forward step, or with `foba` one FoBa iteration, from the
    rescaled select partials (B, T), updating `st` in place; floor2 (B,)
    f32 is the squared exhaustion floor. On CUDA tensors this launches
    csrc/rmp_append.cu, a thread-block cluster per row (`_engine_plan`)."""
    if _on_cpu(pval, pidx, Ac, Bs, floor2, *st):
        return _rmp_append_ref(pval, pidx, Ac, Bs, st, delta2, floor2, foba)
    B, K, n, m = _expect_engine("rmp_append", st, Bs, Ac)
    _expect_stepwise("rmp_append", st)
    T = -(-m // TILE)
    _expect("rmp_append", Bs.device, (pval, _F32, (B, T)),
            (pidx, _I32, (B, T)), (floor2, _F32, (B,)))
    lib = _build.load()
    with torch.cuda.device(Bs.device):
        err = lib.cstpu_rmp_append(
            pval.data_ptr(), pidx.data_ptr(), T, Ac.data_ptr(),
            int(Ac.dtype == torch.bfloat16), Bs.data_ptr(),
            *_state_ptrs(st)[:8], st.pend_u.data_ptr(), st.pend_w.data_ptr(),
            st.fgate.data_ptr(), st.acc.data_ptr(), st.capped.data_ptr(),
            st.ndel.data_ptr(), floor2.data_ptr(), B, n, m, K,
            _degeneracy_rtol(n), float(delta2), int(bool(foba)), _stream())
    _build.check(err, "cstpu_rmp_append")
    LAUNCHES["rmp_append"] += 1


def engine_backward(Bs, st: _EngState, delta2: float, kfinal: int):
    """RMP's backward stage (kfinal < 0: while the increase < delta2; else
    down to kfinal atoms) with its restore terms (pending slots 1..), the
    refits and the pass's latch, updating `st` in place. On CUDA tensors
    this launches csrc/engine_backward.cu, a thread-block cluster per row
    (`_engine_plan`, rmp_append's plan)."""
    if _on_cpu(Bs, *st):
        return _engine_backward_ref(Bs, st, delta2, kfinal)
    B, K, n, m = _expect_engine("engine_backward", st, Bs)
    _expect_stepwise("engine_backward", st)
    lib = _build.load()
    with torch.cuda.device(Bs.device):
        err = lib.cstpu_engine_backward(
            Bs.data_ptr(), *_state_ptrs(st)[:8], st.pend_u.data_ptr(),
            st.pend_w.data_ptr(), st.fgate.data_ptr(), st.acc.data_ptr(),
            st.ndel.data_ptr(), B, n, m, K, float(delta2), int(kfinal),
            _stream())
    _build.check(err, "cstpu_engine_backward")
    LAUNCHES["engine_backward"] += 1


def sp_round(pval, pidx, Ac, Bs, st: _SpState, delta2: float, init: bool):
    """One SP round from the select_topl partials (B, T, k), updating `st`
    in place (the init round sets prev and latches nothing). On CUDA
    tensors this launches csrc/sp_round.cu."""
    if _on_cpu(pval, pidx, Ac, Bs, *st):
        return _sp_round_ref(pval, pidx, Ac, Bs, st, delta2, init)
    B, K2, n = st.cols.shape if st.cols.ndim == 3 else (0, 0, 0)
    k = K2 // 2
    m = Ac.shape[1] if Ac.ndim == 2 else 0
    T = -(-m // TILE)
    if not 1 <= k <= LMAX or K2 != 2 * k:
        raise ValueError(f"sp_round: k={k} outside 1..{LMAX}")
    _expect("sp_round", Bs.device, (pval, _F32, (B, T, k)),
            (pidx, _I32, (B, T, k)), (Ac, _CDTS, (n, m)), (Bs, _F32, (B, n)),
            (st.cols, _F32, (B, K2, n)), (st.Ginv, _F32, (B, k, k)),
            (st.coef, _F32, (B, K2)), (st.idx, _I32, (B, K2)),
            (st.Atb, _F32, (B, K2)), (st.r, _F32, (B, n)),
            (st.done, _F32, (B,)), (st.prev, _F32, (B,)))
    lib = _build.load()
    with torch.cuda.device(Bs.device):
        err = lib.cstpu_sp_round(
            pval.data_ptr(), pidx.data_ptr(), T, Ac.data_ptr(),
            int(Ac.dtype == torch.bfloat16), Bs.data_ptr(),
            *(x.data_ptr() for x in st), B, n, m, k, _degeneracy_rtol(n),
            float(delta2), int(bool(init)), _stream())
    _build.check(err, "cstpu_sp_round")
    LAUNCHES["sp_round"] += 1


# --------------------------------------------------------------------------
# The solves
# --------------------------------------------------------------------------

def _init_engine(Bs, K: int, m: int, cn2=None, npend: int = 0,
                 stepwise: bool = False) -> _EngState:
    """Empty engine state with K slots; SRR's fields when cn2 is given, and
    with `stepwise` RMP's latches (every forward gate open)."""
    B, n = Bs.shape
    dev = Bs.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    srr = {} if cn2 is None else dict(
        resc=cn2[None, :].repeat(B, 1), pend_u=zeros(npend, B, n),
        pend_w=zeros(npend, B), fgate=zeros(B))
    if stepwise:
        srr.update(fgate=torch.ones((B,), dtype=torch.float32, device=dev),
                   acc=zeros(B), capped=zeros(B), ndel=zeros(B))
    return _EngState(**_slot_state(Bs, K, m), Atb=zeros(B, K),
                     amask=torch.zeros((B, m), dtype=torch.uint8, device=dev),
                     done=zeros(B), prev=zeros(B), **srr)


def _sp(A, Bs, k: int, delta, maxiter, corr_dtype, topl, round_,
        upcast: bool):
    n, m = A.shape
    k = int(k)
    if 2 * k > n:
        raise ValueError(f"2k = {2 * k} > {n} = len(b) is invalid for SP")
    maxiter = int(maxiter if maxiter is not None else 16 * k)
    Ac, Bs = _prepare(A, Bs, corr_dtype, upcast)
    delta2 = float(delta) ** 2
    B = Bs.shape[0]
    dev = Bs.device
    base = _slot_state(Bs, 2 * k, m)
    base["Ginv"] = torch.eye(k, device=dev).repeat(B, 1, 1)
    st = _SpState(**base, Atb=torch.zeros((B, 2 * k), device=dev),
                  done=torch.zeros((B,), device=dev),
                  prev=torch.zeros((B,), device=dev))
    round_(*topl(Bs, Ac, k), Ac, Bs, st, delta2, True)
    t = 0
    while t < maxiter and _live_any(st.done):
        round_(*topl(st.r, Ac, k), Ac, Bs, st, delta2, False)
        t += 1
    return _sorted_solution(st.idx, st.coef, m), st.r, t


def _solution(out, return_iters: bool):
    sol, r, t = out
    return (sol, r, t) if return_iters else (sol, r)


def sp_fused_solve(A, Bs, k: int, delta: float = 1e-12, maxiter=None,
                   corr_dtype=torch.bfloat16, return_iters: bool = False):
    """Batched subspace pursuit on the select_topl and sp_round kernels.

    A: (n, m) dictionary; Bs: (B, n) measurements; 2k <= n. maxiter
    defaults to 16k, as cstpu's (the loop ends once every row is done).
    Returns (SparseSolution (B, 2k) sorted by atom index, residuals
    (B, n) f32), and with return_iters the outer iterations run."""
    return _solution(_sp(A, Bs, k, delta, maxiter, corr_dtype, select_topl,
                         sp_round, False), return_iters)


def sp_fused_solve_ref(A, Bs, k: int, delta: float = 1e-12, maxiter=None,
                       corr_dtype=torch.bfloat16,
                       return_iters: bool = False):
    """sp_fused_solve on the plain versions of its kernels."""
    cdt = _check_cdt(corr_dtype)
    return _solution(_sp(A, Bs, k, delta, maxiter, cdt,
                         lambda r, Ac, l: _topl_ref(r, Ac, cdt, l),
                         _sp_round_ref, True), return_iters)


def _ompr(A, Bs, k: int, delta, eta, maxiter, corr_dtype, kernels,
          upcast: bool):
    n, m = A.shape
    k = int(k)
    maxiter = int(maxiter if maxiter is not None else n)
    Ac, Bs = _prepare(A, Bs, corr_dtype, upcast)
    delta2 = float(delta) ** 2
    st = _init_engine(Bs, k + 1, m)
    topl, init, select, swap = kernels
    init(*topl(Bs, Ac, k), Ac, Bs, st)
    t = 0
    while t < maxiter and _live_any(st.done):
        swap(*select(st.r, Ac, amask=st.amask, eta=eta), Ac, Bs, st,
             float(eta), delta2)
        t += 1
    return _sorted_solution(st.idx, st.coef, m), st.r, t


def ompr_fused_solve(A, Bs, k: int, delta: float, eta: float = 1.0,
                     maxiter=None, corr_dtype=torch.bfloat16,
                     return_iters: bool = False):
    """Batched OMP with replacement on the select_topl, engine_init, masked
    select_argmax and ompr_swap kernels. maxiter defaults to n, as
    cstpu's. Returns (SparseSolution (B, k+1), residuals), and with
    return_iters the outer iterations run (the batch runs until its
    slowest row latches)."""
    return _solution(_ompr(A, Bs, k, delta, eta, maxiter, corr_dtype,
                           (select_topl, engine_init, select_argmax,
                            ompr_swap), False), return_iters)


def ompr_fused_solve_ref(A, Bs, k: int, delta: float, eta: float = 1.0,
                         maxiter=None, corr_dtype=torch.bfloat16,
                         return_iters: bool = False):
    """ompr_fused_solve on the plain versions of its kernels."""
    cdt = _check_cdt(corr_dtype)
    return _solution(_ompr(A, Bs, k, delta, eta, maxiter, cdt,
                           (lambda r, Ac, l: _topl_ref(r, Ac, cdt, l),
                            _engine_init_ref, partial(_select_ref, cdt=cdt),
                            _ompr_swap_ref), True), return_iters)


def _srr(A, Bs, k: int, delta, maxiter, l: int, corr_dtype, kernels,
         upcast: bool):
    n, m = A.shape
    k, l = int(k), int(l)
    if l < 1:
        raise ValueError(f"srr_fused_solve: l = {l} < 1")
    maxiter = int(maxiter if maxiter is not None else 4 * k)
    cn2 = torch.sum(A.float() * A.float(), dim=0)  # the f32 dictionary's
    Ac, Bs = _prepare(A, Bs, corr_dtype, upcast)
    delta2 = float(delta) ** 2
    st = _init_engine(Bs, k + l, m, cn2, npend=max(k, l + 1))
    topl, init, select, append, delete = kernels
    init(*topl(Bs, Ac, k), Ac, Bs, st)
    npend = k
    t = 0
    while t < maxiter and _live_any(st.done):
        for _ in range(l):
            append(*select(Ac, cn2, st.r, st.pend_u[:npend],
                           st.pend_w[:npend], 1.0, st.amask, st.resc),
                   Ac, Bs, st)
            npend = 1
        delete(Bs, st, k, l, delta2)
        npend = l + 1
        t += 1
    return _sorted_solution(st.idx, st.coef, m), st.r, t


def srr_fused_solve(A, Bs, k: int, delta: float = 1e-12, maxiter=None,
                    l: int = 1, corr_dtype=torch.bfloat16,
                    return_iters: bool = False):
    """Batched SRR with the oblivious initialization on the select_topl,
    engine_init, fr_select, srr_append and engine_delete kernels. maxiter
    defaults to 4k, as cstpu's. Returns (SparseSolution (B, k+l),
    residuals), and with return_iters the outer iterations run."""
    return _solution(_srr(A, Bs, k, delta, maxiter, l, corr_dtype,
                          (select_topl, engine_init, rescaled_select,
                           srr_append, engine_delete), False), return_iters)


def srr_fused_solve_ref(A, Bs, k: int, delta: float = 1e-12, maxiter=None,
                        l: int = 1, corr_dtype=torch.bfloat16,
                        return_iters: bool = False):
    """srr_fused_solve on the plain versions of its kernels."""
    cdt = _check_cdt(corr_dtype)
    return _solution(_srr(A, Bs, k, delta, maxiter, l, cdt,
                          (lambda r, Ac, l_: _topl_ref(r, Ac, cdt, l_),
                           _engine_init_ref,
                           partial(_rescaled_select_ref, cdt=cdt),
                           _srr_append_ref, _engine_delete_ref), True),
                     return_iters)


def _stepwise_setup(A, Bs, K: int, corr_dtype, upcast: bool):
    """(Ac, Bs, cn2, floor2, empty state) of an RMP or FoBa solve with K
    slots: floor2 = 64 n eps^2 ||b||^2, the squared exhaustion floor."""
    n, m = A.shape
    cn2 = torch.sum(A.float() * A.float(), dim=0)  # the f32 dictionary's
    Ac, Bs = _prepare(A, Bs, corr_dtype, upcast)
    floor2 = _f32(64.0 * n * (1.1920929e-07 ** 2)) * torch.sum(Bs * Bs, dim=1)
    return Ac, Bs, cn2, floor2, _init_engine(Bs, K, m, cn2, npend=K + 1,
                                             stepwise=True)


def _latches(*xs):
    """The (B,) latches xs on the host, one device-to-host copy."""
    return torch.stack(xs).cpu()


def _stepwise_result(st: _EngState, m: int, iters, return_iters: bool):
    out = (_sorted_solution(st.idx, st.coef, m), st.r, st.capped > 0.5)
    return (*out, iters) if return_iters else out


def _rmp(A, Bs, k, delta, maxiter: int, kmax: int, corr_dtype, kernels,
         upcast: bool, return_iters: bool):
    if (k is None) == (delta is None):
        raise ValueError("specify exactly one of k or delta")
    K = int(kmax)
    if k is not None:
        if int(k) > K:
            raise ValueError(f"k = {k} exceeds the kmax = {kmax} slot cap")
        # one pass: forward to exhaustion, backward down to k atoms
        kfinal, delta2, maxiter = int(k), 0.0, 1
    else:
        kfinal, delta2 = -1, float(delta) ** 2
    m = A.shape[1]
    Ac, Bs, cn2, floor2, st = _stepwise_setup(A, Bs, K, corr_dtype, upcast)
    select, append, backward = kernels
    npend = 1            # slot 0 of the empty state: a zero term
    t = fsteps = 0
    live = True
    while t < int(maxiter) and live:
        # forward stage: at most K + 1 steps, the last of a row a rejection;
        # a row whose gate closed is left as it is by every later step
        j, advancing = 0, True
        while j < K + 1 and advancing:
            append(*select(Ac, cn2, st.r, st.pend_u[:npend],
                           st.pend_w[:npend], 1.0, st.amask, st.resc),
                   Ac, Bs, st, delta2, floor2, False)
            npend = 1
            j += 1
            advancing = bool((st.fgate.cpu() > 0.5).any())
        fsteps += j
        backward(Bs, st, delta2, kfinal)
        done, ndel = _latches(st.done, st.ndel)
        live = bool((done < 0.5).any())
        npend = 1 + int(ndel.max())
        t += 1
    return _stepwise_result(st, m, (t, fsteps), return_iters)


def rmp_fused_solve(A, Bs, k: int | None = None, delta: float | None = None,
                    maxiter: int = 1, kmax: int = 32,
                    corr_dtype=torch.bfloat16, return_iters: bool = False):
    """Batched RMP on the fr_select, rmp_append and engine_backward kernels
    with a kmax-slot cap: `delta` alternates a forward stage to exhaustion
    with a backward stage at delta, up to maxiter passes, a row stopping
    when neither stage accepted a step; `k` is one pass, forward to the
    exhaustion floor and backward down to k atoms (k > kmax raises).
    Exactly one of k and delta. Returns (SparseSolution (B, kmax) sorted by
    atom index, residuals (B, n) f32, capped (B,) bool): a capped row's
    forward stage wanted an atom beyond the cap and must be re-solved
    uncapped. With return_iters also (outer passes, forward steps)."""
    return _rmp(A, Bs, k, delta, maxiter, kmax, corr_dtype,
                (rescaled_select, rmp_append, engine_backward), False,
                return_iters)


def rmp_fused_solve_ref(A, Bs, k: int | None = None,
                        delta: float | None = None, maxiter: int = 1,
                        kmax: int = 32, corr_dtype=torch.bfloat16,
                        return_iters: bool = False):
    """rmp_fused_solve on the plain versions of its kernels."""
    cdt = _check_cdt(corr_dtype)
    return _rmp(A, Bs, k, delta, maxiter, kmax, cdt,
                (partial(_rescaled_select_ref, cdt=cdt), _rmp_append_ref,
                 _engine_backward_ref), True, return_iters)


def _foba(A, Bs, delta, kmax: int, corr_dtype, kernels, upcast: bool,
          return_iters: bool):
    n, m = A.shape
    K = int(kmax)
    delta2 = float(delta) ** 2
    Ac, Bs, cn2, floor2, st = _stepwise_setup(A, Bs, K, corr_dtype, upcast)
    select, append = kernels
    npend = 1            # slot 0 of the empty state: a zero term
    t = 0
    while t < n:   # the reference's bound; ends when every row has rejected
        append(*select(Ac, cn2, st.r, st.pend_u[:npend], st.pend_w[:npend],
                       1.0, st.amask, st.resc),
               Ac, Bs, st, delta2, floor2, True)
        t += 1
        alive, ndel = _latches(st.fgate, st.ndel)
        if not bool((alive > 0.5).any()):
            break
        npend = 1 + int(ndel.max())
    return _stepwise_result(st, m, t, return_iters)


def foba_fused_solve(A, Bs, delta: float, kmax: int = 32,
                     corr_dtype=torch.bfloat16, return_iters: bool = False):
    """Batched FoBa on the fr_select and rmp_append kernels with a kmax-slot
    cap: per iteration one forward step and, after an accepted one, the
    deletions whose increase stays below a quarter of the step's gain; at
    most n iterations, ending when every row's forward step was rejected.
    Returns as rmp_fused_solve; with return_iters also the iterations."""
    return _foba(A, Bs, delta, kmax, corr_dtype,
                 (rescaled_select, rmp_append), False, return_iters)


def foba_fused_solve_ref(A, Bs, delta: float, kmax: int = 32,
                         corr_dtype=torch.bfloat16,
                         return_iters: bool = False):
    """foba_fused_solve on the plain versions of its kernels."""
    cdt = _check_cdt(corr_dtype)
    return _foba(A, Bs, delta, kmax, cdt,
                 (partial(_rescaled_select_ref, cdt=cdt), _rmp_append_ref),
                 True, return_iters)


# --------------------------------------------------------------------------
# Shape gates
# --------------------------------------------------------------------------

def _rows_ok(A, Bs) -> bool:
    return Bs.ndim == 2 and Bs.shape[1] == A.shape[0] and Bs.shape[0] >= 1


def supported_sp(A, Bs, k: int, corr_dtype=torch.bfloat16) -> bool:
    """Shape gate of sp_fused_solve: 2k <= n, the top-k acquisition within
    select_topl (k <= LMAX; sp_round's shared memory, which csrc/sp_round.cu
    sizes, then fits a block). Beyond it `sp_batch` takes the sharded solver
    on a one-shard mesh."""
    k = int(k)
    return _rows_ok(A, Bs) and 1 <= k <= LMAX and 2 * k <= A.shape[0]


def supported_ompr(A, Bs, k: int, corr_dtype=torch.bfloat16) -> bool:
    """Shape gate of ompr_fused_solve: the top-k init within select_topl,
    k+1 slots within the engine kernels' shared memory."""
    k = int(k)
    return (_rows_ok(A, Bs) and 1 <= k <= LMAX and k + 1 <= KMAX
            and _engine_smem(A.shape[0], k + 1) <= SMEM_MAX)


def supported_srr(A, Bs, k: int, l: int = 1,
                  corr_dtype=torch.bfloat16) -> bool:
    """Shape gate of srr_fused_solve: the top-k init within select_topl,
    k+l slots within the engine kernels' shared memory."""
    k, l = int(k), int(l)
    return (_rows_ok(A, Bs) and 1 <= k <= LMAX and l >= 1 and k + l <= KMAX
            and _engine_smem(A.shape[0], k + l) <= SMEM_MAX)


def supported_rmp(A, Bs, kmax: int, corr_dtype=torch.bfloat16) -> bool:
    """Shape gate of rmp_fused_solve and foba_fused_solve: kmax slots
    within the engine kernels' shared memory (fr_select takes any number of
    pending terms, one pass over A each)."""
    K = int(kmax)
    return (_rows_ok(A, Bs) and 1 <= K <= KMAX
            and _engine_smem(A.shape[0], K) <= SMEM_MAX)
