"""Sparse Bayesian Learning family (PyTorch counterpart of
cstpu.models.sbl): Tipping EM (`sbl`), fast marginal likelihood (`fsbl`),
Relevance Matching Pursuit at finite noise (`rmps`), noise-variance
learning (`rmps_estimate_noise`) and the traced solvers (`fsbl_traced`,
`rmps_traced`). Signatures are cstpu's.

FSBL and RMPS share the sparsity/quality-factor engine: per atom
S_k = a_k' C^-1 a_k and Q_k = a_k' C^-1 b with C = Sigma + A_active Gamma
A_active', kept under rank-one support changes by explicit C^-1 updates.
Inf-valued alpha marks an inactive atom; masked branches are computed with
`torch.where`, as cstpu does with `jnp.where`.

Batched first. Every body runs over a leading batch axis of measurement
rows with the semantics of cstpu's `jax.vmap` of a `lax.while_loop`: a row
whose loop condition turned false is frozen (its state is selected back
with `torch.where`) while the other rows run on, at every loop level (the
EM loop, FSBL's action loop, RMPS's outer loop and both of its stage
loops). `fsbl(A, b)` and the other per-instance solvers are the case
B = 1; the `*_batch` entry points of cstpu_torch.models.batched call the
bodies with the whole batch.

Each `lax.while_loop` is a Python loop that reads its latch ("every row
stopped") from the device once a step. `LOOP_COUNTS` counts the steps (EM
iterations, FSBL actions, RMPS stage actions) and the latch reads.

This family has no hand-written kernel: cstpu runs it as XLA work (its
whole-solve Pallas kernel lost every hardware comparison and was
removed), so the port runs tensor operations, with cuSOLVER's
factorizations on the card. Every body runs in true f32 (`true_f32`, no
TF32), as cstpu pins f32 products: reduced-precision products lose the
planted atoms in the long chains of rank-one updates at n ~ 1000.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cstpu_torch.ops.util import as_inputs, cholesky_nan, stopped, true_f32
from cstpu_torch.utils.diagnostics import RMPSTrace, SBLTrace

LOOP_COUNTS = {"steps": 0, "latch_reads": 0}


def _stopped(done) -> bool:
    """One latch read: every row of `done` is True (counted in this
    module's LOOP_COUNTS)."""
    return stopped(done, LOOP_COUNTS)


def _rows(live, x):
    """`live` (B,) shaped to broadcast against x (B, ...)."""
    return live.view(-1, *([1] * (x.ndim - 1)))


def _keep(live, new, old):
    """`new` on the live rows and `old` on the others, field by field: a
    stopped row does not move."""
    return type(new)(*(torch.where(_rows(live, x), x, y)
                       for x, y in zip(new, old)))


def _take(x, i):
    """x[b, i[b]] for every row b."""
    return x.gather(1, i[:, None])[:, 0]


def _on(x, A):
    """x (a number, the noise, alpha0) as a tensor in A's dtype on A's
    device."""
    return torch.as_tensor(x, dtype=A.dtype, device=A.device)


def _sigma_matrix(sigma, n: int):
    """A scalar variance (), per-row variances (B,) or a covariance (n, n)
    as (n, n) or (B, n, n)."""
    eye = torch.eye(n, dtype=sigma.dtype, device=sigma.device)
    if sigma.ndim == 0:
        return sigma * eye
    if sigma.ndim == 1:
        return sigma[:, None, None] * eye
    return sigma


def _weighted_gram(A, Bs, sigma):
    """A' Sigma^-1 A and Bs Sigma^-1 A (Sigma a variance, per-row variances
    or a covariance)."""
    if sigma.ndim == 0:
        return (A.T @ A) / sigma, (Bs @ A) / sigma
    if sigma.ndim == 1:
        return ((A.T @ A)[None] / sigma[:, None, None],
                (Bs @ A) / sigma[:, None])
    SiA = torch.linalg.solve(sigma, A)
    return SiA.T @ A, Bs @ SiA


# ---------------------------------------------------------------------------
# Tipping (2001) EM / fixed-point SBL
# ---------------------------------------------------------------------------

def _gamma_tol(g, min_change):
    """Per-row convergence floor for the gamma fixed point: the absolute
    min_change at f64; below 64 bits floored at ~100 eps ||gamma||, the
    iterate's own noise floor, or an f32 loop never latches at m >~ 4096."""
    if torch.finfo(g.dtype).bits >= 64:
        return min_change.expand(g.shape[:-1])
    rel = 100 * torch.finfo(g.dtype).eps * (1.0 + torch.linalg.norm(g, dim=-1))
    return torch.maximum(min_change, rel)


def _em_loop(step, g0, maxiter: int, min_change):
    """The EM fixed point: `step(g)` -> (x, gamma') per row, until
    ||gamma - gamma'|| falls below _gamma_tol, or maxiter steps."""
    g, x = g0, torch.zeros_like(g0)
    done = torch.zeros(g0.shape[0], dtype=torch.bool, device=g0.device)
    for _ in range(maxiter):
        if _stopped(done):
            break
        LOOP_COUNTS["steps"] += 1
        xn, gnew = step(g)
        stop = (torch.linalg.norm(g - gnew, dim=-1)
                < _gamma_tol(gnew, min_change))
        live = ~done
        g = torch.where(live[:, None], gnew, g)
        x = torch.where(live[:, None], xn, x)
        done = done | stop
    return x


def _sbl(A, Bs, sigma, maxiter: int, min_change):
    """The reference's m x m iteration over the rows of Bs."""
    m = A.shape[1]
    ASA, ASb = _weighted_gram(A, Bs, sigma)
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    eps = 8 * torch.finfo(A.dtype).eps

    def step(g):
        L = cholesky_nan(ASA + torch.diag_embed(1.0 / g))
        x = torch.cholesky_solve(ASb[..., None], L)[..., 0]
        Linv = torch.linalg.solve_triangular(L, eye.expand_as(L),
                                             upper=False)
        bdiag = torch.sum(Linv * Linv, dim=-2)        # diag(B^-1)
        # MacKay's update; in f32 rounding pushes the denominator of a
        # pruned atom below 0 and NaNs the next Cholesky: clamp at a
        # dtype-scaled epsilon (never binds at f64)
        denom = torch.maximum(1.0 - bdiag / g, _on(eps, A))
        return x, x * x / denom + 1e-14

    return _em_loop(step, torch.ones_like(ASb), maxiter, min_change)


def _sbl_woodbury(A, Bs, sigma, maxiter: int, min_change):
    """Tipping EM in the n x n measurement-space form for m >> n: with
    C = Sigma + A Gamma A', x = Gamma A' C^-1 b and the MacKay denominator
    1 - diag(B^-1)/gamma = gamma * s, s_k = a_k' C^-1 a_k. Per step one
    (B, n, m) solve and one n x n Cholesky per row, no m x m build."""
    n, m = A.shape
    Sig = _sigma_matrix(sigma, n)
    eps = _on(8 * torch.finfo(A.dtype).eps, A)

    def step(g):
        L = cholesky_nan(Sig + (A * g[:, None, :]) @ A.T)
        CiA = torch.cholesky_solve(A.expand(g.shape[0], n, m), L)  # C^-1 A
        s = torch.sum(A * CiA, dim=-2)                     # a_k' C^-1 a_k
        q = (Bs[:, None, :] @ CiA)[:, 0]                   # a_k' C^-1 b
        x = g * q
        denom = torch.maximum(g * s, eps)
        return x, x * x / denom + 1e-14

    g0 = torch.ones((Bs.shape[0], m), dtype=A.dtype, device=A.device)
    return _em_loop(step, g0, maxiter, min_change)


def _sbl_rows(A, Bs, sigma, maxiter=None, min_change: float = 1e-6,
              method: str = "auto"):
    """`sbl` over the rows of Bs (B, n): (B, m)."""
    n, m = A.shape
    maxiter = int(maxiter if maxiter is not None else 128 * m)
    if method not in ("auto", "direct", "woodbury"):
        raise ValueError(f"unknown sbl method {method!r}")
    if method == "auto":
        method = "woodbury" if m > 2 * n else "direct"
    fn = _sbl_woodbury if method == "woodbury" else _sbl
    with true_f32():
        return fn(A, Bs, _on(sigma, A), maxiter, _on(min_change, A))


def sbl(A, b, sigma, maxiter: int | None = None, min_change: float = 1e-6,
        method: str = "auto"):
    """Sparse Bayesian Learning (Tipping 2001) via the fixed-point gamma
    update. `sigma` is the noise variance (scalar) or covariance (matrix).
    Returns the dense posterior-mean weights.

    `method`: "direct" iterates the m x m system, "woodbury" the
    algebraically identical n x n measurement-space form (the only usable
    one at m >> n), "auto" picks woodbury when m > 2n."""
    A, b = as_inputs(A, b)
    return _sbl_rows(A, b[None], sigma, maxiter, min_change, method)[0]


# ---------------------------------------------------------------------------
# S/Q/C^-1 engine shared by FSBL and RMPS
# ---------------------------------------------------------------------------

class SQState(NamedTuple):
    alpha: torch.Tensor  # f[B, m] prior precisions; inf = inactive
    S: torch.Tensor      # f[B, m] sparsity factors  a_k' C^-1 a_k
    Q: torch.Tensor      # f[B, m] quality factors   a_k' C^-1 b
    Cinv: torch.Tensor   # f[B, n, n]


def _init_sq(A, Bs, sigma, alpha) -> SQState:
    """Build C = Sigma + A Gamma A' over the active set of every row and
    derive S, Q, C^-1. `alpha` (B, m) or (m,), shared by the rows."""
    n, m = A.shape
    B = Bs.shape[0]
    alpha = alpha.expand(B, m)
    g = torch.where(torch.isfinite(alpha), 1.0 / alpha, 0.0)
    L = cholesky_nan(_sigma_matrix(sigma, n) + (A * g[:, None, :]) @ A.T)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Cinv = torch.cholesky_solve(eye.expand(B, n, n), L)
    CA = torch.cholesky_solve(A.expand(B, n, m), L)
    S = torch.sum(CA * A, dim=-2)
    Q = (Bs[:, None, :] @ CA)[:, 0]
    return SQState(alpha=alpha, S=S, Q=Q, Cinv=Cinv)


def _get_sq(S, Q, alpha):
    """Small s, q from big S, Q (Tipping & Faul 2003)."""
    f = torch.where(torch.isfinite(alpha), alpha / (alpha - S), 1.0)
    return S * f, Q * f


def _optimal_alpha(s, q):
    """Closed-form optimal prior precision."""
    return torch.where(s < q * q, s * s / (q * q - s), torch.inf)


def _delta_add(S, Q):
    return (Q * Q - S) / S + torch.log(S) - torch.log(Q * Q)


def _delta_delete(S, Q, alpha):
    return Q * Q / (S - alpha) - torch.log1p(-S / alpha)


def _delta_update(S, Q, alpha, alphan):
    d = 1.0 / alphan - 1.0 / alpha
    return Q * Q / (S + 1.0 / d) - torch.log(torch.clamp(1.0 + S * d, min=0.0))


def _update_sqc(A, st: SQState, i, gamma_change) -> SQState:
    """Rank-one correction C += gamma a_i a_i' of every row (atom i (B,),
    gamma (B,)) propagated to C^-1, S, Q. gamma_change == 0 is an exact
    no-op (the denominator is inf)."""
    alpha_eff = 1.0 / gamma_change
    a = A[:, i].T                                        # (B, n)
    v = torch.einsum("bij,bj->bi", st.Cinv, a)
    denom = alpha_eff + _take(st.S, i)
    Cinv = st.Cinv - (v[:, :, None] * v[:, None, :]) / denom[:, None, None]
    Av = v @ A                                           # (B, m)
    S = st.S - Av * Av / denom[:, None]
    Q = st.Q - Av * _take(st.Q, i)[:, None] / denom[:, None]
    return SQState(alpha=st.alpha, S=S, Q=Q, Cinv=Cinv)


def _set(alpha, i, value):
    """alpha with alpha[b, i[b]] = value[b]."""
    return alpha.scatter(1, i[:, None], value[:, None])


def _posterior_mean(A, Bs, sigma, alpha):
    """Posterior mean restricted to the active atoms (exact zeros
    elsewhere): the full m x m system with inactive precisions clamped to a
    huge finite value (1e30 at f64, 1e18 below), then zeroed."""
    ASA, ASb = _weighted_gram(A, Bs, sigma)
    huge = 1e30 if A.dtype == torch.float64 else 1e18
    L = cholesky_nan(ASA + torch.diag_embed(torch.clamp(alpha, max=huge)))
    x = torch.cholesky_solve(ASb[..., None], L)[..., 0]
    return torch.where(torch.isfinite(alpha), x, 0.0)


def _inactive(A, B: int):
    return torch.full((B, A.shape[1]), torch.inf, dtype=A.dtype,
                      device=A.device)


# ---------------------------------------------------------------------------
# FSBL: greedy best-action marginal-likelihood ascent
# ---------------------------------------------------------------------------

def _fsbl_action_deltas(st: SQState):
    """Potential marginal-likelihood change of the best action per atom."""
    s, q = _get_sq(st.S, st.Q, st.alpha)
    active = torch.isfinite(st.alpha)
    relevant = s < q * q
    alphan = _optimal_alpha(s, q)
    d = torch.where(~active & relevant, _delta_add(st.S, st.Q),
        torch.where(active & ~relevant, _delta_delete(st.S, st.Q, st.alpha),
        torch.where(active & relevant,
                    _delta_update(st.S, st.Q, st.alpha, alphan), 0.0)))
    return d, alphan, active, relevant


def _fsbl_step(A, st: SQState, live):
    """One greedy action per live row (add/delete/re-estimate its best
    atom). Returns (state, (max delta, atom or -1, action or -1))."""
    d, alphan, active, relevant = _fsbl_action_deltas(st)
    i = torch.argmax(d, dim=1)          # first maximum; a NaN counts as it
    d_i = _take(d, i)
    do = d_i > 0
    act_i, rel_i = _take(active, i), _take(relevant, i)
    a_i, an_i = _take(st.alpha, i), _take(alphan, i)
    gamma_change = torch.where(~act_i & rel_i, 1.0 / an_i,
                   torch.where(act_i & ~rel_i, -1.0 / a_i,
                   torch.where(act_i & rel_i, 1.0 / an_i - 1.0 / a_i, 0.0)))
    new_alpha_i = torch.where(rel_i, an_i, torch.inf)
    gamma_change = torch.where(do, gamma_change, 0.0)
    new_alpha_i = torch.where(do, new_alpha_i, a_i)
    st2 = _update_sqc(A, st, i, gamma_change)
    st2 = _keep(live, st2._replace(alpha=_set(st.alpha, i, new_alpha_i)), st)
    # action code: 0 add / 1 delete / 2 re-estimate
    action = torch.where(~act_i & rel_i, 0,
                         torch.where(act_i & ~rel_i, 1, 2)).to(torch.int32)
    info = (d_i, torch.where(do, i, -1).to(torch.int32),
            torch.where(do, action, -1))
    return st2, info


def _fsbl(A, Bs, sigma, maxiter: int, min_increase, traced: bool = False):
    """FSBL over the rows of Bs: (posterior means, alpha, SBLTrace or None;
    the trace (B, maxiter), padded past each row's stop)."""
    B = Bs.shape[0]
    st = _init_sq(A, Bs, sigma, _inactive(A, B))
    tr = None
    if traced:
        z = torch.zeros((B, maxiter), dtype=torch.int32, device=A.device)
        tr = SBLTrace(likelihood_delta=z.to(A.dtype), selected=z - 1,
                      action=z - 1, n_active=z.clone())
    done = torch.zeros((B,), dtype=torch.bool, device=A.device)
    for t in range(maxiter):
        if _stopped(done):
            break
        LOOP_COUNTS["steps"] += 1
        live = ~done
        st, (max_d, i, action) = _fsbl_step(A, st, live)
        if traced:
            n_active = torch.isfinite(st.alpha).sum(1).to(torch.int32)
            for field, v in zip(tr, (max_d, i, action, n_active)):
                field[:, t] = torch.where(live, v, field[:, t])
        # negated >=: a NaN gain stops the row instead of spinning
        done = done | ~(max_d >= min_increase)
    return _posterior_mean(A, Bs, sigma, st.alpha), st.alpha, tr


def _fsbl_rows(A, Bs, sigma, maxiter=None, min_increase: float = 1e-6,
               traced: bool = False):
    maxiter = int(maxiter if maxiter is not None else 2 * A.shape[1])
    with true_f32():
        return _fsbl(A, Bs, _on(sigma, A), maxiter,
                     _on(min_increase, A), traced)


def fsbl(A, b, sigma, maxiter: int | None = None, min_increase: float = 1e-6):
    """Fast SBL (Tipping & Faul 2003): greedy marginal-likelihood ascent
    picking the globally best add/delete/re-estimate action per step.
    Returns the dense posterior-mean weights."""
    A, b = as_inputs(A, b)
    return _fsbl_rows(A, b[None], sigma, maxiter, min_increase)[0][0]


def fsbl_traced(A, b, sigma, maxiter: int | None = None,
                min_increase: float = 1e-6):
    """fsbl returning (posterior mean, SBLTrace): per-action marginal-
    likelihood increases, acted-on atoms, action kinds, and active-set
    size. Pass a modest `maxiter` (default 2m): the trace is maxiter long."""
    A, b = as_inputs(A, b)
    x, _, tr = _fsbl_rows(A, b[None], sigma, maxiter, min_increase,
                          traced=True)
    return x[0], SBLTrace(*(f[0] for f in tr))


# ---------------------------------------------------------------------------
# RMPS: staged coordinate ascent (acquisition to exhaustion, then
# deletion/update), the paper's algorithm at finite noise
# ---------------------------------------------------------------------------

def _has_beneficial_add(st: SQState):
    s, q = _get_sq(st.S, st.Q, st.alpha)
    val = torch.where(~torch.isfinite(st.alpha) & (s < q * q),
                      _delta_add(st.S, st.Q), 0.0)
    return torch.amax(val, dim=1) > 0


def _acquisition_stage(A, st: SQState, maxiter: int, enabled):
    """Add atoms (best delta_add first) until no add is beneficial, on the
    `enabled` rows. Returns (state, starved): `starved` means the maxiter
    cap stopped the stage while a beneficial add was still available, and
    the outer loop must not declare convergence then."""
    stop = ~enabled
    for _ in range(maxiter):
        if _stopped(stop):
            break
        LOOP_COUNTS["steps"] += 1
        s, q = _get_sq(st.S, st.Q, st.alpha)
        active = torch.isfinite(st.alpha)
        relevant = s < q * q
        val = torch.where(~active & relevant, _delta_add(st.S, st.Q), 0.0)
        k = torch.argmax(val, dim=1)
        do = _take(val, k) > 0
        an = _optimal_alpha(_take(s, k), _take(q, k))
        st2 = _update_sqc(A, st, k, torch.where(do, 1.0 / an, 0.0))
        st2 = st2._replace(alpha=_set(
            st.alpha, k, torch.where(do, an, _take(st.alpha, k))))
        st = _keep(~stop, st2, st)
        stop = stop | ~do
    return st, _has_beneficial_add(st)


def _deletion_update_stage(A, st: SQState, maxiter: int, min_increase,
                           enabled):
    """Deletions (q^2/s < 1 rule) with interleaved alpha re-estimation, on
    the `enabled` rows."""
    stop = ~enabled
    for _ in range(maxiter):
        if _stopped(stop):
            break
        LOOP_COUNTS["steps"] += 1
        s, q = _get_sq(st.S, st.Q, st.alpha)
        active = torch.isfinite(st.alpha)
        relevant = s < q * q
        # deletion candidate: least q^2/s among active irrelevant atoms
        dv = torch.where(active & ~relevant, q * q / s, torch.inf)
        kd = torch.argmin(dv, dim=1)
        do_del = _take(dv, kd) < 1
        # update candidate: best re-estimation gain among active relevant
        alphan = _optimal_alpha(s, q)
        uv = torch.where(active & relevant,
                         _delta_update(st.S, st.Q, st.alpha, alphan), 0.0)
        ku = torch.argmax(uv, dim=1)
        uv_u = _take(uv, ku)
        do_upd = ~do_del & (uv_u > 0)
        upd_gain = torch.where(do_upd, uv_u, 0.0)

        i = torch.where(do_del, kd, ku)
        gamma_change = torch.where(
            do_del, -1.0 / _take(st.alpha, kd),
            torch.where(do_upd, 1.0 / _take(alphan, ku)
                        - 1.0 / _take(st.alpha, ku), 0.0))
        new_alpha_i = torch.where(
            do_del, torch.inf,
            torch.where(do_upd, _take(alphan, ku), _take(st.alpha, i)))
        st2 = _update_sqc(A, st, i, gamma_change)
        st2 = st2._replace(alpha=_set(st.alpha, i, new_alpha_i))
        st = _keep(~stop, st2, st)
        stop = stop | (~do_del & (upd_gain < min_increase))
    return st


def _rmps_outer_step(A, Bs, sigma, st, old, t: int, maxiter_acq: int,
                     maxiter_del: int, min_increase, live):
    """One outer RMPS iteration of the live rows (the one implementation
    behind _rmps_optimize and its traced form). Returns (state, old1 = the
    alpha after acquisition, done)."""
    # refresh: rebuild S/Q/C^-1 exactly from alpha, which bounds the
    # rank-one drift to one outer iteration. Not at t = 0: the entry state
    # was built from alpha0 while alpha itself is reset to Inf, and the
    # S/Q/C^-1 of alpha0 steer the first acquisition (the warm start)
    if t > 0:
        st = _keep(live, _init_sq(A, Bs, sigma, st.alpha), st)
    st, starved = _acquisition_stage(A, st, maxiter_acq, live)
    done1 = torch.all(st.alpha == old, dim=1)
    old1 = st.alpha
    st = _deletion_update_stage(A, st, maxiter_del, min_increase,
                                live & ~done1)
    # a capped acquisition stage with beneficial adds pending has not
    # converged, even where the deletion stage changed nothing
    done2 = torch.all(st.alpha == old1, dim=1) & ~starved
    return st, old1, done1 | done2


def _rmps_optimize(A, Bs, sigma, alpha0, maxiter: int, maxiter_acq: int,
                   maxiter_del: int, min_increase, traced: bool = False):
    """The staged ascent over the rows of Bs: (alpha (B, m), RMPSTrace or
    None). alpha is reset to Inf, but the S/Q/C^-1 built from alpha0 are
    kept for the first acquisition stage."""
    B = Bs.shape[0]
    st = _init_sq(A, Bs, sigma, alpha0)._replace(alpha=_inactive(A, B))
    old = st.alpha
    tr = None
    if traced:
        tr = RMPSTrace(*(torch.zeros((B, maxiter), dtype=torch.int32,
                                     device=A.device) for _ in range(4)))
    done = torch.zeros((B,), dtype=torch.bool, device=A.device)
    for t in range(maxiter):
        if _stopped(done):
            break
        live = ~done
        st, old1, done_t = _rmps_outer_step(A, Bs, sigma, st, old, t,
                                            maxiter_acq, maxiter_del,
                                            min_increase, live)
        if traced:
            fin0, fin1, fin2 = (torch.isfinite(old), torch.isfinite(old1),
                                torch.isfinite(st.alpha))
            counts = (fin2, fin1 & ~fin0, fin1 & ~fin2,
                      fin1 & fin2 & (st.alpha != old1))
            for field, c in zip(tr, counts):
                field[:, t] = torch.where(live, c.sum(1).to(torch.int32),
                                          field[:, t])
        old = st.alpha
        done = done | (live & done_t)
    return st.alpha, tr


def _rmps_args(A, maxiter, maxiter_acquisition, maxiter_deletion):
    n = A.shape[0]
    return tuple(int(x if x is not None else n)
                 for x in (maxiter, maxiter_acquisition, maxiter_deletion))


def _rmps_rows(A, Bs, sigma, maxiter=None, maxiter_acquisition=None,
               maxiter_deletion=None, min_increase: float = 1e-6,
               alpha0=None, return_alpha: bool = False):
    """`rmps` over the rows of Bs (B, n); `alpha0` (m,) is shared."""
    with true_f32():
        sig = _on(sigma, A)
        a0 = _inactive(A, 1)[0] if alpha0 is None else _on(alpha0, A)
        alpha, _ = _rmps_optimize(
            A, Bs, sig, a0,
            *_rmps_args(A, maxiter, maxiter_acquisition, maxiter_deletion),
            _on(min_increase, A))
        x = _posterior_mean(A, Bs, sig, alpha)
    return (x, alpha) if return_alpha else x


def rmps(A, b, sigma, maxiter: int | None = None,
         maxiter_acquisition: int | None = None,
         maxiter_deletion: int | None = None,
         min_increase: float = 1e-6, alpha0=None, return_alpha: bool = False):
    """Relevance Matching Pursuit at finite noise (RMP_sigma), staged
    marginal-likelihood coordinate ascent. Returns the dense posterior-mean
    weights (and with `return_alpha` the final prior precisions).

    The outer loop stops right after an acquisition stage that changed
    nothing, without running the deletion/update stage: the result is
    stationary for ADD actions, while a re-estimate or deletion gain may
    remain pending on degenerate problems. `rmps(..., alpha0=alpha)` runs a
    fresh full pass from there."""
    A, b = as_inputs(A, b)
    out = _rmps_rows(A, b[None], sigma, maxiter, maxiter_acquisition,
                     maxiter_deletion, min_increase, alpha0, return_alpha)
    if return_alpha:
        return out[0][0], out[1][0]
    return out[0]


def rmps_traced(A, b, sigma, maxiter: int | None = None,
                maxiter_acquisition: int | None = None,
                maxiter_deletion: int | None = None,
                min_increase: float = 1e-6):
    """rmps returning (posterior mean, RMPSTrace): per outer iteration the
    acquisitions, deletions, changed re-estimates and active-set size."""
    A, b = as_inputs(A, b)
    with true_f32():
        sig = _on(sigma, A)
        Bs = b[None]
        alpha, tr = _rmps_optimize(
            A, Bs, sig, _inactive(A, 1)[0],
            *_rmps_args(A, maxiter, maxiter_acquisition, maxiter_deletion),
            _on(min_increase, A), traced=True)
        x = _posterior_mean(A, Bs, sig, alpha)
    return x[0], RMPSTrace(*(f[0] for f in tr))


# ---------------------------------------------------------------------------
# Noise-variance learning
# ---------------------------------------------------------------------------

def _rmps_noise(A, Bs, sigma2_init, a_sigma2, b_sigma2, maxiter: int,
                min_increase, maxouteriter: int, min_change):
    """The noise-learning EM loop over the rows of Bs: (X (B, m), sigma2
    (B,)). A row that converged is frozen and leaves the batch: each EM
    iteration solves only the rows still running."""
    n = A.shape[0]
    B = Bs.shape[0]
    alpha = _inactive(A, B)
    s2 = sigma2_init.expand(B).clone()
    done = torch.zeros((B,), dtype=torch.bool, device=A.device)
    for _ in range(maxouteriter):
        if _stopped(done):
            break
        rows = torch.nonzero(~done)[:, 0]
        Bl, s2l = Bs[rows], s2[rows]
        # each inner solve COLD-starts: a warm C partly explains the atoms
        # and the EM falls into a period-2 sigma^2 oscillation
        alpha2, _ = _rmps_optimize(A, Bl, s2l, _inactive(A, 1)[0], maxiter,
                                   n, n, min_increase)
        x = _posterior_mean(A, Bl, s2l, alpha2)
        g = torch.where(torch.isfinite(alpha2), 1.0 / alpha2, 0.0)
        r = Bl - x @ A.T
        s2_new = ((torch.sum(r * r, dim=1) + 2 * b_sigma2)
                  / (n - torch.sum(g, dim=1) + 2 * a_sigma2))
        alpha[rows] = alpha2
        s2[rows] = s2_new
        done[rows] = torch.abs(s2_new - s2l) < min_change
    return _posterior_mean(A, Bs, s2, alpha), s2


def _rmps_noise_rows(A, Bs, sigma2_init=1e-2, a_sigma2=0.0, b_sigma2=0.0,
                     maxiter=None, min_increase=1e-6, maxouteriter=16,
                     min_change=1e-12):
    maxiter = int(maxiter if maxiter is not None else 2 * A.shape[1])
    with true_f32():
        return _rmps_noise(
            A, Bs, _on(sigma2_init, A), _on(a_sigma2, A),
            _on(b_sigma2, A), maxiter, _on(min_increase, A),
            int(maxouteriter), _on(min_change, A))


def rmps_estimate_noise(A, b, sigma2_init: float = 1e-2, a_sigma2: float = 0.0,
                        b_sigma2: float = 0.0, maxiter: int | None = None,
                        min_increase: float = 1e-6, maxouteriter: int = 16,
                        min_change: float = 1e-12):
    """RMPS with noise-variance learning: an outer EM loop re-estimating
    sigma^2 under an Inverse-Gamma(a, b) prior. Returns (x, sigma2). Each
    inner RMPS cold-starts."""
    A, b = as_inputs(A, b)
    x, s2 = _rmps_noise_rows(A, b[None], sigma2_init, a_sigma2, b_sigma2,
                             maxiter, min_increase, maxouteriter, min_change)
    return x[0], float(s2[0])
