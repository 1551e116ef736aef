"""Convex sparse recovery (PyTorch counterpart of
cstpu.models.basis_pursuit): (weighted) Basis Pursuit, BP denoising, Candes
and ARD reweighting, ISTA/FISTA. Signatures are cstpu's.

  * bp:  min w'|x| s.t. Ax = b       — ADMM with the constraint row-whitened
         (two shifted passes and one unshifted), so the affine projection
         is a GEMV pair; `method="simplex"` runs the native exact LP.
  * bpd: min w'|x| s.t. ||Ax-b|| <= delta — by default the bracketed secant
         on the LASSO Pareto curve with restarting FISTA inner solves
         (certified inside the ball or the NaN vector); `method="admm"`
         runs the 3-way ADMM splitting, `method="homotopy"` the native
         LASSO-path solver.

The reweighting loops and weight rules follow cstpu: Candes
w = 1/(|x|+eps) and the ARD/SBL-prior weights w_j = sqrt(a_j' K^-1 a_j),
K = eps*I + A diag(|x|/w) A', with the dual-slack screen of the reweighted
BPD at large m.

cstpu's `lax.while_loop`s (the ADMM and restarting-FISTA loops) are Python
loops over device tensors. The stop test is computed on the device every
iteration, and once it is set the state is frozen (`torch.where`), so the
steps after it are exact no-ops (the adaptive rho reads the frozen
iteration count too); the host reads the latch every `CHECK_EVERY`
iterations. The result is bit for bit what a read every iteration gives.
Where every tensor of a loop lies on one card, a block of CHECK_EVERY
iterations (~50 small launches each) is captured once per loop as a CUDA
graph on that card and replayed: the host's launch cost was ~0.75 ms an
iteration against ~0.09 ms of device work. A loop over the CPU or over
several cards (a mesh of devices) runs eagerly. `LOOP_COUNTS` counts loop bodies run (frozen ones included), latch
reads and graph replays. ISTA/FISTA and the power iterations are
`fori_loop`s in cstpu: fixed counts, no latch.

There is no kernel here: cstpu's convex paths reach no Pallas kernel, so
the port runs tensor operations (cuBLAS GEMVs, cuSOLVER factorizations),
every body in true f32 (`true_f32`, no TF32), as cstpu pins f32 products:
the bf16 default breaks ADMM feasibility. The secant and screening loops
decide on the host in float64 numpy, as cstpu's do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cstpu_torch.ops.util import as_inputs, cholesky_nan, true_f32

LOOP_COUNTS = {"iterations": 0, "latch_reads": 0, "replays": 0}
CHECK_EVERY = 32          # loop iterations between two reads of the latch


def _stopped(done) -> bool:
    """One latch read of a device bool."""
    LOOP_COUNTS["latch_reads"] += 1
    return bool(done)


def _map(fn, *trees):
    """fn over the tensors of one or more states of the same structure (a
    list entry holds one tensor per shard)."""
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _freeze(done, old, new):
    """`old` where the latch `done` was set, else `new`, entry by entry."""
    return _map(lambda o, x: torch.where(done.to(o.device), o, x), old, new)


def _rho_mode(i: int) -> str:
    """What cstpu's adaptive rho does at iteration i (its loop counter t):
    rebalance at t % 64 == 63, clamp into [1e-4, 1e6] at t == 0 (the
    caller's rho may lie outside), and nothing else: once rho lies in the
    clamp's range, cstpu's clip(rho * 1) / rho is exactly 1."""
    return "adapt" if i % 64 == 63 else ("clamp" if i == 0 else "plain")


def _steps(body, state, i0: int, n: int):
    """Iterations i0 .. i0 + n - 1 of the loop, eagerly."""
    for i in range(i0, i0 + n):
        state = _freeze(state[-1], state, body(state, _rho_mode(i)))
    return state


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _graph_device(devices):
    """The one CUDA device among `devices`, else None. A CUDA graph holds
    the work of one device: its capture records only what is launched on
    its own stream, so a loop whose tensors lie on the CPU or on more than
    one card runs eagerly."""
    devs = {torch.device(d) for d in devices}
    if len(devs) != 1:
        return None
    (dev,) = devs
    return dev if dev.type == "cuda" and dev.index is not None else None


def _capture(body, static, i0: int, n: int, dev):
    """A CUDA graph of iterations i0 .. i0 + n - 1 on device `dev` that
    reads its state from `static` and writes it back there. Captured on a
    side stream of `dev`; nothing runs until a replay."""
    graph = torch.cuda.CUDAGraph()
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        graph.capture_begin()
        _map(lambda d, x: d.copy_(x), static, _steps(body, static, i0, n))
        graph.capture_end()
    main.wait_stream(side)
    return graph


def _latched(body, state, maxiter: int, devices=(), graphs: bool = True):
    """cstpu's `lax.while_loop(lambda c: (t < maxiter) & ~c.done, body,
    state)`: `state` is a tuple whose last entry is the device latch `done`,
    and `body(state, rho_mode)` one iteration. A body whose entry state was
    done leaves it as it was (`torch.where`), so the latch is read only
    every CHECK_EVERY iterations. Where the state's tensors and `devices`
    (every device the body's own tensors lie on) are one card, each block
    of CHECK_EVERY iterations after one eager block replays a CUDA graph
    captured on that card once per pattern of rho modes (two at
    CHECK_EVERY = 32): the same kernels on the same buffers, without the
    host's launch cost. `graphs=False` runs every block eagerly."""
    dev = _graph_device([x.device for x in _leaves(state)] + list(devices))
    cuda_graphs = {}
    i = 0
    while i < int(maxiter):
        if i and _stopped(state[-1]):
            break
        n = min(CHECK_EVERY, int(maxiter) - i)
        key = tuple(_rho_mode(j) for j in range(i, i + n))
        if i and n == CHECK_EVERY and graphs and dev is not None:
            with torch.cuda.device(dev):
                if not cuda_graphs:
                    # the graphs' state buffers: distinct, no aliases
                    state = _map(torch.clone, state)
                if key not in cuda_graphs:
                    cuda_graphs[key] = _capture(body, state, i, n, dev)
                cuda_graphs[key].replay()
            LOOP_COUNTS["replays"] += 1
        else:
            state = _steps(body, state, i, n)
        LOOP_COUNTS["iterations"] += n
        i += n
    return state


def _in_f32(fn):
    """Run fn with full-f32 products (cstpu's `_f32_matmuls`)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with true_f32():
            return fn(*args, **kwargs)
    return wrapped


def _c(v, like):
    """v as a 0-d tensor in like's dtype on like's device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _norm(x):
    return torch.linalg.vector_norm(x)


def _np64(x):
    """x as a float64 numpy array (a device tensor is copied to the
    host)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _shrink(x, t):
    """Soft-thresholding prox of the (weighted) l1 norm: x - clip(x, -t, t),
    bit for bit sign(x) max(|x| - t, 0) but for the sign of a zero.
    Parity: `shrinkage` (the reference's src/basispursuit.jl:144)."""
    return x - torch.clamp(x, -t, t)


def _adapt_rho(rho_, pri, dua, mu, tau, mode: str):
    """cstpu's residual balancing every 64 iterations (Boyd 3.4.1),
    clamped: (rho', the factor the scaled duals divide by, or None where
    it is exactly 1). `mode` is `_rho_mode` of the iteration."""
    if mode == "plain":
        return rho_, None
    fac = torch.ones_like(tau)
    if mode == "adapt":
        fac = torch.where(pri > mu * dua, tau,
                          torch.where(dua > mu * pri, 1.0 / tau, fac))
    rho_new = torch.clamp(rho_ * fac, 1e-4, 1e6)
    return rho_new, rho_new / rho_


def _rescale(u, fac):
    """The scaled dual(s) u / fac (a shard list too); u where fac is
    None."""
    if fac is None:
        return u
    return _map(lambda x: x / fac.to(x.device), u)


def _latch(like):
    """The latch at entry: False on like's device."""
    return torch.zeros((), dtype=torch.bool, device=like.device)


# ---------------------------------------------------------------------------
# Basis pursuit (equality-constrained weighted l1)
# ---------------------------------------------------------------------------

def _whiten(A, b):
    """Row-whiten Ax = b: three passes Aw <- L^-1 Aw, bw <- L^-1 bw with
    L = chol(Aw Aw' + shift max(diag) I), the first two shifted by 8n ulps
    (keeps the f32 factor real once cond(A)^2 eps ~ 1), the last unshifted
    (orthonormal rows to rounding). See cstpu's `_bp_admm`."""
    n = A.shape[0]
    eps = torch.finfo(A.dtype).eps
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Aw, bw = A, b
    for shift in (8.0 * n * eps, 8.0 * n * eps, 0.0):
        G = Aw @ Aw.T
        G = G + (shift * torch.max(torch.diagonal(G))) * eye
        L = cholesky_nan(G)
        Aw = torch.linalg.solve_triangular(L, Aw, upper=False)
        bw = torch.linalg.solve_triangular(L, bw[:, None], upper=False)[:, 0]
    return Aw, bw


def _admm_consts(like):
    """Over-relaxation 1.8 (Boyd 3.4.3), residual-balancing mu = 10 and
    tau = 2 (Boyd 3.4.1), in like's dtype."""
    return _c(1.8, like), _c(10.0, like), _c(2.0, like)


@_in_f32
def _bp_admm(A, b, w, rho, maxiter: int, tol, z0=None, u0=None):
    """Weighted BP by ADMM on the row-whitened constraint, with
    over-relaxation and residual-balanced rho: (z, u, rho_f). rho_f must
    accompany (z, u) into any warm start: u is the SCALED dual y/rho."""
    Aw, bw = _whiten(A, b)

    def project(v):  # exact projection onto {x : Ax = b} (orthonormal rows)
        return v - (Aw @ v - bw) @ Aw

    x0 = bw @ Aw  # min-norm feasible point
    relax, mu, tau = _admm_consts(A)
    relax1 = 1.0 - relax

    def body(c, mode):
        z, u, rho_, _ = c
        x = project(z - u)
        xh = relax * x + relax1 * z
        z_new = _shrink(xh + u, w / rho_)
        u = u + xh - z_new
        pri = _norm(x - z_new)
        dua = rho_ * _norm(z_new - z)
        scale = 1.0 + _norm(z_new)
        done = (pri < tol * scale) & (dua < tol * scale)
        rho_new, fac = _adapt_rho(rho_, pri, dua, mu, tau, mode)
        return z_new, _rescale(u, fac), rho_new, done

    z_init = x0 if z0 is None else z0
    u_init = torch.zeros_like(x0) if u0 is None else u0
    z, u, rho_f, _ = _latched(body, (z_init, u_init, rho, _latch(A)),
                              maxiter)
    return z, u, rho_f


def _weights(w, A):
    m = A.shape[1]
    if w is None:
        return torch.ones((m,), dtype=A.dtype, device=A.device)
    return torch.as_tensor(w, dtype=A.dtype, device=A.device)


def _tensor(b, A):
    return torch.as_tensor(b, dtype=A.dtype, device=A.device)


def bp(A, b, w=None, rho: float = 1.0, maxiter: int = 20000,
       tol: float = None, method: str = "admm"):
    """(Weighted) basis pursuit: min sum w_i |x_i| s.t. Ax = b.

    Returns a dense vector with exact zeros off the support (the shrinkage
    iterate). Parity target: `basispursuit` (the reference's
    src/basispursuit.jl:1-16).

    `method`: "admm" (default, on the device) or "simplex" (exact vertex
    solution via the native C++ solver in cstpu_torch.native, on the
    host in float64).

    Precision contract: the ADMM constraint is row-whitened (twice — the
    second pass removes the first's O(cond*eps) forward error), so it
    converges at the input dtype's resolution even on conditioned
    dictionaries. On dictionaries with f32-IDENTICAL near-duplicate atoms
    the optimum face is flat below the f32 noise floor; pass f64 inputs or
    use method="simplex" there.
    """
    A, b = as_inputs(A, b)
    b = _tensor(b, A)
    if method == "simplex":
        from cstpu_torch.native import bp_simplex

        wn = None if w is None else _np64(w)
        x = bp_simplex(_np64(A), _np64(b), wn)
        return torch.as_tensor(x, dtype=A.dtype, device=A.device)
    if method != "admm":
        raise ValueError(f"unknown method {method!r}")
    w = _weights(w, A)
    if tol is None:
        tol = 1e-9 if A.dtype == torch.float64 else 1e-6
    z, _, _ = _bp_admm(A, b, w, _c(rho, A), int(maxiter), _c(tol, A))
    return z


basispursuit = bp


# ---------------------------------------------------------------------------
# Basis pursuit denoising (l2-ball constrained weighted l1)
# ---------------------------------------------------------------------------

def _ball(b, delta):
    """Projection onto {y : ||y - b|| <= delta}."""
    tiny = torch.finfo(b.dtype).tiny  # 1e-300 underflows to 0 in f32

    def project_ball(v):
        d = v - b
        nd = _norm(d)
        return b + d * torch.clamp(delta / torch.clamp(nd, min=tiny),
                                   max=1.0)
    return project_ball


@_in_f32
def _bpd_admm(A, b, delta, w, rho, maxiter: int, tol):
    """Weighted BPD by ADMM over (x, z = x, y = Ax) on the operator scaled
    by 1/sigma_max (the splitting blocks stay commensurate at any m):
    (z, uz, uy, rho_f, s). uy is in the SCALED space, so the dual
    certificate is nu = rho_f uy / s with A' nu in w d|x| at the optimum."""
    n, m = A.shape
    s = torch.sqrt(_sigma_max_sq(A))
    A = A / s
    b = b / s
    delta = delta / s
    # x-update solves (I + A'A) x = rhs; factor once on the smaller side
    # the factor's inverse is explicit: I + A'A / s^2 has its eigenvalues
    # in [1, 2], so a GEMV applies it as accurately as two triangular
    # solves, at a fraction of their time
    if m <= n:
        Kinv = torch.cholesky_inverse(cholesky_nan(
            torch.eye(m, dtype=A.dtype, device=A.device) + A.T @ A))

        def xstep(rhs):
            x = Kinv @ rhs
            return x, A @ x
    else:
        Kinv = torch.cholesky_inverse(cholesky_nan(
            torch.eye(n, dtype=A.dtype, device=A.device) + A @ A.T))

        def xstep(rhs):  # Woodbury: (I + A'A)^-1 = I - A'(I + AA')^-1 A
            c = Kinv @ (A @ rhs)
            # A x = A rhs - AA' c = c exactly: the fit is the correction
            return rhs - c @ A, c

    project_ball = _ball(b, delta)
    _, mu, tau = _admm_consts(A)

    def body(c, mode):
        z, y, uz, uy, rho_, _ = c
        x, Ax = xstep((z - uz) + (y - uy) @ A)
        z_new = _shrink(x + uz, w / rho_)
        y_new = project_ball(Ax + uy)
        uz = uz + x - z_new
        uy = uy + Ax - y_new
        pri = _norm(x - z_new) + _norm(Ax - y_new)
        dua = rho_ * (_norm(z_new - z) + _norm(y_new - y))
        scale = 1.0 + _norm(z_new)
        done = (pri < tol * scale) & (dua < tol * scale)
        rho_new, fac = _adapt_rho(rho_, pri, dua, mu, tau, mode)
        return (z_new, y_new, _rescale(uz, fac), _rescale(uy, fac), rho_new,
                done)

    z0 = torch.zeros((m,), dtype=A.dtype, device=A.device)
    z, _, uz, uy, rho_f, _ = _latched(
        body, (z0, b.clone(), z0, torch.zeros_like(b), rho, _latch(A)),
        maxiter)
    return z, uz, uy, rho_f, s


@_in_f32
def _fista_conv(A, b, w, lam, x0, stepsize, maxiter: int, rtol):
    """Weighted-LASSO FISTA (min ||Ax-b||^2 + lam sum w_i |x_i|) with
    gradient-scheme adaptive restart (O'Donoghue & Candes 2015) and a
    relative-change stop. Returns x. The inner engine of the secant BPD
    solver."""
    one = _c(1.0, A)

    def body(c, mode):
        x, y, t, _ = c
        g = (b - A @ y) @ A
        x_new = _shrink(y + 2.0 * stepsize * g, (lam * stepsize) * w)
        t_new = (1.0 + torch.sqrt(1.0 + 4.0 * t * t)) / 2.0
        # gradient restart: momentum pointing uphill -> drop it
        restart = torch.sum((y - x_new) * (x_new - x)) > 0.0
        t_new = torch.where(restart, one, t_new)
        y_new = torch.where(restart, x_new,
                            x_new + ((t - 1.0) / t_new) * (x_new - x))
        done = _norm(x_new - x) <= rtol * (1.0 + _norm(x_new))
        return x_new, y_new, t_new, done

    return _latched(body, (x0, x0, one, _latch(A)), maxiter)[0]


def _support_ls_blend(A, b, x, delta):
    """Feasibility snap: move x toward the least-squares refit on its own
    support until ||Ax - b|| == delta exactly (the residual norm is convex
    along the segment, so the crossing is a quadratic root). Returns
    (x64, ok) in float64 numpy; ok=False when the support's LS residual
    itself misses the ball (no feasible point exists on the segment)."""
    A64 = _np64(A)
    b64 = _np64(b)
    x64 = _np64(x)
    r = b64 - A64 @ x64
    rho = float(np.linalg.norm(r))
    if rho <= delta:
        return x64, True
    sup = np.flatnonzero(x64)
    if sup.size == 0 or sup.size > A64.shape[0]:
        return x64, False
    As = A64[:, sup]
    xs = np.linalg.lstsq(As, b64, rcond=None)[0]
    rls = b64 - As @ xs
    if float(np.linalg.norm(rls)) > delta:
        return x64, False
    d = rls - r
    aa = float(d @ d)
    bb = 2.0 * float(r @ d)
    # aim 1e-6 INSIDE the ball: the blend is computed in f64 but the
    # caller casts back to the input dtype, and an exact-boundary point
    # rounds outside at f32 (~1e-7 relative)
    dtarget = delta * (1.0 - 1e-6)
    cc = rho * rho - dtarget * dtarget
    disc = bb * bb - 4.0 * aa * cc
    if aa <= 0.0 or disc < 0.0:
        t = 1.0
    else:  # q(0) = cc > 0, q(1) <= 0: the unique crossing in (0, 1]
        t = (-bb - np.sqrt(disc)) / (2.0 * aa)
        if not 0.0 < t <= 1.0:
            t = 1.0
    out = x64.copy()
    out[sup] = (1.0 - t) * x64[sup] + t * xs
    return out, True


def _nan_vector(m: int, like):
    return torch.full((m,), torch.nan, dtype=like.dtype, device=like.device)


def _lam_max(A, b, w):
    """2 max_j |a_j'b| / w_j over the finite ratios, on the host in f64:
    the penalty where the LASSO solution leaves x = 0."""
    corr = _np64(torch.abs(b @ A)) / np.maximum(_np64(w), 1e-300)
    corr = corr[np.isfinite(corr)]
    return 2.0 * (float(np.max(corr)) if corr.size else 0.0)


@_in_f32
def _bpd_secant(A, b, delta, w=None, maxiter_outer: int = 24,
                inner: int = 4000, band: float = 0.02, x0=None):
    """BPD by root-finding on the LASSO Pareto curve (SPGL1-style).

    rho(lam) = ||A x_lam - b|| of the penalized solution
    min ||Ax-b||^2 + lam sum w|x| is nondecreasing in lam with
    rho(lam_max) = ||b||, so a bracketed secant on lam — with warm-started
    FISTA inner solves — drives rho into [delta(1-band), delta].
    Feasibility of the RETURNED point is measured from the iterate, with
    the reference's NaN-vector failure path (its src/basispursuit.jl:91-98)
    for genuinely infeasible problems.

    Returns (x, info) with info = {feasible, rho, lam, outers}.
    """
    m = A.shape[1]
    b = _tensor(b, A)
    delta = float(delta)
    w = _weights(w, A)
    nb = float(_norm(b))
    if nb <= delta:
        return (torch.zeros((m,), dtype=A.dtype, device=A.device),
                {"feasible": True, "rho": nb, "lam": float("inf"),
                 "outers": 0})
    lam_max = _lam_max(A, b, w)
    if lam_max <= 0.0:  # every atom infinitely weighted: only x = 0
        return (_nan_vector(m, A),
                {"feasible": False, "rho": nb, "lam": 0.0, "outers": 0})
    step = _auto_stepsize(A)
    rtol = _c(1e-12 if A.dtype == torch.float64 else 1e-7, A)

    def solve(lam, x):
        return _fista_conv(A, b, w, _c(lam, A), x, step, int(inner), rtol)

    def rho_of(x):
        return float(_norm(b - A @ x))

    x_start = (torch.zeros((m,), dtype=A.dtype, device=A.device)
               if x0 is None else _tensor(x0, A))
    return _pareto_secant_loop(A, b, solve, rho_of, x_start, nb, lam_max,
                               delta, band, int(maxiter_outer))


def _pareto_secant_loop(A, b, solve, rho_of, x, nb, lam_max, delta,
                        band, maxiter_outer):
    """The shared bracketed-secant outer loop of the Pareto BPD solvers
    (single-device and sharded): `solve(lam, x_warm)` returns the weighted
    LASSO solution at penalty lam, `rho_of(x)` the measured residual
    norm. `A` is read only by the feasibility snap. Returns (x, info)."""
    m = x.shape[0]
    lam_hi, rho_hi = lam_max, nb          # the x = 0 end of the curve
    lam_lo = rho_lo = x_lo = None         # feasible side (rho <= delta)
    lam = lam_max * delta / nb            # exact for orthonormal rows
    target = delta * (1.0 - 0.5 * band)
    rho = nb
    outers = 0
    for outers in range(1, int(maxiter_outer) + 1):
        x = solve(lam, x)
        rho = rho_of(x)
        if rho <= delta:
            if lam_lo is None or lam > lam_lo:
                lam_lo, rho_lo, x_lo = lam, rho, x
            if rho >= delta * (1.0 - band):
                break
        elif lam < lam_hi:
            lam_hi, rho_hi = lam, rho
        if lam_lo is not None:
            if rho_lo >= delta * (1.0 - band):
                break
            den = rho_hi - rho_lo
            if den > 0.0:
                lam = lam_lo + (target - rho_lo) * (lam_hi - lam_lo) / den
            else:
                lam = 0.5 * (lam_lo + lam_hi)
            if not lam_lo < lam < lam_hi:  # secant left the bracket
                lam = float(np.sqrt(lam_lo * max(lam_hi, 1e-300)))
        else:
            # still infeasible everywhere tried: shrink lam toward 0
            # (rho is ~linear in lam near lam_max, so delta/rho is the
            # right scale), floored so lam cannot collapse in one step
            lam = lam * min(max(0.9 * delta / max(rho, 1e-300), 0.02),
                            0.95)
            if lam < lam_max * 1e-13:
                break  # rho(0+) > delta: problem likely infeasible
    if x_lo is not None:
        return x_lo, {"feasible": True, "rho": rho_lo, "lam": lam_lo,
                      "outers": outers}
    xs, ok = _support_ls_blend(A, b, x, delta)
    if ok:
        rho_s = float(np.linalg.norm(_np64(b) - _np64(A) @ xs))
        return (torch.as_tensor(xs, dtype=x.dtype, device=x.device),
                {"feasible": True, "rho": rho_s, "lam": lam,
                 "outers": outers})
    return (_nan_vector(m, x),
            {"feasible": False, "rho": rho, "lam": lam, "outers": outers})


def _residual_norm(A, x, b) -> float:
    with true_f32():
        return float(_norm(A @ x - b))


def bpd(A, b, delta: float, w=None, rho: float = 1.0, maxiter: int = 20000,
        tol: float = None, method: str = "secant", feas_tol: float = 0.05,
        on_infeasible: str = "nan", return_info: bool = False):
    """(Weighted) basis pursuit denoising: min sum w_i |x_i|
    s.t. ||Ax - b||_2 <= delta. Parity target: `basis_pursuit_denoising`
    (the reference's src/basispursuit.jl:80-100).

    `method`:
      * "secant" (default) — SPGL1-style root-finding on the LASSO
        Pareto curve with FISTA inner solves; the returned point is
        certified feasible (its residual is measured, not trusted from
        solver state) or the NaN failure vector, matching the
        reference's ECOS semantics incl. the solver-failure NaN path.
      * "admm" — the 3-way splitting; a final iterate with
        ||Ax-b|| > delta*(1+feas_tol) triggers `on_infeasible`.
      * "homotopy" — exact-to-rounding via the native C++ LASSO-path
        solver (the role ECOS plays for the reference).

    `on_infeasible` (certified methods): "nan" returns the reference's
    NaN vector; "snap" first attempts the support-LS feasibility blend;
    "raw" returns the iterate unchanged. `return_info=True` additionally
    returns {feasible, rho, ...}.

    delta <= 0 is the equality-BP limit: routed to ADMM with
    on_infeasible="raw" (the ball contract is vacuous there)."""
    A, b = as_inputs(A, b)
    b = _tensor(b, A)
    m = A.shape[1]

    def _with_info(x, info):
        return (x, info) if return_info else x

    if method == "homotopy":
        from cstpu_torch.native import bpd_homotopy

        x, _lam = bpd_homotopy(_np64(A), _np64(b), float(delta),
                               None if w is None else _np64(w))
        x = torch.as_tensor(x, dtype=A.dtype, device=A.device)
        rho_f = _residual_norm(A, x, b)
        return _with_info(x, {"feasible": rho_f <= float(delta) * (1 + 1e-9)
                              + 1e-12, "rho": rho_f})
    if float(delta) <= 0.0 and method in ("secant", "admm"):
        method, on_infeasible = "admm", "raw"
    if method == "secant":
        inner = max(500, int(maxiter) // 5)
        # the secant's last iterate is not retained: "raw" == "nan" here
        x, info = _bpd_secant(A, b, delta, w, inner=inner)
        return _with_info(x, info)
    if method != "admm":
        raise ValueError(f"unknown method {method!r}")
    w = _weights(w, A)
    if tol is None:
        tol = 1e-8 if A.dtype == torch.float64 else 1e-5
    x = _bpd_admm(A, b, _c(delta, A), w, _c(rho, A), int(maxiter),
                  _c(tol, A))[0]
    rho_f = _residual_norm(A, x, b)
    feas = rho_f <= float(delta) * (1.0 + float(feas_tol))
    info = {"feasible": feas, "rho": rho_f, "method": "admm"}
    if feas or on_infeasible == "raw":
        return _with_info(x, info)
    if on_infeasible == "snap":
        xs, ok = _support_ls_blend(A, b, x, float(delta))
        if ok:
            return _with_info(torch.as_tensor(xs, dtype=A.dtype,
                                              device=A.device),
                              {"feasible": True,
                               "rho": float(delta), "method": "admm+snap"})
    return _with_info(_nan_vector(m, A), info)


basis_pursuit_denoising = bpd


# ---------------------------------------------------------------------------
# Reweighting loops and weight rules
# ---------------------------------------------------------------------------

def basispursuit_reweighting(A, b, reweight, maxiter: int = 8,
                             min_decrease: float = 1e-8):
    """Iteratively reweighted BP. Parity: the reference's
    src/basispursuit.jl:18-31.

    Consecutive LP solves are warm-started from the previous ADMM iterate
    (z, u) at the adapted rho: the weights only move the shrinkage
    threshold, so the dual state stays valid."""
    A, b = as_inputs(A, b)
    b = _tensor(b, A)
    m = A.shape[1]
    w = torch.ones((m,), dtype=A.dtype, device=A.device)
    tol = _c(1e-9 if A.dtype == torch.float64 else 1e-6, A)
    x, u, rho = _bp_admm(A, b, w, _c(1.0, A), 20000, tol)
    for _ in range(1, int(maxiter)):
        w = reweight(w, x)
        xs, u, rho = _bp_admm(A, b, w, rho, 20000, tol, z0=x, u0=u)
        if float(_norm(xs - x)) < min_decrease:
            return xs
        x = xs
    return x


def _idx(kidx, like):
    return torch.as_tensor(kidx, dtype=torch.long, device=like.device)


def _regather(x_sub, solved_idx, kidx, m: int, like):
    """x_sub on the columns solved_idx, scattered to m and gathered on the
    columns kidx."""
    full = torch.zeros((m,), dtype=like.dtype, device=like.device)
    full[_idx(solved_idx, like)] = x_sub
    return full[_idx(kidx, like)]


def _scatter64(x_sub, kidx, m: int):
    out = np.zeros((m,), np.float64)
    out[kidx] = _np64(x_sub)
    return out


def bpd_reweighting(A, b, delta, reweight, maxiter: int = 8,
                    min_decrease: float = 1e-4, method: str = "admm",
                    reweight_builder=None, screen: bool | None = None,
                    screen_margin: float = 0.5,
                    maxiter_admm: int = 20000):
    """Iteratively reweighted BPD. Parity: the reference's
    src/basispursuit.jl:102-115. `method` selects the inner solver
    ("admm", "secant" or "homotopy").

    `screen` (ADMM and secant; auto-on at m >= 65536 when
    `reweight_builder` is given): dual-slack screening with a full-m KKT
    verification — the ADMM's ball dual satisfies A'(rho uy / s) in
    w d|x| at the optimum (the secant's LASSO multiplier plays that role),
    so one full-m GEMV checks every discarded atom.
    `reweight_builder(A_sub)` returns the reweight function for a column
    subset.

    Every answer leaves through `_certify`: inside the ball (snapped by the
    support-LS blend where the last iterate stopped short), the iterate
    itself where it is within 1.05 delta and the blend is unavailable (as
    cstpu does), or the NaN vector."""
    A, b = as_inputs(A, b)
    b = _tensor(b, A)
    n, m = A.shape
    if screen is None:
        screen = (method in ("admm", "secant")
                  and reweight_builder is not None
                  and m >= (1 << 16))
    tol = _c(1e-8 if A.dtype == torch.float64 else 1e-5, A)

    # inner solves run with on_infeasible="raw": a mid-loop iterate that
    # has not reached the ball is still a valid reweighting anchor
    def _certify(x):
        rho_f = _residual_norm(A, x, b)
        if rho_f <= float(delta) * (1.0 + 1e-6) or float(delta) <= 0.0:
            return x
        xs, ok = _support_ls_blend(A, b, x, float(delta))
        if ok:
            return torch.as_tensor(xs, dtype=A.dtype, device=A.device)
        if rho_f <= float(delta) * 1.05:
            return x  # inside engineering tolerance, blend unavailable
        return _nan_vector(m, A)

    def unscreened(x):
        w = torch.ones((m,), dtype=A.dtype, device=A.device)
        for _ in range(1, int(maxiter)):
            w = reweight(w, x)
            xs = bpd(A, b, delta, w, method=method, maxiter=maxiter_admm,
                     on_infeasible="raw")
            if float(_norm(xs - x)) < min_decrease:
                return _certify(xs)
            x = xs
        return _certify(x)

    if not screen:
        return unscreened(bpd(A, b, delta, method=method,
                              maxiter=maxiter_admm, on_infeasible="raw"))

    if method == "secant":
        return _bpd_reweighting_screened_secant(
            A, b, delta, reweight, reweight_builder, int(maxiter),
            float(min_decrease), float(screen_margin), _certify)

    dlt = _c(delta, A)
    ones = torch.ones((m,), dtype=A.dtype, device=A.device)
    x, uz, uy, rho, sc = _bpd_admm(A, b, dlt, ones, _c(1.0, A),
                                   int(maxiter_admm), tol)
    slack = float(rho) * np.abs(_np64(uz))
    keep = (slack >= (1.0 - float(screen_margin))) | (np.abs(_np64(x)) > 0)
    kidx = np.flatnonzero(keep)
    if kidx.size == 0:
        # degenerate first solve (x = 0 with near-zero duals): never run
        # the sub-solver on an (n, 0) dictionary
        if float(_norm(b)) <= float(delta) * (1.0 + 1e-9):
            return torch.zeros((m,), dtype=A.dtype, device=A.device)
        kidx = np.arange(m)
    if kidx.size > max(m // 8, 4 * n):
        return unscreened(x)  # dual not settled enough

    ktol = 1e-3
    solved_idx = kidx
    x_sub = x[_idx(kidx, A)]
    A64 = None
    for _ in range(3):
        # regather the warm start from the PREVIOUS round's (indices,
        # values) onto the current (possibly repair-extended) kept set
        x_sub = _regather(x_sub, solved_idx, kidx, m, A)
        solved_idx = kidx
        A_sub = A[:, _idx(kidx, A)]
        sub_reweight = reweight_builder(A_sub)
        w_sub = torch.ones((kidx.size,), dtype=A.dtype, device=A.device)
        uy_s = None
        for _o in range(1, int(maxiter)):
            w_sub = sub_reweight(w_sub, x_sub)
            xs, _, uy_s, rho_s, s_s = _bpd_admm(
                A_sub, b, dlt, w_sub, _c(1.0, A), int(maxiter_admm), tol)
            moved = float(_norm(xs - x_sub))
            x_sub = xs
            if moved < min_decrease:
                break
        if uy_s is None:  # maxiter == 1: no reweighting happened
            break
        # --- full-m KKT verification via the ball dual ----------------
        x_full = torch.zeros((m,), dtype=A.dtype, device=A.device)
        x_full[_idx(kidx, A)] = x_sub
        w_full = _np64(reweight(ones, x_full))
        nu = (float(rho_s) / float(s_s)) * _np64(uy_s)
        if A64 is None:
            A64 = _np64(A)
        margins = np.abs(nu @ A64)
        viol = margins > w_full * (1.0 + ktol)
        viol[kidx] = False
        bad = np.flatnonzero(viol)
        if bad.size == 0:
            return _certify(x_full)
        kidx = np.sort(np.concatenate([kidx, bad]))
    out = torch.zeros((m,), dtype=A.dtype, device=A.device)
    out[_idx(solved_idx, A)] = x_sub
    return _certify(out)


def _bpd_reweighting_screened_secant(A, b, delta, reweight,
                                     reweight_builder, maxiter: int,
                                     min_decrease: float, margin: float,
                                     certify):
    """Secant-screened reweighted BPD.

    The secant solver's certificate is its terminal LASSO multiplier lam,
    for which |2 a_j'r| <= lam w_j with equality on the support (exact KKT
    of the weighted LASSO the Pareto point solves). Screening keeps atoms
    with margin |2 a_j'r|/lam >= (1 - screen_margin) plus the support,
    runs the reweighting loop on the kept columns with warm-started secant
    solves, and re-verifies ALL discarded atoms with one full-m GEMV
    against the final (lam, w) — any violator is re-admitted and the
    subproblem re-solved (<= 3 repair rounds). The final answer goes
    through `certify`."""
    n, m = A.shape
    A64 = _np64(A)
    b64 = _np64(b)
    x, info = _bpd_secant(A, b, delta)
    if not info["feasible"]:
        return _nan_vector(m, A)
    lam_s = max(float(info["lam"]), 1e-300)
    r = b64 - A64 @ _np64(x)
    margins = np.abs(2.0 * (r @ A64)) / lam_s
    keep = (margins >= (1.0 - margin)) | (np.abs(_np64(x)) > 0)
    kidx = np.flatnonzero(keep)
    if kidx.size == 0 or kidx.size > max(m // 8, 4 * n):
        # screen ineffective: plain secant reweighting loop
        w = torch.ones((m,), dtype=A.dtype, device=A.device)
        for _ in range(1, maxiter):
            w = reweight(w, x)
            x2, info = _bpd_secant(A, b, delta, w)
            if not info["feasible"]:
                break
            if float(_norm(x2 - x)) < min_decrease:
                return certify(x2)
            x = x2
        return certify(x)

    ktol = 1e-3
    solved_idx = kidx
    x_sub = x[_idx(kidx, A)]
    for _ in range(3):
        x_sub = _regather(x_sub, solved_idx, kidx, m, A)
        solved_idx = kidx
        A_sub = A[:, _idx(kidx, A)]
        sub_rw = reweight_builder(A_sub)
        w_sub = torch.ones((kidx.size,), dtype=A.dtype, device=A.device)
        for _o in range(1, maxiter):
            w_sub = sub_rw(w_sub, x_sub)
            xs, sinfo = _bpd_secant(A_sub, b, delta, w_sub, x0=x_sub)
            if not sinfo["feasible"]:
                break
            moved = float(_norm(xs - x_sub))
            x_sub = xs
            lam_s = max(float(sinfo["lam"]), 1e-300)
            if moved < min_decrease:
                break
        # full-m KKT verification against the final (lam, w)
        x_full = _scatter64(x_sub, kidx, m)
        x_dev = torch.as_tensor(x_full, dtype=A.dtype, device=A.device)
        w_full = _np64(reweight(torch.ones((m,), dtype=A.dtype,
                                           device=A.device), x_dev))
        r_s = b64 - A64 @ x_full
        viol = np.abs(2.0 * (r_s @ A64)) > lam_s * w_full * (1.0 + ktol)
        viol[kidx] = False
        bad = np.flatnonzero(viol)
        if bad.size == 0:
            return certify(x_dev)
        kidx = np.sort(np.concatenate([kidx, bad]))
    out = _scatter64(x_sub, solved_idx, m)
    return certify(torch.as_tensor(out, dtype=A.dtype, device=A.device))


def candes_weights(w, x, eps: float):
    """w = 1/(|x| + eps). Parity: the reference's src/basispursuit.jl:33-39."""
    w = 1.0 / (torch.abs(x) + eps)
    if not bool(torch.all(torch.isfinite(w))):
        raise FloatingPointError("weights contain NaN or Inf")
    return w


def candes_function(eps: float):
    return lambda w, x: candes_weights(w, x, eps)


def _ard_floor(q, qmax):
    """sqrt(max(q, floor)), floor = max(8 eps qmax, tiny): a rounding-
    negative quadratic form of a fully-pruned atom must not clamp to an
    exact 0 weight (the next |x|/w would NaN the solve)."""
    fi = torch.finfo(q.dtype)
    floor = torch.clamp(8 * fi.eps * qmax, min=fi.tiny)
    return torch.sqrt(torch.maximum(q, floor))


@_in_f32
def _ard_weights(A, x, w, eps, iters: int):
    n = A.shape[0]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    for _ in range(int(iters)):
        wx = torch.abs(x) / w
        K = eps * eye + (A * wx[None, :]) @ A.T
        KA = torch.cholesky_solve(A, cholesky_nan(K))
        q = torch.sum(A * KA, dim=0)
        w = _ard_floor(q, torch.max(q))
    return w


def ard_weights(w, A, x, eps: float, iters: int = 8):
    """ARD/SBL-prior weights w_j = sqrt(a_j' K^-1 a_j) with
    K = eps*I + A diag(|x|/w) A', fixed-pointed `iters` times.
    Parity: the reference's src/basispursuit.jl:49-65."""
    if bool(torch.any(w == 0)):
        raise ValueError("weights cannot be zero")
    return _ard_weights(A, x, w, _c(eps, A), int(iters))


def ard_function(A, eps: float):
    return lambda w, x: ard_weights(w, A, x, eps)


def bp_candes(A, b, eps: float = 1e-2, maxiter: int = 8):
    """Candes-reweighted BP. Parity: the reference's
    src/basispursuit.jl:41-45."""
    return basispursuit_reweighting(A, b, candes_function(eps),
                                    maxiter=maxiter)


def bp_ard(A, b, eps: float = 1e-2, maxiter: int = 8):
    """ARD-reweighted BP. Parity: the reference's src/basispursuit.jl:70-74."""
    A, b = as_inputs(A, b)
    return basispursuit_reweighting(A, b, ard_function(A, eps),
                                    maxiter=maxiter)


def bpd_candes(A, b, delta: float, eps: float = None, maxiter: int = 8,
               method: str = "admm", **kw):
    """Candes-reweighted BPD (eps defaults to delta).
    Parity: the reference's src/basispursuit.jl:119-121."""
    eps = delta if eps is None else eps
    return bpd_reweighting(A, b, delta, candes_function(eps),
                           maxiter=maxiter, method=method,
                           reweight_builder=lambda As: candes_function(eps),
                           **kw)


def bpd_ard(A, b, delta: float, eps: float = None, maxiter: int = 8,
            method: str = "admm", **kw):
    """ARD-reweighted BPD (eps defaults to delta^2).
    Parity: the reference's src/basispursuit.jl:122-124."""
    A, b = as_inputs(A, b)
    eps = delta ** 2 if eps is None else eps
    return bpd_reweighting(A, b, delta, ard_function(A, eps),
                           maxiter=maxiter, method=method,
                           reweight_builder=lambda As: ard_function(As, eps),
                           **kw)


# ---------------------------------------------------------------------------
# ISTA / FISTA
# ---------------------------------------------------------------------------

@_in_f32
def _sigma_max_sq(A):
    """sigma_max(A)^2 by 64 power iterations on the smaller Gram operator
    (two GEMVs per step) — shared by the spectral ISTA step and the BPD
    operator normalization. A 0-d tensor on A's device."""
    n, m = A.shape
    if n <= m:
        def G(v):
            return A @ (v @ A)          # top eig of A A'  (n, n)
    else:
        def G(v):
            return (A @ v) @ A          # top eig of A'A   (m, m)
    kk = min(n, m)
    v = 1.0 + 1e-3 * torch.arange(kk, dtype=A.dtype, device=A.device)
    v = v / _norm(v)
    for _ in range(64):
        w = G(v)
        v = w / _norm(w)
    return v @ G(v)


def _auto_stepsize(A):
    """Largest provably-convergent gradient step for min ||Ax-b||^2 + l1:
    just under 1/L with L = 2*sigma_max(A)^2 (the 0.95 margin covers the
    Rayleigh-quotient underestimate of 64 power iterations)."""
    return 0.95 / (2.0 * _sigma_max_sq(A))


@_in_f32
def _ista(A, b, w, x0, stepsize, maxiter: int, accelerated: bool):
    """maxiter (F)ISTA steps from x0 (cstpu's `fori_loop`: no stop test)."""
    x = y = x0
    t = _c(1.0, A)
    for _ in range(int(maxiter)):
        LOOP_COUNTS["iterations"] += 1
        g = (b - A @ y) @ A
        x_new = _shrink(y + 2 * stepsize * g, w * stepsize)
        if accelerated:
            t_new = (1.0 + torch.sqrt(1.0 + 4.0 * t * t)) / 2.0
            y = x_new + ((t - 1.0) / t_new) * (x_new - x)
            t = t_new
        else:
            y = x_new
        x = x_new
    return x


def _prox_grad(A, b, lam, x0, maxiter, stepsize, accelerated):
    A, b = as_inputs(A, b)
    b = _tensor(b, A)
    m = A.shape[1]
    w = torch.broadcast_to(_tensor(lam, A), (m,))
    x0 = (torch.zeros((m,), dtype=A.dtype, device=A.device) if x0 is None
          else _tensor(x0, A))
    step = _auto_stepsize(A) if stepsize is None else _c(stepsize, A)
    return _ista(A, b, w, x0, step, int(maxiter), accelerated)


def ista(A, b, lam, x0=None, maxiter: int = 1024,
         stepsize: float | None = 1e-2):
    """Proximal gradient for the weighted-l1 LASSO
    min ||Ax-b||^2 + sum w_i |x_i| (lam scalar or per-atom weights).
    Parity: the reference's src/basispursuit.jl:164-183 (same fixed-stepsize
    default); `stepsize=None` uses the spectral step 0.95/(2 sigma_max^2)."""
    return _prox_grad(A, b, lam, x0, maxiter, stepsize, False)


def fista(A, b, lam, x0=None, maxiter: int = 1024,
          stepsize: float | None = 1e-2):
    """Accelerated proximal gradient (FISTA) for the weighted-l1 LASSO: the
    Beck-Teboulle iteration with the same objective convention as `ista`.
    `stepsize=None` uses the spectral step 0.95/(2 sigma_max^2)."""
    return _prox_grad(A, b, lam, x0, maxiter, stepsize, True)
