"""Native (C++) runtime components, loaded via ctypes (cstpu_torch's copy
of cstpu.native: the same two C++ sources, built with the same flags).

The reference's only native code is binary solver dependencies (COIN-OR Clp
C++ simplex, ECOS C interior point) reached through JuMP
(the reference's src/CompressedSensing.jl:15-20). The equivalents:

  * `simplex_solve` — dense two-phase revised simplex (simplex.cpp), the
    exact LP path for basis pursuit (`bp(..., method="simplex")`) and the
    conformance oracle for the ADMM solver.
  * `lasso_homotopy` / `bpd_homotopy` — exact weighted-LASSO path solver
    (lars.cpp); `bpd_homotopy` stops at the ||Ax-b|| = delta crossing,
    the machine-precision equivalent of the SOCP the reference ships to
    ECOS (`bpd(..., method="homotopy")`).

The shared library is built on demand with g++ (no pybind11/setuptools
required) into the package's build directory, `cstpu_torch/build/`, under
a name that carries a hash of the sources' contents: a library built from
other sources is never loaded. A failed build raises with g++'s messages.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "simplex.cpp"), os.path.join(_HERE, "lars.cpp")]
_BUILD = os.path.join(os.path.dirname(_HERE), "build")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]
_lock = threading.Lock()
_lib = None


def _lib_path() -> str:
    """The library's path, keyed by a content hash of the sources: a
    library built from other sources (stale, or another version's) is
    never loaded against these ctypes signatures."""
    h = hashlib.sha256()
    for s in _SRCS:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"libcstpu_native-{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    """Compile to `out` via a process-unique temp file, atomically
    os.replace'd: concurrent importing processes (pytest-xdist workers,
    batch jobs) must never dlopen a half-written .so. A failed build
    raises with g++'s standard error."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, *_SRCS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(
                f"cstpu_torch.native: g++ failed ({res.returncode}):\n"
                f"{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _build() -> str:
    """Compile the native library unless the build of these sources
    exists."""
    out = _lib_path()
    if not os.path.exists(out):
        _compile(out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.cstpu_simplex_solve.restype = ctypes.c_int
            lib.cstpu_simplex_solve.argtypes = [
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int, ctypes.c_double,
            ]
            lib.cstpu_lars_solve.restype = ctypes.c_int
            lib.cstpu_lars_solve.argtypes = [
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
            lib.cstpu_lars_solve_batch.restype = ctypes.c_int
            lib.cstpu_lars_solve_batch.argtypes = [
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int,
            ]
            _lib = lib
    return _lib


class SimplexError(RuntimeError):
    pass


_STATUS = {1: "infeasible", 2: "unbounded", 3: "iteration limit",
           4: "numerical failure"}


def simplex_solve(A, b, c, max_iter: int = 0, tol: float = 1e-9):
    """Solve min c'x s.t. Ax = b, x >= 0 exactly (vertex solution).

    Returns (x, objective). Raises SimplexError on infeasible/unbounded/
    failed problems.
    """
    lib = _load()
    A = np.ascontiguousarray(A, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    c = np.ascontiguousarray(c, np.float64)
    n, N = A.shape
    if b.shape != (n,) or c.shape != (N,):
        raise ValueError("shape mismatch")
    x = np.zeros(N, np.float64)
    obj = ctypes.c_double(0.0)
    dp = ctypes.POINTER(ctypes.c_double)
    rc = lib.cstpu_simplex_solve(
        n, N,
        A.ctypes.data_as(dp), b.ctypes.data_as(dp), c.ctypes.data_as(dp),
        x.ctypes.data_as(dp), ctypes.byref(obj), int(max_iter), float(tol))
    if rc in _STATUS:
        raise SimplexError(f"simplex: {_STATUS[rc]}")
    return x, obj.value


def bp_simplex(A, b, w=None):
    """Exact (weighted) basis pursuit via the native simplex:
    min w'(x+ + x-) s.t. A(x+ - x-) = b — the same LP the reference ships
    to Clp (the reference's src/basispursuit.jl:6-16). Returns a dense x
    with exact zeros off the optimal vertex support."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    n, m = A.shape
    w = np.ones(m) if w is None else np.asarray(w, np.float64)
    # Row-whiten the equality constraints (feasible set and objective
    # unchanged — same trick as the ADMM path): on a cond ~2e5
    # correlated dictionary the raw LP's basis solves accumulate enough
    # round-off that xB drifts slightly negative, the ratio test goes
    # negative, and Bland's anti-cycling premise (primal feasibility)
    # breaks — observed as a genuine livelock (1e6 iterations, no
    # termination). With orthonormal rows the basis systems are
    # perfectly conditioned and the same LP solves in milliseconds.
    try:
        L = np.linalg.cholesky(A @ A.T)
        # numpy-only (scipy is not a declared dependency): a general
        # solve against the triangular factor is exact and the (n, n)
        # system is solved once per call
        Awhite = np.linalg.solve(L, A)
        bwhite = np.linalg.solve(L, b)
    except np.linalg.LinAlgError:  # rank-deficient AA' — solve raw
        Awhite, bwhite = A, b
    Astd = np.concatenate([Awhite, -Awhite], axis=1)
    cstd = np.concatenate([w, w])
    x, _ = simplex_solve(Astd, bwhite, cstd)
    return x[:m] - x[m:]


class HomotopyError(RuntimeError):
    pass


_LARS_STATUS = {1: "iteration limit", 2: "numerical failure",
                3: "bad argument",
                4: "target unreachable (infeasible delta)"}


def _lars(A, b, w, mode: int, target: float, max_iter: int):
    lib = _load()
    A = np.ascontiguousarray(A, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    n, m = A.shape
    if b.shape != (n,):
        raise ValueError("shape mismatch")
    w = np.ones(m) if w is None else np.ascontiguousarray(w, np.float64)
    if w.shape != (m,):
        raise ValueError("weights shape mismatch")
    x = np.zeros(m, np.float64)
    lam = ctypes.c_double(0.0)
    iters = ctypes.c_int(0)
    dp = ctypes.POINTER(ctypes.c_double)
    rc = lib.cstpu_lars_solve(
        n, m, A.ctypes.data_as(dp), b.ctypes.data_as(dp),
        w.ctypes.data_as(dp), int(mode), float(target),
        x.ctypes.data_as(dp), ctypes.byref(lam), ctypes.byref(iters),
        int(max_iter))
    if rc:
        raise HomotopyError(f"homotopy: {_LARS_STATUS.get(rc, rc)}")
    if mode == 1:
        return _bpd_terminal_polish(A, b, w, lam.value, x, float(target))
    return _kkt_repair(A, b, w, lam.value, x), lam.value


def _bpd_terminal_polish(A, b, w, lam, x, delta, max_rounds: int = 60):
    """Terminal refinement for the BPD (mode-1) path.

    _kkt_repair restores LASSO stationarity AT the walker's terminal
    lambda — but on a twin-atom corrupted path that lambda itself is
    wrong, so the repaired point lands OFF the delta ball (fuzz trials
    165: 1.0001x outside; 251: 0.847x — inside but l1-suboptimal). The
    BPD contract is ||Ax-b|| = delta, so when the repaired residual
    deviates, root-find lambda with a bracketed secant, using
    _kkt_repair as the exact LASSO solver at each trial lambda (rho is
    monotone nondecreasing and piecewise-smooth in lambda, so this
    converges to rounding in a few rounds). No-op on clean paths."""
    x = _kkt_repair(A, b, w, lam, x)
    rho = float(np.linalg.norm(b - A @ x))
    tol = 1e-10 * max(delta, 0.0) + 1e-13 * float(np.linalg.norm(b))
    if abs(rho - delta) <= tol or lam <= 0:
        return x, lam
    lam_a = rho_a = x_a = None   # rho <= delta side (lam too big? no: feasible)
    lam_b = rho_b = None         # rho > delta side
    best = (abs(rho - delta), x, lam)

    def record(l, r, xx):
        nonlocal lam_a, rho_a, x_a, lam_b, rho_b
        if r <= delta:
            if lam_a is None or l > lam_a:
                lam_a, rho_a, x_a = l, r, xx
        elif lam_b is None or l < lam_b:
            lam_b, rho_b = l, r

    record(lam, rho, x)
    cur_lam, cur_x = lam, x
    for _ in range(max_rounds):
        if lam_a is not None and lam_b is not None:
            den = rho_b - rho_a
            nl = (lam_a + (delta - rho_a) * (lam_b - lam_a) / den
                  if den > 0 else 0.5 * (lam_a + lam_b))
            if not lam_a < nl < lam_b:
                nl = 0.5 * (lam_a + lam_b)
        elif lam_b is None:
            # every point so far is inside the ball: raise lambda
            nl = cur_lam * min(max(delta / max(rho, 1e-300), 1.1), 10.0)
        else:
            nl = cur_lam * max(min(delta / rho, 0.9), 0.1)
        cur_lam = nl
        cur_x = _kkt_repair(A, b, w, cur_lam, cur_x)
        rho = float(np.linalg.norm(b - A @ cur_x))
        record(cur_lam, rho, cur_x)
        if abs(rho - delta) < best[0]:
            best = (abs(rho - delta), cur_x, cur_lam)
        if abs(rho - delta) <= tol:
            return cur_x, cur_lam
    # rounds exhausted: prefer the feasible-side bracket point
    if x_a is not None and delta - rho_a <= 1e-6 * delta:
        return x_a, lam_a
    return best[1], best[2]


def _kkt_repair(A, b, w, lam, x, max_rounds: int = 100):
    """Terminal active-set refinement of a near-solution of the weighted
    LASSO at `lam`.

    On twin-atom degenerate dictionaries the path walker can end with a
    stale sign: a zero-crossing that TIES (within its event tolerance)
    with a join event slips past the leave scan and the returned x
    carries a 2*lam KKT violation on that atom (found by the fuzz's
    exact-oracle cross-check at cond ~7e3, |corr| 0.964 twins). Rather
    than perturbing the event logic (tried: preferring drops at ties
    destabilizes other paths), repair at the end: classic finite
    active-set iteration — solve the restricted stationarity system for
    the current support/signs, evict sign-inconsistent atoms, admit the
    worst KKT violator, repeat. From a near-solution this converges in
    a few rounds; it is a no-op (one KKT evaluation) on the clean paths.
    """
    if lam <= 0:
        return x

    def _gap(z, c):
        g = np.where(z != 0, np.abs(c - lam * w * np.sign(z)),
                     np.maximum(np.abs(c) - lam * w, 0.0))
        return g

    # tolerance: relative to lam AND floored at the rounding noise of
    # evaluating the gradient itself — without the floor, large-scale
    # data (||b|| >> lam) makes the check unpassable, the loop burns
    # max_rounds on a clean path, and x is replaced by a no-better
    # iterate (breaking bitwise batch parity)
    scale = float(np.linalg.norm(b)) * float(np.max(np.abs(A)))
    tol = max(1e-9 * lam * float(np.max(w)),
              64 * np.finfo(np.float64).eps * scale * np.sqrt(A.shape[0]))
    c = A.T @ (b - A @ x)
    gap = _gap(x, c)
    gap_in = float(np.max(gap))
    if gap_in <= tol:
        return x  # clean path: keep the walker's x BITWISE (batch parity)
    sup = [int(j) for j in np.flatnonzero(x)]
    sgn = {j: float(np.sign(x[j])) for j in sup}
    x2 = x
    for _ in range(max_rounds):
        # restricted stationarity solve for the current support + signs
        while sup:
            As = A[:, sup]
            s = np.array([sgn[j] for j in sup])
            ws = w[sup]
            try:
                xs = np.linalg.solve(As.T @ As, As.T @ b - lam * ws * s)
            except np.linalg.LinAlgError:
                return x  # degenerate restricted system: keep the path x
            bad = [p for p in range(len(sup)) if xs[p] * s[p] < 0]
            if not bad:
                break
            # evict the most sign-inconsistent atom and re-solve
            worst = max(bad, key=lambda p: -xs[p] * s[p])
            del sgn[sup[worst]]
            sup.pop(worst)
        x2 = np.zeros_like(x)
        if sup:
            x2[sup] = xs
        c = A.T @ (b - A @ x2)
        gap = _gap(x2, c)
        j = int(np.argmax(gap))
        if gap[j] <= tol:
            return x2
        if j not in sup:
            sup.append(j)
        # join (or re-join after an eviction) with the gradient's sign;
        # for an active stationarity violator this flips it through the
        # next restricted solve
        sgn[j] = float(np.sign(c[j]))
    # rounds exhausted: never return something worse than the walker's x
    return x2 if float(np.max(gap)) < gap_in else x


def lasso_homotopy(A, b, lam: float, w=None, max_iter: int = 0):
    """Exact weighted-LASSO solution of
    min_x 0.5||Ax-b||^2 + lam * sum_j w_j |x_j|
    by walking the piecewise-linear homotopy path (lars.cpp). Returns a
    dense x with exact zeros off-support — the conformance oracle for
    cstpu.ista/fista (parity target: src/basispursuit.jl:139-183)."""
    x, _ = _lars(A, b, w, 0, float(lam), max_iter)
    return x


def _lars_batch(A, Bs, w, mode: int, target: float, max_iter: int,
                n_threads: int):
    lib = _load()
    A = np.ascontiguousarray(A, np.float64)
    Bs = np.ascontiguousarray(Bs, np.float64)
    n, m = A.shape
    if Bs.ndim != 2 or Bs.shape[1] != n:
        raise ValueError("Bs must be (B, n)")
    B = Bs.shape[0]
    w = np.ones(m) if w is None else np.ascontiguousarray(w, np.float64)
    if w.shape != (m,):
        raise ValueError("weights shape mismatch")
    X = np.zeros((B, m), np.float64)
    lams = np.zeros(B, np.float64)
    statuses = np.zeros(B, np.int32)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    rc = lib.cstpu_lars_solve_batch(
        n, m, A.ctypes.data_as(dp), Bs.ctypes.data_as(dp), B,
        w.ctypes.data_as(dp), int(mode), float(target),
        X.ctypes.data_as(dp), lams.ctypes.data_as(dp),
        statuses.ctypes.data_as(ip), int(max_iter), int(n_threads))
    if rc:
        raise HomotopyError(f"homotopy batch: {_LARS_STATUS.get(rc, rc)}")
    # same terminal repair as the single path (no-op on clean rows, so
    # batch stays bitwise-equal to sequential). Screen the whole batch
    # with ONE GEMM — per-row Python GEMVs would dominate the threaded
    # C solve's wall-clock on large batches — and repair only the rows
    # the screen flags (rare).
    C = (Bs - X @ A.T) @ A                                    # (B, m)
    lamw = lams[:, None] * w[None, :]
    gaps = np.where(X != 0, np.abs(C - lamw * np.sign(X)),
                    np.maximum(np.abs(C) - lamw, 0.0)).max(axis=1)
    scale = (np.linalg.norm(Bs, axis=1) * float(np.max(np.abs(A)))
             * np.sqrt(n) * 64 * np.finfo(np.float64).eps)
    tols = np.maximum(1e-9 * lams * float(np.max(w)), scale)
    for i in np.flatnonzero((gaps > tols) & (statuses == 0) & (lams > 0)):
        if mode == 1:
            # corrupted terminal lambda: re-root-find the delta crossing
            # (see _bpd_terminal_polish) so the row honors the ball
            X[i], lams[i] = _bpd_terminal_polish(
                A, Bs[i], w, float(lams[i]), X[i], float(target))
        else:
            X[i] = _kkt_repair(A, Bs[i], w, float(lams[i]), X[i])
    return X, lams, statuses


def lasso_homotopy_batch(A, Bs, lam: float, w=None, max_iter: int = 0,
                         n_threads: int = 0):
    """Exact weighted-LASSO solutions for a batch of measurement rows,
    solved in parallel on host threads (the reference is single-threaded
    even on host — src/CompressedSensing.jl:12 imports Base.Threads and
    never uses it). Returns (X (B, m), statuses (B,)) — per-instance
    statuses (0 ok) instead of a batch abort."""
    X, _, st = _lars_batch(A, Bs, w, 0, float(lam), max_iter, n_threads)
    return X, st


def bpd_homotopy_batch(A, Bs, delta: float, w=None, max_iter: int = 0,
                       n_threads: int = 0):
    """Exact BPD solutions for a batch of measurement rows (threaded; see
    lasso_homotopy_batch). Returns (X, lams, statuses)."""
    return _lars_batch(A, Bs, w, 1, float(delta), max_iter, n_threads)


def bpd_homotopy(A, b, delta: float, w=None, max_iter: int = 0):
    """Exact (weighted) basis-pursuit denoising via the homotopy path:
    min sum_j w_j |x_j| s.t. ||Ax - b||_2 <= delta — the same SOCP the
    reference ships to ECOS (the reference's src/basispursuit.jl:83-99).
    The path is left at the exact ||r|| = delta crossing (a quadratic
    root inside one linear segment), so x is exact to rounding. On
    twin-atom degenerate paths the terminal _kkt_repair restores
    stationarity at the crossing lambda; in that (rare) case the
    residual matches delta to the repair's accuracy instead of exactly.
    Returns (x, lam) with lam the equivalent LASSO multiplier."""
    return _lars(A, b, w, 1, float(delta), max_iter)
