"""Column-sharded convex solvers over a mesh of shards (PyTorch counterpart
of cstpu.parallel.convex): basis pursuit ADMM, ARD reweighting, BP
denoising (ADMM and the certified secant), ISTA/FISTA. Signatures are
cstpu's without `atoms_axis`: the port's mesh has its axes by name.

The primal vectors (x, z, u, w) lie with the dictionary columns, one piece
per shard on the shard's device; b, y and the n x n factors lie on the
home device of the mesh's first batch row in this process (a batch axis of
the mesh replicates the work, as cstpu's shard_map does, so it runs once
in each process; over a mesh that spans processes each process works on
its own shards of that row, and every process returns the whole
result). Every
ADMM and FISTA iteration makes one n-length `psum` of the shards' A_s v_s
products and one packed psum of its three scalar sums; the sums run over
the shards in a fixed order, so one shard and four agree to rounding. The
n x n normal-equation factor AA' = psum(A_s A_s') is computed once.

Above _WHITEN_BYTES_MAX bytes a shard, the row-whitening and the ARD sweeps
run in column chunks of at most _ARD_CHUNK_MAX columns (the same numerics,
only the Gram summation order changes): at cstpu's config 5 scale
(1024 x 2^20 f32, 4 GB) the full-width temporaries would double the
dictionary several times over.

The while loops read their latch every `CHECK_EVERY` iterations, with the
frozen-state rule and the `LOOP_COUNTS` of cstpu_torch.models.
basis_pursuit; a loop whose row spans processes runs eagerly (`_loop`).
`matmul_precision` keeps cstpu's strings: "float32" runs the
products with TF32 off, "tensorfloat32" with it on.
"""

from __future__ import annotations

import numpy as np
import torch

from cstpu_torch.models.basis_pursuit import (
    LOOP_COUNTS, _adapt_rho, _admm_consts, _ard_floor, _ard_weights, _ball,
    _bp_admm, _c, _in_f32, _latch, _latched, _norm, _np64,
    _pareto_secant_loop, _rescale, _shrink, _sigma_max_sq)
from cstpu_torch.ops.util import cholesky_nan, true_f32
from cstpu_torch.parallel.mesh import Mesh, ShardedDictionary, make_mesh
from cstpu_torch.parallel.sharded_sbl import _Row, _row

# Above this many bytes per shard the whitening and ARD sweeps run in
# column chunks (peak: A + one whitened buffer + a chunk temp)
_WHITEN_BYTES_MAX = 1 << 28     # 256 MB
# 65536 f32 columns at n = 1024 is 256 MB of chunk temps; module-level so
# tests can shrink it to exercise the remainder-tail path at test sizes
_ARD_CHUNK_MAX = 65536

_TF32 = {"float32": False, "tensorfloat32": True}


def _matmul_precision(prec: str):
    """f32 products in full f32 ("float32") or TF32 ("tensorfloat32")
    inside the block (`true_f32`)."""
    if prec not in _TF32:
        raise ValueError(f"unknown matmul_precision {prec!r}; valid: "
                         f"{sorted(_TF32)}")
    return true_f32(_TF32[prec])


def _ard_chunk(m_local: int) -> int:
    """Column-chunk width for the lean sweeps: up to _ARD_CHUNK_MAX
    columns; the remainder is one narrower tail chunk."""
    return min(m_local, _ARD_CHUNK_MAX)


def _chunks(ml: int):
    c = _ard_chunk(ml)
    return [(c0, min(c0 + c, ml)) for c0 in range(0, ml, c)]


def _lean(row: _Row) -> bool:
    A0 = row.A[0]
    return A0.shape[0] * row.ml * A0.element_size() > _WHITEN_BYTES_MAX


# ---------------------------------------------------------------------------
# Shards, vectors and collectives
# ---------------------------------------------------------------------------

def _setup(A, mesh: Mesh):
    """(this process's first batch row of shards, the dense A or an array
    view of the shards for the host-side fallbacks)."""
    if mesh is None:
        mesh = make_mesh()
    s = mesh.shape["atoms"]
    if not isinstance(A, ShardedDictionary):
        A = torch.as_tensor(A)
    n, m = A.shape
    if m % s:
        raise ValueError(f"m = {m} not divisible by atom shards {s}")
    i = mesh.rows()[0]
    if isinstance(A, ShardedDictionary):
        row = _row(mesh, A, i)
        return row, _Gathered(row)
    ml = m // s
    cut = {j: A[:, j * ml:(j + 1) * ml].to(mesh.devices[i][j])
           for j in mesh.local(i)}
    return _row(mesh, _in_row(mesh, i, cut, (n, m), A.dtype), i), A


def _in_row(mesh: Mesh, i: int, shards: dict, shape, dtype):
    """A ShardedDictionary whose only shards are `shards` ({shard index:
    tensor}), in batch row i."""
    grid = tuple(tuple(shards.get(j) if r == i else None
                       for j in range(mesh.shape["atoms"]))
                 for r in range(mesh.shape["batch"]))
    return ShardedDictionary(grid, shape, dtype, mesh)


class _Gathered:
    """The row's shards as one host array, built only when numpy reads it
    (the rare host-side fallbacks; over a row that spans processes every
    process of the row reads it at the same point)."""

    def __init__(self, row: _Row):
        self.row = row
        self.shape = (row.A[0].shape[0], row.m)

    def __array__(self, dtype=None, copy=None):
        row = self.row
        if row.mesh.row_spans(row.i):
            out = row.cat(row.A, dim=1).cpu().numpy()
        else:
            out = torch.cat([a.cpu() for a in row.A], dim=1).numpy()
        return out if dtype is None else out.astype(dtype)


def _split(row: _Row, v):
    """A full (m,) vector as this process's shards' pieces."""
    return [v[j * row.ml:(j + 1) * row.ml].to(dev)
            for j, dev in zip(row.js, row.devs)]


def _join(row: _Row, vs):
    return row.cat(vs)


def _on(x, row: _Row, dtype):
    return torch.as_tensor(x, dtype=dtype, device=row.home)


def _psum(row: _Row, xs):
    return row.psum(xs)


def _loop(row: _Row, body, state, maxiter: int):
    """`_latched` over the row's devices. A row whose shards span processes
    runs eagerly: a CUDA graph would capture its exchanges with the other
    processes, which run on the host."""
    return _latched(body, state, maxiter, (row.home, *row.devs),
                    graphs=not row.mesh.row_spans(row.i))


def _fit(row: _Row, A, vs):
    """A v = psum of the shards' A_s v_s, at home."""
    return _psum(row, [A_l @ v for A_l, v in zip(A, vs)])


def _corr(row: _Row, A, r):
    """r' A, one piece per shard."""
    return [r.to(dev) @ A_l for A_l, dev in zip(A, row.devs)]


def _sqsums(row: _Row, *pairs):
    """One packed psum of sum(a * b) over the shards, for each (a, b) pair
    of shard lists: a (len(pairs),) tensor at home."""
    loc = [torch.stack([torch.sum(a[j] * b[j]) for a, b in pairs])
           for j in range(len(row.devs))]
    return _psum(row, loc)


def _diff(a, b):
    return [x - y for x, y in zip(a, b)]


# ---------------------------------------------------------------------------
# Sharded basis pursuit (equality-constrained weighted l1)
# ---------------------------------------------------------------------------

def _gram(row: _Row, A, lean: bool):
    """psum of the shards' A_s A_s' (chunk by chunk when lean)."""
    n = A[0].shape[0]
    parts = []
    for A_l in A:
        if not lean:
            parts.append(A_l @ A_l.T)
            continue
        G = torch.zeros((n, n), dtype=A_l.dtype, device=A_l.device)
        for c0, c1 in _chunks(row.ml):
            Ac = A_l[:, c0:c1]
            G = G + Ac @ Ac.T
        parts.append(G)
    return _psum(row, parts)


def _whiten_shards(row: _Row, b, lean: bool):
    """The row-whitening of cstpu's sharded BP: three passes (two shifted
    by 8n ulps, one unshifted) of L = chol(psum(A_s A_s') + shift), each
    shard whitening its own columns. Lean: the whitened copy is one new
    buffer per shard, solved chunk by chunk in place."""
    n = b.shape[0]
    dt = row.A[0].dtype
    eps = torch.finfo(dt).eps
    eye = torch.eye(n, dtype=dt, device=row.home)
    Aw, bw, own = list(row.A), b, False
    for shift in (8.0 * n, 8.0 * n, 0.0):
        G = _gram(row, Aw, lean)
        G = G + (shift * eps * torch.max(torch.diagonal(G))) * eye
        L = cholesky_nan(G)
        for j, (A_l, dev) in enumerate(zip(Aw, row.devs)):
            Ld = L.to(dev)
            if not lean:
                Aw[j] = torch.linalg.solve_triangular(Ld, A_l, upper=False)
                continue
            W = A_l if own else A_l.clone()
            for c0, c1 in _chunks(row.ml):
                W[:, c0:c1] = torch.linalg.solve_triangular(
                    Ld, W[:, c0:c1], upper=False)
            Aw[j] = W
        own = True
        bw = torch.linalg.solve_triangular(L, bw[:, None], upper=False)[:, 0]
    return Aw, bw


def _bp_shards(row: _Row, b, w, rho, maxiter: int, tol, z0=None, u0=None):
    """The sharded BP ADMM (cstpu's `_bp_admm_shard_body`): (z, u) as
    shard lists and rho_f."""
    Aw, bw = _whiten_shards(row, b, _lean(row))

    def project(vs):  # exact projection onto {x : Ax = b}
        d = _fit(row, Aw, vs) - bw
        return [v - d.to(v.device) @ A_l for v, A_l in zip(vs, Aw)]

    x0 = _corr(row, Aw, bw)  # min-norm feasible point
    relax, mu, tau = _admm_consts(b)
    relax1 = 1.0 - relax

    def body(c, mode):
        z, u, rho_, _ = c
        x = project(_diff(z, u))
        xh = [relax.to(a.device) * a + relax1.to(a.device) * zz
              for a, zz in zip(x, z)]
        z_new = [_shrink(h + uu, wl / rho_.to(wl.device))
                 for h, uu, wl in zip(xh, u, w)]
        u = [uu + h - zn for uu, h, zn in zip(u, xh, z_new)]
        # the three convergence norms ride ONE packed scalar psum
        xz, dz = _diff(x, z_new), _diff(z_new, z)
        sq = _sqsums(row, (xz, xz), (dz, dz), (z_new, z_new))
        pri = torch.sqrt(sq[0])
        dua = rho_ * torch.sqrt(sq[1])
        scale = 1.0 + torch.sqrt(sq[2])
        done = (pri < tol * scale) & (dua < tol * scale)
        rho_new, fac = _adapt_rho(rho_, pri, dua, mu, tau, mode)
        return z_new, _rescale(u, fac), rho_new, done

    z_init = x0 if z0 is None else z0
    u_init = [torch.zeros_like(v) for v in x0] if u0 is None else u0
    z, u, rho_f, _ = _loop(row, body, (z_init, u_init, rho, _latch(b)),
                           maxiter)
    return z, u, rho_f


def _tol(tol, dt, f64: float, f32: float) -> float:
    if tol is None:
        return f64 if dt == torch.float64 else f32
    return float(tol)


def bp_sharded(A, b, w=None, mesh: Mesh = None, rho: float = 1.0,
               maxiter: int = 20000, tol: float = None, warm=None,
               matmul_precision: str = "float32"):
    """(Weighted) basis pursuit with a column-sharded dictionary.

    Semantics match cstpu_torch.bp (ADMM, incl. the adaptive-rho
    rebalancing); x/z/u/w live sharded with the columns. Returns
    (z, u, rho_final), z and u full (m,) vectors on the home device —
    pass `warm=(z, u, rho_final)` to warm-start the next solve (u is the
    SCALED dual y/rho, so the adapted rho travels with it). `A` may be a
    tensor or the result of `shard_dictionary`.
    """
    row, _ = _setup(A, mesh)
    dt = row.A[0].dtype
    b = _on(b, row, dt)
    m = row.m
    w = (torch.ones((m,), dtype=dt, device=row.home) if w is None
         else _on(w, row, dt))
    tol = _on(_tol(tol, dt, 1e-9, 1e-6), row, dt)
    with _matmul_precision(str(matmul_precision)):
        if warm is None:
            z, u, rho_f = _bp_shards(row, b, _split(row, w),
                                     _on(rho, row, dt), int(maxiter), tol)
        else:
            z, u, rho_f = _bp_shards(
                row, b, _split(row, w), _on(warm[2], row, dt), int(maxiter),
                tol, _split(row, _on(warm[0], row, dt)),
                _split(row, _on(warm[1], row, dt)))
    return _join(row, z), _join(row, u), rho_f


# ---------------------------------------------------------------------------
# Sharded ARD weights and ARD-reweighted BP
# ---------------------------------------------------------------------------

def _ard_shards(row: _Row, x, w, eps, iters: int):
    """cstpu's `_ard_weights_shard_body`: the ARD fixed point with
    K = eps I + psum(A_s diag(|x_s|/w_s) A_s'), each shard extracting its
    own quadratic forms; chunked when lean. x, w: shard lists."""
    A = row.A
    n = A[0].shape[0]
    dt = A[0].dtype
    lean = _lean(row)
    eye = torch.eye(n, dtype=dt, device=row.home)
    for _ in range(int(iters)):
        wx = [torch.abs(xl) / wl for xl, wl in zip(x, w)]
        parts = []
        for A_l, wl in zip(A, wx):
            if not lean:
                parts.append((A_l * wl[None, :]) @ A_l.T)
                continue
            Kacc = torch.zeros((n, n), dtype=dt, device=A_l.device)
            for c0, c1 in _chunks(row.ml):
                Ac = A_l[:, c0:c1]
                Kacc = Kacc + (Ac * wl[c0:c1][None, :]) @ Ac.T
            parts.append(Kacc)
        L = cholesky_nan(eps * eye + _psum(row, parts))
        q = [_quad_forms(row, A_l, L.to(A_l.device), lean) for A_l in A]
        qmax = row.pmax([torch.max(ql) for ql in q])
        w = [_ard_floor(ql, qmax.to(ql.device)) for ql in q]
    return w


def _quad_forms(row: _Row, A_l, L, lean: bool):
    """a_j' K^-1 a_j for the columns of one shard, K = L L'."""
    if not lean:
        return torch.sum(A_l * torch.cholesky_solve(A_l, L), dim=0)
    q = torch.empty((row.ml,), dtype=A_l.dtype, device=A_l.device)
    for c0, c1 in _chunks(row.ml):
        Ac = A_l[:, c0:c1]
        q[c0:c1] = torch.sum(Ac * torch.cholesky_solve(Ac, L), dim=0)
    return q


def _ard_joined(row: _Row, x, w, eps, iters: int = 8):
    """The sharded ARD fixed point on full (m,) vectors x and w."""
    return _join(row, _ard_shards(row, _split(row, x), _split(row, w),
                                  _on(eps, row, x.dtype), iters))


def _sharded(row: _Row):
    """The row's shards as a ShardedDictionary (no copy)."""
    return _in_row(row.mesh, row.i, dict(zip(row.js, row.A)),
                   (row.A[0].shape[0], row.m), row.A[0].dtype)


def ard_weights_sharded(A, x, w, mesh: Mesh, eps: float, iters: int = 8):
    """Column-sharded ARD weights w_j = sqrt(a_j' K^-1 a_j),
    K = eps*I + A diag(|x|/w) A', fixed-pointed `iters` times: a full (m,)
    vector on the home device."""
    row, _ = _setup(A, mesh)
    dt = row.A[0].dtype
    w = _on(w, row, dt)
    if bool(torch.any(w == 0)):
        raise ValueError("weights cannot be zero")  # parity with the
    #                     unsharded rule (the reference's basispursuit.jl)
    with _matmul_precision("float32"):
        return _ard_joined(row, _on(x, row, dt), w, eps, int(iters))


def bp_ard_sharded(A, b, mesh: Mesh, eps: float = 1e-2, maxiter: int = 8,
                   min_decrease: float = 1e-8,
                   maxiter_admm: int | None = None,
                   admm_chunk: int | None = None,
                   screen: bool | None = None, screen_margin: float = 0.5,
                   **bp_kwargs):
    """ARD-reweighted basis pursuit, column-sharded end to end.

    Per outer iteration: one sharded BP solve + one sharded ARD weight
    fixed point. `maxiter` is the OUTER reweighting count; `maxiter_admm`
    caps the inner ADMM solve. `admm_chunk` splits each inner solve into
    warm-restarted runs of at most that many iterations and stops early
    once a restarted run moves z by less than tol (1 + ||z||).

    `screen` (auto-on at m >= 65536): after the first full-m solve, run
    the remaining reweighting outers on a dual-slack-screened
    sub-dictionary and verify every discarded atom's KKT margin at full
    m — see _screened_ard_continue. `screen_margin` is the slack band
    kept (0.5 keeps atoms within 50% of dual-activity)."""
    row, _ = _setup(A, mesh)
    dt = row.A[0].dtype
    m = row.m
    if maxiter_admm is not None:
        bp_kwargs = {**bp_kwargs, "maxiter": int(maxiter_admm)}
    mm_prec = str(bp_kwargs.get("matmul_precision", "float32"))
    Ash = _sharded(row)

    def solve(w, warm):
        if not admm_chunk:
            return bp_sharded(Ash, b, w, mesh, warm=warm, **bp_kwargs)
        total = int(bp_kwargs.get("maxiter", 20000))
        chunk = min(int(admm_chunk), total)
        out = warm
        remaining = total
        while remaining > 0:
            # cap the tail chunk at the remaining budget so `maxiter` is
            # honored exactly
            kw = {**bp_kwargs, "maxiter": min(chunk, remaining)}
            prev = out
            out = bp_sharded(Ash, b, w, mesh, warm=out, **kw)
            remaining -= kw["maxiter"]
            if prev is not None and remaining > 0:
                # early exit: once the inner ADMM has converged, a
                # restarted chunk only jitters z by round-off. An explicit
                # tol=0.0 means no convergence stop
                dz = float(_norm(out[0] - prev[0]))
                tol_eff = _tol(bp_kwargs.get("tol"), dt, 1e-9, 1e-6)
                if dz <= tol_eff * (1.0 + float(_norm(prev[0]))):
                    break
        return out

    x, u, rho = solve(None, None)
    if screen is None:
        screen = m >= (1 << 16)
    if screen:
        out = _screened_ard_continue(
            row, b, x, u, rho, float(eps), int(maxiter),
            float(min_decrease), float(screen_margin), bp_kwargs)
        if out is not None:
            return out
        # screening declined (dual not settled enough) — fall through
    w = torch.ones((m,), dtype=dt, device=row.home)
    for _ in range(1, int(maxiter)):
        # the fixed point directly: its dtype-eps floor keeps the weights
        # of internally-produced x nonzero, so no zero check (a sync)
        with _matmul_precision(mm_prec):
            w = _ard_joined(row, x, w, eps)
        xs, u, rho = solve(w, (x, u, rho))
        if float(_norm(xs - x)) < min_decrease:
            return xs
        x = xs
    return x


def _margins(row: _Row, Lk, nu):
    """The full-m verification sweep: per atom the quadratic form
    q_j = a_j' K^-1 a_j (the final ARD weight squared) and the dual
    correlation c_j = a_j' nu — one chunked pass over the shards."""
    q, corr = [], []
    for A_l, dev in zip(row.A, row.devs):
        Ld, nd = Lk.to(dev), nu.to(dev)
        ql = torch.empty((row.ml,), dtype=A_l.dtype, device=dev)
        cl = torch.empty((row.ml,), dtype=A_l.dtype, device=dev)
        for c0, c1 in _chunks(row.ml):
            Ac = A_l[:, c0:c1]
            ql[c0:c1] = torch.sum(Ac * torch.cholesky_solve(Ac, Ld), dim=0)
            cl[c0:c1] = nd @ Ac
        q.append(ql)
        corr.append(cl)
    return _join(row, q), _join(row, corr)


def _columns(row: _Row, kidx):
    """A[:, kidx] gathered from the shards onto the home device (kidx
    ascending). Over a row that spans processes each shard's columns are
    padded to the most any shard holds and all-gathered."""
    kidx = np.asarray(kidx)
    ml = row.ml
    mine = [kidx[(kidx >= j * ml) & (kidx < (j + 1) * ml)] - j * ml
            for j in range(row.mesh.shape["atoms"])]
    if not row.mesh.row_spans(row.i):
        return torch.cat([A_l[:, torch.as_tensor(mine[j], device=A_l.device)]
                          .to(row.home) for j, A_l in zip(row.js, row.A)
                          if mine[j].size], dim=1)
    most = max(x.size for x in mine)
    parts = [A_l[:, torch.as_tensor(np.pad(mine[j], (0, most - mine[j].size)),
                                    device=A_l.device)]
             for j, A_l in zip(row.js, row.A)]
    got = row.mesh.all_gather(parts, row.home, row.i)        # (s, n, most)
    return torch.cat([got[j, :, :x.size] for j, x in enumerate(mine)], dim=1)


def _screened_ard_continue(row: _Row, b, x, u, rho, eps: float,
                           maxiter: int, min_decrease: float,
                           margin: float, bp_kwargs):
    """Run ARD reweighting outers 2..maxiter on a SCREENED sub-dictionary,
    then verify every discarded atom's KKT margin at full m (cstpu's
    `_screened_ard_continue`).

    At the weighted-BP optimum the ADMM scaled dual satisfies rho*u = A'nu
    with |a_j'nu| = w_j on the support and < w_j off it, so after the
    first full-m solve the per-atom dual slack rho*|u_j| says which atoms
    can matter. Since x is zero off the kept set, the ARD kernel is
    exactly the kept-column kernel. After the sub-solves a dual estimate
    nu (support least squares) is checked against the final full-m weights
    in ONE chunked pass; violators are re-admitted and the sub-solve rerun
    (<= 3 repair rounds). Returns None when the first solve's dual is not
    settled enough to screen."""
    dt = x.dtype
    n = b.shape[0]
    m = x.shape[0]
    tol = _tol(bp_kwargs.get("tol"), dt, 1e-9, 1e-6)
    # the sub-problems are tiny: give them the full default budget even
    # when the caller capped the FULL-m first solve via maxiter_admm
    sub_maxiter = max(20000, int(bp_kwargs.get("maxiter", 20000)))
    slack = float(rho) * np.abs(_np64(u))
    keep = (slack >= (1.0 - margin)) | (np.abs(_np64(x)) > 0)
    kidx = np.flatnonzero(keep)
    if kidx.size > max(m // 8, 4 * n):
        return None  # dual not settled: screening would be guesswork
    if kidx.size < min(2 * n, m):
        # guarantee a row-spanning sub-dictionary (the whitened sub-ADMM
        # needs full row rank): pad with the highest-slack discarded atoms
        rest = np.argsort(-slack[~keep])
        pad = np.flatnonzero(~keep)[rest[: min(2 * n, m) - kidx.size]]
        kidx = np.sort(np.concatenate([kidx, pad]))

    def at(idx):
        return torch.as_tensor(idx, dtype=torch.long, device=row.home)

    ktol = 1e-3
    solved_idx = kidx
    for _ in range(3):
        solved_idx = kidx
        A_sub = _columns(row, kidx)
        x_sub, u_sub = x[at(kidx)], u[at(kidx)]
        w_sub = torch.ones((kidx.size,), dtype=dt, device=row.home)
        rho_s = _on(rho, row, dt)
        for _o in range(1, maxiter):
            w_sub = _ard_weights(A_sub, x_sub, w_sub, _on(eps, row, dt), 8)
            xs, u_sub, rho_s = _bp_admm(A_sub, b, w_sub, rho_s, sub_maxiter,
                                        _on(tol, row, dt), z0=x_sub,
                                        u0=u_sub)
            moved = float(_norm(xs - x_sub))
            x_sub = xs
            if moved < min_decrease:
                break

        # --- full-m KKT verification ---------------------------------
        xh = _np64(x_sub)
        sup = np.flatnonzero(np.abs(xh) > 0)
        if sup.size == 0:
            break
        Ah = _np64(A_sub)
        wh = _np64(w_sub)
        g = (np.sign(xh) * wh)[sup]
        nu, *_ = np.linalg.lstsq(Ah[:, sup].T, g, rcond=None)    # (n,)
        # final ARD kernel is the kept-column kernel (x zero elsewhere)
        wx = np.abs(xh) / wh
        K = eps * np.eye(n) + (Ah * wx[None, :]) @ Ah.T
        Lk = _on(np.linalg.cholesky(K), row, dt)
        with _matmul_precision("float32"):
            q, corr = _margins(row, Lk, _on(nu, row, dt))
        w_all = np.sqrt(np.maximum(_np64(q), 0.0))
        corr = np.abs(_np64(corr))
        viol = corr > w_all * (1.0 + ktol) + ktol * corr.max()
        viol[kidx] = False
        bad = np.flatnonzero(viol)
        if bad.size == 0:
            out = torch.zeros((m,), dtype=dt, device=row.home)
            out[at(kidx)] = x_sub
            return out
        # re-admit the violators, then rerun the sub-solve on the wider
        # set (warm-started from the scattered sub solution)
        kidx = np.sort(np.concatenate([kidx, bad]))
        x = torch.zeros((m,), dtype=dt, device=row.home)
        x[at(solved_idx)] = x_sub
        u = torch.zeros((m,), dtype=dt, device=row.home)
        u[at(solved_idx)] = u_sub
        rho = rho_s
    # repair budget exhausted — return the last sub solution (feasible
    # and supported on solved_idx; its certificate check fell short)
    out = torch.zeros((m,), dtype=dt, device=row.home)
    out[at(solved_idx)] = x_sub
    return out


# ---------------------------------------------------------------------------
# Sharded basis pursuit DENOISING (l2-ball constraint)
# ---------------------------------------------------------------------------

def _bpd_shards(row: _Row, b, delta, w, rho, maxiter: int, tol, warm=None):
    """The sharded BPD ADMM (cstpu's `_bpd_admm_shard_body`, the Woodbury
    form): one n-length psum of the shards' A_s rhs_s per iteration plus
    one packed scalar psum; A x IS the Woodbury correction c (since
    (I + AA') c = A rhs), so no second pass. Returns (z, uz) as shard
    lists and (y, uy, rho_f) at home."""
    n = b.shape[0]
    dt = b.dtype
    AAt = _gram(row, row.A, False)
    # operator normalization: sigma_max^2 = top eig of AA' by 64 power
    # iterations; (A, b, delta) / sigma_max keep the blocks commensurate
    v = 1.0 + 1e-3 * torch.arange(n, dtype=dt, device=row.home)
    v = v / _norm(v)
    for _ in range(64):
        w_ = AAt @ v
        v = w_ / _norm(w_)
    s = torch.sqrt(v @ (AAt @ v))
    A = [A_l / s.to(A_l.device) for A_l in row.A]
    b = b / s
    delta = delta / s
    # explicit inverse: the eigenvalues of I + AA' / s^2 lie in [1, 2]
    Kinv = torch.cholesky_inverse(cholesky_nan(
        torch.eye(n, dtype=dt, device=row.home) + AAt / (s * s)))
    del AAt
    project_ball = _ball(b, delta)
    _, mu, tau = _admm_consts(b)

    def body(c, mode):
        z, y, uz, uy, rho_, _ = c
        yu = y - uy
        rhs = [(zz - u) + yu.to(A_l.device) @ A_l
               for zz, u, A_l in zip(z, uz, A)]
        Arhs = _fit(row, A, rhs)                     # THE collective
        cvec = Kinv @ Arhs
        x = [r - cvec.to(A_l.device) @ A_l for r, A_l in zip(rhs, A)]
        Ax = cvec                                    # = A x exactly
        z_new = [_shrink(a + u, wl / rho_.to(wl.device))
                 for a, u, wl in zip(x, uz, w)]
        y_new = project_ball(Ax + uy)
        uz = [u + a - zn for u, a, zn in zip(uz, x, z_new)]
        uy = uy + Ax - y_new
        xz, dz = _diff(x, z_new), _diff(z_new, z)
        sq = _sqsums(row, (xz, xz), (dz, dz), (z_new, z_new))
        pri = torch.sqrt(sq[0]) + _norm(Ax - y_new)
        dua = rho_ * (torch.sqrt(sq[1]) + _norm(y_new - y))
        scale = 1.0 + torch.sqrt(sq[2])
        done = (pri < tol * scale) & (dua < tol * scale)
        rho_new, fac = _adapt_rho(rho_, pri, dua, mu, tau, mode)
        return (z_new, y_new, _rescale(uz, fac), _rescale(uy, fac), rho_new,
                done)

    if warm is None:
        z0 = [torch.zeros((row.ml,), dtype=dt, device=dev)
              for dev in row.devs]
        state = (z0, b.clone(), z0, torch.zeros_like(b), rho)
    else:
        zw, uzw, yw, uyw, rhow = warm
        state = (zw, yw, uzw, uyw, rhow)
    z, y, uz, uy, rho_f, _ = _loop(row, body, (*state, _latch(b)), maxiter)
    return z, uz, y, uy, rho_f


def bpd_sharded(A, b, delta, w=None, mesh: Mesh = None, rho: float = 1.0,
                maxiter: int = 20000, tol: float = None, warm=None,
                matmul_precision: str = "float32"):
    """(Weighted) basis pursuit denoising, column-sharded.

    Semantics match cstpu_torch.bpd(method="admm") without its
    certification (as cstpu's: the raw ADMM iterate, which may stop
    outside the ball); returns (z, uz, y, uy, rho_final), z and uz full
    (m,) vectors — pass the 5-tuple back as `warm=` to continue a solve.
    Callers wanting just the solution take element 0. `A` may be a tensor
    or the result of `shard_dictionary`.
    """
    row, _ = _setup(A, mesh)
    dt = row.A[0].dtype
    m = row.m
    b = _on(b, row, dt)
    w = (torch.ones((m,), dtype=dt, device=row.home) if w is None
         else _on(w, row, dt))
    tol = _on(_tol(tol, dt, 1e-8, 1e-5), row, dt)
    delta = _on(delta, row, dt)
    if warm is not None:
        zw, uzw, yw, uyw, rhow = warm
        warm = (_split(row, _on(zw, row, dt)), _split(row, _on(uzw, row, dt)),
                _on(yw, row, dt), _on(uyw, row, dt), _on(rhow, row, dt))
    with _matmul_precision(str(matmul_precision)):
        z, uz, y, uy, rho_f = _bpd_shards(row, b, delta, _split(row, w),
                                          _on(rho, row, dt), int(maxiter),
                                          tol, warm)
    return _join(row, z), _join(row, uz), y, uy, rho_f


def bpd_candes_sharded(A, b, delta, mesh: Mesh, eps: float = None,
                       maxiter: int = 8, **bpd_kwargs):
    """Candes-reweighted sharded BPD (eps defaults to delta). The weight
    rule w = 1/(|x| + eps) is elementwise. Returns the raw ADMM iterate of
    the last solve, as cstpu does."""
    eps = float(delta) if eps is None else float(eps)
    x = bpd_sharded(A, b, delta, None, mesh, **bpd_kwargs)[0]
    for _ in range(1, int(maxiter)):
        w = 1.0 / (torch.abs(x) + eps)
        xs = bpd_sharded(A, b, delta, w, mesh, **bpd_kwargs)[0]
        if float(_norm(xs - x)) < 1e-4:
            return xs
        x = xs
    return x


def bpd_ard_sharded(A, b, delta, mesh: Mesh, eps: float = None,
                    maxiter: int = 8, **bpd_kwargs):
    """ARD-reweighted sharded BPD (eps defaults to delta^2); weights via
    the sharded ARD fixed point (chunked at large shards). Returns the raw
    ADMM iterate of the last solve, as cstpu does."""
    eps = float(delta) ** 2 if eps is None else float(eps)
    row, _ = _setup(A, mesh)
    dt = row.A[0].dtype
    m = row.m
    Ash = _sharded(row)
    mm_prec = str(bpd_kwargs.get("matmul_precision", "float32"))
    x = bpd_sharded(Ash, b, delta, None, mesh, **bpd_kwargs)[0]
    w = torch.ones((m,), dtype=dt, device=row.home)
    for _ in range(1, int(maxiter)):
        with _matmul_precision(mm_prec):
            w = _ard_joined(row, x, w, eps)
        xs = bpd_sharded(Ash, b, delta, w, mesh, **bpd_kwargs)[0]
        if float(_norm(xs - x)) < 1e-4:
            return xs
        x = xs
    return x


# ---------------------------------------------------------------------------
# Sharded proximal-gradient path (ISTA/FISTA)
# ---------------------------------------------------------------------------

@_in_f32
def _sigma_max_sq_shards(row: _Row):
    """sigma_max(A)^2 by cstpu's 64 power iterations, on the shards when
    n <= m (G v = psum(A_s (v' A_s))), else on the gathered A'A side."""
    A = row.A
    n = A[0].shape[0]
    if n > row.m:
        return _sigma_max_sq(row.cat(A, dim=1))
    dt = A[0].dtype

    def G(v):
        return _fit(row, A, _corr(row, A, v))

    v = 1.0 + 1e-3 * torch.arange(n, dtype=dt, device=row.home)
    v = v / _norm(v)
    for _ in range(64):
        w_ = G(v)
        v = w_ / _norm(w_)
    return v @ G(v)


def _stepsize(row: _Row):
    """cstpu's spectral step 0.95 / (2 sigma_max^2)."""
    return 0.95 / (2.0 * _sigma_max_sq_shards(row))


@_in_f32
def _ista_shards(row: _Row, b, w, stepsize, maxiter: int,
                 accelerated: bool):
    """(F)ISTA with x sharded over the atoms: the only communication is the
    n-length psum of the partial fits A_s x_s per iteration."""
    A = row.A
    x = [torch.zeros((row.ml,), dtype=b.dtype, device=dev)
         for dev in row.devs]
    y = x
    t = _c(1.0, b)
    for _ in range(int(maxiter)):
        LOOP_COUNTS["iterations"] += 1
        r = b - _fit(row, A, y)
        g = _corr(row, A, r)
        x_new = [_shrink(yl + 2 * stepsize.to(yl.device) * gl,
                         wl * stepsize.to(wl.device))
                 for yl, gl, wl in zip(y, g, w)]
        if accelerated:
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            f = ((t - 1.0) / t_new)
            y = [xn + f.to(xn.device) * (xn - xo)
                 for xn, xo in zip(x_new, x)]
            t = t_new
        else:
            y = x_new
        x = x_new
    return x


def ista_sharded(A, b, lam, mesh: Mesh, maxiter: int = 1024,
                 stepsize: float | None = 1e-2, accelerated: bool = False):
    """(F)ISTA with the dictionary and solution column-sharded: one
    n-length psum per iteration. `accelerated=True` is FISTA (Nesterov
    momentum). Semantics of cstpu_torch.ista / fista, including
    `stepsize=None` for the spectral (power-iteration) auto step."""
    row, _ = _setup(A, mesh)
    dt = row.A[0].dtype
    m = row.m
    step = (_stepsize(row) if stepsize is None
            else _on(stepsize, row, dt))
    w = torch.broadcast_to(_on(lam, row, dt), (m,))
    return _join(row, _ista_shards(row, _on(b, row, dt), _split(row, w),
                                   step, int(maxiter), bool(accelerated)))


def fista_sharded(A, b, lam, mesh: Mesh, maxiter: int = 1024,
                  stepsize: float | None = 1e-2):
    """Sharded FISTA (see ista_sharded)."""
    return ista_sharded(A, b, lam, mesh, maxiter, stepsize,
                        accelerated=True)


# ---------------------------------------------------------------------------
# Sharded secant BPD (SPGL1-style Pareto root-finding)
# ---------------------------------------------------------------------------

@_in_f32
def _fista_conv_shards(row: _Row, b, w, lam, x0, stepsize, maxiter: int,
                       rtol):
    """Warm-startable sharded FISTA with gradient restart and a
    relative-change stop (the twin of basis_pursuit._fista_conv). Per
    iteration: the n-length fit psum plus ONE packed (3,)-scalar psum
    (restart dot, step norm, iterate norm)."""
    A = row.A
    one = _c(1.0, b)
    ls = lam * stepsize

    def body(c, mode):
        x, y, t, _ = c
        r = b - _fit(row, A, y)
        g = _corr(row, A, r)
        x_new = [_shrink(yl + 2.0 * stepsize.to(yl.device) * gl,
                         ls.to(wl.device) * wl)
                 for yl, gl, wl in zip(y, g, w)]
        step = _diff(x_new, x)
        glob = _sqsums(row, (_diff(y, x_new), step), (step, step),
                       (x_new, x_new))
        restart = glob[0] > 0.0
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        t_new = torch.where(restart, one, t_new)
        f = (t - 1.0) / t_new
        y_new = [torch.where(restart.to(xn.device), xn,
                             xn + f.to(xn.device) * (xn - xo))
                 for xn, xo in zip(x_new, x)]
        done = torch.sqrt(glob[1]) <= rtol * (1.0 + torch.sqrt(glob[2]))
        return x_new, y_new, t_new, done

    return _loop(row, body, (x0, x0, one, _latch(b)), maxiter)[0]


def bpd_secant_sharded(A, b, delta, w=None, mesh: Mesh = None,
                       maxiter_outer: int = 24, inner: int = 4000,
                       band: float = 0.02,
                       matmul_precision: str = "float32",
                       return_info: bool = False):
    """Column-sharded BPD with certified feasibility: the same bracketed
    secant on the LASSO Pareto curve as cstpu_torch.bpd (method="secant"),
    with the inner FISTA solves running sharded (one n-psum + one packed
    scalar psum per iteration). Returns x (m,) on the home device — or the
    reference's NaN failure vector when no feasible point exists.
    `return_info=True` -> (x, info)."""
    row, dense = _setup(A, mesh)
    dt = row.A[0].dtype
    m = row.m
    b = _on(b, row, dt)
    delta = float(delta)
    w = (torch.ones((m,), dtype=dt, device=row.home) if w is None
         else _on(w, row, dt))
    nb = float(_norm(b))

    def _with_info(x, info):
        return (x, info) if return_info else x

    if nb <= delta:
        return _with_info(torch.zeros((m,), dtype=dt, device=row.home),
                          {"feasible": True, "rho": nb,
                           "lam": float("inf"), "outers": 0})
    with _matmul_precision(str(matmul_precision)):
        corr = np.abs(_np64(_join(row, _corr(row, row.A, b))))
    corr = corr / np.maximum(_np64(w), 1e-300)
    corr = corr[np.isfinite(corr)]
    lam_max = 2.0 * (float(np.max(corr)) if corr.size else 0.0)
    if lam_max <= 0.0:
        return _with_info(torch.full((m,), torch.nan, dtype=dt,
                                     device=row.home),
                          {"feasible": False, "rho": nb, "lam": 0.0,
                           "outers": 0})
    step = _on(float(_stepsize(row)), row, dt)
    rtol = _on(1e-12 if dt == torch.float64 else 1e-7, row, dt)
    ws = _split(row, w)

    def solve(lam, x):
        return _join(row, _fista_conv_shards(
            row, b, ws, _on(lam, row, dt), _split(row, x), step, int(inner),
            rtol))

    def rho_of(x):
        with _matmul_precision(str(matmul_precision)):
            return float(_norm(b - _fit(row, row.A, _split(row, x))))

    x, info = _pareto_secant_loop(dense, b, solve, rho_of,
                                  torch.zeros((m,), dtype=dt,
                                              device=row.home),
                                  nb, lam_max, delta, band,
                                  int(maxiter_outer))
    return _with_info(x, info)
