"""Randomized invariant fuzz of cstpu_torch, the PyTorch/CUDA port.

The tests pin discriminating seeds; this harness goes wide: every trial
draws a random problem (shape bucket, conditioning, noise, sparsity) and
checks invariants that must hold on any input, not planted-support
recovery, which greedy methods may legitimately miss on hard instances:

  * container integrity: masked indices in range, no duplicate active
    atoms, finite coefficients;
  * batch against single: every `*_batch` entry agrees row for row with
    its per-instance solver (in f64, where ties resolve alike);
  * kernel against plain: on the card, every kernel route of the
    `*_batch` entry points (the `*_fused_solve` the entry point runs)
    against the same call on the kernels' plain twins (`*_fused_solve_
    ref`), held to recovery quality (equal support size, residual norm
    within a near-tie tolerance: docs/DESIGN.md's conformance contract);
    on the CPU both routes are the plain twin, and the check says so;
  * sharded against single: column-sharded OMP on meshes of 2 and 4
    shards selects the atoms the unsharded batch solver does, and the
    sharded convex solvers match their single-device twins to solver
    tolerance;
  * exact oracles: fista against the exact LASSO path objective, BP's
    ADMM against the exact simplex LP (feasibility-aware both ways), BPD
    against the exact homotopy delta crossing, the active-set engine
    against numpy's normal equations over random append/delete
    sequences, RMPS against the Tipping-Faul stationarity conditions
    recomputed from scratch;
  * the analysis utilities (Babel function, coherence, generators,
    preconditioners) and sbl's Woodbury form against its direct one.

The port of benchmarks/fuzz.py: its thirteen checks on cstpu_torch's API.
The trial number seeds a numpy Generator and a torch.Generator on the
device, so focused and round-robin campaigns see the same problems.

Run:  python tools/fuzz_torch.py [trials] [seed0] [check-substring]
          [--device cpu|cuda]
(defaults 60 trials, seed 0, every check in turn, the card). Exits 1 and
lists every violation; a check that raises is a violation. It imports
torch, numpy and cstpu_torch only.
"""

from __future__ import annotations

import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import cstpu_torch as ct  # noqa: E402
from cstpu_torch.models import batched  # noqa: E402

SHAPES = [(32, 128), (64, 128), (64, 256), (32, 48)]
F32, F64 = torch.float32, torch.float64


class Fuzz:
    """One campaign: its device and the violations found so far."""

    def __init__(self, device):
        self.dev = torch.device(device)
        self.violations: list[str] = []
        self.notes: list[str] = []

    @property
    def on_card(self) -> bool:
        return self.dev.type == "cuda"

    def flag(self, trial, what):
        self.violations.append(f"trial {trial}: {what}")
        print(f"FUZZ VIOLATION  trial {trial}: {what}", flush=True)

    def gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.dev).manual_seed(int(seed))

    def mesh(self, shards: int):
        return ct.make_mesh((1, shards), devices=[self.dev])


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _integrity(fz, trial, name, sol, m):
    idx, mask, val = _np(sol.idx), _np(sol.mask), _np(sol.val)
    act = idx[mask]
    if act.size and (act.min() < 0 or act.max() >= m):
        fz.flag(trial, f"{name}: active index out of range: {act}")
    if len(set(act.tolist())) != act.size:
        fz.flag(trial, f"{name}: duplicate active atoms: {sorted(act)}")
    if not np.all(np.isfinite(val[mask])):
        fz.flag(trial, f"{name}: non-finite active coefficient")


def _row(sol, i):
    """Row i of a batched SparseSolution."""
    return ct.SparseSolution(idx=sol.idx[i], val=sol.val[i],
                             mask=sol.mask[i], m=sol.m)


def _problem(fz, rng, trial, dtype=F32):
    n, m = SHAPES[rng.integers(len(SHAPES))]
    k = int(rng.integers(1, 7))
    correlated = bool(rng.integers(2))
    gen = fz.gen(rng.integers(2 ** 31))
    if correlated:
        A, x, b = ct.correlated_data(gen, n, m, k, decay=1.0, dtype=dtype)
    else:
        A, x, b = ct.sparse_data(gen, n, m, k, dtype=dtype)
    if rng.integers(2):
        b = ct.perturb(fz.gen(trial + 10 ** 6), b, 5e-3)
    return A, x, b, k


def _rows(fz, rng, b):
    """An 8-row batch mixing b with seven perturbed copies."""
    gen = fz.gen(rng.integers(2 ** 31))
    return torch.stack([b] + [ct.perturb(gen, b, 1e-2) for _ in range(7)])


def _resid(A, y, sol):
    x = sol.todense() if hasattr(sol, "todense") else sol
    return float(torch.linalg.norm(A @ x.to(A.dtype) - y))


BATCH_PAIRS = [
    ("omp", lambda A, y, k: ct.omp(A, y, k),
     lambda A, Y, k: batched.omp_batch(A, Y, k)),
    ("gomp", lambda A, y, k: ct.gomp(A, y, 2, k),
     lambda A, Y, k: batched.gomp_batch(A, Y, 2, k)),
    ("fr", lambda A, y, k: ct.fr(A, y, sparsity=k),
     lambda A, Y, k: batched.fr_batch(A, Y, sparsity=k)),
    ("sp", lambda A, y, k: ct.sp(A, y, k),
     lambda A, Y, k: batched.sp_batch(A, Y, k)),
    ("ompr", lambda A, y, k: ct.ompr(A, y, k, 1e-12),
     lambda A, Y, k: batched.ompr_batch(A, Y, k, 1e-12)),
    ("srr", lambda A, y, k: ct.srr(A, y, k),
     lambda A, Y, k: batched.srr_batch(A, Y, k)),
    ("rmp", lambda A, y, k: ct.rmp(A, y, k=k),
     lambda A, Y, k: batched.rmp_batch(A, Y, k=k)),
]


def check_batch_vs_single(fz, trial, rng, A, b, k):
    """Logic equivalence of the batch dispatchers, in f64: a batched
    product's order differs from the per-instance one, and in f32 a
    noise-floor near-tie can flip a late greedy pick; f64 resolves ties
    alike, so a disagreement here is a wiring bug (gating, masking, row
    merging). RMP on a correlated dictionary keeps ties below even f64's
    noise floor, so it redraws a Gaussian one."""
    name, single, bat = BATCH_PAIRS[(trial // len(CHECKS))
                                    % len(BATCH_PAIRS)]
    if name == "rmp":
        A, _, b = ct.sparse_data(fz.gen(rng.integers(2 ** 31)), A.shape[0],
                                 A.shape[1], k, dtype=F64)
    A, b = A.to(F64), b.to(F64)
    Y = _rows(fz, rng, b)
    sols = bat(A, Y, k)
    m = A.shape[1]
    for i in (0, 3, 7):
        row = _row(sols, i)
        _integrity(fz, trial, f"{name}_batch[{i}]", row, m)
        ref = single(A, Y[i], k)
        if list(row.nzind) != list(ref.nzind):
            fz.flag(trial, f"{name}: batch row {i} support "
                           f"{list(row.nzind)} != single {list(ref.nzind)}")
        elif not np.allclose(row.nzval, ref.nzval, rtol=1e-4, atol=1e-6):
            fz.flag(trial, f"{name}: batch row {i} coefficients diverge")


def _kernel_pairs():
    """name -> (kernel route, plain twins, gate) on (A, Y, k); each
    returns a batched SparseSolution, MP's dense x, or RMP's and FoBa's
    (solution, capped (B,))."""
    from cstpu_torch.ops import fused_backward as fb
    from cstpu_torch.ops import fused_solve as fs
    from cstpu_torch.ops import fused_twostage as ft

    cdt = dict(corr_dtype=F32)

    def first(fn):
        return lambda *a, **kw: fn(*a, **kw)[0]

    def capped(fn):
        return lambda *a, **kw: fn(*a, **kw)[::2]

    return {
        "omp": (first(lambda A, Y, k: fs.omp_fused_solve(A, Y, k, **cdt)),
                first(lambda A, Y, k: fs.omp_fused_solve_ref(A, Y, k, **cdt)),
                lambda A, Y, k: fs.supported(A, Y, k, F32)),
        "mp": (first(lambda A, Y, k: fs.mp_fused_solve(A, Y, 4 * k, **cdt)),
               first(lambda A, Y, k: fs.mp_fused_solve_ref(A, Y, 4 * k,
                                                           **cdt)),
               lambda A, Y, k: fs.supported_mp(A, Y)),
        "fr": (first(lambda A, Y, k: fs.fr_fused_solve(A, Y, k, **cdt)),
               first(lambda A, Y, k: fs.fr_fused_solve_ref(A, Y, k, **cdt)),
               lambda A, Y, k: fs.supported_fr(A, Y, k, F32)),
        "gomp": (first(lambda A, Y, k: fs.gomp_fused_solve(A, Y, 2, k,
                                                           **cdt)),
                 first(lambda A, Y, k: fs.gomp_fused_solve_ref(A, Y, 2, k,
                                                               **cdt)),
                 lambda A, Y, k: fs.supported_gomp(A, Y, 2, k)),
        "sp": (first(lambda A, Y, k: ft.sp_fused_solve(A, Y, k, **cdt)),
               first(lambda A, Y, k: ft.sp_fused_solve_ref(A, Y, k, **cdt)),
               lambda A, Y, k: ft.supported_sp(A, Y, k, F32)),
        "ompr": (first(lambda A, Y, k: ft.ompr_fused_solve(A, Y, k, 1e-12,
                                                           **cdt)),
                 first(lambda A, Y, k: ft.ompr_fused_solve_ref(
                     A, Y, k, 1e-12, **cdt)),
                 lambda A, Y, k: ft.supported_ompr(A, Y, k, F32)),
        "srr": (first(lambda A, Y, k: ft.srr_fused_solve(A, Y, k, **cdt)),
                first(lambda A, Y, k: ft.srr_fused_solve_ref(A, Y, k,
                                                             **cdt)),
                lambda A, Y, k: ft.supported_srr(A, Y, k, 1, F32)),
        "rmp": (capped(lambda A, Y, k: ft.rmp_fused_solve(
                    A, Y, delta=1e-2, kmax=16, **cdt)),
                capped(lambda A, Y, k: ft.rmp_fused_solve_ref(
                    A, Y, delta=1e-2, kmax=16, **cdt)),
                lambda A, Y, k: ft.supported_rmp(A, Y, 16, F32)),
        "foba": (capped(lambda A, Y, k: ft.foba_fused_solve(
                     A, Y, 1e-2, kmax=16, **cdt)),
                 capped(lambda A, Y, k: ft.foba_fused_solve_ref(
                     A, Y, 1e-2, kmax=16, **cdt)),
                 lambda A, Y, k: ft.supported_rmp(A, Y, 16, F32)),
        "fbr": (first(lambda A, Y, k: fb.fbr_fused_solve(A, Y, sparsity=k)),
                first(lambda A, Y, k: fb.fbr_fused_solve_ref(A, Y,
                                                             sparsity=k)),
                lambda A, Y, k: fb.supported_backward(A, Y)),
        "lace": (first(lambda A, Y, k: fb.lace_fused_solve(A, Y,
                                                           sparsity=k)),
                 first(lambda A, Y, k: fb.lace_fused_solve_ref(
                     A, Y, sparsity=k)),
                 lambda A, Y, k: fb.supported_backward(A, Y)),
    }


def check_kernel_vs_plain(fz, trial, rng, A, b, k):
    """Quality conformance of every kernel route against its plain twins
    on the same inputs (true f32 correlation): equal support size and a
    residual no worse than the plain solve's beyond a near-tie tolerance.
    The backward family redraws a square 128 x 128 dictionary. RMP's and
    FoBa's rows that hit the kmax cap on either route are truncations of a
    forward stage that wanted more atoms, its late picks at the noise
    floor (docs/DESIGN.md: exhaustion-mode compositions land in different
    valid optima), and are left out."""
    from cstpu_torch.ops.fused_solve import LAUNCHES

    if not fz.on_card:
        note = ("check_kernel_vs_plain: skipped on the CPU, where both "
                "routes are the plain twin")
        if note not in fz.notes:
            fz.notes.append(note)
            print(note, flush=True)
        return
    Y = _rows(fz, rng, b)
    As, _, bs = ct.sparse_data(fz.gen(rng.integers(2 ** 31)), 128, 128, k)
    Ys = _rows(fz, rng, bs)
    for name, (kern, plain, gate) in _kernel_pairs().items():
        A_, Y_ = (As, Ys) if name in ("fbr", "lace") else (A, Y)
        if not gate(A_, Y_, k):
            continue
        before = sum(LAUNCHES.values())
        got = kern(A_, Y_, k)
        torch.cuda.synchronize()
        if sum(LAUNCHES.values()) == before:
            fz.flag(trial, f"{name}: the kernel route launched no kernel")
        want = plain(A_, Y_, k)
        cut = torch.zeros((Y_.shape[0],), dtype=torch.bool, device=fz.dev)
        if isinstance(got, tuple):
            (got, c1), (want, c2) = got, want
            cut = c1 | c2
        for i in range(Y_.shape[0]):
            if bool(cut[i]):
                continue
            if name == "mp":
                rk, rx = _resid(A_, Y_[i], got[i]), _resid(A_, Y_[i],
                                                           want[i])
            else:
                row, rrow = _row(got, i), _row(want, i)
                _integrity(fz, trial, f"{name} kernel[{i}]", row,
                           A_.shape[1])
                rk, rx = _resid(A_, Y_[i], row), _resid(A_, Y_[i], rrow)
                if int(row.mask.sum()) != int(rrow.mask.sum()):
                    fz.flag(trial, f"{name}: row {i} support size "
                                   f"{int(row.mask.sum())} != plain "
                                   f"{int(rrow.mask.sum())}")
                    continue
            if rk > rx * (1 + 1e-3) + 1e-4:
                fz.flag(trial, f"{name}: row {i} residual {rk:.3e} worse "
                               f"than plain {rx:.3e}")


def check_sharded_vs_single(fz, trial, rng, A, b, k):
    """Column-sharded OMP (f32 correlation) on meshes of 2 and 4 shards
    against the unsharded batch solver, at a shardable shape (n=64,
    m=1024, redrawn with the trial's conditioning): the same atoms on a
    Gaussian dictionary; on a correlated one, twins may tie within an f32
    ulp across shards, and the invariant is the answer's quality."""
    gen = fz.gen(rng.integers(2 ** 31))
    correlated = bool(rng.integers(2))
    if correlated:
        A, _, b = ct.correlated_data(gen, 64, 1024, k, decay=1.0)
    else:
        A, _, b = ct.sparse_data(gen, 64, 1024, k)
    Y = _rows(fz, rng, b)
    ref = batched.omp_batch(A, Y, k, precision="f32")
    for shards in (2, 4):
        sol = ct.omp_sharded_fused(A, Y, k, fz.mesh(shards),
                                   corr_dtype=F32)
        if torch.equal(sol.idx.cpu(), ref.idx.cpu()):
            continue
        if not correlated:
            fz.flag(trial, f"omp_sharded_fused on {shards} shards: "
                           f"selection differs from the unsharded solve")
            continue
        for i in range(Y.shape[0]):
            rk = _resid(A, Y[i], _row(sol, i))
            rx = _resid(A, Y[i], _row(ref, i))
            if rk > rx * 1.5 + 1e-3:
                fz.flag(trial, f"omp_sharded_fused on {shards} shards: row "
                               f"{i} residual {rk:.3e} far above "
                               f"unsharded {rx:.3e}")


def check_lasso_oracle(fz, trial, rng, A, b, k):
    from cstpu_torch.native import lasso_homotopy

    lam = float(10 ** rng.uniform(-4, -2))
    y, An = _np(b).astype(np.float64), _np(A).astype(np.float64)
    xi = _np(ct.fista(A, b, lam, maxiter=4096,
                      stepsize=None)).astype(np.float64)
    xs = lasso_homotopy(An, y, lam)

    def obj(z):
        return 0.5 * np.sum((An @ z - y) ** 2) + lam * np.sum(np.abs(z))

    if obj(xs) > obj(xi) + 1e-8:
        fz.flag(trial, f"lasso: exact path objective {obj(xs):.6e} ABOVE "
                       f"fista {obj(xi):.6e}: homotopy not optimal")
    if abs(obj(xs) - obj(xi)) > 5e-3:
        fz.flag(trial, f"lasso: fista objective gap "
                       f"{abs(obj(xs) - obj(xi)):.2e}")


BACKWARD_PAIRS = [
    ("br", lambda A, y, k: ct.br(A, y, sparsity=k),
     lambda A, Y, k: batched.br_batch(A, Y, sparsity=k)),
    ("fbr", lambda A, y, k: ct.fbr(A, y, sparsity=k),
     lambda A, Y, k: batched.fbr_batch(A, Y, sparsity=k)),
    ("lace", lambda A, y, k: ct.lace(A, y, sparsity=k),
     lambda A, Y, k: batched.lace_batch(A, Y, sparsity=k)),
]


def check_backward_batch_vs_single(fz, trial, rng, A, b, k):
    """The backward family needs full column rank: square or
    overdetermined problems, redrawn in f64 (the rationale of
    check_batch_vs_single)."""
    name, single, bat = BACKWARD_PAIRS[(trial // len(CHECKS))
                                       % len(BACKWARD_PAIRS)]
    n = int(rng.choice([32, 48]))
    m = n if name != "lace" else n - 16          # lace: overdetermined
    A, _, b = ct.sparse_data(fz.gen(rng.integers(2 ** 31)), n, m, k,
                             dtype=F64)
    Y = _rows(fz, rng, b)
    sols = bat(A, Y, k)
    for i in (0, 5):
        row = _row(sols, i)
        _integrity(fz, trial, f"{name}_batch[{i}]", row, m)
        ref = single(A, Y[i], k)
        if list(row.nzind) != list(ref.nzind):
            fz.flag(trial, f"{name}: batch row {i} support "
                           f"{list(row.nzind)} != single {list(ref.nzind)}")


def check_sbl_batch_vs_single(fz, trial, rng, A, b, k):
    """The SBL family: batched posterior means against the single path in
    f64; supports thresholded at sigma."""
    sigma = 1e-2
    A, b = A.to(F64), b.to(F64)
    Y = _rows(fz, rng, b)
    which = ["sbl", "fsbl", "rmps"][(trial // len(CHECKS)) % 3]
    single = {"sbl": ct.sbl, "fsbl": ct.fsbl, "rmps": ct.rmps}[which]
    bat = {"sbl": batched.sbl_batch, "fsbl": batched.fsbl_batch,
           "rmps": batched.rmps_batch}[which]
    Xs = _np(bat(A, Y, sigma))
    for i in (0, 5):
        xr = _np(single(A, Y[i], sigma))
        got = np.flatnonzero(np.abs(Xs[i]) > sigma)
        want = np.flatnonzero(np.abs(xr) > sigma)
        if not np.array_equal(got, want):
            fz.flag(trial, f"{which}: batch row {i} support@sigma "
                           f"{got.tolist()} != single {want.tolist()}")


def check_sbl_woodbury_vs_direct(fz, trial, rng, A, b, k):
    """Plain sbl's n x n Woodbury form against the m x m iteration on any
    input (the same gamma fixed point), in f64; a scalar or a matrix
    noise."""
    sigma2 = float(10.0 ** rng.uniform(-5, -3))
    A, b = A.to(F64), b.to(F64)
    sig = sigma2 if rng.random() < 0.5 else sigma2 * torch.eye(
        A.shape[0], dtype=F64, device=A.device)
    xd = _np(ct.sbl(A, b, sig, method="direct"))
    xw = _np(ct.sbl(A, b, sig, method="woodbury"))
    thr = np.sqrt(sigma2)
    got, want = np.flatnonzero(np.abs(xw) > thr), np.flatnonzero(
        np.abs(xd) > thr)
    if not np.array_equal(got, want):
        fz.flag(trial, f"sbl woodbury support {got.tolist()} != direct "
                       f"{want.tolist()}")
    elif not np.allclose(xw, xd, atol=1e-6):
        fz.flag(trial, f"sbl woodbury coef dev {np.abs(xw - xd).max():.2e}")


def check_bp_feasibility(fz, trial, rng, A, b, k):
    """BP's ADMM iterate is primal feasible and no sparser certificate
    exists: the exact simplex LP is the oracle, with the ADMM iterate
    projected onto {Ax = b} first so that the comparison is rigorous."""
    from cstpu_torch.native import bp_simplex

    A64, y64 = _np(A).astype(np.float64), _np(b).astype(np.float64)
    xb = _np(ct.bp(A, b)).astype(np.float64)
    feas = float(np.linalg.norm(A64 @ xb - y64))
    scale = 1.0 + float(np.linalg.norm(y64))
    if feas > 1e-3 * scale:
        fz.flag(trial, f"bp[admm]: infeasible, ||Ax-b|| = {feas:.2e}")
    xs = bp_simplex(A64, y64)
    if float(np.linalg.norm(A64 @ xs - y64)) > 1e-8 * scale:
        fz.flag(trial, "bp[simplex]: exact LP returned an infeasible vertex")
    L = np.linalg.cholesky(A64 @ A64.T)
    xproj = xb + A64.T @ np.linalg.solve(L.T, np.linalg.solve(
        L, y64 - A64 @ xb))
    if np.sum(np.abs(xs)) > np.sum(np.abs(xproj)) + 1e-6:
        fz.flag(trial, f"bp: simplex objective {np.sum(np.abs(xs)):.6f} "
                       f"ABOVE feasible-projected admm "
                       f"{np.sum(np.abs(xproj)):.6f}: LP not optimal")
    if (feas < 1e-3 * scale
            and np.sum(np.abs(xb)) > np.sum(np.abs(xs)) * 1.05 + 1e-3):
        fz.flag(trial, f"bp[admm]: objective {np.sum(np.abs(xb)):.6f} far "
                       f"above exact {np.sum(np.abs(xs)):.6f}")


def check_active_set_sequence(fz, trial, rng, A, b, k):
    """The engine under every greedy solver: a random append/delete
    sequence tracks numpy's normal equations (f64): coefficients,
    residual, gamma leverage and the OLS rescaling denominators."""
    from cstpu_torch.ops import active_set as aset

    n, m, kmax = 32, 48, 10
    A, _, b = ct.sparse_data(fz.gen(rng.integers(2 ** 31)), n, m, k,
                             dtype=F64)
    An, bn = _np(A), _np(b)
    colnorm2 = torch.sum(A * A, dim=0)
    st = aset.empty(n, kmax, m, A.dtype, A.device)
    sup: list[int] = []
    for step in range(14):
        if sup and (len(sup) >= kmax or rng.random() < 0.3):
            pos = int(rng.integers(len(sup)))
            st = aset.delete(st, pos, m)
            sup.pop(pos)
        else:
            i = int(rng.choice([j for j in range(m) if j not in sup]))
            st = aset.append(A, b, st, i)
            sup.append(i)
        st = aset.refit(st)
        kk = len(sup)
        if int(st.k) != kk or sorted(_np(st.idx)[:kk]) != sorted(sup):
            fz.flag(trial, f"aset step {step}: bookkeeping "
                           f"{_np(st.idx)[:kk]} != {sup}")
            return
        if not kk:
            continue
        As = An[:, sup]
        Gi = np.linalg.inv(As.T @ As)
        coef = Gi @ (As.T @ bn)
        if not np.allclose(_np(st.coef)[:kk], coef, rtol=1e-8, atol=1e-10):
            fz.flag(trial, f"aset step {step}: coef diverges from lstsq")
        if not np.allclose(_np(aset.residual(st, b)), bn - As @ coef,
                           atol=1e-9):
            fz.flag(trial, f"aset step {step}: residual diverges")
        if not np.allclose(_np(aset.gamma(st))[:kk], np.diag(Gi), rtol=1e-8,
                           atol=1e-10):
            fz.flag(trial, f"aset step {step}: gamma leverage diverges")
        resc = _np(aset.ols_rescaling(A, st, colnorm2))
        W = As.T @ An
        want = _np(colnorm2) - np.sum(W * (Gi @ W), axis=0)
        if not np.allclose(resc, want, rtol=1e-8, atol=1e-9):
            fz.flag(trial, f"aset step {step}: ols_rescaling diverges")


def check_bpd_oracle(fz, trial, rng, A, b, k):
    """BPD's default (secant) against the exact homotopy delta crossing:
    the point lies in the l2 ball (certified) and its objective is within
    first-order distance of the exact one; BPD's ADMM is feasible or
    declares its failure (all-NaN, feasible=False), never a silent
    violation."""
    from cstpu_torch.native import bpd_homotopy

    delta = float(10 ** rng.uniform(-2.3, -1.5))
    A64, y64 = _np(A).astype(np.float64), _np(b).astype(np.float64)
    xd, info = ct.bpd(A, b, delta, return_info=True)
    xd = _np(xd).astype(np.float64)
    if not info["feasible"]:
        fz.flag(trial, f"bpd[secant]: declared infeasible, rho "
                       f"{info['rho']:.4e} vs delta {delta:.4e}")
        return
    ball = float(np.linalg.norm(A64 @ xd - y64))
    if ball > delta * (1.0 + 1e-5):
        fz.flag(trial, f"bpd[secant]: ball violated, ||Ax-b|| = {ball:.4e} "
                       f"vs delta {delta:.4e}")
    xh, _lam = bpd_homotopy(A64, y64, delta)
    if np.linalg.norm(A64 @ xh - y64) > delta * (1 + 1e-9) + 1e-12:
        fz.flag(trial, "bpd[homotopy]: exact crossing violates the ball")
    if np.abs(xh).sum() > np.abs(xd).sum() + 1e-4 and ball <= delta:
        fz.flag(trial, f"bpd: exact objective {np.abs(xh).sum():.6f} ABOVE "
                       f"feasible secant {np.abs(xd).sum():.6f}")
    if np.abs(xd).sum() > np.abs(xh).sum() * 1.05 + 1e-3:
        fz.flag(trial, f"bpd[secant]: objective {np.abs(xd).sum():.6f} far "
                       f"above exact {np.abs(xh).sum():.6f}")
    xa, ainfo = ct.bpd(A, b, delta, method="admm", return_info=True)
    xa = _np(xa).astype(np.float64)
    if np.all(np.isfinite(xa)):
        balla = float(np.linalg.norm(A64 @ xa - y64))
        if balla > delta * 1.05 + 1e-9:
            fz.flag(trial, f"bpd[admm]: SILENT ball violation "
                           f"{balla:.4e} vs delta {delta:.4e}")
    elif ainfo["feasible"] or not np.all(np.isnan(xa)):
        fz.flag(trial, "bpd[admm]: failure vector not all-NaN or "
                       "feasible flag inconsistent")


def check_convex_sharded(fz, trial, rng, A, b, k):
    """The column-sharded convex solvers on four shards against their
    single-device twins: the same ADMM / proximal semantics, so results
    agree to solver tolerance (not bitwise: the shards' sums run in
    another order)."""
    from cstpu_torch.parallel import (bp_sharded, bpd_secant_sharded,
                                      fista_sharded)

    mesh = fz.mesh(4)
    which = ["bp", "fista", "bpd_secant"][(trial // len(CHECKS)) % 3]
    if which == "bpd_secant":
        delta = float(10 ** rng.uniform(-2.3, -1.5))
        xs, sinfo = bpd_secant_sharded(A, b, delta, mesh=mesh,
                                       return_info=True)
        xr, rinfo = ct.bpd(A, b, delta, return_info=True)
        if sinfo["feasible"] != rinfo["feasible"]:
            fz.flag(trial, f"bpd_secant_sharded: feasibility flag "
                           f"{sinfo['feasible']} != single "
                           f"{rinfo['feasible']}")
            return
        if not sinfo["feasible"]:
            return
        feas = _resid(A, b, xs)
        if feas > delta * (1 + 1e-5):
            fz.flag(trial, f"bpd_secant_sharded: ball violated {feas:.3e} "
                           f"vs delta {delta:.3e}")
        o_s, o_r = float(xs.abs().sum()), float(xr.abs().sum())
        if o_s > o_r * 1.05 + 1e-3:
            fz.flag(trial, f"bpd_secant_sharded: objective {o_s:.6f} far "
                           f"above single-device {o_r:.6f}")
    elif which == "bp":
        zs = bp_sharded(A, b, mesh=mesh)[0]
        xr = ct.bp(A, b)
        feas_s, feas_r = _resid(A, b, zs), _resid(A, b, xr)
        scale = 1.0 + float(torch.linalg.norm(b))
        if feas_s > max(10 * feas_r, 1e-3 * scale):
            fz.flag(trial, f"bp_sharded: feasibility {feas_s:.2e} far "
                           f"above single-device {feas_r:.2e}")
        o_s, o_r = float(zs.abs().sum()), float(xr.abs().sum())
        if abs(o_s - o_r) > 1e-2 * (1 + o_r):
            fz.flag(trial, f"bp_sharded: objective {o_s:.6f} vs "
                           f"single-device {o_r:.6f}")
    else:
        lam = float(10 ** rng.uniform(-4, -2))
        xs = fista_sharded(A, b, lam, mesh, maxiter=2048, stepsize=None)
        xr = ct.fista(A, b, lam, maxiter=2048, stepsize=None)
        An, yn = _np(A).astype(np.float64), _np(b).astype(np.float64)

        def obj(z):
            z = _np(z).astype(np.float64)
            return (0.5 * np.sum((An @ z - yn) ** 2)
                    + lam * np.sum(np.abs(z)))

        if abs(obj(xs) - obj(xr)) > 1e-3 * (1 + obj(xr)):
            fz.flag(trial, f"fista_sharded: objective {obj(xs):.6e} vs "
                           f"single-device {obj(xr):.6e}")


def check_sbl_stationarity(fz, trial, rng, A, b, k):
    """SBL's fixed-point oracle: at RMPS convergence no add action may
    still gain marginal likelihood beyond the solver's tolerance, and a
    pending delete or update gain (the reference stops right after an
    acquisition stage that changed nothing) is acted on by one warm
    restart. S and Q are recomputed from scratch in f64 numpy; the gains
    are the Tipping-Faul closed forms."""
    sigma = float(10 ** rng.uniform(-5, -3))          # noise variance
    A, b = A.to(F64), b.to(F64)
    x, alpha = ct.rmps(A, b, sigma, return_alpha=True)
    An, yn = _np(A), _np(b)
    al = _np(alpha).astype(np.float64)
    n, m = An.shape
    act = np.isfinite(al)
    C = sigma * np.eye(n)
    if act.any():
        C = C + (An[:, act] / al[act][None, :]) @ An[:, act].T
    Ci = np.linalg.inv(C)
    S = np.einsum("ij,ij->j", An, Ci @ An)
    Q = An.T @ (Ci @ yn)
    with np.errstate(all="ignore"):
        f = np.where(act, al / (al - S), 1.0)
        sq_s, sq_q = S * f, Q * f
        rel = sq_s < sq_q * sq_q
        aln = np.where(rel, sq_s * sq_s / (sq_q * sq_q - sq_s), np.inf)
        gain = np.zeros(m)
        add = ~act & rel
        gain[add] = (Q[add] ** 2 - S[add]) / S[add] \
            + np.log(S[add]) - np.log(Q[add] ** 2)
        dele = act & ~rel
        gain[dele] = Q[dele] ** 2 / (S[dele] - al[dele]) \
            - np.log1p(-S[dele] / al[dele])
        upd = act & rel
        dd = 1.0 / aln[upd] - 1.0 / al[upd]
        gain[upd] = Q[upd] ** 2 / (S[upd] + 1.0 / dd) \
            - np.log(np.maximum(1.0 + S[upd] * dd, 0.0))
    gain = np.where(np.isfinite(gain), gain, 0.0)
    j = int(np.argmax(gain))
    if gain[j] > 1e-2:
        if add[j]:
            fz.flag(trial, f"rmps not add-stationary: atom {j} would still "
                           f"gain {gain[j]:.3e} marginal likelihood")
            return
        _, alpha2 = ct.rmps(A, b, sigma, alpha0=alpha, return_alpha=True)
        al2 = _np(alpha2).astype(np.float64)
        if np.array_equal(np.where(np.isfinite(al2), al2, 0),
                          np.where(np.isfinite(al), al, 0)):
            fz.flag(trial, f"rmps stuck: warm restart did not act on a "
                           f"{gain[j]:.3e} pending gain (atom {j})")


def check_analysis_utilities(fz, trial, rng, A, b, k):
    """Dictionary-analysis identities on any input: the Babel function's
    monotonicity and bounds (Tropp), the generators' contracts (unit
    columns, an exact perturbation norm), the preconditioners'
    consistency."""
    m = A.shape[1]
    kk = min(8, m - 1)
    mus = _np(ct.cumbabel(A, kk)).astype(np.float64)
    mu = float(ct.coherence(A))
    if abs(mus[0] - mu) > 1e-6:
        fz.flag(trial, f"babel(1) {mus[0]} != coherence {mu}")
    if np.any(np.diff(mus) < -1e-9):
        fz.flag(trial, f"cumbabel not monotone: {mus}")
    if np.any(mus > np.arange(1, kk + 1) * mu + 1e-9):
        fz.flag(trial, "mu_1(i) > i*mu: Babel bound violated")
    for i in (1, kk):
        bi = float(ct.babel(A, i))
        if abs(bi - mus[i - 1]) > 1e-9:
            fz.flag(trial, f"babel({i}) {bi} != cumbabel[{i - 1}] "
                           f"{mus[i - 1]}")
    cn = _np(ct.colnorms(ct.normalize_columns(A)))
    if not np.allclose(cn, 1.0, atol=1e-5):
        fz.flag(trial, "normalize_columns did not produce unit columns")
    delta = float(10 ** rng.uniform(-3, -1))
    y = ct.perturb(fz.gen(trial), b, delta)
    got = float(torch.linalg.norm(y - b))
    if abs(got - delta) > 1e-5 * (1 + delta):
        fz.flag(trial, f"perturb norm {got} != {delta}")
    A64 = A.to(F64)
    P = ct.svd_preconditioner(A64, 1e-6)
    if not np.allclose(_np(P(A64)), _np(ct.precondition(A64, 1e-6)),
                       atol=1e-8):
        fz.flag(trial, "precondition != svd_preconditioner(A) @ A")


CHECKS = [check_batch_vs_single, check_kernel_vs_plain,
          check_sharded_vs_single, check_lasso_oracle,
          check_backward_batch_vs_single, check_sbl_batch_vs_single,
          check_bp_feasibility, check_active_set_sequence,
          check_bpd_oracle, check_convex_sharded, check_sbl_stationarity,
          check_analysis_utilities, check_sbl_woodbury_vs_direct]


def run_trial(fz, trial, check):
    """One trial of `check` on the trial's problem; a check that raises is
    a violation (its exception and the last frame of its traceback)."""
    rng = np.random.default_rng(trial)
    A, _, b, k = _problem(fz, rng, trial)
    try:
        check(fz, trial, rng, A, b, k)
    except Exception as e:  # noqa: BLE001 - the raise is the finding
        where = traceback.extract_tb(e.__traceback__)[-1]
        fz.flag(trial, f"{check.__name__} raised {type(e).__name__}: {e} "
                       f"({os.path.basename(where.filename)}:{where.lineno})")


def run(trials: int, seed0: int = 0, only: str | None = None,
        device: str = "cuda") -> Fuzz:
    """A campaign of `trials` trials from `seed0`: with `only`, every trial
    runs the one check whose name holds it, else the trials take the
    checks in turn. Returns the campaign (its violations)."""
    checks = CHECKS
    if only is not None:
        checks = [c for c in CHECKS if only in c.__name__]
        if len(checks) != 1:
            raise ValueError(f"check filter {only!r} matches "
                             f"{[c.__name__ for c in checks]}")
    fz = Fuzz(device)
    for trial in range(seed0, seed0 + trials):
        run_trial(fz, trial, checks[0] if only else
                  CHECKS[trial % len(CHECKS)])
        if trial % 10 == 9:
            print(f"[fuzz] {trial + 1 - seed0}/{trials} trials, "
                  f"{len(fz.violations)} violations", flush=True)
    return fz


def main(argv) -> int:
    """fuzz_torch.py [trials] [seed0] [check-substring] [--device cpu|cuda]"""
    args = list(argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    if device not in ("cpu", "cuda"):
        print(f"--device must be cpu or cuda, got {device!r}")
        return 2
    if device == "cuda" and not torch.cuda.is_available():
        print("fuzz_torch: no CUDA device; pass --device cpu for the CPU")
        return 2
    trials = int(args[0]) if args else 60
    seed0 = int(args[1]) if len(args) > 1 else 0
    only = args[2] if len(args) > 2 else None
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fz = run(trials, seed0, only, device)
    except ValueError as e:
        print(e)
        return 2
    dev = (torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu")
    print(f"[fuzz] done on {dev}: {trials} trials, {len(fz.violations)} "
          f"violations" + "".join(f"\n  {v}" for v in fz.violations))
    return 1 if fz.violations else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
