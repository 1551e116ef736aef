"""cstpu_torch's convex family and oracle (cstpu_torch.models.basis_pursuit,
cstpu_torch.models.exhaustive) against cstpu's, on the CPU, on cstpu's
seeded problems (tests/conftest.py, n=32, m=48, k=3) handed to both
packages through numpy.

Tolerances: in float64 the supports {|x| > 1e-5} are equal and x agrees to
1e-6 (1 + ||x||) (both run the same iterations; only the order of
floating-point sums differs); in float32 the supports are equal on the
planted problems and x agrees to 1e-3. `return_info`'s feasibility flags
are equal; `exhaustive`'s indices are exactly equal. The latch read every
CHECK_EVERY iterations is held bit for bit against a read every
iteration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstpu
import cstpu_torch
from cstpu.models import basis_pursuit as jbp
from cstpu_torch.models import basis_pursuit as tbp
from cstpu_torch.models import exhaustive as tex
from cstpu_torch.utils.interop import to_torch

DELTA = 1e-2
SUP_TOL = 1e-5
RTOL64 = 1e-6
ATOL32 = 1e-3


def _problem(seed, n=32, m=48, k=3, dtype=None):
    from conftest import planted_problem

    return planted_problem(seed, n=n, m=m, k=k, noise=DELTA / 2, dtype=dtype)


def _close(got, want, f64=True, sup=True):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if f64:
        tol = RTOL64 * (1.0 + np.linalg.norm(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL32)
    if sup:
        np.testing.assert_array_equal(np.abs(got) > SUP_TOL,
                                      np.abs(want) > SUP_TOL)


def _both(fn_name, A, b, *args, **kw):
    """(cstpu_torch's result, cstpu's) of the same call."""
    got = getattr(cstpu_torch, fn_name)(to_torch(A), to_torch(b), *args,
                                        **kw)
    want = getattr(cstpu, fn_name)(A, b, *args, **kw)
    return got, want


# (name, measurement: "b" exact / "y" noisy, args, kwargs)
CALLS = [
    ("bp", "b", (), {}),
    ("bp", "b", (), {"method": "simplex"}),
    ("bp_candes", "b", (), {}),
    ("bp_ard", "b", (), {}),
    ("bpd", "y", (DELTA,), {}),
    ("bpd", "y", (DELTA,), {"method": "admm"}),
    ("bpd", "y", (DELTA,), {"method": "homotopy"}),
    ("bpd_candes", "y", (DELTA,), {"maxiter": 3}),
    ("bpd_ard", "y", (DELTA,), {}),
    ("bpd_ard", "y", (DELTA,), {"method": "secant"}),
    ("bpd_candes", "y", (DELTA,), {"method": "secant"}),
    ("ista", "y", (DELTA / 10,), {"stepsize": 1e-1}),
    ("ista", "y", (DELTA / 10,), {"stepsize": None, "maxiter": 256}),
    ("fista", "y", (DELTA / 10,), {"stepsize": 1e-1}),
    ("fista", "y", (1e-3,), {"stepsize": None, "maxiter": 256}),
]


def _id(c):
    name, _, _, kw = c
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("call", CALLS, ids=[_id(c) for c in CALLS])
def test_convex_matches_cstpu_f64(call):
    name, which, args, kw = call
    A, x, b, y = _problem(60 + CALLS.index(call))
    got, want = _both(name, A, b if which == "b" else y, *args, **kw)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    _close(got, want)
    if not name.startswith(("ista", "fista")):
        tol = SUP_TOL if which == "b" else DELTA
        np.testing.assert_array_equal(
            np.flatnonzero(np.abs(got.numpy()) > tol),
            np.flatnonzero(np.asarray(x)))


F32_CALLS = [c for c in CALLS if c[3].get("method") not in ("simplex",
                                                             "homotopy")]


@pytest.mark.parametrize("call", F32_CALLS, ids=[_id(c) for c in F32_CALLS])
def test_convex_matches_cstpu_f32(call):
    name, which, args, kw = call
    A, x, b, y = _problem(60 + CALLS.index(call), dtype=jnp.float32)
    got, want = _both(name, A, b if which == "b" else y, *args, **kw)
    assert got.dtype == torch.float32
    _close(got, want, f64=False, sup=False)
    if not name.startswith(("ista", "fista")):
        tol = 1e-3 if which == "b" else DELTA
        planted = np.flatnonzero(np.asarray(x))
        np.testing.assert_array_equal(
            np.flatnonzero(np.abs(got.numpy()) > tol), planted)
        np.testing.assert_array_equal(
            np.flatnonzero(np.abs(np.asarray(want)) > tol), planted)


@pytest.mark.parametrize("fn", ["bpd_ard", "bpd_candes"])
@pytest.mark.parametrize("method", ["admm", "secant"])
@pytest.mark.parametrize("margin", [0.5, 0.0])
def test_screened_reweighting_matches_cstpu(fn, method, margin):
    # cstpu's own screened problem (tests/test_basis_pursuit.py): n=16,
    # m=96; margin 0 stresses the repair loop
    from conftest import planted_problem

    A, x, b, y = planted_problem(95, n=16, m=96, k=3, noise=5e-3)
    got, want = _both(fn, A, y, DELTA, method=method, screen=True,
                      screen_margin=margin)
    _close(got, want)
    np.testing.assert_array_equal(
        np.flatnonzero(np.abs(got.numpy()) > DELTA),
        np.flatnonzero(np.asarray(x)))


def test_weighted_bp_matches_cstpu():
    A, x, b, _ = _problem(68)
    w = np.ones(48)
    w[np.flatnonzero(np.asarray(x))] = 1e-6
    got = cstpu_torch.bp(to_torch(A), to_torch(b), to_torch(w))
    _close(got, cstpu.bp(A, b, w))
    gots = cstpu_torch.bp(to_torch(A), to_torch(b), to_torch(w),
                          method="simplex")
    np.testing.assert_array_equal(gots.numpy(),
                                  np.asarray(cstpu.bp(A, b, w,
                                                      method="simplex")))


def _fuzz12345():
    """cstpu's pinned fuzz draw (tests/test_basis_pursuit.py), on which the
    ADMM stops outside the ball."""
    from test_basis_pursuit import _fuzz12345_problem

    return _fuzz12345_problem()


@pytest.mark.parametrize("method,on_infeasible", [
    ("secant", "nan"), ("admm", "nan"), ("admm", "snap"), ("admm", "raw"),
    ("homotopy", "nan")])
def test_return_info_feasibility_matches_cstpu(method, on_infeasible):
    A, b, delta = _fuzz12345()
    got, ginfo = cstpu_torch.bpd(to_torch(A), to_torch(b), delta,
                                 method=method, on_infeasible=on_infeasible,
                                 return_info=True)
    want, winfo = cstpu.bpd(A, b, delta, method=method,
                            on_infeasible=on_infeasible, return_info=True)
    assert ginfo["feasible"] == winfo["feasible"]
    assert ginfo.get("method") == winfo.get("method")
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if np.isfinite(want).all():
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL32)
    if ginfo["feasible"] and method != "admm":
        rho = np.linalg.norm(np.asarray(A, np.float64) @ got
                             - np.asarray(b, np.float64))
        assert rho <= delta * (1.0 + 1e-5)


def test_infeasible_problem_returns_nan_like_cstpu():
    # an overdetermined system whose best residual misses the ball
    key = jax.random.PRNGKey(7)
    Ai = jax.random.normal(key, (24, 3), jnp.float64)
    Ai = Ai / jnp.linalg.norm(Ai, axis=0, keepdims=True)
    bi = jax.random.normal(jax.random.PRNGKey(8), (24,), jnp.float64)
    An, bn = np.asarray(Ai), np.asarray(bi)
    minres = np.linalg.norm(bn - An @ np.linalg.lstsq(An, bn,
                                                      rcond=None)[0])
    got, ginfo = cstpu_torch.bpd(to_torch(An), to_torch(bn), minres * 0.5,
                                 return_info=True)
    _, winfo = cstpu.bpd(Ai, bi, minres * 0.5, return_info=True)
    assert not ginfo["feasible"] and not winfo["feasible"]
    assert bool(torch.isnan(got).all())
    # delta >= ||b||: the exact zero, feasible
    z, zinfo = cstpu_torch.bpd(to_torch(An), to_torch(bn),
                               float(np.linalg.norm(bn)) * 1.5,
                               return_info=True)
    assert zinfo["feasible"] and float(z.abs().max()) == 0.0


@pytest.mark.parametrize("delta", [0.0, -1.0])
def test_nonpositive_delta_routes_to_admm(delta):
    A, x, b, _ = _problem(32)
    got, ginfo = cstpu_torch.bpd(to_torch(A), to_torch(b), delta,
                                 return_info=True)
    want, winfo = cstpu.bpd(A, b, delta, return_info=True)
    assert ginfo["method"] == winfo["method"] == "admm"
    if delta == 0.0:
        _close(got, want)
    # below 0 the ball is empty and the iterates wander: the route is
    # what is held there


def test_zero_delta_f32_finite_like_cstpu():
    # delta = 0 with an exactly-feasible iterate hits the ball
    # projection's divide guard (tiny, not 1e-300, which is 0 in f32)
    A, x, b, _ = _problem(32, dtype=jnp.float32)
    got = cstpu_torch.bpd(to_torch(A), to_torch(b), 0.0)
    want = cstpu.bpd(A, b, 0.0)
    assert bool(torch.isfinite(got).all())
    _close(got, want, f64=False)
    assert float(torch.linalg.norm(to_torch(A) @ got - to_torch(b))) < 1e-3


def test_indefinite_gram_gives_nan_like_cstpu():
    # a zero row makes every whitening Gram singular: jnp's Cholesky
    # returns NaN, and so must the port's (torch's would raise)
    A, x, b, _ = _problem(33)
    A = np.array(A)
    A[0] = 0.0
    got = cstpu_torch.bp(to_torch(A), to_torch(b), maxiter=64)
    want = np.asarray(cstpu.bp(A, b, maxiter=64))
    assert bool(torch.isnan(got).all()) and np.isnan(want).all()


def test_weight_rules_raise_like_cstpu():
    x = torch.tensor([0.0, 1.0], dtype=torch.float64)
    with pytest.raises(FloatingPointError):
        tbp.candes_weights(None, x, 0.0)
    with pytest.raises(ValueError, match="zero"):
        tbp.ard_weights(torch.zeros(2, dtype=torch.float64),
                        torch.eye(2, dtype=torch.float64), x, 1e-2)


def test_ard_weights_match_cstpu():
    A, x, b, _ = _problem(62)
    w0 = np.linspace(0.5, 2.0, 48)
    got = tbp.ard_weights(to_torch(w0), to_torch(A), to_torch(x), 1e-2)
    want = jbp.ard_weights(jnp.asarray(w0), A, x, 1e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


def test_auto_stepsize_matches_cstpu():
    for shape in ((32, 48), (48, 32)):
        A = np.asarray(jax.random.normal(jax.random.PRNGKey(5), shape,
                                         jnp.float64))
        np.testing.assert_allclose(float(tbp._auto_stepsize(to_torch(A))),
                                   float(jbp._auto_stepsize(A)), rtol=1e-12)


@pytest.mark.parametrize("call", [
    ("bp", (), {}), ("bpd", (DELTA,), {"method": "admm"}),
    ("bpd", (DELTA,), {}), ("bpd_ard", (DELTA,), {"maxiter": 3})])
def test_latch_every_check_is_bit_exact(call, monkeypatch):
    # the frozen state makes the steps past the stop exact no-ops: reading
    # the latch every CHECK_EVERY iterations gives what a read every
    # iteration gives, bit for bit, in fewer reads
    name, args, kw = call
    A, x, b, y = _problem(71, dtype=jnp.float32)
    A, y = to_torch(A), to_torch(y)
    runs = {}
    for every in (1, tbp.CHECK_EVERY):
        monkeypatch.setattr(tbp, "CHECK_EVERY", every)
        tbp.LOOP_COUNTS.update(iterations=0, latch_reads=0)
        runs[every] = (getattr(cstpu_torch, name)(A, y, *args, **kw),
                       dict(tbp.LOOP_COUNTS))
    (x1, c1), (xk, ck) = runs[1], runs[tbp.CHECK_EVERY]
    assert torch.equal(x1, xk)
    assert ck["latch_reads"] < c1["latch_reads"]
    assert c1["iterations"] <= ck["iterations"]


def test_fista_counts_fixed_iterations():
    A, x, b, y = _problem(66)
    tbp.LOOP_COUNTS.update(iterations=0, latch_reads=0)
    cstpu_torch.fista(to_torch(A), to_torch(y), 1e-3, maxiter=100)
    assert tbp.LOOP_COUNTS == {"iterations": 100, "latch_reads": 0,
                               "replays": 0}


def test_noncpu_inputs_need_a_card():
    # arrays that are not tensors go to the CUDA device: without one the
    # entry raises instead of solving on the CPU unasked
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    A, x, b, _ = _problem(60)
    with pytest.raises(RuntimeError, match="CUDA"):
        cstpu_torch.bp(np.asarray(A), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("repeat", [False, True])
def test_exhaustive_matches_cstpu(seed, repeat):
    A, x, b, y = _problem(200 + seed)
    A = np.array(A)
    if repeat:
        # a candidate with a repeated column scores as its span does
        A[:, 7] = A[:, 3]
    got = cstpu_torch.exhaustive(to_torch(A), to_torch(y), 3)
    want = cstpu.exhaustive(A, np.asarray(y), 3)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_exhaustive_chunks_and_ties(monkeypatch):
    # chunk boundaries (a chunk smaller than the stack) change nothing; an
    # exact tie (two identical columns) goes to the lowest candidate, as
    # jnp.argmin's does
    A, x, b, y = _problem(210)
    A = np.array(A)
    sup = np.flatnonzero(np.asarray(x))
    A[:, 47] = A[:, sup[0]]
    want = cstpu.exhaustive(A, np.asarray(b), 3)
    monkeypatch.setattr(tex, "CHUNK_BYTES", 32 * 3 * 8 * 1000)
    got = cstpu_torch.exhaustive(to_torch(A), to_torch(b), 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sup)


def test_exhaustive_checks_candidates_first():
    A = torch.zeros((4, 200), dtype=torch.float64)
    with pytest.raises(ValueError, match="max_candidates"):
        cstpu_torch.exhaustive(A, torch.zeros(4, dtype=torch.float64), 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rho_modes_are_cstpus_rule(dtype):
    # cstpu rebalances at t % 64 == 63 and clamps every iteration; off the
    # rebalancing iterations its factor clip(rho * 1) / rho is exactly 1
    # once rho lies in [1e-4, 1e6] (from t = 1 on), which the port's
    # "plain" mode takes for granted
    assert [tbp._rho_mode(i) for i in (0, 1, 62, 63, 64, 127, 128)] == [
        "clamp", "plain", "plain", "adapt", "plain", "adapt", "plain"]
    mu, tau = torch.tensor(10.0, dtype=dtype), torch.tensor(2.0, dtype=dtype)
    g = torch.Generator().manual_seed(0)
    for rho in torch.exp(torch.empty(200, dtype=dtype).uniform_(
            np.log(1e-4), np.log(1e6), generator=g)):
        rho = torch.clamp(rho, 1e-4, 1e6)
        assert torch.clamp(rho * 1.0, 1e-4, 1e6) / rho == 1.0
        assert tbp._adapt_rho(rho, mu, mu, mu, tau, "plain") == (rho, None)
    for pri, dua, want in ((1.0, 0.01, 2.0), (0.01, 1.0, 0.5),
                           (1.0, 1.0, 1.0)):
        rho = torch.tensor(3.0, dtype=dtype)
        new, fac = tbp._adapt_rho(rho, torch.tensor(pri, dtype=dtype),
                                  torch.tensor(dua, dtype=dtype), mu, tau,
                                  "adapt")
        assert float(new) == 3.0 * want and float(fac) == want
    new, fac = tbp._adapt_rho(torch.tensor(1e-6, dtype=dtype), mu, mu, mu,
                              tau, "clamp")
    assert float(new) == pytest.approx(1e-4) and float(fac) == pytest.approx(
        100.0)
