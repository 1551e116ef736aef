"""cstpu_torch's column-sharded convex solvers (cstpu_torch.parallel.convex)
against cstpu's on its eight-device CPU mesh, on cstpu's own problems
(tests/test_sharded.py: n=32, m=48 or 56, k=3), float64, converted through
numpy. The port runs on CPU meshes of one and four shards.

Tolerances: x agrees with cstpu's to 1e-6 (1 + ||x||) and the supports
{|x| > 1e-5} are equal (the ADMM and FISTA iterations are cstpu's; only the
order of the shard sums differs). One shard against four, the lean
(chunked) whitening against the full one, and a warm-restarted solve
against one run to the same fixed point: 1e-9 absolute, the tolerance of
cstpu's own lean-mode test, and 2e-5 for the warm restart (the adaptive
rho fires on each run's own 64-iteration schedule, as in cstpu).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstpu.parallel.convex as jcv
import cstpu_torch.parallel.convex as tcv
from cstpu import perturb
from cstpu.parallel import mesh as jmesh
from cstpu_torch.models import basis_pursuit as tbp
from cstpu_torch.parallel import make_mesh, shard_dictionary
from cstpu_torch.utils.interop import to_torch

DELTA = 1e-2
RTOL = 1e-6
SUP_TOL = 1e-5
SHARDS = [1, 4]


@pytest.fixture(scope="module")
def jax_mesh():
    assert jax.device_count() >= 8
    return jmesh.make_mesh((1, 8))


def _mesh(s):
    return make_mesh((1, s), devices=["cpu"])


def _problem(seed, n=32, m=48, k=3):
    from conftest import planted_problem

    A, x, b, _ = planted_problem(seed, n=n, m=m, k=k)
    y = perturb(jax.random.PRNGKey(seed * 10), b, DELTA / 2)
    return A, x, b, y


def _close(got, want, sup=True):
    assert got.device.type == "cpu" and got.dtype == torch.float64
    got, want = got.numpy(), np.asarray(want)
    tol = RTOL * (1.0 + np.linalg.norm(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if sup:
        np.testing.assert_array_equal(np.abs(got) > SUP_TOL,
                                      np.abs(want) > SUP_TOL)


def _t(*xs):
    return [to_torch(x) for x in xs]


# name -> (seed, port call, cstpu call); `tm` the port's mesh, `jm` cstpu's
CALLS = {
    "bp_sharded": (75, lambda A, b, y, tm: tcv.bp_sharded(A, b, mesh=tm)[0],
                   lambda A, b, y, jm: jcv.bp_sharded(A, b, mesh=jm)[0]),
    "bp_ard_sharded": (76, lambda A, b, y, tm: tcv.bp_ard_sharded(A, b, tm),
                       lambda A, b, y, jm: jcv.bp_ard_sharded(A, b, jm)),
    "bp_ard_sharded_chunked": (
        76, lambda A, b, y, tm: tcv.bp_ard_sharded(A, b, tm, admm_chunk=100),
        lambda A, b, y, jm: jcv.bp_ard_sharded(A, b, jm, admm_chunk=100)),
    "bpd_sharded": (79,
                    lambda A, b, y, tm: tcv.bpd_sharded(A, y, DELTA,
                                                        mesh=tm)[0],
                    lambda A, b, y, jm: jcv.bpd_sharded(A, y, DELTA,
                                                        mesh=jm)[0]),
    "bpd_candes_sharded": (
        81, lambda A, b, y, tm: tcv.bpd_candes_sharded(A, y, DELTA, tm),
        lambda A, b, y, jm: jcv.bpd_candes_sharded(A, y, DELTA, jm)),
    "bpd_ard_sharded": (
        81, lambda A, b, y, tm: tcv.bpd_ard_sharded(A, y, DELTA, tm),
        lambda A, b, y, jm: jcv.bpd_ard_sharded(A, y, DELTA, jm)),
    "bpd_secant_sharded": (
        84, lambda A, b, y, tm: tcv.bpd_secant_sharded(A, y, DELTA, mesh=tm),
        lambda A, b, y, jm: jcv.bpd_secant_sharded(A, y, DELTA, mesh=jm)),
    "ista_sharded": (80,
                     lambda A, b, y, tm: tcv.ista_sharded(A, b, 1e-3, tm,
                                                          maxiter=256),
                     lambda A, b, y, jm: jcv.ista_sharded(A, b, 1e-3, jm,
                                                          maxiter=256)),
    "fista_sharded": (80,
                      lambda A, b, y, tm: tcv.fista_sharded(A, b, 1e-3, tm,
                                                            maxiter=256),
                      lambda A, b, y, jm: jcv.fista_sharded(A, b, 1e-3, jm,
                                                            maxiter=256)),
    "fista_sharded_auto_step": (
        80, lambda A, b, y, tm: tcv.fista_sharded(A, b, 1e-3, tm,
                                                  maxiter=256,
                                                  stepsize=None),
        lambda A, b, y, jm: jcv.fista_sharded(A, b, 1e-3, jm, maxiter=256,
                                              stepsize=None)),
}


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("name", sorted(CALLS))
def test_sharded_convex_matches_cstpu(name, s, jax_mesh):
    seed, tcall, jcall = CALLS[name]
    A, x, b, y = _problem(seed)
    got = tcall(*_t(A, b, y), _mesh(s))
    _close(got, jcall(A, b, y, jax_mesh))
    if not name.startswith(("ista", "fista")):
        tol = SUP_TOL if name.startswith("bp_") else DELTA
        np.testing.assert_array_equal(
            np.flatnonzero(np.abs(got.numpy()) > tol),
            np.flatnonzero(np.asarray(x)))


@pytest.mark.parametrize("s", SHARDS)
def test_ard_weights_sharded_matches_cstpu(s, jax_mesh):
    A, x, b, _ = _problem(62)
    w0 = np.linspace(0.5, 2.0, 48)
    got = tcv.ard_weights_sharded(*_t(A, x, w0), _mesh(s), 1e-2)
    want = jcv.ard_weights_sharded(A, x, jnp.asarray(w0), jax_mesh, 1e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)
    with pytest.raises(ValueError, match="zero"):
        tcv.ard_weights_sharded(*_t(A, x, np.zeros(48)), _mesh(s), 1e-2)


def test_bpd_secant_sharded_info_matches_cstpu(jax_mesh):
    A, x, b, y = _problem(84)
    got, ginfo = tcv.bpd_secant_sharded(*_t(A, y), DELTA, mesh=_mesh(4),
                                        return_info=True)
    want, winfo = jcv.bpd_secant_sharded(A, y, DELTA, mesh=jax_mesh,
                                         return_info=True)
    assert ginfo["feasible"] and winfo["feasible"]
    assert ginfo["outers"] == winfo["outers"]
    feas = np.linalg.norm(np.asarray(A) @ got.numpy() - np.asarray(y))
    assert feas <= DELTA * (1 + 1e-6)
    z, zinfo = tcv.bpd_secant_sharded(*_t(A, y),
                                      float(np.linalg.norm(y)) * 2,
                                      mesh=_mesh(4), return_info=True)
    assert zinfo["feasible"] and float(z.abs().max()) == 0.0


@pytest.mark.parametrize("name", ["bp_sharded", "bp_ard_sharded",
                                  "bpd_sharded", "bpd_secant_sharded",
                                  "fista_sharded"])
def test_one_shard_against_four(name):
    seed, tcall, _ = CALLS[name]
    A, x, b, y = _problem(seed)
    one = tcall(*_t(A, b, y), _mesh(1))
    four = tcall(*_t(A, b, y), _mesh(4))
    np.testing.assert_allclose(four.numpy(), one.numpy(), rtol=0, atol=1e-9)


def test_sharded_dictionary_input():
    A, x, b, y = _problem(75)
    mesh = _mesh(4)
    At, bt = _t(A, b)
    got = tcv.bp_sharded(shard_dictionary(At, mesh), bt, mesh=mesh)[0]
    want = tcv.bp_sharded(At, bt, mesh=mesh)[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("s", SHARDS)
def test_lean_whitening_matches_full(s, monkeypatch):
    # the chunked path (auto above _WHITEN_BYTES_MAX, config 5's 4 GB
    # regime) against the full-width one: the same fixed point
    A, x, b, _ = _problem(76)
    ref = tcv.bp_ard_sharded(*_t(A, b), _mesh(s))
    monkeypatch.setattr(tcv, "_WHITEN_BYTES_MAX", 0)
    lean = tcv.bp_ard_sharded(*_t(A, b), _mesh(s))
    np.testing.assert_allclose(lean.numpy(), ref.numpy(), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(np.flatnonzero(np.abs(lean.numpy())
                                                 > SUP_TOL),
                                  np.flatnonzero(np.asarray(x)))


def test_lean_whitening_f32_ill_conditioned_matches_cstpu(monkeypatch,
                                                          jax_mesh):
    # cstpu's own ill-conditioned case (cond ~3e4, f32): the lean mode
    # must keep the whitened path's feasibility class, as cstpu's does
    from cstpu.utils.data import correlated_data

    A64, x, b64 = correlated_data(jax.random.PRNGKey(77), n=32, m=48, k=3)
    A = jnp.asarray(A64, jnp.float32)
    b = jnp.asarray(b64, jnp.float32)
    At, bt = _t(A, b)
    # one shard: this f32 problem runs ~16000-20000 iterations
    whit = tcv.bp_sharded(At, bt, mesh=_mesh(1))[0].numpy()
    monkeypatch.setattr(tcv, "_WHITEN_BYTES_MAX", 0)
    lean = tcv.bp_sharded(At, bt, mesh=_mesh(1))[0].numpy()
    An, bn = np.asarray(A), np.asarray(b)
    bnorm = np.linalg.norm(bn)
    feas_whit = np.linalg.norm(An @ whit - bn)
    feas_lean = np.linalg.norm(An @ lean - bn)
    assert feas_whit < 1e-4 * bnorm and feas_lean < 1e-4 * bnorm
    assert feas_lean <= 4.0 * feas_whit + 1e-6 * bnorm
    want = np.asarray(jcv.bp_sharded(A, b, mesh=jax_mesh)[0])
    np.testing.assert_allclose(whit, want, rtol=0, atol=1e-3)


def test_ard_chunk_remainder_tail(monkeypatch, jax_mesh):
    # odd m_local in lean mode: full chunks plus one narrower tail chunk
    # (7 = 4 + 3 per shard at m = 56 on eight shards; 14 = 4+4+4+2 on four)
    A, x, b, _ = _problem(78, m=56)
    ref = tcv.bp_ard_sharded(*_t(A, b), _mesh(4))
    monkeypatch.setattr(tcv, "_WHITEN_BYTES_MAX", 0)
    monkeypatch.setattr(tcv, "_ARD_CHUNK_MAX", 4)
    assert tcv._chunks(14) == [(0, 4), (4, 8), (8, 12), (12, 14)]
    lean = tcv.bp_ard_sharded(*_t(A, b), _mesh(4))
    np.testing.assert_allclose(lean.numpy(), ref.numpy(), rtol=0, atol=1e-9)
    _close(lean, jcv.bp_ard_sharded(A, b, jax_mesh))


def test_bpd_sharded_warm_restart_continues():
    # 2 x 300 warm-restarted iterations land at the fixed point of one
    # 600-iteration run (cstpu's own contract and tolerance)
    A, x, b, y = _problem(80)
    At, yt = _t(A, y)
    mesh = _mesh(4)
    one = tcv.bpd_sharded(At, yt, DELTA, mesh=mesh, maxiter=600, tol=0.0)
    out = tcv.bpd_sharded(At, yt, DELTA, mesh=mesh, maxiter=300, tol=0.0)
    out = tcv.bpd_sharded(At, yt, DELTA, mesh=mesh, maxiter=300, tol=0.0,
                          warm=out)
    np.testing.assert_allclose(out[0].numpy(), one[0].numpy(), atol=2e-5)
    assert len(out) == 5


def test_bp_sharded_warm_matches_cstpu(jax_mesh):
    # warm= continuation: (z, u, rho) from a capped solve, then the rest
    A, x, b, _ = _problem(75)
    At, bt = _t(A, b)
    mesh = _mesh(4)
    tw = tcv.bp_sharded(At, bt, mesh=mesh, maxiter=40)
    jw = jcv.bp_sharded(A, b, mesh=jax_mesh, maxiter=40)
    for g, w in zip(tw, jw):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
    got = tcv.bp_sharded(At, bt, mesh=mesh, warm=tw)
    want = jcv.bp_sharded(A, b, mesh=jax_mesh, warm=jw)
    for g, w in zip(got, want):
        _close(g, w, sup=False)


@pytest.mark.parametrize("margin", [0.5, 0.0])
def test_screened_matches_unscreened(margin, jax_mesh):
    # cstpu's screened problem (n=16, m=96): screened == unscreened, and
    # both == cstpu's screened solve
    A, x, b, _ = _problem(82, n=16, m=96)
    At, bt = _t(A, b)
    mesh = _mesh(4)
    ref = tcv.bp_ard_sharded(At, bt, mesh, screen=False)
    scr = tcv.bp_ard_sharded(At, bt, mesh, screen=True,
                             screen_margin=margin)
    np.testing.assert_array_equal(
        np.flatnonzero(np.abs(scr.numpy()) > SUP_TOL),
        np.flatnonzero(np.abs(ref.numpy()) > SUP_TOL))
    np.testing.assert_array_equal(
        np.flatnonzero(np.abs(scr.numpy()) > SUP_TOL),
        np.flatnonzero(np.asarray(x)))
    np.testing.assert_allclose(scr.numpy(), ref.numpy(), atol=1e-6)
    _close(scr, jcv.bp_ard_sharded(A, b, jax_mesh, screen=True,
                                   screen_margin=margin))


def test_matmul_precision_knob():
    # the knob threads through and is inert on the CPU
    A, x, b, _ = _problem(77)
    At, bt = _t(A, b)
    hi = tcv.bp_sharded(At, bt, mesh=_mesh(4))[0]
    tf = tcv.bp_sharded(At, bt, mesh=_mesh(4),
                        matmul_precision="tensorfloat32")[0]
    assert torch.equal(hi, tf)
    with pytest.raises(ValueError, match="matmul_precision"):
        tcv.bp_sharded(At, bt, mesh=_mesh(4), matmul_precision="bf16")


def test_indivisible_width_raises():
    A, x, b, _ = _problem(75)
    with pytest.raises(ValueError, match="divisible"):
        tcv.bp_sharded(*_t(A, b), mesh=_mesh(5))


def test_sharded_latch_is_bit_exact(monkeypatch):
    A, x, b, y = _problem(79)
    At, yt = _t(A, y)
    runs = []
    for every in (1, tbp.CHECK_EVERY):
        monkeypatch.setattr(tbp, "CHECK_EVERY", every)
        tbp.LOOP_COUNTS.update(iterations=0, latch_reads=0)
        runs.append((tcv.bpd_sharded(At, yt, DELTA, mesh=_mesh(4)),
                     dict(tbp.LOOP_COUNTS)))
    (o1, c1), (ok, ck) = runs
    for g, w in zip(o1, ok):
        assert torch.equal(g, w)
    assert ck["latch_reads"] < c1["latch_reads"]
