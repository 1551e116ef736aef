"""cstpu_torch's SBL family (cstpu_torch.models.sbl and its four `*_batch`
entry points) against cstpu's, on the CPU, on cstpu's seeded problems
handed to both packages through numpy.

Tolerances: in float64 the sets of finite alpha are equal and x agrees to
1e-8 absolute (both solve the same systems by other factorizations); in
float32 x agrees to 1e-4 absolute and the supports {|x| > sigma} are equal.
A learned sigma^2 agrees to 1e-6 relative, or 1e-16 absolute where it
collapsed to rounding. Integer trace fields are equal; a trace's likelihood
deltas agree to 1e-8 (f64). A row that stopped is held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstpu
import cstpu_torch
from cstpu.models import sbl as jsbl
from cstpu_torch.models import sbl as tsbl
from cstpu_torch.utils.interop import to_torch

SIGMA = 1e-2
ATOL64 = 1e-8
ATOL32 = 1e-4
# a learned sigma^2 to rtol 1e-6, or to 1e-16 where the flat-prior EM
# collapses it to ~1e-15, the rounding of the residual's norm
S2_ATOL = 1e-16


def _problem(seed, n=32, m=48, k=3, dtype=jnp.float64):
    from conftest import planted_problem

    return planted_problem(seed, n=n, m=m, k=k, noise=SIGMA / 2, dtype=dtype)


def _cov(n, dtype, seed=83):
    """A well-conditioned non-diagonal SPD covariance at sigma^2 scale."""
    W = jax.random.normal(jax.random.PRNGKey(seed), (n, n), dtype) / np.sqrt(n)
    return SIGMA ** 2 * (0.5 * jnp.eye(n, dtype=dtype) + W @ W.T)


def _close(got, want, dtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    atol = ATOL64 if dtype == jnp.float64 else ATOL32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if dtype != jnp.float64:
        np.testing.assert_array_equal(np.abs(got) > SIGMA,
                                      np.abs(want) > SIGMA)


def _same_alpha(got, want):
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(np.asarray(want)))


@pytest.mark.parametrize("method", ["direct", "woodbury", "auto"])
@pytest.mark.parametrize("cov", [False, True])
def test_sbl_matches_cstpu(method, cov):
    A, x, b, y = _problem(58, m=128)
    sig = _cov(32, A.dtype) if cov else SIGMA ** 2
    got = cstpu_torch.sbl(to_torch(A), to_torch(y), to_torch(sig),
                          method=method)
    want = cstpu.sbl(A, y, sig, method=method)
    _close(got, want, A.dtype)


def test_sbl_rejects_unknown_method():
    A, x, b, y = _problem(58)
    with pytest.raises(ValueError, match="unknown sbl method"):
        cstpu_torch.sbl(to_torch(A), to_torch(y), SIGMA ** 2, method="lu")


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("cov", [False, True])
def test_fsbl_matches_cstpu(dtype, cov):
    A, x, b, y = _problem(51, dtype=dtype)
    sig = _cov(32, dtype) if cov else SIGMA ** 2
    tA, ty, ts = to_torch(A), to_torch(y), to_torch(sig)
    _close(cstpu_torch.fsbl(tA, ty, ts), cstpu.fsbl(A, y, sig), dtype)
    # the prior precisions: the same atoms end active
    _, t_alpha, _ = tsbl._fsbl_rows(tA, ty[None], ts)
    _, j_alpha = jsbl._fsbl(A, y, sig, 2 * A.shape[1],
                            jnp.asarray(1e-6, dtype))
    _same_alpha(t_alpha[0], j_alpha)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("seed", [52, 53])
def test_rmps_matches_cstpu(dtype, seed):
    A, x, b, y = _problem(seed, dtype=dtype)
    tA, ty = to_torch(A), to_torch(y)
    tx, ta = cstpu_torch.rmps(tA, ty, SIGMA ** 2, return_alpha=True)
    jx, ja = cstpu.rmps(A, y, SIGMA ** 2, return_alpha=True)
    _close(tx, jx, dtype)
    _same_alpha(ta, ja)
    if dtype == jnp.float64:
        # resuming from the converged alpha (in f32 the first add gains
        # there are +-ulp, a rounding tie)
        _close(cstpu_torch.rmps(tA, ty, SIGMA ** 2, alpha0=ta),
               cstpu.rmps(A, y, SIGMA ** 2, alpha0=ja), dtype)


def test_rmps_warm_start_steers_first_acquisition():
    # cstpu's discriminator: a strong prior on the cold start's first pick
    # changes what one capped acquisition adds (the S/Q/C^-1 built from
    # alpha0 are kept for the first stage)
    kd, kn = jax.random.split(jax.random.PRNGKey(70))
    A, x, b = cstpu.sparse_data(kd, n=32, m=64, k=3, dtype=jnp.float32)
    y = cstpu.perturb(kn, b, 1e-2)
    tA, ty = to_torch(A), to_torch(y)
    kw = dict(maxiter=1, maxiter_acquisition=1)
    cold = cstpu_torch.rmps(tA, ty, 1e-4, **kw)
    jstar = int(torch.argmax(cold.abs()))
    alpha0 = jnp.full((64,), jnp.inf, jnp.float32).at[jstar].set(1e-4)
    warm = cstpu_torch.rmps(tA, ty, 1e-4, alpha0=to_torch(alpha0), **kw)
    assert not bool(torch.all(cold == warm))
    _close(cold, cstpu.rmps(A, y, 1e-4, **kw), jnp.float32)
    _close(warm, cstpu.rmps(A, y, 1e-4, alpha0=alpha0, **kw), jnp.float32)


def test_rmps_capped_acquisition_not_starved():
    # cstpu's discriminator (tests/test_sharded.py): with
    # maxiter_acquisition=1 and without the starved guard this problem
    # stops after one outer iteration on a single-atom support
    kd, kn = jax.random.split(jax.random.PRNGKey(8))
    A, x, b = cstpu.correlated_data(kd, n=32, m=128, k=3, dtype=jnp.float32)
    y = cstpu.perturb(kn, b, SIGMA)
    got = cstpu_torch.rmps(to_torch(A), to_torch(y), 1e-4,
                           maxiter_acquisition=1)
    _close(got, cstpu.rmps(A, y, 1e-4, maxiter_acquisition=1), jnp.float32)
    planted = set(np.flatnonzero(np.asarray(x)).tolist())
    assert planted <= set(np.flatnonzero(np.abs(got.numpy()) > SIGMA))


@pytest.mark.parametrize("prior", [(0.0, 0.0), (1.0, SIGMA ** 2)])
def test_rmps_estimate_noise_matches_cstpu(prior):
    A, x, b, y = _problem(54)
    a, bb = prior
    tx, ts2 = cstpu_torch.rmps_estimate_noise(
        to_torch(A), to_torch(y), SIGMA ** 2, a_sigma2=a, b_sigma2=bb)
    jx, js2 = cstpu.rmps_estimate_noise(A, y, SIGMA ** 2, a_sigma2=a,
                                        b_sigma2=bb)
    assert isinstance(ts2, float)
    _close(tx, jx, jnp.float64)
    np.testing.assert_allclose(ts2, js2, rtol=1e-6, atol=S2_ATOL)


def test_rmps_estimate_noise_flat_prior_collapses_like_cstpu():
    # the reference's flat-prior EM (a = b = 0) drives sigma^2 towards 0
    # on noisy rows, far below the noise (||e||^2 / n = 7.8e-7 here); in
    # f32 that collapse can cross 0 (a negative sigma^2, then NaN). Both
    # packages do the same: the fault is the algorithm's (ROADMAP Queue 3)
    A, x, b, y = _problem(54)
    Bs = jnp.stack([y, cstpu.perturb(jax.random.PRNGKey(77), b, SIGMA / 2)])
    _, ts2 = cstpu_torch.rmps_estimate_noise_batch(to_torch(A), to_torch(Bs),
                                                   SIGMA ** 2)
    _, js2 = cstpu.rmps_estimate_noise_batch(A, Bs, SIGMA ** 2)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), rtol=1e-6,
                               atol=S2_ATOL)
    assert np.all(np.asarray(js2) < 1e-9)


def test_fsbl_traced_matches_cstpu():
    A, x, b = cstpu.sparse_data(jax.random.PRNGKey(94), n=32, m=48, k=3)
    tx, ttr = cstpu_torch.fsbl_traced(to_torch(A), to_torch(b), SIGMA ** 2,
                                      maxiter=64)
    jx, jtr = cstpu.fsbl_traced(A, b, SIGMA ** 2, maxiter=64)
    _close(tx, jx, jnp.float64)
    assert isinstance(ttr, cstpu_torch.SBLTrace)
    for field in ("selected", "action", "n_active"):
        got, want = getattr(ttr, field), np.asarray(getattr(jtr, field))
        assert got.dtype == torch.int32 and got.shape == (64,)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(ttr.likelihood_delta.numpy(),
                               np.asarray(jtr.likelihood_delta), rtol=0,
                               atol=1e-8)
    # padded past the stop, as in cstpu
    assert int((ttr.action >= 0).sum()) < 64


def test_rmps_traced_matches_cstpu():
    A, x, b = cstpu.sparse_data(jax.random.PRNGKey(95), n=32, m=48, k=3)
    tx, ttr = cstpu_torch.rmps_traced(to_torch(A), to_torch(b), SIGMA ** 2)
    jx, jtr = cstpu.rmps_traced(A, b, SIGMA ** 2)
    _close(tx, jx, jnp.float64)
    assert isinstance(ttr, cstpu_torch.RMPSTrace)
    for field in ttr._fields:
        got = getattr(ttr, field)
        assert got.dtype == torch.int32 and got.shape == (32,)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jtr, field)))
    assert int(ttr.n_added[0]) >= 3


def _batch_problem(dtype):
    A, x, b, y = _problem(51, dtype=dtype)
    y2 = cstpu.perturb(jax.random.PRNGKey(77), b, SIGMA / 2)
    return A, jnp.stack([b, y, y2])


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("name", ["fsbl_batch", "rmps_batch", "sbl_batch"])
def test_batch_entry_points_match_cstpu(name, dtype):
    A, Bs = _batch_problem(dtype)
    got = getattr(cstpu_torch, name)(to_torch(A), to_torch(Bs), SIGMA ** 2)
    assert got.shape == (3, A.shape[1]) and got.device.type == "cpu"
    _close(got, getattr(cstpu, name)(A, Bs, SIGMA ** 2), dtype)


def test_rmps_batch_options_match_cstpu():
    # options the sharded route does not take run the batched body on any
    # device: alpha0 shared by the rows, return_alpha batched
    A, Bs = _batch_problem(jnp.float64)
    tA, tB = to_torch(A), to_torch(Bs)
    alpha0 = jnp.full((A.shape[1],), jnp.inf).at[3].set(1.0)
    tx, ta = cstpu_torch.rmps_batch(tA, tB, SIGMA ** 2,
                                    alpha0=to_torch(alpha0),
                                    return_alpha=True, maxiter_deletion=2)
    jx, ja = cstpu.rmps_batch(A, Bs, SIGMA ** 2, alpha0=alpha0,
                              return_alpha=True, maxiter_deletion=2)
    _close(tx, jx, jnp.float64)
    _same_alpha(ta, ja)


def test_rmps_estimate_noise_batch_matches_cstpu():
    A, Bs = _batch_problem(jnp.float64)
    kw = dict(a_sigma2=1.0, b_sigma2=SIGMA ** 2)
    tx, ts2 = cstpu_torch.rmps_estimate_noise_batch(
        to_torch(A), to_torch(Bs[1:]), SIGMA ** 2, **kw)
    jx, js2 = cstpu.rmps_estimate_noise_batch(A, Bs[1:], SIGMA ** 2, **kw)
    assert tx.shape == (2, A.shape[1]) and ts2.shape == (2,)
    _close(tx, jx, jnp.float64)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), rtol=1e-6)


def test_batched_row_frozen_after_its_stop():
    # one batch, rows that stop at different steps: cut the loop right after
    # the early row's last step and let it run on; the early row's results
    # are the same bits either way, so a stopped row does not move while
    # the others run (vmap's semantics)
    A, x, b, y = _problem(51)
    kd = jax.random.PRNGKey(9)
    X = jnp.zeros((48,)).at[jax.random.permutation(kd, 48)[:6]].set(1.0)
    Bs = to_torch(jnp.stack([y, A @ X]))
    tA = to_torch(A)
    s2 = torch.tensor(SIGMA ** 2, dtype=torch.float64)
    mi = torch.tensor(1e-6, dtype=torch.float64)
    x_all, a_all, tr = tsbl._fsbl(tA, Bs, s2, 96, mi, traced=True)
    # a live step records its best delta; a frozen one leaves the 0 pad
    steps = [int(np.flatnonzero(tr.likelihood_delta[r].numpy())[-1]) + 1
             for r in range(2)]
    early = int(np.argmin(steps))
    assert steps[early] < steps[1 - early]
    x_cut, a_cut, _ = tsbl._fsbl(tA, Bs, s2, steps[early], mi)
    assert torch.equal(a_all[early], a_cut[early])
    assert torch.equal(x_all[early], x_cut[early])

    # RMPS: the same at the outer loop; one acquisition per outer
    # iteration, so a row with more atoms runs more of them
    tr_ = tsbl._rmps_optimize(tA, Bs, s2, tsbl._inactive(tA, 1)[0], 32, 1,
                              32, mi, traced=True)
    a_all, rtr = tr_
    outer = (rtr.n_active.numpy() > 0).sum(1)
    early = int(np.argmin(outer))
    assert outer[early] < outer[1 - early]
    a_cut, _ = tsbl._rmps_optimize(tA, Bs, s2, tsbl._inactive(tA, 1)[0],
                                   int(outer[early]), 1, 32, mi)
    assert torch.equal(a_all[early], a_cut[early])


def test_no_tensor_inputs_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: inputs go there")
    A, x, b, y = _problem(51)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cstpu_torch.fsbl(np.asarray(A), np.asarray(y), SIGMA ** 2)
