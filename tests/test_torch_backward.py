"""cstpu_torch's per-instance backward family (br, fbr, lace) against
cstpu's, in float64 on the CPU, on cstpu's seeded square problems handed to
both packages through numpy.

Tolerances: supports identical, coefficients to 1e-8 absolute (both solve
the same least-squares problems in f64 by different factorizations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstpu
import cstpu_torch
from cstpu.models import backward as jbackward
from cstpu.ops import active_set as jaset
from cstpu_torch.models import backward as tbackward
from cstpu_torch.ops import active_set as taset
from cstpu_torch.utils.interop import solution_to_numpy, to_torch

ATOL = 1e-8
DELTA = 1e-2
SOLVERS = {"br": (cstpu_torch.br, cstpu.br),
           "fbr": (cstpu_torch.fbr, cstpu.fbr),
           "lace": (cstpu_torch.lace, cstpu.lace)}


def _problem(seed, n=32, m=None, k=3):
    """(A, planted support, b, y) in f64, square unless m is given."""
    from conftest import planted_problem

    A, x, b, y = planted_problem(seed, n=n, m=n if m is None else m, k=k,
                                 noise=DELTA / 2, dtype=jnp.float64)
    return A, set(np.flatnonzero(np.asarray(x)).tolist()), b, y


def _same(tsol, jsol):
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=0, atol=ATOL)
    return set(t["idx"][t["mask"]].tolist())


@pytest.mark.parametrize("name", ["br", "fbr", "lace"])
@pytest.mark.parametrize("seed,kw", [(20, {"sparsity": 3}),
                                     (21, {"max_residual": DELTA}),
                                     (22, {"max_increase": DELTA})])
def test_backward_matches_cstpu(name, seed, kw):
    # the reference's three equivalent stopping criteria on a square system
    A, sup, b, y = _problem(seed)
    tsolve, jsolve = SOLVERS[name]
    got = _same(tsolve(to_torch(A), to_torch(y), **kw), jsolve(A, y, **kw))
    assert got == sup


@pytest.mark.parametrize("name", ["br", "fbr", "lace"])
def test_backward_overdetermined_and_sparsity_zero(name):
    A, sup, b, y = _problem(313, n=48, m=32)
    tsolve, jsolve = SOLVERS[name]
    assert _same(tsolve(to_torch(A), to_torch(y), sparsity=3),
                 jsolve(A, y, sparsity=3)) == sup
    # unbounded thresholds and sparsity 0: every atom is deleted
    tsol = tsolve(to_torch(A), to_torch(b))
    _same(tsol, jsolve(A, b))
    assert int(tsol.mask.sum()) == 0


def test_br_naive_matches_fast_and_cstpu():
    A, sup, b, y = _problem(23)
    tA, ty = to_torch(A), to_torch(y)
    slow = cstpu_torch.br(tA, ty, sparsity=3, naive=True)
    assert _same(slow, cstpu.br(A, y, sparsity=3, naive=True)) == sup
    fast = cstpu_torch.br(tA, ty, sparsity=3)
    assert torch.equal(fast.idx, slow.idx)
    np.testing.assert_allclose(fast.val.numpy(), slow.val.numpy(), rtol=1e-8)


@pytest.mark.parametrize("name", ["br", "fbr", "lace"])
def test_backward_requires_overdetermined(name):
    A, x, b = cstpu.sparse_data(jax.random.PRNGKey(24), n=16, m=32, k=3,
                                dtype=jnp.float64)
    with pytest.raises(ValueError):
        SOLVERS[name][0](to_torch(A), to_torch(b), sparsity=3)


def test_fbr_return_failed_and_rank_deficient_gram():
    A, sup, b, y = _problem(318)
    sol, failed = cstpu_torch.fbr(to_torch(A), to_torch(y), sparsity=3,
                                  return_failed=True)
    assert failed.dtype == torch.bool and not bool(failed)
    assert set(sol.idx[sol.mask].tolist()) == sup
    # a duplicated column makes the Gram singular and the Cholesky init
    # NaN: the flag latches (a negated >=) instead of reporting success
    A0 = jax.random.normal(jax.random.PRNGKey(60), (48, 31), jnp.float64)
    A = jnp.concatenate([A0, A0[:, :1]], axis=1)
    A = A / jnp.linalg.norm(A, axis=0, keepdims=True)
    b = A[:, 0] + A[:, 5]
    _, jfailed = cstpu.fbr(A, b, sparsity=3, return_failed=True)
    _, tfailed = cstpu_torch.fbr(to_torch(A), to_torch(b), sparsity=3,
                                 return_failed=True)
    assert bool(tfailed) and bool(jfailed)


def test_fbr_state_and_delete_match_cstpu():
    # one Schur downdate with its left-compaction, field by field
    A, sup, b, y = _problem(25, n=16, k=2)
    jst = jbackward._fbr_delete(jbackward._fbr_init(A, y), 5, 16)
    tst = tbackward._fbr_delete(
        tbackward._fbr_init(to_torch(A), to_torch(y)), 5, 16)
    assert isinstance(tst, tbackward.FBRState) and int(tst.k) == 15
    np.testing.assert_array_equal(tst.idx.numpy(), np.asarray(jst.idx))
    np.testing.assert_array_equal(tst.mask.numpy(), np.asarray(jst.mask))
    for name in ("cols", "AAinv", "Ab", "coef"):
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)), rtol=0,
                                   atol=1e-7, err_msg=name)


def test_lace_step_matches_cstpu():
    A, sup, b, y = _problem(26, n=16, k=2)
    m = 16
    full = jnp.arange(m, dtype=jnp.int32), jnp.ones((m,), bool)
    jst = jaset.refit(jaset.rebuild(A, y, *full))
    tst = taset.refit(taset.rebuild(
        to_torch(A), to_torch(y), torch.arange(m, dtype=torch.int32),
        torch.ones((m,), dtype=torch.bool)))
    for max_eps, want in ((jnp.inf, True), (0.0, False)):
        jst2, jacc = jbackward.lace_step(A, y, jst, max_eps, jnp.inf, m)
        tst2, tacc = tbackward.lace_step(to_torch(A), to_torch(y), tst,
                                         float(max_eps), torch.inf, m)
        assert tacc == bool(jacc) == want
        np.testing.assert_array_equal(tst2.idx.numpy(), np.asarray(jst2.idx))
        np.testing.assert_allclose(tst2.coef.numpy(), np.asarray(jst2.coef),
                                   rtol=0, atol=ATOL)
