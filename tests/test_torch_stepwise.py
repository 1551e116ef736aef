"""cstpu_torch's per-instance stepwise solvers (rmp, foba) against cstpu's,
in float64 on the CPU, on cstpu's seeded problems handed to both packages
through numpy.

Tolerances: supports identical, coefficients to 1e-8 absolute (both solve
the same least-squares problems in f64 by different factorizations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstpu
import cstpu_torch
from cstpu_torch.models import stepwise as tstep
from cstpu_torch.utils.interop import (
    solution_from_cstpu, solution_to_numpy, to_torch)

ATOL = 1e-8
DELTA = 1e-2


def _problem(seed, n=32, m=64, k=3):
    """(A, planted support, b, y) in f64 from cstpu's generators."""
    from conftest import planted_problem

    A, x, b, y = planted_problem(seed, n=n, m=m, k=k, noise=DELTA,
                                 dtype=jnp.float64)
    return A, set(np.flatnonzero(np.asarray(x)).tolist()), b, y


def _same(tsol, jsol):
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=0, atol=ATOL)
    return set(t["idx"][t["mask"]].tolist())


@pytest.mark.parametrize("seed,k", [(40, 3), (25, 4), (1112, 4)])
def test_rmp_k_matches_cstpu(seed, k):
    # 25 and 1112: noiseless draws on which a forward stage without the
    # exhaustion floor ran on to full rank (cstpu's tests/test_stepwise.py)
    if seed == 40:
        A, sup, b, y = _problem(seed)
    else:
        A, x, b = cstpu.sparse_data(jax.random.PRNGKey(seed), n=32, m=128,
                                    k=4, dtype=jnp.float64)
        sup, y = set(np.flatnonzero(np.asarray(x)).tolist()), b
    tA = to_torch(A)
    assert _same(cstpu_torch.rmp(tA, to_torch(b), k=k),
                 cstpu.rmp(A, b, k=k)) == sup
    _same(cstpu_torch.rmp(tA, to_torch(y), k=k), cstpu.rmp(A, y, k=k))


@pytest.mark.parametrize("seed,maxiter", [(41, 1), (42, 3), (43, 2)])
def test_rmp_delta_matches_cstpu(seed, maxiter):
    A, sup, b, y = _problem(seed)
    tA = to_torch(A)
    for bb in (b, y):
        got = _same(cstpu_torch.rmp(tA, to_torch(bb), delta=DELTA,
                                    maxiter=maxiter),
                    cstpu.rmp(A, bb, delta=DELTA, maxiter=maxiter))
        assert got == sup


@pytest.mark.parametrize("seed", [43, 44])
def test_foba_matches_cstpu(seed):
    A, sup, b, y = _problem(seed)
    tA = to_torch(A)
    for bb in (b, y):
        assert _same(cstpu_torch.foba(tA, to_torch(bb), DELTA),
                     cstpu.foba(A, bb, DELTA)) == sup


def test_backward_stages_delete_on_a_correlated_dictionary(monkeypatch):
    # a coherent dictionary with noise: early picks are superseded, so
    # FoBa's gain / 2 rule and RMP's backward stage really delete (counted
    # here), and both packages take the same steps
    kd, kn = jax.random.split(jax.random.PRNGKey(11))
    A, x, b = cstpu.correlated_data(kd, n=32, m=128, k=4, decay=0.25,
                                    dtype=jnp.float64)
    deleted = []
    step = tstep.backward_step_rows
    monkeypatch.setattr(tstep, "backward_step_rows", lambda *a, **kw: (
        lambda out: deleted.append(int(out[1].sum())) or out)(step(*a, **kw)))
    tA = to_torch(A)
    for kk in jax.random.split(kn, 4)[2:]:
        y = cstpu.perturb(kk, b, 5e-2)
        _same(cstpu_torch.foba(tA, to_torch(y), 2e-2), cstpu.foba(A, y, 2e-2))
        assert sum(deleted) >= 2, deleted
        deleted.clear()
        _same(cstpu_torch.rmp(tA, to_torch(y), delta=5e-2, maxiter=3),
              cstpu.rmp(A, y, delta=5e-2, maxiter=3))
        assert sum(deleted) >= 2, deleted
        deleted.clear()


@pytest.mark.parametrize("form", ["indices", "solution", "dense"])
def test_rmp_warm_start_forms(form):
    # the true support as integer indices, as a SparseSolution, or as a
    # dense float vector whose support is taken: a stationary point
    A, sup, b, y = _problem(77)
    idx = np.array(sorted(sup), np.int32)
    if form == "indices":
        jx0, tx0 = jnp.asarray(idx), torch.as_tensor(idx)
    elif form == "solution":
        jx0 = cstpu.fr(A, b, sparsity=3)
        tx0 = solution_from_cstpu(jx0)
    else:
        dense = np.zeros(64)
        dense[idx[0]] = 1.0
        jx0, tx0 = jnp.asarray(dense), torch.as_tensor(dense)
    got = _same(cstpu_torch.rmp(to_torch(A), to_torch(b), delta=1e-8, x0=tx0),
                cstpu.rmp(A, b, delta=1e-8, x0=jx0))
    assert got == sup


def test_rmp_stationary_warm_start_returns_its_refit():
    # small planted coefficients: each deletion's increase lies below
    # delta^2, so a backward stage run despite the stationary forward stage
    # would prune the exact warm support
    A, x, b = cstpu.sparse_data(jax.random.PRNGKey(50), n=32, m=64, k=3,
                                dtype=jnp.float64)
    sup = np.flatnonzero(np.asarray(x)).astype(np.int32)
    bs = A @ (0.05 * jnp.sign(x))
    tsol = cstpu_torch.rmp(to_torch(A), to_torch(bs), delta=0.1,
                           x0=torch.as_tensor(sup))
    got = _same(tsol, cstpu.rmp(A, bs, delta=0.1, x0=jnp.asarray(sup)))
    assert got == set(sup.tolist())
    np.testing.assert_allclose(tsol.todense().numpy()[sup],
                               0.05 * np.sign(np.asarray(x))[sup], atol=1e-6)


def test_rmp_warm_start_wide_padded_support():
    # a GOMP solution over an overcomplete dictionary is padded to width
    # m = 64 > min(n, m) = 32: the active entries are compacted in order
    A, sup, b, y = _problem(51)
    jx0 = cstpu.gomp(A, y, 1, None, max_residual=1e-2)
    assert jx0.idx.shape[0] == 64
    got = _same(cstpu_torch.rmp(to_torch(A), to_torch(y), delta=1e-2,
                                x0=solution_from_cstpu(jx0)),
                cstpu.rmp(A, y, delta=1e-2, x0=jx0))
    assert got == sup


def test_rmp_needs_exactly_one_of_k_and_delta():
    A, sup, b, y = _problem(52)
    for kw in ({}, {"k": 3, "delta": 1e-2}):
        with pytest.raises(ValueError, match="exactly one"):
            cstpu_torch.rmp(to_torch(A), to_torch(b), **kw)


def test_approx_eq_is_the_references_isapprox():
    x = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    assert tstep._approx_eq(x, x + 1e-9)
    assert not tstep._approx_eq(x, x + 1e-6)
    assert tstep._approx_eq(torch.zeros(3), torch.zeros(3))
