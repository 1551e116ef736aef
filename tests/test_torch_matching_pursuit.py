"""cstpu_torch's matching pursuits against cstpu's, in f64, on the same
planted problems: identical supports, values to rtol 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstpu
import cstpu_torch
from cstpu_torch.utils.interop import solution_to_numpy, to_torch


def _problem(seed, n=32, m=48, k=3):
    from conftest import planted_problem

    A, x, b, y = planted_problem(seed, n=n, m=m, k=k, dtype=jnp.float64)
    return A, x, b, y


def _same(tsol, jsol):
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("seed,k,noisy", [(10, 3, False), (11, 3, True),
                                          (12, 8, True), (13, None, True)])
def test_omp_matches(seed, k, noisy):
    A, x, b, y = _problem(seed)
    rhs = y if noisy else b
    _same(cstpu_torch.omp(to_torch(A), to_torch(rhs), k), cstpu.omp(A, rhs, k))


def test_omp_recovers_planted_support():
    A, x, b, y = _problem(14)
    sol = cstpu_torch.omp(to_torch(A), to_torch(y), 3)
    np.testing.assert_array_equal(sol.nzind, cstpu.support(x))


@pytest.mark.parametrize("eps", [0.0, 1e-9])
def test_omp_stalls_on_duplicate(eps):
    # column 0 is e_0 and column 47 duplicates it; b = 2 e_0. The tie picks
    # atom 0 (lowest index), the fit is exact in floating point, so the
    # residual is exactly zero and every later argmax lands on the active
    # atom 0 again: the solve stalls with one atom, on both packages
    A, x, b, y = _problem(15)
    A = np.asarray(A).copy()
    A[:, 0] = 0.0
    A[0, 0] = 1.0
    A[:, 47] = A[:, 0]
    b = 2.0 * A[:, 0]
    tsol = cstpu_torch.omp(to_torch(A), to_torch(b), 8, eps)
    _same(tsol, cstpu.omp(jnp.asarray(A), jnp.asarray(b), 8, eps))
    assert tsol.nzind.tolist() == [0]
    assert tsol.nzval.tolist() == [2.0]


@pytest.mark.parametrize("eps", [1e-1, 3e-2, 1e-6])
def test_omp_epsilon_stop_matches(eps):
    A, x, b, y = _problem(16)
    tsol = cstpu_torch.omp(to_torch(A), to_torch(y), 8, eps)
    _same(tsol, cstpu.omp(A, y, 8, eps))


@pytest.mark.parametrize("k", [1, 7, 20])
def test_mp_matches(k):
    A, x, b, y = _problem(17)
    np.testing.assert_allclose(cstpu_torch.mp(to_torch(A), to_torch(y), k).numpy(),
                               np.asarray(cstpu.mp(A, y, k)),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("l,k,eps", [(2, 4, 0.0), (2, 5, 0.0), (1, 3, 0.0),
                                     (3, 7, 1e-2), (2, None, 0.0)])
def test_gomp_matches(l, k, eps):
    A, x, b, y = _problem(18, k=4)
    _same(cstpu_torch.gomp(to_torch(A), to_torch(y), l, k, eps),
          cstpu.gomp(A, y, l, k, eps))


@pytest.mark.parametrize("k", [3, 6])
def test_oblivious_matches(k):
    A, x, b, y = _problem(19)
    _same(cstpu_torch.oblivious(to_torch(A), to_torch(y), k),
          cstpu.oblivious(A, y, k))


def test_oblivious_rejects_k_beyond_rank():
    A, x, b, y = _problem(20)
    with pytest.raises(ValueError):
        cstpu_torch.oblivious(to_torch(A), to_torch(y), 33)


def test_solvers_stay_on_the_input_dtype():
    A, x, b, y = _problem(21)
    tA32, ty32 = to_torch(A, dtype=torch.float32), to_torch(y, dtype=torch.float32)
    assert cstpu_torch.omp(tA32, ty32, 3).val.dtype == torch.float32
    assert cstpu_torch.mp(tA32, ty32, 3).dtype == torch.float32
