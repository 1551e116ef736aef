"""cstpu_torch.models.forward against cstpu.models.forward on the CPU, in
f64, on the same numpy-seeded problems.

Tolerances: in f64 both packages take the same decisions, so supports are
identical and coefficients agree to 1e-10 relative (atol 1e-12); the
per-atom scores of `forward_step` to 1e-9 relative (the rescalings are
differences of O(1) terms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstpu
import cstpu_torch
from cstpu.models import forward as jfw
from cstpu.ops import active_set as jaset
from cstpu_torch.models import forward as tfw
from cstpu_torch.ops import active_set as taset
from cstpu_torch.utils.interop import solution_to_numpy, to_torch

RTOL, ATOL = 1e-10, 1e-12


def _problem(seed, n=32, m=128, k=3, noise=5e-3):
    from conftest import planted_problem

    return planted_problem(seed, n=n, m=m, k=k, noise=noise)


def _same(tsol, jsol, rtol=RTOL):
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=rtol, atol=ATOL)
    return t


@pytest.mark.parametrize("seed,k", [(500, 3), (501, 3), (502, 6)])
def test_fr_sparsity_matches_cstpu(seed, k):
    # beyond the planted count the noiseless row picks atoms by rounding
    # noise after its exact fit, so there only the noisy row is compared
    A, x, b, y = _problem(seed)
    for rhs in ((b, y) if k == 3 else (y,)):
        t = _same(tfw.fr(to_torch(A), to_torch(rhs), sparsity=k),
                  cstpu.fr(A, rhs, sparsity=k))
        assert t["mask"].sum() == k
    # exact support on the noiseless row
    got = solution_to_numpy(tfw.fr(to_torch(A), to_torch(b), sparsity=3))
    np.testing.assert_array_equal(got["idx"][got["mask"]],
                                  np.flatnonzero(np.asarray(x)))


@pytest.mark.parametrize("kw", [{"min_decrease": 1e-2, "sparsity": 8},
                                {"max_residual": 0.05, "sparsity": 8},
                                {"max_residual": 1e-2},
                                {"min_decrease": 2e-3}])
def test_fr_stopping_rules_match_cstpu(kw):
    A, x, b, y = _problem(503)
    t = _same(tfw.fr(to_torch(A), to_torch(y), **kw), cstpu.fr(A, y, **kw))
    assert t["mask"].sum() < kw.get("sparsity", 32)


@pytest.mark.parametrize("seed", [504, 505])
def test_fr_exhaustion_mode_matches_cstpu(seed):
    # sparsity=None: the residual stop is floored at exhaustion_floor, so
    # the noiseless row stops at its exact fit instead of adding junk (the
    # noisy row would run to full rank, where the last picks are rounding
    # noise; it is compared with a decrease floor above the noise)
    A, x, b, y = _problem(seed)
    planted = np.flatnonzero(np.asarray(x))
    t = _same(tfw.fr(to_torch(A), to_torch(b)), cstpu.fr(A, b))
    np.testing.assert_array_equal(t["idx"][t["mask"]], planted)
    t = _same(tfw.fr(to_torch(A), to_torch(y), min_decrease=1e-2),
              cstpu.fr(A, y, min_decrease=1e-2))
    assert set(planted) <= set(t["idx"][t["mask"]])


def test_exhaustion_floor_matches_cstpu():
    for dtype in (jnp.float64, jnp.float32):
        A, x, b, y = _problem(506)
        A, y = A.astype(dtype), y.astype(dtype)
        got = float(tfw.exhaustion_floor(to_torch(A), to_torch(y)))
        want = float(jfw.exhaustion_floor(A, y))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_forward_step_matches_cstpu():
    A, x, b, y = _problem(507)
    n, m = A.shape
    tA, ty = to_torch(A), to_torch(y)
    jst = jaset.refit(jaset.empty(n, 6, m, A.dtype))
    tst = taset.refit(taset.empty(n, 6, m, tA.dtype))
    jc, tc = jnp.sum(A * A, axis=0), torch.sum(tA * tA, dim=0)
    for _ in range(4):
        jst, jacc, jd2 = jfw.forward_step(A, y, jst, 0.0, 0.0, jc, m)
        tst, tacc, td2 = tfw.forward_step(tA, ty, tst, 0.0, 0.0, tc, m)
        assert bool(tacc) == bool(jacc)
        np.testing.assert_array_equal(tst.idx.numpy(), np.asarray(jst.idx))
        fin = np.isfinite(np.asarray(jd2))
        np.testing.assert_array_equal(np.isfinite(td2.numpy()), fin)
        np.testing.assert_allclose(td2.numpy()[fin], np.asarray(jd2)[fin],
                                   rtol=1e-9, atol=1e-12)
    # a forward step that its rules refuse reports accepted=False
    tst2, tacc, _ = tfw.forward_step(tA, ty, tst, 1e6, 0.0, tc, m)
    assert not bool(tacc) and int(tst2.k) == int(tst.k)


def test_forward_deltas_active_zero_and_degenerate_inf():
    A, x, b, y = _problem(508)
    An = np.asarray(A).copy()
    An[:, 7] = An[:, 3]                       # a twin of atom 3
    tA = torch.from_numpy(An)
    st = taset.refit(taset.append(tA, to_torch(y),
                                  taset.empty(32, 4, 128, tA.dtype), 3))
    d2, _ = tfw.forward_deltas(tA, to_torch(y), st,
                               torch.sum(tA * tA, dim=0), 128)
    assert float(d2[3]) == 0.0 and float(d2[7]) == -np.inf


def test_fr_warm_matches_cstpu():
    A, x, b, y = _problem(509)
    nz = np.array([40, 3, 17])
    _same(tfw.fr_warm(to_torch(A), to_torch(y), nz),
          jfw.fr_warm(A, y, jnp.asarray(nz)))


def test_aliases_are_fr():
    for name in ("ols", "oomp", "ormp", "stepwise_regression"):
        assert getattr(cstpu_torch, name) is cstpu_torch.fr
        assert getattr(tfw, name) is tfw.fr
