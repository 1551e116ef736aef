"""cstpu_torch's per-instance two-stage solvers (sp, ompr, srr) and
backward steps against cstpu's, in float64 on the CPU, on cstpu's seeded
problems handed to both packages through numpy.

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


def _problem(seed, n=32, m=128, k=3, correlated=False):
    """(A, planted support, b, y) in f64 from cstpu's generators."""
    from conftest import planted_problem

    if not correlated:
        A, x, b, y = planted_problem(seed, n=n, m=m, k=k, dtype=jnp.float64)
    else:
        kd, kn = jax.random.split(jax.random.PRNGKey(seed))
        A, x, b = cstpu.correlated_data(kd, n=n, m=m, k=k,
                                        dtype=jnp.float64)
        y = cstpu.perturb(kn, b, 5e-3)
    return A, set(np.flatnonzero(np.asarray(x)).tolist()), b, y


def _same(tsol, jsol):
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=0, atol=ATOL)
    return set(t["idx"][t["mask"]].tolist())


@pytest.mark.parametrize("seed,correlated", [(500, False), (1, True)])
def test_sp_matches_cstpu(seed, correlated):
    A, sup, b, y = _problem(seed, correlated=correlated)
    tA = to_torch(A)
    for bb in (b, y):
        got = _same(cstpu_torch.sp(tA, to_torch(bb), 3, maxiter=8),
                    cstpu.sp(A, bb, 3, maxiter=8))
        if not correlated:
            assert sup <= got


def test_sp_matches_cstpu_unstructured():
    # Gaussian measurements with no sparse fit at k = 8 (cstpu's fuzz
    # shape, tests/test_fused_solve.py:149-168): every prune is a real
    # decision between atoms
    ka, kb = jax.random.split(jax.random.PRNGKey(502))
    A = jax.random.normal(ka, (64, 256), jnp.float64)
    A = A / jnp.linalg.norm(A, axis=0, keepdims=True)
    for bb in jax.random.normal(kb, (3, 64), jnp.float64):
        _same(cstpu_torch.sp(to_torch(A), to_torch(bb), 8, maxiter=8),
              cstpu.sp(A, bb, 8, maxiter=8))


def test_sp_rejects_2k_beyond_n():
    A, _, b, _ = _problem(502)
    with pytest.raises(ValueError, match="2k"):
        cstpu_torch.sp(to_torch(A), to_torch(b), 17)


@pytest.mark.parametrize("seed,correlated,delta", [(800, False, 1e-10),
                                                   (2, True, 1e-2),
                                                   (7, True, 1e-2)])
def test_ompr_matches_cstpu(seed, correlated, delta):
    # correlated seeds 2 and 7: the gradient score must come from the
    # pre-append solution (cstpu's tests/test_fused_solve.py:273-295)
    A, sup, b, y = _problem(seed, correlated=correlated)
    tA = to_torch(A)
    for bb in (b, y):
        _same(cstpu_torch.ompr(tA, to_torch(bb), 3, delta, maxiter=16),
              cstpu.ompr(A, bb, 3, delta, maxiter=16))


def test_ompr_eta_and_bail_out():
    # a step size other than 1, and a zero measurement: no passive atom
    # scores above 0, so the oblivious start comes back unchanged
    A, _, b, y = _problem(801)
    tA = to_torch(A)
    _same(cstpu_torch.ompr(tA, to_torch(y), 3, 1e-10, eta=0.5),
          cstpu.ompr(A, y, 3, 1e-10, eta=0.5))
    z = jnp.zeros_like(b)
    _same(cstpu_torch.ompr(tA, to_torch(z), 3, 1e-10),
          cstpu.ompr(A, z, 3, 1e-10))


@pytest.mark.parametrize("l", [1, 2])
@pytest.mark.parametrize("init", [1, 2])
def test_srr_matches_cstpu(l, init):
    A, sup, b, y = _problem(700)
    tA = to_torch(A)
    for bb in (b, y):
        got = _same(cstpu_torch.srr(tA, to_torch(bb), 3, l=l,
                                    initialization=init),
                    cstpu.srr(A, bb, 3, l=l, initialization=init))
        assert sup <= got


def test_srr_correlated_matches_cstpu():
    A, _, b, y = _problem(3, correlated=True)
    tA = to_torch(A)
    for bb in (b, y):
        _same(cstpu_torch.srr(tA, to_torch(bb), 3, maxiter=6),
              cstpu.srr(A, bb, 3, maxiter=6))


def test_srr_random_initialization_contract():
    # initialization 3 draws with a torch.Generator: its picks are not
    # cstpu's, so this holds its contract: k atoms, the same answer for the
    # same seed, the residual of the returned fit, and no run without a key
    A, sup, b, y = _problem(701)
    tA, ty = to_torch(A), to_torch(y)
    sols = [cstpu_torch.srr(tA, ty, 3, initialization=3,
                            key=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    for sol in sols:
        assert int(sol.mask.sum()) == 3 and sol.idx.shape == (4,)
    assert torch.equal(sols[0].idx, sols[1].idx)
    assert torch.equal(sols[0].val, sols[1].val)
    # at a fixed point the fit is least squares on its support
    s = sols[0]
    cols = tA[:, s.idx[s.mask].long()]
    ls = torch.linalg.lstsq(cols, ty[:, None]).solution[:, 0]
    np.testing.assert_allclose(s.val[s.mask].numpy(), ls.numpy(), atol=1e-8)
    with pytest.raises(ValueError, match="Generator"):
        cstpu_torch.srr(tA, ty, 3, initialization=3)


def _state(A, b, idx):
    """The same refitted active set in both packages (f64)."""
    m = A.shape[1]
    kmax = len(idx) + 1
    full = np.array(list(idx) + [m], np.int32)
    mask = np.arange(kmax) < len(idx)
    jst = jaset.refit(jaset.rebuild(A, b, jnp.asarray(full),
                                    jnp.asarray(mask)))
    tst = taset.refit(taset.rebuild(to_torch(A), to_torch(b),
                                    torch.from_numpy(full),
                                    torch.from_numpy(mask)))
    return jst, tst


@pytest.mark.parametrize("naive", [False, True])
def test_backward_deltas_and_step_match_cstpu(naive):
    A, sup, b, y = _problem(702)
    m = A.shape[1]
    jst, tst = _state(A, y, sorted(sup) + [5, 77])
    jd = np.asarray(jbackward.backward_deltas(y, jst, m, naive=naive))
    td = tbackward.backward_deltas(to_torch(y), tst, m, naive=naive).numpy()
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-8, atol=1e-12)
    inf = jnp.inf
    jst2, jacc = jbackward.backward_step(A, y, jst, inf, inf, m, naive=naive)
    tst2, tacc = tbackward.backward_step(to_torch(A), to_torch(y), tst,
                                         torch.inf, torch.inf, m,
                                         naive=naive)
    assert bool(jacc) and tacc
    _same(taset.finalize(tst2, m), jaset.finalize(jst2, m))
    # the deleted atom is a decoy, never a planted one
    assert sup <= set(solution_to_numpy(taset.finalize(tst2, m))["idx"]
                      .tolist())
    # a residual bound the deletion would break refuses it
    tst3, tacc3 = tbackward.backward_step(to_torch(A), to_torch(y), tst,
                                          1e-6, torch.inf, m)
    _, jacc3 = jbackward.backward_step(A, y, jst, 1e-6, inf, m)
    assert not tacc3 and not bool(jacc3) and tst3 is tst
