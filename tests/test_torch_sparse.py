"""cstpu_torch's solution container, helpers and selection primitives
against cstpu's, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstpu
import cstpu_torch
from cstpu.ops import select as jselect
from cstpu.ops import util as jutil
from cstpu_torch.ops import select as tselect
from cstpu_torch.ops import util as tutil
from cstpu_torch.utils import sparse as tsparse
from cstpu_torch.utils.interop import (solution_from_cstpu,
                                       solution_to_numpy, to_torch)


def _dense(seed, m=48, k=5):
    rng = np.random.default_rng(seed)
    x = np.zeros(m)
    x[rng.choice(m, k, replace=False)] = rng.standard_normal(k)
    return x


def _same_solution(tsol, jsol):
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    assert t["m"] == j["m"]
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=0, atol=0)


@pytest.mark.parametrize("kmax", [None, 8])
def test_from_dense_and_views_match(kmax):
    x = _dense(0)
    ts = tsparse.from_dense(torch.from_numpy(x), kmax=kmax)
    js = cstpu.utils.sparse.from_dense(x, kmax=kmax)
    _same_solution(ts, js)
    np.testing.assert_array_equal(ts.nzind, js.nzind)
    np.testing.assert_array_equal(ts.nzval, js.nzval)
    assert ts.nnz == js.nnz
    np.testing.assert_array_equal(ts.todense().numpy(),
                                  np.asarray(js.todense()))


def test_from_dense_rejects_overflow():
    with pytest.raises(ValueError):
        tsparse.from_dense(torch.from_numpy(_dense(1, k=5)), kmax=3)


def test_droptol_support_samesupport_match():
    x = _dense(2) * np.array([1e-4 if i % 2 else 1.0 for i in range(48)])
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(
        tsparse.droptol(tx, 1e-3).numpy(), np.asarray(cstpu.droptol(jx, 1e-3)))
    ts = tsparse.from_dense(tx, kmax=8)
    js = cstpu.utils.sparse.from_dense(x, kmax=8)
    _same_solution(tsparse.droptol(ts, 1e-3), cstpu.droptol(js, 1e-3))
    for tol in (0.0, 1e-3):
        np.testing.assert_array_equal(tsparse.support(tx, tol),
                                      cstpu.support(jx, tol))
        assert (tsparse.samesupport(tx, ts, tol)
                == cstpu.samesupport(jx, js, tol))
    assert not cstpu_torch.samesupport(tx, tsparse.droptol(ts, 1e-3))


@pytest.mark.parametrize("sparse_in", [False, True])
def test_polish_matches(sparse_in):
    from conftest import planted_problem

    A, x, b, y = planted_problem(3, n=32, m=48, k=3, dtype=jnp.float64)
    noisy = np.asarray(x) + 1e-2 * (np.arange(48) % 7 == 0)
    tA, ty = to_torch(A), to_torch(y)
    if sparse_in:
        tin = tsparse.from_dense(torch.from_numpy(noisy), kmax=10)
        jin = cstpu.utils.sparse.from_dense(noisy, kmax=10)
        tout, jout = tsparse.polish(tA, ty, tin, 0.5), cstpu.polish(A, y, jin, 0.5)
        np.testing.assert_array_equal(tout.idx.numpy(), np.asarray(jout.idx))
        np.testing.assert_allclose(tout.val.numpy(), np.asarray(jout.val),
                                   atol=1e-10)
    else:
        tout = tsparse.polish(tA, ty, torch.from_numpy(noisy), 0.5)
        jout = cstpu.polish(A, y, jnp.asarray(noisy), 0.5)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-10)


def test_padded_to_dense_batched_and_single():
    rng = np.random.default_rng(4)
    idx = np.array([[3, 7, 10, 10], [0, 9, 10, 10]], np.int32)
    mask = idx < 10
    val = rng.standard_normal((2, 4))
    out = tutil.padded_to_dense(torch.from_numpy(idx), torch.from_numpy(val),
                                torch.from_numpy(mask), 10)
    for row in range(2):
        want = jutil.padded_to_dense(jnp.asarray(idx[row]),
                                     jnp.asarray(val[row]),
                                     jnp.asarray(mask[row]), 10)
        np.testing.assert_array_equal(out[row].numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["argmax", "argmin"])
def test_masked_argmax_argmin_match(which):
    s = np.array([0.5, 2.0, -1.0, 2.0, 7.0, -1.0])
    valid = np.array([True, True, True, True, False, True])
    tf = getattr(tutil, f"masked_{which}")
    jf = getattr(jutil, f"masked_{which}")
    ti, tv = tf(torch.from_numpy(s), torch.from_numpy(valid))
    ji, jv = jf(jnp.asarray(s), jnp.asarray(valid))
    assert int(ti) == int(ji)
    assert float(tv) == float(jv)
    assert float(tutil.norm2(torch.from_numpy(s))) == float(jutil.norm2(
        jnp.asarray(s)))


@pytest.mark.parametrize("scores", [
    [1.0, 3.0, 2.0, 3.0, 3.0, 0.5],            # ties: lowest index first
    [1.0, np.nan, 3.0, 3.0, np.nan, 0.5],      # NaN counts as largest
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
])
def test_top1_topl_tie_and_nan_order(scores):
    s = np.asarray(scores, np.float32)
    ti, _ = tselect.top1(torch.from_numpy(s))
    ji, _ = jselect.top1(jnp.asarray(s))
    assert int(ti) == int(ji)
    for l in (1, 3, 6):
        np.testing.assert_array_equal(
            tselect.topl(torch.from_numpy(s), l).numpy(),
            np.asarray(jselect.topl(jnp.asarray(s), l)))


def test_abs_correlate_matches():
    rng = np.random.default_rng(5)
    A, r = rng.standard_normal((16, 40)), rng.standard_normal(16)
    np.testing.assert_allclose(
        tselect.abs_correlate(torch.from_numpy(A), torch.from_numpy(r)).numpy(),
        np.asarray(jselect.abs_correlate(jnp.asarray(A), jnp.asarray(r))),
        atol=1e-12)


def test_interop_round_trips():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    t = to_torch(a)
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), a)
    assert to_torch(jnp.asarray(a), dtype=torch.float64).dtype == torch.float64
    a[0, 0] = 99.0                       # a copy, not a view
    assert float(t[0, 0]) != 99.0
    # batched cstpu solution -> torch -> numpy keeps every field
    xs = np.stack([_dense(s, m=20, k=3) for s in (7, 8)])
    rows = [cstpu.utils.sparse.from_dense(x, 6) for x in xs]
    jsol = cstpu.SparseSolution(jnp.stack([s.idx for s in rows]),
                                jnp.stack([s.val for s in rows]),
                                jnp.stack([s.mask for s in rows]), 20)
    tsol = solution_from_cstpu(jsol)
    assert tsol.idx.dtype == torch.int32 and tsol.mask.dtype == torch.bool
    _same_solution(tsol, jsol)
    np.testing.assert_array_equal(tsol.todense().numpy(), xs)
