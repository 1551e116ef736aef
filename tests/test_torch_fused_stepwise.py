"""The plain versions of the stepwise kernels of
cstpu_torch.ops.fused_twostage (the whole solves `rmp_fused_solve_ref` and
`foba_fused_solve_ref`) on the CPU against cstpu's Pallas kernels
(`rmp_fused_solve`, `foba_fused_solve`) in interpret mode, on the seeds of
cstpu's tests/test_fused_solve.py and the same numpy arrays.

Tolerances: dense solutions and residuals to 1e-4 absolute, the tolerance
cstpu holds its kernels to against its XLA paths, in f32 and in bf16 (both
solve the bf16-rounded problem); supports and `capped` equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstpu
from cstpu.ops import fused_twostage as jft
from cstpu_torch.ops import fused_twostage as tft
from cstpu_torch.utils.interop import solution_to_numpy, to_torch

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
ATOL = 1e-4


def _problem(seed, n=32, m=128, k=3):
    from conftest import planted_problem

    return planted_problem(seed, n=n, m=m, k=k, noise=1e-2 / 2,
                           dtype=jnp.float32)


def _compare(tout, jout):
    """(SparseSolution, r, capped) triples: supports and capped equal,
    values and residuals to ATOL."""
    t, j = solution_to_numpy(tout[0]), solution_to_numpy(jout[0])
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    return t


def _dense(sol):
    t = solution_to_numpy(sol)
    out = np.zeros((t["idx"].shape[0], t["m"] + 1), t["val"].dtype)
    np.put_along_axis(out, np.where(t["mask"], t["idx"], t["m"]),
                      np.where(t["mask"], t["val"], 0), axis=1)
    return out[:, :-1]


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("maxiter", [1, 3])
def test_rmp_delta_matches_pallas_kernel(cdt, maxiter):
    A, x, b, y = _problem(910)
    Bs = jnp.stack([b, y, -2.0 * b, b + y])
    jout = jft.rmp_fused_solve(A, Bs, delta=1e-2, maxiter=maxiter, kmax=8,
                               corr_dtype=JDT[cdt], interpret=True)
    *tout, (t, f) = tft.rmp_fused_solve_ref(
        to_torch(A), to_torch(Bs), delta=1e-2, maxiter=maxiter, kmax=8,
        corr_dtype=TDT[cdt], return_iters=True)
    got = _compare(tout, jout)
    assert got["idx"].shape == (4, 8) and not tout[2].any()
    assert 1 <= t <= maxiter and f >= 4
    if cdt == "f32":   # and the per-instance path's solution
        ref = np.stack([np.asarray(cstpu.rmp(A, bb, delta=1e-2).todense())
                        for bb in Bs])
        np.testing.assert_allclose(_dense(tout[0]), ref, atol=ATOL)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_rmp_k_matches_pallas_kernel(cdt):
    # forward to the f32 exhaustion floor, backward to k; kmax = n holds
    # whatever the noisy row's exhaustion takes. That row fills all n slots
    # of a square, badly conditioned system: in f32 the two packages still
    # agree (cstpu's own test), on the bf16-rounded problem the last pivots
    # are rounding noise and the two runs part, so bf16 takes exact rows
    A, x, b, y = _problem(910)
    Bs = jnp.stack([b, y]) if cdt == "f32" else jnp.stack([b, -2.0 * b])
    n = A.shape[0]
    jout = jft.rmp_fused_solve(A, Bs, k=3, kmax=n, corr_dtype=JDT[cdt],
                               interpret=True)
    tout = tft.rmp_fused_solve_ref(to_torch(A), to_torch(Bs), k=3, kmax=n,
                                   corr_dtype=TDT[cdt])
    t = _compare(tout, jout)
    assert not tout[2].any()
    planted = set(np.flatnonzero(np.asarray(x)).tolist())
    for row in range(2):
        assert set(t["idx"][row][t["mask"][row]].tolist()) == planted


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_rmp_capped_flag_and_argument_errors(cdt):
    # kmax = 2 cannot hold a 3-sparse solution: the forward stage reports
    # the cap instead of truncating in silence
    A, x, b, y = _problem(911)
    Bs = jnp.stack([b, y])
    jout = jft.rmp_fused_solve(A, Bs, delta=1e-2, kmax=2,
                               corr_dtype=JDT[cdt], interpret=True)
    tout = tft.rmp_fused_solve_ref(to_torch(A), to_torch(Bs), delta=1e-2,
                                   kmax=2, corr_dtype=TDT[cdt])
    _compare(tout, jout)
    assert tout[2].all()
    tA, tB = to_torch(A), to_torch(Bs)
    with pytest.raises(ValueError, match="kmax"):
        tft.rmp_fused_solve_ref(tA, tB, k=9, kmax=8, corr_dtype=TDT[cdt])
    for kw in ({}, {"k": 3, "delta": 1e-2}):
        with pytest.raises(ValueError, match="exactly one"):
            tft.rmp_fused_solve_ref(tA, tB, **kw)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_foba_matches_pallas_kernel(cdt):
    A, x, b, y = _problem(912)
    Bs = jnp.stack([b, y, -b, 0.5 * b + y])
    jout = jft.foba_fused_solve(A, Bs, delta=1e-2, kmax=8,
                                corr_dtype=JDT[cdt], interpret=True)
    *tout, t = tft.foba_fused_solve_ref(to_torch(A), to_torch(Bs), 1e-2,
                                        kmax=8, corr_dtype=TDT[cdt],
                                        return_iters=True)
    _compare(tout, jout)
    assert not tout[2].any() and t >= 4
    if cdt == "f32":
        ref = np.stack([np.asarray(cstpu.foba(A, bb, 1e-2).todense())
                        for bb in Bs])
        np.testing.assert_allclose(_dense(tout[0]), ref, atol=ATOL)


@pytest.mark.parametrize("solver", ["rmp", "foba"])
def test_stepwise_correlated_deletions_match_pallas_kernel(solver):
    # a correlated dictionary with noise: early picks are superseded, so the
    # backward stages delete and their restore terms feed the next select
    import jax

    kd, kn = jax.random.split(jax.random.PRNGKey(11))
    A, x, b = cstpu.correlated_data(kd, n=32, m=128, k=4, decay=0.25,
                                    dtype=jnp.float32)
    Bs = jnp.stack([cstpu.perturb(kk, b, 5e-2)
                    for kk in jax.random.split(kn, 4)])
    if solver == "rmp":
        jout = jft.rmp_fused_solve(A, Bs, delta=5e-2, maxiter=3, kmax=12,
                                   corr_dtype=jnp.float32, interpret=True)
        tout = tft.rmp_fused_solve_ref(to_torch(A), to_torch(Bs), delta=5e-2,
                                       maxiter=3, kmax=12,
                                       corr_dtype=torch.float32)
    else:
        jout = jft.foba_fused_solve(A, Bs, delta=2e-2, kmax=12,
                                    corr_dtype=jnp.float32, interpret=True)
        tout = tft.foba_fused_solve_ref(to_torch(A), to_torch(Bs), 2e-2,
                                        kmax=12, corr_dtype=torch.float32)
    _compare(tout, jout)


def test_stepwise_nan_row_is_left_empty():
    # a NaN row's scores are NaN: its forward step is rejected at once and
    # the row comes back empty, as cstpu's
    A, x, b, y = _problem(913)
    Bs = jnp.stack([b.at[2].set(jnp.nan), y])
    for jout, tout in (
            (jft.rmp_fused_solve(A, Bs, delta=1e-2, kmax=8,
                                 corr_dtype=jnp.float32, interpret=True),
             tft.rmp_fused_solve_ref(to_torch(A), to_torch(Bs), delta=1e-2,
                                     kmax=8, corr_dtype=torch.float32)),
            (jft.foba_fused_solve(A, Bs, 1e-2, kmax=8,
                                  corr_dtype=jnp.float32, interpret=True),
             tft.foba_fused_solve_ref(to_torch(A), to_torch(Bs), 1e-2, kmax=8,
                                      corr_dtype=torch.float32))):
        t, j = solution_to_numpy(tout[0]), solution_to_numpy(jout[0])
        np.testing.assert_array_equal(t["idx"], j["idx"])
        assert not t["mask"][0].any()
        np.testing.assert_allclose(t["val"][1], j["val"][1], atol=ATOL)
        np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))


def test_stepwise_gate():
    A = torch.zeros((1024, 8192))
    Bs = torch.zeros((64, 1024))
    assert tft.supported_rmp(A, Bs, 32)
    assert tft.supported_rmp(A, Bs, 128)
    assert not tft.supported_rmp(A, Bs, 129)         # beyond KMAX
    assert not tft.supported_rmp(A, Bs, 0)
    assert not tft.supported_rmp(A, Bs[:, :10], 8)
