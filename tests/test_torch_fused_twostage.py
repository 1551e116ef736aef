"""The plain versions of the two-stage kernels of
cstpu_torch.ops.fused_twostage (the whole solves `sp_fused_solve_ref`,
`ompr_fused_solve_ref`, `srr_fused_solve_ref`) on the CPU against cstpu's
Pallas kernels (`sp_fused_solve`, `ompr_fused_solve`, `srr_fused_solve`)
in interpret mode, on the seeds of cstpu's tests/test_fused_solve.py and
the same numpy arrays.

Tolerances: supports equal; coefficients and residuals to 1e-4 absolute,
the tolerance cstpu holds its kernels to against its XLA paths, in f32 and
in bf16 (both solve the bf16-rounded problem). SP's outer iterations are
equal. OMPR's are not compared: once a row's support settles, its next
swap re-adds and drops the same atom and the latch `prev <= ||r||^2`
compares two residual norms of one support, equal to rounding, which the
two runs may break differently (unless delta stops the row first)."""

import jax
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


def _correlated(seed, n=32, m=128, k=3, decay=2.0):
    kd, kn = jax.random.split(jax.random.PRNGKey(seed))
    A, x, b = cstpu.correlated_data(kd, n=n, m=m, k=k, decay=decay,
                                    dtype=jnp.float32)
    return A, x, b, cstpu.perturb(kn, b, 5e-3)


def _compare(tout, jout, atol=ATOL):
    """(SparseSolution, r) pairs: supports equal, values and r to atol."""
    t, j = solution_to_numpy(tout[0]), solution_to_numpy(jout[0])
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], rtol=0, atol=atol)
    live = ~np.isnan(np.asarray(jout[1])).any(axis=1)
    np.testing.assert_allclose(tout[1].numpy()[live],
                               np.asarray(jout[1])[live], rtol=0, atol=atol)
    return t


def _active(t, row):
    return set(t["idx"][row][t["mask"][row]].tolist())


# --------------------------------------------------------------------------
# SP (K12)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_sp_matches_pallas_kernel(cdt):
    A, x, b, y = _problem(500)
    Bs = jnp.stack([b, y, -2.0 * b, b + y])
    *jout, jit = jft.sp_fused_solve(A, Bs, 3, maxiter=8, corr_dtype=JDT[cdt],
                                    interpret=True, return_iters=True)
    *tout, tit = tft.sp_fused_solve_ref(to_torch(A), to_torch(Bs), 3,
                                        maxiter=8, corr_dtype=TDT[cdt],
                                        return_iters=True)
    t = _compare(tout, jout)
    assert tit == int(jit)
    assert t["idx"].shape == (4, 6)              # 2k slots, as cstpu's
    planted = set(np.flatnonzero(np.asarray(x)).tolist())
    for row in range(4):
        assert planted <= _active(t, row)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_sp_recovers_and_matches_unstructured(cdt):
    # 501: exact recovery of a noisy row; 502: Gaussian measurements with
    # no sparse fit at k = 8, where every prune decides between atoms
    A, x, b, y = _problem(501)
    jout = jft.sp_fused_solve(A, y[None, :], 3, corr_dtype=JDT[cdt],
                              interpret=True)
    tout = tft.sp_fused_solve_ref(to_torch(A), to_torch(y[None, :]), 3,
                                  corr_dtype=TDT[cdt])
    t = _compare(tout, jout)
    assert _active(t, 0) == set(np.flatnonzero(np.asarray(x)).tolist())
    ka, kb = jax.random.split(jax.random.PRNGKey(502))
    A = jax.random.normal(ka, (64, 256))
    A = A / jnp.linalg.norm(A, axis=0, keepdims=True)
    Bs = jax.random.normal(kb, (6, 64))
    _compare(tft.sp_fused_solve_ref(to_torch(A), to_torch(Bs), 8, maxiter=8,
                                    corr_dtype=TDT[cdt]),
             jft.sp_fused_solve(A, Bs, 8, maxiter=8, corr_dtype=JDT[cdt],
                                interpret=True))


@pytest.mark.parametrize("seed", [1, 3, 4])
def test_sp_multi_swap_correlated(seed):
    # correlated draws that swap atoms over several rounds (cstpu's
    # tests/test_fused_solve.py:391-419, the default bf16): the port's
    # exact rebuild must decide as cstpu's incremental/Newton-Schulz routes
    A, x, b = cstpu.correlated_data(jax.random.PRNGKey(seed), n=64, m=256,
                                    k=5, decay=1.0, dtype=jnp.float32)
    Bs = jnp.stack([cstpu.perturb(kk, b, 5e-3) for kk in
                    jax.random.split(jax.random.PRNGKey(seed + 100), 8)])
    *jout, jit = jft.sp_fused_solve(A, Bs, 5, maxiter=12, interpret=True,
                                    return_iters=True)
    *tout, tit = tft.sp_fused_solve_ref(to_torch(A), to_torch(Bs), 5,
                                        maxiter=12, return_iters=True)
    _compare(tout, jout)
    assert tit == int(jit) >= 3, (tit, int(jit))


def test_sp_nan_row_masks_out():
    A, x, b, y = _problem(930)
    Bs = jnp.stack([b.at[0].set(jnp.nan), y, b, -y])
    *jout, jit = jft.sp_fused_solve(A, Bs, 3, maxiter=8,
                                    corr_dtype=jnp.float32, interpret=True,
                                    return_iters=True)
    *tout, tit = tft.sp_fused_solve_ref(to_torch(A), to_torch(Bs), 3,
                                        maxiter=8, corr_dtype=torch.float32,
                                        return_iters=True)
    t = _compare(tout, jout)
    assert not t["mask"][0].any() and tit == int(jit)
    with pytest.raises(ValueError, match="2k"):
        tft.sp_fused_solve_ref(to_torch(A), to_torch(Bs), 17)


# --------------------------------------------------------------------------
# OMPR (K13)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_ompr_matches_pallas_kernel(cdt):
    A, x, b, y = _problem(800)
    Bs = jnp.stack([b, y, -b, 2.0 * y])
    jout = jft.ompr_fused_solve(A, Bs, 3, delta=1e-10, maxiter=16,
                                corr_dtype=JDT[cdt], interpret=True)
    tout = tft.ompr_fused_solve_ref(to_torch(A), to_torch(Bs), 3, 1e-10,
                                    maxiter=16, corr_dtype=TDT[cdt])
    t = _compare(tout, jout)
    assert t["idx"].shape == (4, 4)              # k+1 slots, as cstpu's


@pytest.mark.parametrize("seed", [2, 7])
def test_ompr_preappend_gradient_discriminators(seed):
    # the deletion score is built from the pre-append solution: on these
    # correlated seeds the post-append variant deletes another slot (cstpu's
    # tests/test_fused_solve.py:273-295)
    A, x, b, y = _correlated(seed)
    Bs = jnp.stack([y, cstpu.perturb(jax.random.PRNGKey(seed + 50), b,
                                     5e-3)])
    jout = jft.ompr_fused_solve(A, Bs, 3, 1e-2, corr_dtype=jnp.float32,
                                interpret=True)
    tout = tft.ompr_fused_solve_ref(to_torch(A), to_torch(Bs), 3, 1e-2,
                                    corr_dtype=torch.float32)
    t = _compare(tout, jout)
    for row in range(2):
        ref = cstpu.ompr(A, Bs[row], 3, 1e-2)
        assert _active(t, row) == set(np.asarray(ref.nzind).tolist())


def test_ompr_eta_and_nan_row():
    A, x, b, y = _problem(801)
    Bs = jnp.stack([b.at[3].set(jnp.nan), y, -y, 0.5 * y])
    jout = jft.ompr_fused_solve(A, Bs, 3, 1e-10, eta=0.5, maxiter=16,
                                corr_dtype=jnp.float32, interpret=True)
    tout = tft.ompr_fused_solve_ref(to_torch(A), to_torch(Bs), 3, 1e-10,
                                    eta=0.5, maxiter=16,
                                    corr_dtype=torch.float32)
    t = _compare(tout, jout)
    assert not t["mask"][0].any()


# --------------------------------------------------------------------------
# SRR (K14)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("l", [1, 2])
def test_srr_matches_pallas_kernel(cdt, l):
    A, x, b, y = _problem(700)
    Bs = jnp.stack([b, y, -b, b + 0.5 * y])
    jout = jft.srr_fused_solve(A, Bs, 3, l=l, corr_dtype=JDT[cdt],
                               interpret=True)
    tout = tft.srr_fused_solve_ref(to_torch(A), to_torch(Bs), 3, l=l,
                                   corr_dtype=TDT[cdt])
    t = _compare(tout, jout)
    assert t["idx"].shape == (4, 3 + l)          # k+l slots, as cstpu's
    planted = set(np.flatnonzero(np.asarray(x)).tolist())
    for row in range(4):
        assert planted <= _active(t, row)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_srr_correlated_swaps_and_nan_row(cdt):
    # the correlated dictionary of suite config 3b (decay 0.25) makes the
    # forward and backward steps swap atoms; a NaN row never latches (the
    # loop runs to maxiter, as cstpu's) and comes back masked
    A, x, b, y = _correlated(11, n=32, m=128, k=4, decay=0.25)
    Bs = jnp.stack([y, b.at[2].set(jnp.nan), -y, 2.0 * b])
    jout = jft.srr_fused_solve(A, Bs, 4, maxiter=5, l=2,
                               corr_dtype=JDT[cdt], interpret=True)
    *tout, tit = tft.srr_fused_solve_ref(to_torch(A), to_torch(Bs), 4,
                                         maxiter=5, l=2,
                                         corr_dtype=TDT[cdt],
                                         return_iters=True)
    t = _compare(tout, jout)
    assert not t["mask"][1].any() and tit == 5


# --------------------------------------------------------------------------
# Gates
# --------------------------------------------------------------------------

def test_twostage_gates():
    A = torch.zeros((1024, 8192))
    Bs = torch.zeros((64, 1024))
    assert tft.supported_sp(A, Bs, 32)
    assert not tft.supported_sp(A, Bs, 33)           # beyond select_topl
    assert not tft.supported_sp(A[:60], Bs[:, :60], 31)   # 2k > n
    assert tft.supported_ompr(A, Bs, 32)
    assert not tft.supported_ompr(A, Bs, 33)
    assert tft.supported_srr(A, Bs, 16, 1)
    assert tft.supported_srr(A, Bs, 16, 100)
    assert not tft.supported_srr(A, Bs, 16, 0)
    assert not tft.supported_srr(A, Bs, 32, 100)     # k + l > KMAX
    assert not tft.supported_ompr(A, Bs[:, :10], 8)
    with pytest.raises(ValueError):
        tft.srr_fused_solve_ref(A[:32, :128], Bs[:2, :32], 3, l=0)
