"""cstpu_torch.ops.fused_solve on the CPU (the plain versions of the select
and append kernels) against cstpu's Pallas kernels in interpret mode, on
the same inputs.

Tolerances: with corr f32 the indices are identical and values and
residuals agree to 1e-4, the tolerance cstpu holds its kernel to against
its XLA path (tests/test_fused_solve.py); with bf16 both solve the
bf16-rounded problem, so planted supports agree and values to 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu.ops import fused_solve as jfs
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.utils.interop import solution_to_numpy, to_torch

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _problem(seed, n=32, m=128, k=3):
    from conftest import planted_problem

    return planted_problem(seed, n=n, m=m, k=k, noise=5e-3,
                           dtype=jnp.float32)


def _batch(seed, n=32, m=128, k=3):
    A, x, b, y = _problem(seed, n, m, k)
    return A, x, jnp.stack([b, y, 2.0 * b, b - 0.1 * y])


def _active(sol_np):
    return [np.sort(i[m]) for i, m in zip(sol_np["idx"], sol_np["mask"])]


@pytest.mark.parametrize("seed", [200, 201])
def test_f32_matches_pallas_kernel(seed):
    A, x, Bs = _batch(seed)
    jsol, jr = jfs.omp_fused_solve(A, Bs, 3, corr_dtype=jnp.float32,
                                   interpret=True)
    tsol, tr = tfs.omp_fused_solve(to_torch(A), to_torch(Bs), 3,
                                   corr_dtype=torch.float32)
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
    # the residual is the one of the returned solution
    dense = tsol.todense()
    np.testing.assert_allclose((to_torch(Bs) - dense @ to_torch(A).T).numpy(),
                               tr.numpy(), atol=1e-4)


@pytest.mark.parametrize("seed", [202, 203])
def test_bf16_matches_pallas_kernel(seed):
    A, x, Bs = _batch(seed, n=64, m=256)
    jsol, _ = jfs.omp_fused_solve(A, Bs, 3, corr_dtype=jnp.bfloat16,
                                  interpret=True)
    tsol, _ = tfs.omp_fused_solve(to_torch(A), to_torch(Bs), 3)
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    planted = np.sort(np.flatnonzero(np.asarray(x)))
    for got, want in zip(_active(t), _active(j)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, planted)
    np.testing.assert_allclose(t["val"], j["val"], atol=1e-3)


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_k_beyond_rank_stalls_cleanly(cdt):
    A, x, b, y = _problem(204)
    Bs = jnp.stack([b, y])
    tsol, tr = tfs.omp_fused_solve(to_torch(A), to_torch(Bs), 8,
                                   corr_dtype=TDT[cdt])
    jsol, jr = jfs.omp_fused_solve(A, Bs, 8, corr_dtype=JDT[cdt],
                                   interpret=True)
    dense = tsol.todense()
    # the extra steps corrupt nothing: the fit stays exact on the clean row
    np.testing.assert_allclose((dense[0] @ to_torch(A).T).numpy(),
                               np.asarray(b), atol=1e-4 if cdt == "f32" else 1e-2)
    assert tsol.mask.sum(1).max() <= 8
    np.testing.assert_allclose(tr.norm(dim=1).numpy(),
                               np.linalg.norm(np.asarray(jr), axis=1),
                               atol=1e-4 if cdt == "f32" else 1e-3)


def test_nan_row_matches_pallas_kernel():
    # a NaN in a measurement poisons every score of that row: the select
    # rule gives index INT_MAX, which masks out; clean rows are untouched
    # cstpu's kernel, whose raw output is (INT_MAX, m, m) for that row, is
    # read through its `_to_solution` sort (sort_in_kernel=False): its
    # in-kernel sort moves idx through an f32 product with the NaN
    # coefficients and reports the poisoned row as three active atom-0
    # slots, which K1's own INT_MAX rule does not intend
    A, x, b, y = _problem(205)
    Bs = jnp.stack([b.at[0].set(jnp.nan), y, b])
    jsol, _ = jfs.omp_fused_solve(A, Bs, 3, corr_dtype=jnp.float32,
                                  interpret=True, sort_in_kernel=False)
    jdef, _ = jfs.omp_fused_solve(A, Bs, 3, corr_dtype=jnp.float32,
                                  interpret=True)
    tsol, _ = tfs.omp_fused_solve(to_torch(A), to_torch(Bs), 3,
                                  corr_dtype=torch.float32)
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_array_equal(t["idx"][1:], np.asarray(jdef.idx)[1:])
    assert not t["mask"][0].any()
    clean, _ = tfs.omp_fused_solve(to_torch(A), to_torch(Bs[1:]), 3,
                                   corr_dtype=torch.float32)
    np.testing.assert_array_equal(t["idx"][1:], clean.idx.numpy())
    np.testing.assert_array_equal(t["val"][1:], clean.val.numpy())


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_stream_matches_pallas_stream_kernel(cdt):
    A, x, b, y = _problem(206, n=32, m=512)
    Bs = jnp.stack([b, y, -b, 0.3 * b + y])
    jsol, jr = jfs.omp_stream_solve(A, Bs, 3, corr_dtype=JDT[cdt],
                                    interpret=True)
    tsol, tr = tfs.omp_stream_solve(to_torch(A), to_torch(Bs), 3,
                                    corr_dtype=TDT[cdt])
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    atol = 1e-4 if cdt == "f32" else 1e-3
    for got, want in zip(_active(t), _active(j)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(t["val"], j["val"], atol=atol)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=atol)


def test_ragged_m_and_odd_batch():
    # the port takes any n, m and B (cstpu's kernel wants m % 128 == 0 and
    # B % 8 == 0); hold it against cstpu's per-instance XLA omp in f32
    rng = np.random.default_rng(207)
    A = rng.standard_normal((40, 300)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((5, 300), np.float32)
    for row in X:
        row[rng.choice(300, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    Bs = X @ A.T
    tsol, _ = tfs.omp_fused_solve(to_torch(A), to_torch(Bs), 4,
                                  corr_dtype=torch.float32)
    import cstpu

    jsol = jax.vmap(lambda bb: cstpu.omp(jnp.asarray(A), bb, 4))(
        jnp.asarray(Bs))
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_allclose(t["val"], j["val"], atol=1e-4)
    for row, got in zip(X, _active(t)):
        np.testing.assert_array_equal(got, np.flatnonzero(row))


def test_select_partials_tie_and_nan_rules():
    # duplicated column -> lowest index; NaN row -> (NaN, INT_MAX);
    # ragged last tile masked
    rng = np.random.default_rng(208)
    A = rng.standard_normal((16, 300)).astype(np.float32)
    A[:, 290] = A[:, 17]
    r = np.stack([A[:, 17], rng.standard_normal(16).astype(np.float32)])
    r[1, 3] = np.nan
    pval, pidx = tfs._select_ref(torch.from_numpy(r), torch.from_numpy(A),
                                 torch.float32)
    assert pval.shape == (2, 3) and pidx.dtype == torch.int32
    vmax = pval.amax(1, keepdim=True)
    best = torch.where(pval == vmax, pidx, tfs.INT_MAX).amin(1)
    assert best.tolist() == [17, tfs.INT_MAX]
    assert int(pidx[0, 2]) == 290          # the tie's other copy, tile 2
    assert torch.isnan(pval[1]).all()


def test_supported_gates():
    A = torch.zeros((1024, 8192))
    Bs = torch.zeros((64, 1024))
    assert tfs.supported(A, Bs, 32) and tfs.supported_stream(A, Bs, 32)
    big = torch.empty((1024, 131072), device="meta")
    assert not tfs.supported(big, Bs, 32) and tfs.supported_stream(big, Bs, 32)
    assert not tfs.supported_stream(A, Bs, tfs.KMAX + 1)
    assert tfs.supported(A, Bs, 32, torch.float32)


def test_degeneracy_rtol_is_cstpu_value():
    for n in (32, 1024):
        assert tfs._degeneracy_rtol(n) == jfs._degeneracy_rtol(n)


def test_rejects_other_corr_dtypes():
    A, x, b, y = _problem(209)
    with pytest.raises(ValueError):
        tfs.omp_fused_solve(to_torch(A), to_torch(b)[None], 3,
                            corr_dtype=torch.float16)
