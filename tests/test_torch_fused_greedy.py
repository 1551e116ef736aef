"""The plain versions of the MP, GOMP and FR kernels of
cstpu_torch.ops.fused_solve on the CPU against cstpu's Pallas kernels
(`mp_fused_solve`, `gomp_fused_solve`, `fr_fused_solve`) in interpret mode,
on the same numpy-seeded inputs (n=32, m=128, B=8).

Tolerances: with corr f32 the indices are identical on rows whose picks are
not at rounding level, and values and residuals agree to 1e-4 absolute,
the tolerance cstpu holds its kernels to against its XLA paths
(tests/test_fused_solve.py); MP's dense x and r, which involve no solve,
to 1e-5. With bf16 both solve the bf16-rounded problem: supports agree and
values to 1e-3. Rows with an exact fit (noiseless) are compared only up to
the fit: past it, both pick atoms by rounding noise (docs/DESIGN.md:
recovery quality, not bitwise agreement, at near-ties)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu.ops import fused_solve as jfs
from cstpu_torch.ops import fused_solve as tfs
from cstpu_torch.utils.interop import solution_to_numpy, to_torch

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
ATOL = {"f32": 1e-4, "bf16": 1e-3}


def _noisy_batch(seed, B=8, n=32, m=128, k=3):
    """(A, planted supports (B, k), Bs): B noisy measurements, each of its
    own planted k-sparse +-1 signal, numpy-seeded."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    sup = np.stack([np.sort(rng.choice(m, k, replace=False))
                    for _ in range(B)])
    X = np.zeros((B, m), np.float32)
    for row, s in zip(X, sup):
        row[s] = rng.choice([-1.0, 1.0], k)
    noise = rng.standard_normal((B, n)).astype(np.float32)
    noise *= 5e-3 / np.linalg.norm(noise, axis=1, keepdims=True)
    return A, sup, (X @ A.T + noise).astype(np.float32)


def _compare(tsol, jsol, atol):
    t, j = solution_to_numpy(tsol), solution_to_numpy(jsol)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    np.testing.assert_allclose(t["val"], j["val"], atol=atol)
    return t


def _active(sol_np, row):
    return set(sol_np["idx"][row][sol_np["mask"][row]].tolist())


# --------------------------------------------------------------------------
# MP (K5)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_mp_matches_pallas_kernel(cdt):
    A, sup, Bs = _noisy_batch(600)
    Bs[3, 5] = np.nan                              # a NaN row: no-op steps
    jx, jr = jfs.mp_fused_solve(A, Bs, 12, corr_dtype=JDT[cdt],
                                interpret=True)
    tx, tr = tfs.mp_fused_solve_ref(to_torch(A), to_torch(Bs), 12,
                                    corr_dtype=TDT[cdt])
    atol = 1e-5 if cdt == "f32" else 1e-4
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=atol)
    ok = np.arange(8) != 3
    np.testing.assert_allclose(tr.numpy()[ok], np.asarray(jr)[ok], atol=atol)
    assert not tx[3].any() and torch.isnan(tr[3]).any()
    # the residual is the one of the returned x against the cdt-rounded
    # dictionary, and it falls
    Ac = to_torch(A).to(TDT[cdt]).float()
    np.testing.assert_allclose((to_torch(Bs) - tx @ Ac.T).numpy()[ok],
                               tr.numpy()[ok], atol=1e-4)
    assert bool((tr[ok].norm(dim=1) < to_torch(Bs)[ok].norm(dim=1)).all())


def test_mp_duplicated_column_lowest_index_wins():
    A, sup, Bs = _noisy_batch(601)
    A[:, 100] = A[:, 20]
    Bs[0] = A[:, 20] * 2.0
    jx, _ = jfs.mp_fused_solve(A, Bs, 4, corr_dtype=jnp.float32,
                               interpret=True)
    tx, _ = tfs.mp_fused_solve_ref(to_torch(A), to_torch(Bs), 4,
                                   corr_dtype=torch.float32)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    assert float(tx[0, 20]) == pytest.approx(2.0) and float(tx[0, 100]) == 0


# --------------------------------------------------------------------------
# GOMP (K4)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("l,k", [(1, 3), (2, 5), (3, 7)])   # (3, 7): k % l
def test_gomp_matches_pallas_kernel(cdt, l, k):
    A, sup, Bs = _noisy_batch(602 + l)
    js, jr = jfs.gomp_fused_solve(A, Bs, l, k, corr_dtype=JDT[cdt],
                                  interpret=True)
    ts, tr = tfs.gomp_fused_solve_ref(to_torch(A), to_torch(Bs), l, k,
                                      corr_dtype=TDT[cdt])
    t = _compare(ts, js, ATOL[cdt])
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL[cdt])
    assert t["idx"].shape == (8, k)
    if k >= 3:
        for row, s in enumerate(sup):
            assert set(s.tolist()) <= _active(t, row)


def test_gomp_nan_row_masked_and_duplicate_skipped():
    # NaN row: every pick INT_MAX, masked through cstpu's _to_solution;
    # a duplicated column ties with its twin, the lower index comes first
    # and the twin is rejected as degenerate without using a slot
    A, sup, Bs = _noisy_batch(606)
    j0 = int(sup[1][0])
    A[:, 127] = A[:, j0]
    Bs[0, 2] = np.nan
    js, _ = jfs.gomp_fused_solve(A, Bs, 2, 4, corr_dtype=jnp.float32,
                                 interpret=True)
    ts, _ = tfs.gomp_fused_solve_ref(to_torch(A), to_torch(Bs), 2, 4,
                                     corr_dtype=torch.float32)
    t = _compare(ts, js, ATOL["f32"])
    assert not t["mask"][0].any()
    assert j0 in _active(t, 1) and 127 not in _active(t, 1)


def test_gomp_topl_32_nan_row_and_a_column_repeated_across_tiles():
    # l = k = 32 (LMAX) picks in one step, in true f32, m = 512 (four
    # tiles): a NaN row picks nothing, and a column repeated in another
    # tile ties with its twin: the lower index is picked, the copy rejected
    # as degenerate
    A, sup, Bs = _noisy_batch(607, n=64, m=512)
    j0 = int(sup[1][0])
    twin = (j0 // 128 + 2) % 4 * 128 + 17
    A[:, twin] = A[:, j0]
    Bs[0, 5] = np.nan
    js, jr = jfs.gomp_fused_solve(A, Bs, tfs.LMAX, tfs.LMAX,
                                  corr_dtype=jnp.float32, interpret=True)
    ts, tr = tfs.gomp_fused_solve_ref(to_torch(A), to_torch(Bs), tfs.LMAX,
                                      tfs.LMAX, corr_dtype=torch.float32)
    t = _compare(ts, js, ATOL["f32"])
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL["f32"])
    assert not t["mask"][0].any()
    assert j0 in _active(t, 1) and twin not in _active(t, 1)
    for row in range(2, 8):
        assert set(sup[row].tolist()) <= _active(t, row)


def test_gomp_k_beyond_n_is_clamped():
    # the tests/test_fused_solve.py:238 pattern: k > n clamps the slot
    # width to n, and the planted atoms are all found
    A, sup, Bs = _noisy_batch(607, B=2)
    js, _ = jfs.gomp_fused_solve(A, Bs, 2, 128, corr_dtype=jnp.float32,
                                 interpret=True)
    ts, _ = tfs.gomp_fused_solve_ref(to_torch(A), to_torch(Bs), 2, 128,
                                     corr_dtype=torch.float32)
    t, j = solution_to_numpy(ts), solution_to_numpy(js)
    assert t["idx"].shape == j["idx"].shape == (2, 32)
    for row, s in enumerate(sup):
        assert set(s.tolist()) <= _active(t, row)
        assert set(s.tolist()) <= _active(j, row)


def test_gomp_max_residual_latches():
    # a residual tolerance above the noise stops each row after the
    # iteration that fits its planted atoms; the remainder iteration of
    # k % l = 2 picks still runs, as in cstpu: 3 + 2 atoms for a row fitted
    # by its first iteration
    A, sup, Bs = _noisy_batch(608)
    js, _ = jfs.gomp_fused_solve(A, Bs, 3, 8, max_residual=0.05,
                                 corr_dtype=jnp.float32, interpret=True)
    ts, _ = tfs.gomp_fused_solve_ref(to_torch(A), to_torch(Bs), 3, 8,
                                     max_residual=0.05,
                                     corr_dtype=torch.float32)
    t = _compare(ts, js, ATOL["f32"])
    counts = set(t["mask"].sum(1).tolist())
    assert 5 in counts and counts <= {5, 8}


# --------------------------------------------------------------------------
# FR (K3)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_fr_matches_pallas_kernel(cdt):
    A, sup, Bs = _noisy_batch(610)
    js, jr = jfs.fr_fused_solve(A, Bs, 3, corr_dtype=JDT[cdt],
                                interpret=True)
    ts, tr = tfs.fr_fused_solve_ref(to_torch(A), to_torch(Bs), 3,
                                    corr_dtype=TDT[cdt])
    t = _compare(ts, js, ATOL[cdt])
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL[cdt])
    for row, s in enumerate(sup):
        assert _active(t, row) == set(s.tolist())


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_fr_min_decrease_stops_early(cdt):
    # the tests/test_fused_solve.py:80 pattern: a min_decrease above the
    # noise stops each row after its informative atoms
    A, sup, Bs = _noisy_batch(611)
    js, _ = jfs.fr_fused_solve(A, Bs, 8, min_decrease=1e-2,
                               corr_dtype=JDT[cdt], interpret=True)
    ts, _ = tfs.fr_fused_solve_ref(to_torch(A), to_torch(Bs), 8,
                                   min_decrease=1e-2, corr_dtype=TDT[cdt])
    t = _compare(ts, js, ATOL[cdt])
    for row, s in enumerate(sup):
        assert _active(t, row) == set(s.tolist())


def test_fr_max_residual_nan_row_and_degenerate_twin():
    # max_residual stop; a NaN row latches at once and comes back fully
    # masked; the twin of an active atom scores -inf and is never picked
    A, sup, Bs = _noisy_batch(612)
    j0 = int(sup[1][0])
    A[:, 127] = A[:, j0]
    Bs[0, 4] = np.nan
    js, _ = jfs.fr_fused_solve(A, Bs, 6, max_residual=0.05,
                               corr_dtype=jnp.float32, interpret=True)
    ts, _ = tfs.fr_fused_solve_ref(to_torch(A), to_torch(Bs), 6,
                                   max_residual=0.05,
                                   corr_dtype=torch.float32)
    t = _compare(ts, js, ATOL["f32"])
    assert not t["mask"][0].any()
    assert j0 in _active(t, 1) and 127 not in _active(t, 1)
    for row in range(1, 8):
        assert set(sup[row].tolist()) <= _active(t, row)
    assert (t["mask"][1:].sum(1) < 6).all()


# --------------------------------------------------------------------------
# Sorting and gates
# --------------------------------------------------------------------------

def test_unsorted_slots_come_back_sorted_as_cstpu():
    # GOMP and FR keep their slots in insertion order; _sorted_solution
    # must give what cstpu's _to_solution gives, pads and NaN-row slots
    # (INT_MAX) masked last
    m = 50
    idx = np.array([[40, 3, 50, 17, 50],
                    [2147483647, 50, 50, 50, 50],
                    [9, 8, 7, 6, 5],
                    [50, 21, 50, 0, 49]], np.int32)
    coef = np.arange(20, dtype=np.float32).reshape(4, 5) - 7.5
    t = solution_to_numpy(tfs._sorted_solution(torch.from_numpy(idx),
                                                torch.from_numpy(coef), m))
    j = solution_to_numpy(jfs._to_solution(jnp.asarray(idx),
                                           jnp.asarray(coef), m))
    for key in ("idx", "val", "mask"):
        np.testing.assert_array_equal(t[key], j[key])
    assert (np.diff(t["idx"], axis=1) >= 0).all()


def test_greedy_gates():
    A = torch.zeros((1024, 8192))
    Bs = torch.zeros((64, 1024))
    assert tfs.supported_mp(A, Bs)
    assert tfs.supported_gomp(A, Bs, 4, 32)
    assert not tfs.supported_gomp(A, Bs, tfs.LMAX + 1, 64)
    assert tfs.supported_gomp(A, Bs, 200, 16)       # one remainder of 16
    assert tfs.supported_fr(A, Bs, 16)
    assert not tfs.supported_fr(A, Bs, tfs.KMAX + 1)
    assert not tfs.supported_mp(A, Bs[:, :10])
    with pytest.raises(ValueError):
        tfs.gomp_fused_solve_ref(A[:64, :128], Bs[:2, :64], tfs.LMAX + 1, 64)
