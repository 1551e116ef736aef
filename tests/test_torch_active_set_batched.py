"""The batched forms of cstpu_torch's active-set engine (`*_batched`, a
leading batch axis and masks for gates) against a loop over the per-instance
functions, in f64 on the same numpy inputs (atol 1e-12: the same sums in
another order), and against cstpu's vmapped engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstpu.ops import active_set as jas
from cstpu_torch.ops import active_set as tas
from cstpu_torch.utils.interop import solution_to_numpy

ATOL = 1e-12
B, N, M, KMAX = 5, 24, 40, 4


def _problem(seed, n=N, m=M, rows=B):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m))
    A /= np.linalg.norm(A, axis=0)
    return torch.from_numpy(A), torch.from_numpy(rng.standard_normal((rows, n)))


def _row(st, b):
    return tas.ActiveSet(*(x[b] for x in st))


def _same(batched, singles):
    """Row b of the batched state equals the b-th per-instance state."""
    for b, one in enumerate(singles):
        got = _row(batched, b)
        for name in ("idx", "mask", "k"):
            assert torch.equal(getattr(got, name), getattr(one, name)), (b, name)
        for name in ("cols", "G", "Ginv", "Atb", "coef"):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), getattr(one, name).numpy(),
                atol=ATOL, err_msg=f"row {b} {name}")


def _append_both(A, Bs, st, singles, atoms, ok):
    """One gated append and refit of atom atoms[b] in row b, both ways."""
    atoms = torch.as_tensor(atoms, dtype=torch.int32)
    ok = torch.as_tensor(ok)
    st = tas.refit_batched(tas.append_col_gated_batched(
        A[:, atoms.long()].T, Bs, st, atoms, ok))
    singles = [tas.refit(tas.append_col_gated(
        A[:, int(i)], Bs[b], one, int(i), bool(o)))
        for b, (one, i, o) in enumerate(zip(singles, atoms, ok))]
    return st, singles


def _filled(seed=0, steps=3):
    A, Bs = _problem(seed)
    st = tas.empty_batched(B, N, KMAX, M, torch.float64)
    singles = [tas.empty(N, KMAX, M, torch.float64) for _ in range(B)]
    rng = np.random.default_rng(seed + 100)
    picks = np.stack([rng.permutation(M)[:steps] for _ in range(B)], axis=1)
    for atoms in picks:
        st, singles = _append_both(A, Bs, st, singles, atoms, [True] * B)
    return A, Bs, st, singles


def test_empty_batched():
    st = tas.empty_batched(3, 8, 4, 20, torch.float64)
    _same(st, [tas.empty(8, 4, 20, torch.float64)] * 3)
    assert st.k.shape == (3,) and st.cols.shape == (3, 8, 4)


def test_append_refit_residual_contains():
    A, Bs, st, singles = _filled()
    _same(st, singles)
    assert st.k.tolist() == [3] * B
    np.testing.assert_allclose(
        tas.residual_batched(st, Bs).numpy(),
        torch.stack([tas.residual(one, Bs[b])
                     for b, one in enumerate(singles)]).numpy(), atol=ATOL)
    probe = torch.tensor([int(singles[0].idx[1]), 0, int(singles[2].idx[0]),
                          M - 1, int(singles[4].idx[2])], dtype=torch.int32)
    got = tas.contains_batched(st, probe)
    assert got.tolist() == [bool(tas.contains(one, int(i)))
                            for one, i in zip(singles, probe)]
    assert got[0] and got[2] and got[4]


def test_gate_off_rows_keep_their_state():
    A, Bs, st, singles = _filled(1, steps=2)
    before = tas.ActiveSet(*(x.clone() for x in st))
    ok = [True, False, True, False, False]
    st, singles = _append_both(A, Bs, st, singles, [30, 31, 32, 33, 34], ok)
    _same(st, singles)
    assert st.k.tolist() == [3, 2, 3, 2, 2]
    for b in (1, 3, 4):
        for x, y in zip(_row(st, b), _row(before, b)):
            assert torch.equal(x, y)


def test_rows_at_capacity_reject():
    A, Bs, st, singles = _filled(2, steps=3)
    # rows 0 and 1 reach capacity, then every row is offered one more atom
    st, singles = _append_both(A, Bs, st, singles, [35, 36, 0, 0, 0],
                               [True, True, False, False, False])
    assert st.k.tolist() == [4, 4, 3, 3, 3]
    st, singles = _append_both(A, Bs, st, singles, [37, 38, 37, 38, 39],
                               [True] * B)
    _same(st, singles)
    assert st.k.tolist() == [4] * B
    assert st.idx[0].tolist().count(37) == 0


def test_degenerate_column_is_rejected():
    A, Bs, st, singles = _filled(3, steps=2)
    # row 0 is offered a column inside its active span, row 1 a copy of an
    # active column; the others a fresh atom
    a = A[:, torch.tensor([20, 21, 22, 23, 24])].T.clone()
    a[0] = 0.3 * st.cols[0, :, 0] - 1.7 * st.cols[0, :, 1]
    a[1] = st.cols[1, :, 1]
    atoms = torch.tensor([20, 21, 22, 23, 24], dtype=torch.int32)
    ok = torch.ones(B, dtype=torch.bool)
    got = tas.append_col_gated_batched(a, Bs, st, atoms, ok)
    want = [tas.append_col_gated(a[b], Bs[b], one, int(atoms[b]), True)
            for b, one in enumerate(singles)]
    _same(got, want)
    assert got.k.tolist() == [2, 2, 3, 3, 3]


def test_delete_and_refresh():
    A, Bs, st, singles = _filled(4, steps=4)
    pos = torch.tensor([0, 3, 1, 2, 0])
    got = tas.refit_batched(tas.delete_batched(st, pos, M))
    want = [tas.refit(tas.delete(one, int(p), M))
            for one, p in zip(singles, pos)]
    _same(got, want)
    assert got.k.tolist() == [3] * B
    # refresh recomputes the same inverse from the exact Gram
    again = tas.refresh_batched(got)
    np.testing.assert_allclose(again.Ginv.numpy(), got.Ginv.numpy(),
                               atol=1e-10)
    _same(again._replace(Ginv=got.Ginv), want)


def test_refresh_gives_nan_for_a_singular_row_and_spares_the_others():
    A, Bs, st, singles = _filled(5, steps=2)
    G = st.G.clone()
    G[2, 0, 1] = G[2, 1, 0] = 1.0           # two equal unit columns
    out = tas.refresh_batched(st._replace(G=G))
    assert torch.isnan(out.Ginv[2]).all()
    np.testing.assert_allclose(out.Ginv[[0, 1, 3, 4]].numpy(),
                               st.Ginv[[0, 1, 3, 4]].numpy(), atol=1e-10)


def test_where_rows_and_finalize():
    A, Bs, st, singles = _filled(6, steps=3)
    st2, singles2 = _append_both(A, Bs, st, singles, [1, 2, 3, 4, 5],
                                 [True] * B)
    gate = torch.tensor([True, False, True, False, True])
    mixed = tas.where_rows(gate, st2, st)
    _same(mixed, [b2 if g else b1
                  for g, b1, b2 in zip(gate, singles, singles2)])
    sol = tas.finalize_batched(mixed, M)
    for b in range(B):
        one = tas.finalize(_row(mixed, b), M)
        assert torch.equal(sol.idx[b], one.idx)
        assert torch.equal(sol.mask[b], one.mask)
        np.testing.assert_allclose(sol.val[b].numpy(), one.val.numpy(),
                                   atol=ATOL)
    assert sol.m == M and sol.idx.dtype == torch.int32


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_matches_cstpu_vmapped_engine(dtype):
    # the chain a sharded OMP step runs, against jax.vmap of cstpu's engine
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    A, Bs = _problem(7)
    A, Bs = A.to(dtype), Bs.to(dtype)
    jA, jB = jnp.asarray(A.numpy()), jnp.asarray(Bs.numpy())
    st = tas.empty_batched(B, N, KMAX, M, dtype)
    js = jax.vmap(lambda _: jas.empty(N, KMAX, M, jdt))(jnp.arange(B))
    rng = np.random.default_rng(8)
    for step in range(5):                    # the fifth finds every row full
        atoms = rng.permutation(M)[:B].astype(np.int32)
        ok = np.array([True, True, step != 1, True, step != 2])
        st = tas.refit_batched(tas.append_col_gated_batched(
            A[:, torch.from_numpy(atoms).long()].T, Bs, st,
            torch.from_numpy(atoms), torch.from_numpy(ok)))
        js = jax.vmap(lambda a, bb, s, i, o: jas.refit(
            jas.append_col_gated(a, bb, s, i, o)))(
            jA[:, atoms].T, jB, js, jnp.asarray(atoms), jnp.asarray(ok))
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for name in ("idx", "mask", "k"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    for name in ("cols", "G", "Ginv", "Atb", "coef"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=tol,
                                   err_msg=name)
    t = solution_to_numpy(tas.finalize_batched(st, M))
    j = solution_to_numpy(jax.vmap(lambda s: jas.finalize(s, M))(js))
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_allclose(t["val"], j["val"], atol=tol)


def test_gamma_and_w_of_batched():
    # the two engine pieces of the sharded forward-regression family: every
    # row of the batched forms equals the per-instance form, and both equal
    # cstpu's `_w_of` and `gamma`
    from cstpu.parallel.sharded import _w_of

    A, Bs, st, singles = _filled(seed=3)
    np.testing.assert_allclose(
        tas.gamma_batched(st).numpy(),
        torch.stack([tas.gamma(one) for one in singles]).numpy(), atol=ATOL)
    a = A[:, [7, 11, 13, 17, 19]].T.contiguous()
    a[1] = singles[1].cols[:, 0]          # a column already in the span: the
    #                                       floor on d keeps w finite
    W = tas.w_of_batched(st, a)
    assert W.dtype == torch.float32 and tuple(W.shape) == (B, N)
    for b, one in enumerate(singles):
        w = tas.w_of(one, a[b])
        assert w.dtype == torch.float32
        np.testing.assert_allclose(W[b].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7)
        jst = jas.ActiveSet(*(jnp.asarray(x.numpy()) for x in one))
        if b == 1:
            continue     # d is rounding noise under the floor on both sides
        np.testing.assert_allclose(
            w.numpy(), np.asarray(_w_of(jst, jnp.asarray(a[b].numpy()))),
            rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tas.gamma(one).numpy(),
                                   np.asarray(jas.gamma(jst)), atol=ATOL)
    assert torch.isfinite(W).all()
    # w is orthogonal to the active columns and has unit energy d / d
    live = [0, 2, 3, 4]
    proj = torch.einsum("bnk,bn->bk", st.cols.float(), W)[live]
    assert float(proj.abs().max()) < 1e-5
